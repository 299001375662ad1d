"""Kernel launches per render in the traced slice."""


def read(run):
    if run.slice is None:
        return None
    return run.slice.launches() / run.slice.requests
