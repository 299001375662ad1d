"""Seconds from the process's start to the window's first request, less
the reference's work in set-up (a train mix's target)."""


def read(run):
    return run.setup_s
