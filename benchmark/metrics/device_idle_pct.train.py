"""The share of the traced slice in which no operation ran on the device:
1 - (union of device operations' intervals) / (the slice's wall time)."""


def read(run):
    if run.slice is None:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
