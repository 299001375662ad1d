"""Device milliseconds a step of the persistent-path recorder."""


def read(run):
    if run.slice is None:
        return None
    s = run.slice.device_s(lambda n: "record_pp_kernel" in n)
    return s * 1e3 / run.slice.requests if s > 0 else None
