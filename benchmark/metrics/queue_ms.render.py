"""Device milliseconds a render of the queue megakernel."""


def read(run):
    if run.slice is None:
        return None
    s = run.slice.device_s(lambda n: "megakernel_queue" in n)
    return s * 1e3 / run.slice.requests if s > 0 else None
