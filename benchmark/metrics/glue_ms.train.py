"""Device milliseconds a step of operations that are not the program's own
CUDA kernels: the compaction's sorts, cumsums and copies, Adam, the
loss."""

from benchmark import kernels


def read(run):
    if run.slice is None:
        return None
    return run.slice.device_s(lambda n: not kernels.is_own(n)) * 1e3 \
        / run.slice.requests
