"""Device milliseconds a frame of operations that are not the program's
own CUDA kernels: the streamed tables' build, the sort, permutations and
partitions between launches, the scatters, the sum over samples and the
image's copy to the host."""

from benchmark import kernels


def read(run):
    if run.slice is None:
        return None
    s = run.slice.device_s(lambda n: not kernels.is_own(n))
    return s * 1e3 / run.slice.requests if s > 0 else None
