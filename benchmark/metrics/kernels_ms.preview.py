"""Device milliseconds a frame of the program's own CUDA kernels (every
``__global__`` of its ``csrc/``): whichever engine ``render_fast`` picks,
the wavefront's launches or the queue megakernel and its fold."""

from benchmark import kernels


def read(run):
    if run.slice is None:
        return None
    s = run.slice.device_s(kernels.is_own)
    return s * 1e3 / run.slice.requests if s > 0 else None
