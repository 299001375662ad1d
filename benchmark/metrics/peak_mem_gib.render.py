"""torch.cuda.max_memory_allocated() over the window (or the traced
slice), after reset_peak_memory_stats(), in GiB."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
