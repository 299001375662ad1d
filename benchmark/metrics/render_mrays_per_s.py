"""Camera rays (pixels x spp) of every render completed in the window, over
the window's wall time, in millions a second."""


def read(run):
    return sum(run.rays) / run.window_s / 1e6
