"""Peak device memory over the window of frames (the reader of
``peak_mem_gib.render``, moving the frames' latency metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "peak_mem_gib.render.py").read(run)
