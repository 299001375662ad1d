"""Device milliseconds a preview frame of the queue megakernel (the reader
of ``queue_ms.render``, moving the preview cell's metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "queue_ms.render.py").read(run)
