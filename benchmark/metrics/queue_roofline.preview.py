"""The queue megakernel's share of its roofline a preview frame (the reader
of ``queue_roofline.render``, moving the preview cell's metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "queue_roofline.render.py").read(run)
