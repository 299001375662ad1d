"""Kernel launches per preview frame in the traced slice (the reader of
``launches_per_render``, moving the preview cell's metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "launches_per_render.py").read(run)
