"""The device's idle share of the traced slice of preview frames (the
reader of ``device_idle_pct.render``, moving the preview cell's metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "device_idle_pct.render.py").read(run)
