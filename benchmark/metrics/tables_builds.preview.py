"""Table builds a preview frame in the traced slice (the reader of
``tables_builds.render``, moving the preview cell's metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "tables_builds.render.py").read(run)
