"""Host milliseconds a preview frame inside ``rayz.tables`` (the reader of
``tables_ms.render``, moving the preview cell's metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "tables_ms.render.py").read(run)
