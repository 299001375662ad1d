"""Host milliseconds a preview frame inside the program's ``rayz.*`` spans
(the reader of ``program_host_ms.render``, moving the preview cell's
metric)."""

from benchmark.harness import ROOT, load_module


def read(run):
    return load_module(ROOT / "metrics" / "program_host_ms.render.py").read(run)
