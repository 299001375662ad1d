"""The queue megakernel's least time a render (``roofline/megakernel_queue``)
over its device time a render, in percent."""

from benchmark import roofline
from benchmark.harness import ROOT, load_module


def read(run):
    ms = load_module(ROOT / "metrics" / "queue_ms.render.py").read(run)
    work = load_module(ROOT / "roofline" / "megakernel_queue.py").work(run)
    if ms is None or work is None:
        return None
    least = roofline.least_time_s(*work, run.device_kind)
    return None if least is None else 100.0 * least * 1e3 / ms
