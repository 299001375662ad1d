"""The persistent-path recorder's least time a step
(``roofline/record_pp_kernel``) over its device time a step, in percent."""

from benchmark import roofline
from benchmark.harness import ROOT, load_module


def read(run):
    ms = load_module(ROOT / "metrics" / "record_pp_ms.train.py").read(run)
    work = load_module(ROOT / "roofline" / "record_pp_kernel.py").work(run)
    if ms is None or work is None:
        return None
    least = roofline.least_time_s(*work, run.device_kind)
    return None if least is None else 100.0 * least * 1e3 / ms
