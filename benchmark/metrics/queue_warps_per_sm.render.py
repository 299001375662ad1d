"""Warps an SM of the queue megakernel's launches in the traced slice,
from the launch geometry the device trace gives each kernel: Kineto's own
``warps per SM`` where present, else grid x block / 32 / the card's SMs.
The queue's grid is persistent (its blocks all resident at once), so this
is the warps each SM keeps in flight. The mean over the slice's launches;
None where it has no queue launch or none with its geometry."""

import math

#: SMs of the cards the benchmark names (``roofline/peaks.json``).
SMS = {"NVIDIA H100 80GB HBM3": 132}


def _warps(args: dict, sms):
    if "warps per SM" in args:
        return float(args["warps per SM"])
    if sms is None or "grid" not in args or "block" not in args:
        return None
    return math.prod(args["grid"]) * math.prod(args["block"]) / 32 / sms


def read(run):
    if run.slice is None:
        return None
    sms = SMS.get(run.device_kind)
    warps = [_warps(e.get("args", {}), sms) for e in run.slice.kernels
             if "megakernel_queue" in e["name"]]
    warps = [w for w in warps if w is not None]
    return sum(warps) / len(warps) if warps else None
