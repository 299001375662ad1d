"""Least times of kernels: operations and bytes from the cell's inputs and
the reference's own counts, over the card's published peaks
(``peaks.json``). One module per kernel, named after it, gives
``work(run) -> (operations, bytes)`` for one request."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from benchmark import scene as bs
from benchmark.reference.tracer import SPHERE_TEST_FLOPS, TRIANGLE_TEST_FLOPS

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def least_time_s(flops: float, nbytes: float,
                 device_kind: str) -> Optional[float]:
    """The larger of operations over the FP32 peak and bytes over the
    memory bandwidth of ``device_kind``; None for a card not in the
    table."""
    with open(_PEAKS) as fh:
        peak = json.load(fh).get(device_kind)
    if peak is None:
        return None
    return max(flops / peak["fp32_flops_per_s"], nbytes / peak["bytes_per_s"])


def scene_work(cfg: dict, segments: float):
    """Operations and bytes of ``segments`` nearest-hit queries, each
    testing every primitive of the scene (no padding) as the reference
    does, and the scene's tables and one image, each counted once: a
    sphere as 8 words (centre, velocity, radius, material), a triangle as
    10, a material as 5, a texture as 8, a pixel as 3, 4 bytes a word."""
    a = bs.inputs(cfg)
    n, m = len(a["sph_r"]), len(a["tri_m"])
    width, height = cfg["resolution"]
    flops = segments * (n * SPHERE_TEST_FLOPS + m * TRIANGLE_TEST_FLOPS)
    words = (8 * n + 10 * m + 5 * len(a["mat_kind"]) + 8 * len(a["tex_kind"])
             + 3 * width * height)
    return flops, 4.0 * words
