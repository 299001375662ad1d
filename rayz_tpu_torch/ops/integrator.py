"""Render settings shared by the engines.

PyTorch counterpart of ``RenderConfig`` in :mod:`rayz_tpu.ops.integrator`.
The dense (autograd) integrator itself joins this module in a later slice;
its ``chunk_size`` and ``remat`` settings join with it.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["RenderConfig"]


class RenderConfig(NamedTuple):
    """Static render settings. Defaults mirror the reference Tracer fields
    (max_bounces=50, samples_per_px=10). The reference's t_min is 1e-10 in
    f64; in f32 that invites shadow acne, so the default is 1e-3."""

    spp: int = 10
    max_depth: int = 50
    t_min: float = 1e-3
    jitter: bool = True
