"""Render settings shared by the engines, and the flat pixel grid.

PyTorch counterpart of ``RenderConfig`` and ``_pixel_grid`` in
:mod:`rayz_tpu.ops.integrator`. The dense (autograd) integrator itself
joins this module in a later slice; its ``chunk_size`` and ``remat``
settings join with it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["RenderConfig"]


class RenderConfig(NamedTuple):
    """Static render settings. Defaults mirror the reference Tracer fields
    (max_bounces=50, samples_per_px=10). The reference's t_min is 1e-10 in
    f64; in f32 that invites shadow acne, so the default is 1e-3."""

    spp: int = 10
    max_depth: int = 50
    t_min: float = 1e-3
    jitter: bool = True


def _pixel_grid(camera):
    """Flat int32 pixel coordinates [H*W] in the reference's layout
    (integrator.py:95): x = column i, y = row j, index j*W + i."""
    xs = torch.arange(camera.width, dtype=torch.int32, device=camera.device)
    ys = torch.arange(camera.height, dtype=torch.int32, device=camera.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    return gx.reshape(-1), gy.reshape(-1)
