"""Reparameterized random sampling from uniform draws.

PyTorch counterpart of :mod:`rayz_tpu.utils.sampling`: closed-form
transforms with the distributions of the reference's rejection loops. The
JAX functions take ``jax.random`` keys; these take the uniform draws
themselves, as tensors, because the port keys every draw by (seed, pixel,
sample, bounce, draw number) (:mod:`rayz_tpu_torch.ops.rng`). The
transforms are the megakernel's: a unit vector by the cylinder map
(:func:`rayz_tpu_torch.ops.rng.unit3`), the ball's radius as a cube root by
exp/log, the disk's as a square root. So a render that feeds them the
megakernel's draws traces the megakernel's paths.
"""

from __future__ import annotations

import math

import torch

from ..ops import rng
from . import vec

__all__ = ["uniform", "cube_root", "random_unit_vector",
           "random_in_unit_sphere", "random_in_hemisphere",
           "random_in_unit_disk"]


def uniform(u: torch.Tensor, low: float = 0.0,
            high: float = 1.0) -> torch.Tensor:
    """``u`` in [0, 1) mapped onto [low, high)."""
    return low + (high - low) * u


def cube_root(u: torch.Tensor) -> torch.Tensor:
    """u^(1/3) as the kernels compute it: exp(log(max(u, 1e-24)) / 3)."""
    return torch.exp(torch.log(torch.clamp_min(u, 1e-24)) * (1.0 / 3.0))


def random_unit_vector(u_z: torch.Tensor, u_phi: torch.Tensor
                       ) -> torch.Tensor:
    """Uniform direction on the unit sphere [..., 3] from two uniforms
    (z ~ U[-1, 1], phi ~ U[0, 2 pi))."""
    return torch.stack(rng.unit3(u_z, u_phi), dim=-1)


def random_in_unit_sphere(u_z: torch.Tensor, u_phi: torch.Tensor,
                          u_r: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit ball [..., 3]: a uniform direction scaled
    by u^(1/3)."""
    return random_unit_vector(u_z, u_phi) * cube_root(u_r)[..., None]


def random_in_hemisphere(s: torch.Tensor, normal: torch.Tensor
                         ) -> torch.Tensor:
    """The ball sample ``s`` flipped to ``normal``'s side, not normalized
    (material.zig:207-211)."""
    keep = (vec.dot(s, normal) > 0.0)[..., None]
    return torch.where(keep, s, -s)


def random_in_unit_disk(u_r: torch.Tensor, u_theta: torch.Tensor
                        ) -> torch.Tensor:
    """Uniform point in the unit disk [..., 2]: r = sqrt(u_r), theta =
    2 pi u_theta."""
    r = torch.sqrt(u_r)
    theta = (2.0 * math.pi) * u_theta
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
