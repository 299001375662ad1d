"""Batched 3-vector math on ``[..., 3]`` tensors.

PyTorch counterpart of :mod:`rayz_tpu.utils.vec`: vectors are the trailing
axis of ordinary tensors, so every operation is batched; rays are separate
origin, direction and time tensors, and :func:`ray_at` is the batched
``Ray.at``. Each formula is the JAX module's term for term.
"""

from __future__ import annotations

import torch

__all__ = ["dot", "norm", "norm2", "normalize", "cross", "reflect",
           "refract", "ray_at", "near_zero", "NEAR_ZERO_TOL"]

# Tolerance of V3.nearZero (vec.zig:107-110).
NEAR_ZERO_TOL = 1e-8


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis of 3-vectors broadcast against
    each other, shape [...]. Written out, (a0 b0 + a1 b1) + a2 b2, so the
    result of each element never depends on the shape around it (a
    reduction's order may)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm2(a: torch.Tensor) -> torch.Tensor:
    """Squared magnitude over the trailing axis."""
    return dot(a, a)


def norm(a: torch.Tensor) -> torch.Tensor:
    """Magnitude."""
    return torch.sqrt(norm2(a))


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector. ``eps`` floors the magnitude, for the zero vector in
    differentiated code; with the default 0 it matches the reference
    exactly (0/0 -> nan)."""
    n = norm(a)[..., None]
    if eps:
        n = torch.clamp_min(n, eps)
    return a / n


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of the (possibly non-unit) ``d`` about the unit
    normal ``n`` (material.zig:185-187)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(unit_dir: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """Snell refraction of a unit direction about the unit normal ``n``
    (material.zig:189-194); the parallel part's radicand is clamped at 0,
    so the result under total internal reflection is finite but unused.
    The clamp is a double where: at a radicand of exactly 0 (a grazing
    ray) sqrt's derivative is inf, and even a zero cotangent (a ray that
    is not refracted) would carry NaN into the normal's gradient."""
    if torch.is_tensor(eta) and eta.dim():
        eta = eta[..., None]
    cos_theta = dot(-unit_dir, n)[..., None]
    perp = (unit_dir + cos_theta * n) * eta
    rad = 1.0 - norm2(perp)
    pos = rad > 0.0
    root = torch.where(pos, torch.sqrt(torch.where(pos, rad, 1.0)), 0.0)
    return perp + -root[..., None] * n


def ray_at(origin: torch.Tensor, direction: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
    """Point along the ray: origin + t * direction."""
    return origin + t[..., None] * direction


def near_zero(a: torch.Tensor, tol: float = NEAR_ZERO_TOL) -> torch.Tensor:
    """All components within ``tol`` of zero. Shape [...] bool."""
    return torch.all(torch.abs(a) <= tol, dim=-1)
