"""Batched ray/primitive intersection for the dense integrator.

PyTorch counterpart of :mod:`rayz_tpu.ops.intersect`: every ray tests every
primitive as one dense [R, N] computation, a first-minimum reduction picks
the nearest hit, and the hit's attributes come from [R]-sized gathers of
the winner. Plain torch; the JAX module computes it in XLA, outside any
Pallas kernel.

Two departures in form, none in value:

* The JAX package writes the inner products as ``[R,3] @ [3,N]`` matrix
  products pinned to HIGHEST precision (intersect.py:53-65): at reduced
  precision their rounding rings every surface with self-intersections.
  Here they are broadcast multiply-adds, which no matmul precision setting
  (``torch.set_float32_matmul_precision``, ``allow_tf32``) can change.
* The [R, N] sweep runs without autograd and keeps only the winner's
  column; the winner's distance is then computed again from its gathered
  parameters with the same elementwise operations, so it equals the
  sweep's bit for bit and carries the gradient. Gradients reach only the
  winner's t, as through JAX's argmin and take_along_axis, and the backward
  keeps O(R) tensors per bounce instead of O(R N).

The nearest hit is JAX's: the first minimum wins, padding never hits, and
a sphere wins a tie with a triangle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.scene import Scene
from ..utils import vec

__all__ = ["HitRecord", "intersect", "intersect_spheres",
           "intersect_triangles", "aabb_hit", "aabb_enclose",
           "aabb_longest_axis", "sphere_aabb"]


class HitRecord(NamedTuple):
    """Batched hit (hit.zig:16-42). ``normal`` is unit and turned against
    the ray; ``front_face`` says which side was hit."""

    t: torch.Tensor  # [R], +inf on a miss
    point: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3]
    front_face: torch.Tensor  # [R] bool
    material: torch.Tensor  # [R] int32
    hit: torch.Tensor  # [R] bool


def _sphere_t(c0, vel, r, valid, origin, direction, time, t_min, t_max,
              has_motion: bool):
    """Sphere distances, the quadratic with the half-b form of
    Sphere.hitInner (geom.zig:38-66): the near root in [t_min, t_max], else
    the far one, else +inf. The sphere parameters are [N, 3] / [N] with
    rays [R, 3] / [R] broadcast to [R, N] (``c0[None]``), or gathered per
    ray ([R, 3] against [R, 3]). The terms are JAX's, in its order."""
    d_dot_o = vec.dot(direction, origin)
    a = vec.norm2(direction)
    o2 = vec.norm2(origin)
    d_dot_c = vec.dot(direction, c0)
    o_dot_c = vec.dot(origin, c0)
    c0_sq = vec.norm2(c0)
    if has_motion:
        d_dot_c = d_dot_c + time * vec.dot(direction, vel)
        o_dot_c = o_dot_c + time * vec.dot(origin, vel)
        c0_sq = (c0_sq + 2.0 * time * vec.dot(c0, vel)
                 + (time * time) * vec.norm2(vel))
    half_b = d_dot_c - d_dot_o
    c_term = c0_sq - 2.0 * o_dot_c + o2 - r * r
    disc = half_b * half_b - a * c_term
    pos = disc > 0.0
    # double where: sqrt'(0) is inf, so non-hit lanes take a dummy 1
    rt = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    t1 = (half_b - rt) * inv_a
    t2 = (half_b + rt) * inv_a
    t1_ok = (t1 >= t_min) & (t1 <= t_max)
    t2_ok = (t2 >= t_min) & (t2 <= t_max)
    inf = torch.full((), float("inf"), dtype=t1.dtype, device=t1.device)
    t = torch.where(t1_ok, t1, torch.where(t2_ok, t2, inf))
    return torch.where((disc >= 0.0) & valid, t, inf)


def intersect_spheres(scene: Scene, origin, direction, time, t_min: float,
                      t_max: float = float("inf")):
    """Nearest sphere hit per ray: (t [R], idx [R] int64), t = +inf on a
    miss; moving centers at center0 + time * velocity (intersect.py:69)."""
    c0, vel, r = scene.sphere_center, scene.sphere_velocity, scene.sphere_radius
    with torch.no_grad():
        t_all = _sphere_t(c0[None], vel[None], r[None],
                          scene.sphere_valid[None], origin[:, None],
                          direction[:, None], time[:, None], t_min, t_max,
                          scene.has_motion)
        idx = torch.argmin(t_all, dim=1)
        del t_all
    t = _sphere_t(c0[idx], vel[idx], r[idx], scene.sphere_valid[idx], origin,
                  direction, time, t_min, t_max, scene.has_motion)
    return t, idx


def _triangle_frame(scene: Scene):
    """Per-triangle plane normal (unnormalized) and the dual basis g1, g2
    of the edges, [M, 3] each (intersect.py:122): differentiable in the
    vertices."""
    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    n = vec.cross(e1, e2)
    d11 = vec.dot(e1, e1)
    d12 = vec.dot(e1, e2)
    d22 = vec.dot(e2, e2)
    den = d11 * d22 - d12 * d12
    nz = den != 0.0
    inv_den = torch.where(nz, 1.0 / torch.where(nz, den, 1.0), 0.0)
    g1 = (e1 * d22[:, None] - e2 * d12[:, None]) * inv_den[:, None]
    g2 = (e2 * d11[:, None] - e1 * d12[:, None]) * inv_den[:, None]
    return n, g1, g2


def _triangle_t(n, g1, g2, v0, valid, origin, direction, t_min, t_max):
    """Triangle distances by the plane, then barycentrics as affine
    functions of the hit point (intersect.py:139): +inf where the ray is
    parallel, out of range or outside. Broadcast as :func:`_sphere_t`."""
    n_dot_v0 = vec.dot(n, v0)
    n_dot_o = vec.dot(origin, n)
    n_dot_d = vec.dot(direction, n)
    parallel = n_dot_d == 0.0
    t = (n_dot_v0 - n_dot_o) / torch.where(parallel, 1.0, n_dot_d)
    g1_o = vec.dot(origin, g1) - vec.dot(g1, v0)
    g1_d = vec.dot(direction, g1)
    g2_o = vec.dot(origin, g2) - vec.dot(g2, v0)
    g2_d = vec.dot(direction, g2)
    u = g1_o + t * g1_d
    v = g2_o + t * g2_d
    ok = ((~parallel) & (t >= t_min) & (t <= t_max) & (u >= 0.0)
          & (v >= 0.0) & (u + v <= 1.0) & valid)
    return torch.where(ok, t, torch.full((), float("inf"), dtype=t.dtype,
                                         device=t.device))


def intersect_triangles(scene: Scene, origin, direction, time,
                        t_min: float, t_max: float = float("inf"),
                        frame=None):
    """Nearest double-sided triangle hit per ray: (t [R], idx [R] int64),
    t = +inf on a miss. Triangles are static (``time`` unused). ``frame``
    is :func:`_triangle_frame`'s, when the caller has it."""
    del time
    n, g1, g2 = _triangle_frame(scene) if frame is None else frame
    v0, valid = scene.tri_v0, scene.tri_valid
    with torch.no_grad():
        t_all = _triangle_t(n[None], g1[None], g2[None], v0[None],
                            valid[None], origin[:, None], direction[:, None],
                            t_min, t_max)
        idx = torch.argmin(t_all, dim=1)
        del t_all
    t = _triangle_t(n[idx], g1[idx], g2[idx], v0[idx], valid[idx], origin,
                    direction, t_min, t_max)
    return t, idx


def intersect(scene: Scene, origin, direction, time, t_min: float,
              t_max: float = float("inf")) -> HitRecord:
    """Nearest hit over all primitives (intersect.py:184): the spheres',
    then the triangles' where there are any, a sphere winning a tie."""
    t_s, i_s = intersect_spheres(scene, origin, direction, time, t_min, t_max)
    if scene.n_triangles > 0:
        frame = _triangle_frame(scene)
        t_t, i_t = intersect_triangles(scene, origin, direction, time, t_min,
                                       t_max, frame)
        sphere_wins = t_s <= t_t
        t = torch.where(sphere_wins, t_s, t_t)
    else:
        t = t_s
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 0.0)
    point = vec.ray_at(origin, direction, t_safe)

    # outward normal: unit(point - center(time)), the unit of the offset
    # and not offset / radius, so a negative-radius "bubble" points out too
    cen = scene.sphere_center[i_s]
    if scene.has_motion:
        cen = cen + time[:, None] * scene.sphere_velocity[i_s]
    normal = vec.normalize(point - cen, eps=1e-20)
    material = scene.sphere_material[i_s]
    if scene.n_triangles > 0:
        n_tri = vec.normalize(frame[0][i_t], eps=1e-20)
        normal = torch.where(sphere_wins[:, None], normal, n_tri)
        material = torch.where(sphere_wins, material,
                               scene.tri_material[i_t])

    # front-face flip (hit.zig:31-34): the normal opposes the ray
    front_face = vec.dot(normal, direction) < 0.0
    normal = torch.where(front_face[:, None], normal, -normal)
    return HitRecord(t=t, point=point, normal=normal, front_face=front_face,
                     material=material.to(torch.int32), hit=hit)


def aabb_hit(low, high, origin, direction, t_min, t_max):
    """Batched slab test, AABB.hit (hit.zig:70-98; intersect.py:234): the
    per-axis intervals intersected with [t_min, t_max]; a hit iff t1 > t0
    (strict). Division by a zero direction component follows IEEE, as in
    JAX: an infinite slab bound, or NaN where the origin lies on the slab's
    plane, which every comparison then fails. ``low``/``high`` [..., 3]
    broadcast against ``origin``/``direction`` [..., 3]."""
    t0s = (low - origin) / direction
    t1s = (high - origin) / direction
    lo = torch.minimum(t0s, t1s)
    hi = torch.maximum(t0s, t1s)
    t0 = torch.maximum(lo.amax(dim=-1), torch.as_tensor(t_min, dtype=lo.dtype,
                                                        device=lo.device))
    t1 = torch.minimum(hi.amin(dim=-1), torch.as_tensor(t_max, dtype=hi.dtype,
                                                        device=hi.device))
    return t1 > t0


def aabb_enclose(low_a, high_a, low_b, high_b):
    """Union of two boxes, AABB.enclose (hit.zig:55-60; intersect.py:250)."""
    return torch.minimum(low_a, low_b), torch.maximum(high_a, high_b)


def aabb_longest_axis(low, high):
    """Index of the widest axis (int32), AABB.longestAxis (hit.zig:62-64;
    intersect.py:257): the first axis on a tie."""
    return torch.argmax(high - low, dim=-1).to(torch.int32)


def sphere_aabb(center0, velocity, radius):
    """Box of a (possibly moving) sphere over t in [0, 1], the union of its
    boxes at t = 0 and t = 1, Sphere.boundingBox (geom.zig:24-31;
    intersect.py:265)."""
    r = radius[..., None]
    c1 = center0 + velocity
    return aabb_enclose(center0 - r, center0 + r, c1 - r, c1 + r)
