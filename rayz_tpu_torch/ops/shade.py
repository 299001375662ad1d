"""Texture evaluation, material scattering and sky shading for the dense
integrator.

PyTorch counterpart of :mod:`rayz_tpu.ops.shade`: every material branch is
computed for every ray and the ray's own is selected by its kind code;
each formula is the JAX module's term for term, quirks included. One
difference by design: JAX's ``scatter`` splits its key five ways and draws
a separate ball, unit and hemisphere sample, a fuzz vector and a coin; here
it takes the five numbers a megakernel bounce draws (``_key_draws``: a unit
vector, a cube-root radius, a Schlick uniform) and uses them as the
megakernel's ``_scatter`` does: the ball sample is the unit vector times
the radius, the hemisphere sample that ball sample flipped, the fuzz the
unit vector. So one seed traces the megakernel's paths (up to near ties:
the two round differently), and JAX's only in distribution.
"""

from __future__ import annotations

import torch

from ..models.scene import (DIFFUSE_UNIT_SPHERE, DIFFUSE_UNIT_SPHERE_SURFACE,
                            MAT_DIELECTRIC, MAT_METALLIC, TEX_SOLID, Scene)
from ..utils import sampling, vec
from .intersect import HitRecord

__all__ = ["texture_value", "scatter", "sky_color", "schlick_reflectance",
           "MAX_TEXTURE_DEPTH"]

# Chase depth for a directly constructed Scene whose tex_depth is 0
# (unknown); builder scenes carry their exact nest depth.
MAX_TEXTURE_DEPTH = 4


def texture_value(scene: Scene, tex_idx: torch.Tensor,
                  point: torch.Tensor) -> torch.Tensor:
    """Batched Texture.value (material.zig:41-51), any checker nesting: a
    solid gives its color; a checker picks its even or odd child by the
    parity of floor(x/s) + floor(y/s) + floor(z/s) (floor modulo, so
    negative cells too), chased for the scene's static ``tex_depth``
    levels. Differentiable in ``tex_color``."""
    levels = scene.tex_depth if scene.tex_depth > 0 else MAX_TEXTURE_DEPTH
    cur = tex_idx.long()
    done = torch.zeros(tex_idx.shape, dtype=torch.bool, device=point.device)
    out = torch.zeros((*tex_idx.shape, 3), dtype=point.dtype,
                      device=point.device)
    for _ in range(levels):
        is_solid = scene.tex_kind[cur] == TEX_SOLID
        take = is_solid & ~done
        out = torch.where(take[..., None], scene.tex_color[cur], out)
        done = done | is_solid
        scale = scene.tex_scale[cur][..., None]
        cells = torch.floor(point / scale).to(torch.int32)
        even = (cells[..., 0] + cells[..., 1] + cells[..., 2]) % 2 == 0
        child = torch.where(even, scene.tex_even[cur], scene.tex_odd[cur])
        cur = torch.where(done, cur, child.long())
    # unresolved only where a hand-built nest exceeds the fallback depth:
    # the node's own color, as in JAX
    return torch.where(done[..., None], out, scene.tex_color[cur])


def schlick_reflectance(cos_theta: torch.Tensor, eta) -> torch.Tensor:
    """Schlick's approximation (material.zig:179-183)."""
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    one_minus = 1.0 - cos_theta
    om2 = one_minus * one_minus
    return r0 + (1.0 - r0) * (om2 * om2 * one_minus)


def sky_color(direction: torch.Tensor) -> torch.Tensor:
    """Miss shading (renderer.zig:124-125), the reference's formula: with
    t = 0.5 (unit(d).y + 1), ``t * ((1 - t) white + blue)``."""
    t = 0.5 * (vec.normalize(direction)[..., 1] + 1.0)
    t = t[..., None]
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=direction.dtype,
                        device=direction.device)
    return ((1.0 - t) + blue) * t


def scatter(scene: Scene, direction: torch.Tensor, hit: HitRecord, draws):
    """Batched Material.scatter (material.zig:162-177), every material
    evaluated and the ray's selected. ``direction`` is the incoming ray's
    (not normalized); ``draws`` the bounce's (u_x, u_y, u_z, radius,
    coin), each [R]: a unit vector, the ball radius u^(1/3) and a uniform.
    Returns (new direction [R, 3], attenuation [R, 3], scattered [R]
    bool); the caller moves the origin to the hit point and keeps the
    time."""
    ux, uy, uz, cb, us = (x.to(direction.dtype) for x in draws)
    mat = hit.material.long()
    kind = scene.mat_kind[mat]
    tex = scene.mat_texture[mat]
    fuzz = scene.mat_fuzz[mat]
    ior = scene.mat_ior[mat]
    method = scene.mat_method[mat]
    normal, point = hit.normal, hit.point

    # ---- diffuse (material.zig:75-101) ----
    s_unit = torch.stack([ux, uy, uz], dim=-1)
    s_sphere = s_unit * cb[..., None]
    s_hemi = sampling.random_in_hemisphere(s_sphere, normal)
    offset = torch.where(
        (method == DIFFUSE_UNIT_SPHERE)[..., None], normal + s_sphere,
        torch.where((method == DIFFUSE_UNIT_SPHERE_SURFACE)[..., None],
                    normal + s_unit, s_hemi))
    target = point + offset
    # reference quirk (material.zig:85-86): the near-zero test is on the
    # target POINT, which then snaps to the bare normal
    target = torch.where(vec.near_zero(target)[..., None], normal, target)
    dir_diffuse = target - point
    albedo = texture_value(scene, tex, point)

    # ---- metallic (material.zig:107-131): fuzz clamped to <= 1; absorbed
    # unless scattered above the surface ----
    refl = vec.normalize(vec.reflect(direction, normal), eps=1e-20)
    # jnp.minimum: at fuzz == 1 each side takes half the gradient
    fz = torch.minimum(fuzz, torch.ones_like(fuzz))
    dir_metal = refl + fz[..., None] * s_unit
    metal_ok = vec.dot(dir_metal, normal) > 0.0

    # ---- dielectric (material.zig:136-159): reflects the NON-unit
    # incoming direction, refracts the unit one, as the reference does ----
    eta = torch.where(hit.front_face, 1.0 / ior, ior)
    unit_dir = vec.normalize(direction)
    cos_theta = vec.dot(-unit_dir, normal)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = eta * sin_theta > 1.0
    do_reflect = cannot_refract | (schlick_reflectance(cos_theta, eta) > us)
    dir_diel = torch.where(do_reflect[..., None],
                           vec.reflect(direction, normal),
                           vec.refract(unit_dir, normal, eta))

    # ---- select by kind (material.zig:167-176) ----
    is_metal = kind == MAT_METALLIC
    is_diel = kind == MAT_DIELECTRIC
    new_dir = torch.where(is_diel[..., None], dir_diel,
                          torch.where(is_metal[..., None], dir_metal,
                                      dir_diffuse))
    attenuation = torch.where(is_diel[..., None], 1.0, albedo)
    # degenerate-scatter guard (the JAX engines'): a zero direction would
    # miss everything and send 0/0 through sky_color; absorb it instead
    tiny = 1e-20 if new_dir.dtype == torch.float32 else 1e-300
    scattered = torch.where(is_metal, metal_ok, True) & (
        vec.norm2(new_dir) > tiny)
    return new_dir, attenuation, scattered
