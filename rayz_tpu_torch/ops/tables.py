"""Scene and camera tables shared by every kernel of the port.

PyTorch counterpart of the host-side table builders of
:mod:`rayz_tpu.ops.megakernel` (``supports_scene``, ``_material_rows``,
``scene_tables``, ``tri_tables``, ``_pad_poison``, ``_camera_vector``,
``_resolve_tiling`` and the culling-off part of ``_smem_scene_inputs``).
Every table equals its JAX twin exactly: the sums are written out in the
order XLA evaluates them.

The residency rule is re-derived for the H100: the megakernel copies the
camera vector and the full tables into one block's dynamic shared memory,
which holds at most 227 KB (232,448 bytes) per block on Hopper.
:func:`fits_shared` is that rule; it replaces the JAX package's
``fits_smem``/``SMEM_BUDGET``, which are sized for the 1 MiB SMEM of a TPU
v5e.
"""

from __future__ import annotations

import torch

from ..models.camera import Camera
from ..models.scene import MAT_DIELECTRIC, TEX_SOLID, Scene, _round_up

__all__ = ["supports_scene", "scene_tables", "tri_tables", "fits_shared",
           "shared_bytes", "SHARED_LIMIT", "CAM_WORDS"]

# Sphere table rows (one f32 row per attribute, columns = spheres).
_CX, _CY, _CZ, _CCMR2 = 0, 1, 2, 3
_VX, _VY, _VZ, _CV2, _VV = 4, 5, 6, 7, 8
_PKF, _IOS = 9, 10  # packed (kind*4+method)*4 + 2*fuzz; ior-or-scale
_EVR, _EVG, _EVB, _ODR, _ODG, _ODB = 11, 12, 13, 14, 15, 16
_NROWS = 17

# Triangle table rows (columns = triangles): plane normal n = e1 x e2 and
# n.v0; dual-basis rows g1/g2 with their v0 inner products; then the same
# material/texture block as spheres.
_TNX, _TNY, _TNZ, _TNV0 = 0, 1, 2, 3
_TG1X, _TG1Y, _TG1Z, _TG1V = 4, 5, 6, 7
_TG2X, _TG2Y, _TG2Z, _TG2V = 8, 9, 10, 11
_TPKF, _TIOS = 12, 13
_TEVR, _TEVG, _TEVB, _TODR, _TODG, _TODB = 14, 15, 16, 17, 18, 19
_TNROWS = 20

_BIG = 3.0e38  # stand-in for +inf (t on miss)

#: f32 words the camera vector occupies at the head of the kernel's shared
#: memory (18 used, padded to keep the tables 16-byte aligned).
CAM_WORDS = 20

#: Dynamic shared memory one block may use on an H100 (bytes).
SHARED_LIMIT = 232_448


def supports_scene(scene: Scene) -> bool:
    """Static eligibility: any non-empty sphere/triangle scene WITHOUT
    nested checker textures. The kernel resolves exactly one level of
    checker, so a deeper nest would render differently; such scenes are
    rejected instead of silently degraded (``Scene.deep_checker``)."""
    return ((scene.n_spheres > 0 or scene.n_triangles > 0)
            and not scene.deep_checker)


def _resolve_tiling(scene: Scene) -> int:
    """Per-scene sweep unroll the tables are padded to: 8 primitives per
    group for sphere scenes, 16 for triangle-dominant ones, as in the JAX
    package. The kernel unrolls its sweeps by 8, so both keep its loops free
    of remainders. (The TPU tile size has no counterpart here: the kernel's
    block is a fixed 128 threads, see csrc/megakernel.cu.)"""
    return 16 if scene.n_triangles > scene.n_spheres else 8


def _material_rows(scene: Scene, mat: torch.Tensor):
    """Per-primitive material/texture rows shared by the sphere and triangle
    tables: packed (kind, method, fuzz), ior-or-checker-scale, and the
    one-level-resolved even/odd checker colors (a solid texture is its own
    color). Kind and method decode exactly from the packed float; fuzz loses
    a few mantissa bits (<4e-6 absolute). ior and checker scale are
    mutually exclusive by material kind, so they share one row."""
    f32 = torch.float32
    mat = mat.long()
    kind = scene.mat_kind[mat].to(f32)
    method = scene.mat_method[mat].to(f32)
    fuzz = scene.mat_fuzz[mat].to(f32)
    ior = scene.mat_ior[mat].to(f32)

    tex = scene.mat_texture[mat].long()
    solid = scene.tex_kind[tex] == TEX_SOLID
    base = scene.tex_color[tex].to(f32)
    even = scene.tex_color[scene.tex_even[tex].long()].to(f32)
    odd = scene.tex_color[scene.tex_odd[tex].long()].to(f32)
    ev = torch.where(solid[:, None], base, even)
    od = torch.where(solid[:, None], base, odd)
    one = torch.ones((), dtype=f32, device=mat.device)
    scale = torch.where(solid, one, scene.tex_scale[tex].to(f32))

    pkf = (kind * 4.0 + method) * 4.0 + 2.0 * torch.clamp_max(fuzz, 1.0)
    ios = torch.where(kind == float(MAT_DIELECTRIC), ior, scale)
    return [pkf, ios, ev[:, 0], ev[:, 1], ev[:, 2],
            od[:, 0], od[:, 1], od[:, 2]]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of [N, 3] tensors, summed left to right as XLA's
    three-element reduce does."""
    p = a * b
    return p[:, 0] + p[:, 1] + p[:, 2]


def scene_tables(scene: Scene) -> torch.Tensor:
    """Flatten the sphere SoA into the [17, N] f32 table the kernel reads:
    per-sphere geometry (center, velocity, |c|^2 - r^2 with padding lanes
    pushed to +BIG so they never hit) joined with the material rows."""
    f32 = torch.float32
    c = scene.sphere_center.to(f32)
    v = scene.sphere_velocity.to(f32)
    r = scene.sphere_radius.to(f32)

    ccmr2 = _dot3(c, c) - r * r
    big = torch.full_like(ccmr2, _BIG)
    ccmr2 = torch.where(scene.sphere_valid, ccmr2, big)
    cv2 = 2.0 * _dot3(c, v)
    vv = _dot3(v, v)

    return torch.stack([
        c[:, 0], c[:, 1], c[:, 2], ccmr2,
        v[:, 0], v[:, 1], v[:, 2], cv2, vv,
        *_material_rows(scene, scene.sphere_material),
    ])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product in the term order of ``jnp.cross``."""
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=1)


def tri_tables(scene: Scene) -> torch.Tensor:
    """Flatten the triangle SoA into the [20, M] f32 table: plane normal
    n = e1 x e2 with n.v0, the dual basis (g1, g2) of the edge frame (so
    barycentrics are affine in the hit point), and the material rows.
    Padding columns get g1.v0 = +BIG, so their barycentric u is hugely
    negative and they never win."""
    f32 = torch.float32
    v0 = scene.tri_v0.to(f32)
    e1 = scene.tri_v1.to(f32) - v0
    e2 = scene.tri_v2.to(f32) - v0
    n = _cross(e1, e2)
    d11 = _dot3(e1, e1)
    d12 = _dot3(e1, e2)
    d22 = _dot3(e2, e2)
    den = d11 * d22 - d12 * d12
    nonzero = den != 0.0
    one = torch.ones_like(den)
    inv_den = torch.where(nonzero, 1.0 / torch.where(nonzero, den, one),
                          torch.zeros_like(den))
    g1 = (e1 * d22[:, None] - e2 * d12[:, None]) * inv_den[:, None]
    g2 = (e2 * d11[:, None] - e1 * d12[:, None]) * inv_den[:, None]

    nv0 = _dot3(n, v0)
    g1v = _dot3(g1, v0)
    g2v = _dot3(g2, v0)
    g1v = torch.where(scene.tri_valid, g1v, torch.full_like(g1v, _BIG))

    return torch.stack([
        n[:, 0], n[:, 1], n[:, 2], nv0,
        g1[:, 0], g1[:, 1], g1[:, 2], g1v,
        g2[:, 0], g2[:, 1], g2[:, 2], g2v,
        *_material_rows(scene, scene.tri_material),
    ])


def _pad_poison(tab: torch.Tensor, n: int, poison_row: int) -> torch.Tensor:
    """Pad a [rows, N] table to N=n columns whose ``poison_row`` is +BIG so
    they can never win the nearest-hit search."""
    pad = n - tab.shape[1]
    if pad <= 0:
        return tab
    tab = torch.nn.functional.pad(tab, (0, pad))
    tab[poison_row, -pad:] = _BIG
    return tab


def _camera_vector(camera: Camera) -> torch.Tensor:
    """[18] f32: look_from, px_du, px_dv, px_origin, defocus_u, defocus_v."""
    f32 = torch.float32
    return torch.cat([
        camera.look_from.to(f32), camera.px_du.to(f32),
        camera.px_dv.to(f32), camera.px_origin.to(f32),
        camera.defocus_u.to(f32), camera.defocus_v.to(f32),
    ])


def _padded_counts(scene: Scene, unroll: int):
    n_pad = int(scene.sphere_radius.shape[0]) if scene.n_spheres > 0 else 0
    m_pad = int(scene.tri_material.shape[0]) if scene.n_triangles > 0 else 0
    return _round_up(n_pad, unroll), _round_up(m_pad, unroll)


def _smem_scene_inputs(scene: Scene, unroll: int):
    """Whole-scene-in-shared-memory table prep (culling off): the sphere
    and triangle tables, each padded to an unroll multiple with poisoned
    columns. An absent primitive class gives an empty [rows, 0] table.
    Returns (sphere table, triangle table, padded sphere count, padded
    triangle count)."""
    n_pad, m_pad = _padded_counts(scene, unroll)
    dev = scene.device
    stab = (_pad_poison(scene_tables(scene), n_pad, _CCMR2) if n_pad
            else torch.zeros((_NROWS, 0), dtype=torch.float32, device=dev))
    ttab = (_pad_poison(tri_tables(scene), m_pad, _TG1V) if m_pad
            else torch.zeros((_TNROWS, 0), dtype=torch.float32, device=dev))
    return stab.contiguous(), ttab.contiguous(), n_pad, m_pad


def shared_bytes(n_pad: int, m_pad: int) -> int:
    """Dynamic shared memory the megakernel asks for: the camera vector and
    both full tables, f32."""
    return 4 * (CAM_WORDS + _NROWS * n_pad + _TNROWS * m_pad)


def fits_shared(scene: Scene) -> bool:
    """Whether the scene's tables fit one block's shared memory on an H100
    (~13.6k spheres or ~11.6k triangles). The flagship needs 34.8 KB, the
    Cornell box 122.9 KB (above the 48 KB default, so the kernel opts in).
    Same accounting as the launch-time check in the wrapper."""
    unroll = _resolve_tiling(scene)
    return shared_bytes(*_padded_counts(scene, unroll)) <= SHARED_LIMIT
