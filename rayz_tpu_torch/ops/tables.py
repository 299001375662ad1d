"""Scene and camera tables shared by every kernel of the port.

PyTorch counterpart of the host-side table builders of
:mod:`rayz_tpu.ops.megakernel` (``supports_scene``, ``_material_rows``,
``scene_tables``, ``tri_tables``, ``_pad_poison``, ``_camera_vector``,
``_resolve_tiling``, ``_smem_scene_inputs``, ``_stream_scene_inputs`` and
their culling helpers: Morton order, bound rows, near-to-far order,
superclusters). Every table equals its JAX twin exactly or within an ulp:
the sums are written out in the order XLA evaluates them, and every sort is
stable, as ``jnp.argsort`` is.

Every engine's table layout is decided here, by :func:`resolve`: resident
in one block's shared memory (culled behind block bounds or not) or
streamed from device memory in chunks, the unroll, block, chunk and
supercluster sizes, whether bounds are tested and the launch's shared
memory, all in a :class:`Layout` that the kernel wrappers read;
:func:`layout_tables` builds the tables it names. The rules are the
H100's, whose blocks hold at most 232,448 bytes of dynamic shared memory
(they replace the JAX package's ``fits_smem``/``fits_stream``/
``SMEM_BUDGET``, sized for the 1 MiB SMEM of a TPU v5e): resident, the
megakernel holds n_pad <= 3,416 spheres or m_pad <= 2,904 triangles
(:func:`fits_shared`, both recorders' rule too), in blocks as wide as keep
32 warps an SM (:func:`queue_threads`); streamed, the chunk bounds of
about 7.37 M primitives at the default chunk (7.29 M with motion,
:func:`fits_stream`), 6.9 M in the wavefront's launch and 7.4 M in the
recorder's. The forward renders take their tables from :data:`TABLE_MEMO`
(:class:`Memo`); the recorders build theirs on every call.

Chunk and block sizes of the streamed layout (:data:`DEFAULT_STREAM_CHUNK`,
:data:`STREAM_BLOCK`) are the H100's own. On the TPU a chunk is a DMA into
SMEM scratch (4,096 columns, 327,680 bytes for triangles: more than a
Hopper block holds), and the block inside it is ``stream // 128`` by a DMA
alignment rule. Here nothing is copied: a chunk is a bound level only, so
its size trades bound tests against pruning granularity. The defaults,
chunk 512 and block 32, are the best of a sweep on the card (chunks 256 to
2,048, blocks 16 to 128, ``python -m rayz_tpu_torch.tune tiling``; PERF.md
Findings PR 4). Chunk and block size change only the order of the sweep,
never the winner (except at exact ties).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.camera import _VECTORS, Camera
from ..models.scene import _STATIC, MAT_DIELECTRIC, TEX_SOLID, Scene, _round_up
from ..utils.profiling import span

__all__ = ["supports_scene", "scene_tables", "tri_tables", "resolve",
           "fits", "fits_shared", "fits_stream", "layout_tables",
           "queue_threads", "sphere_records", "pack_records", "Layout",
           "ENGINES", "MODES", "SHARED_LIMIT", "CAM_WORDS", "WF_HEAD_WORDS",
           "WF_STAGE_WORDS", "WF_PARK_WORDS", "CULLING_AUTO_THRESHOLD",
           "DEFAULT_BLOCK", "DEFAULT_STREAM_CHUNK", "STREAM_BLOCK",
           "RECORD_STREAM_CHUNK", "RECORD_STREAM_BLOCK", "Tables",
           "StreamTables", "Memo", "TABLE_MEMO", "VIEW_MEMO", "clear_memos"]

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
#: One H100 SM: its shared memory (bytes; each resident block takes its
#: dynamic shared memory and :data:`BLOCK_RESERVED` more), its threads and
#: its 32-bit registers.
SM_SHARED = 233_472
BLOCK_RESERVED = 1_024
SM_THREADS = 2_048
SM_REGISTERS = 65_536
#: The resident queue kernel's builds (``kBlock`` and ``kWide`` in
#: csrc/megakernel.cu): threads a block, registers a thread at most.
QUEUE_WIDTHS = ((128, 64), (1024, 64))

#: f32 words at the head of the wavefront kernel's shared memory: the
#: camera vector (20) and 8 work counters for each of its 4 warps, keeping
#: what follows 16-byte aligned.
WF_HEAD_WORDS = 52
#: f32 words of the streamed wavefront's staging, after the head: for each
#: of its 4 warps, 32 columns of 12 words (a triangle's sweep rows; a
#: sphere's take 9 with motion, 4 without) and its 32 rays with their
#: terms (12 words each).
WF_STAGE_WORDS = 4 * 2 * 32 * 12
#: f32 words in which each of the streamed wavefront's 128 threads parks
#: its throughput and radiance (6 words) while it sweeps.
WF_PARK_WORDS = 128 * 6

#: Block culling switches on at or above this many primitives (both
#: classes together) where the caller leaves ``culling`` to the default.
CULLING_AUTO_THRESHOLD = 2048
#: Primitives per culling block of the resident (in-shared-memory) layout.
DEFAULT_BLOCK = 64
#: Primitives per chunk of the streamed layout (H100 default, see the
#: module docstring): a 100k-sphere scene has 196 chunks in 49
#: superclusters of 4 (3.9 KB of bound rows in shared memory).
DEFAULT_STREAM_CHUNK = 512
#: Primitives per culling block inside a streamed chunk.
STREAM_BLOCK = 32


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
    of remainders. (The TPU tile size has no counterpart here: the queue
    kernel's block is 128 threads, or for a large resident table the wide
    build's, see :func:`queue_threads`.)"""
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


def _camera_vector(camera: Camera, dtype=torch.float32) -> torch.Tensor:
    """[18] (f32 unless ``dtype``): look_from, px_du, px_dv, px_origin,
    defocus_u, defocus_v."""
    return torch.cat([
        camera.look_from.to(dtype), camera.px_du.to(dtype),
        camera.px_dv.to(dtype), camera.px_origin.to(dtype),
        camera.defocus_u.to(dtype), camera.defocus_v.to(dtype),
    ])


def _padded_counts(scene: Scene, unroll: int, blk: int = 0):
    """Raw column counts of the two classes (0 for an absent class), padded
    to a culling-block multiple (``blk > 0``) and then to the unroll."""
    n_pad = int(scene.sphere_radius.shape[0]) if scene.n_spheres > 0 else 0
    m_pad = int(scene.tri_material.shape[0]) if scene.n_triangles > 0 else 0
    if blk:
        n_pad, m_pad = _round_up(n_pad, blk), _round_up(m_pad, blk)
    return _round_up(n_pad, unroll), _round_up(m_pad, unroll)


# --------------------------------------------------------------------------
# culling helpers: Morton order, bound rows, near-to-far order
# --------------------------------------------------------------------------

def _sum3(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of length 3, left to right (XLA's order)."""
    return p[..., 0] + p[..., 1] + p[..., 2]


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` (int64) so they occupy every third
    bit: the Morton bit-interleave. JAX computes it in uint32; every value
    here stays below 2^32, so int64 gives the same bits."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def _morton_perm(lo: torch.Tensor, hi: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Permutation sorting primitives by the 30-bit Morton code of their
    AABB centre (invalid and padding columns last), so that neighbouring
    primitives share a culling block. Stable, as ``jnp.argsort``."""
    c = 0.5 * (lo + hi)
    inf = torch.tensor(float("inf"), dtype=c.dtype, device=c.device)
    cmin = torch.where(valid[:, None], c, inf).amin(dim=0)
    cmax = torch.where(valid[:, None], c, -inf).amax(dim=0)
    span = torch.clamp_min(cmax - cmin, 1e-12)
    q = torch.clip((c - cmin) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))
    code = torch.where(valid, code, 0xFFFFFFFF)
    return torch.argsort(code, stable=True)


def _block_rows(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor,
                block: int) -> torch.Tensor:
    """[4, N/block] bounding-sphere rows of blocks of ``block`` consecutive
    primitives: centre xyz and |c|^2 - r^2, the form a sphere test reads, so
    a bound test is a sphere test. A block with no valid member gets
    |c|^2 - r^2 = +BIG and never passes."""
    nb = lo.shape[0] // block
    inf = torch.tensor(float("inf"), dtype=lo.dtype, device=lo.device)
    blo = torch.where(valid[:, None], lo, inf).reshape(nb, block, 3).amin(1)
    bhi = torch.where(valid[:, None], hi, -inf).reshape(nb, block, 3).amax(1)
    bc = 0.5 * (blo + bhi)
    half = 0.5 * (bhi - blo)
    br2 = _sum3(half * half)
    any_valid = valid.reshape(nb, block).any(dim=1)
    bc = torch.where(any_valid[:, None], bc, 0.0)
    ccmr2 = torch.where(any_valid, _sum3(bc * bc) - br2, _BIG)
    return torch.stack([bc[:, 0], bc[:, 1], bc[:, 2], ccmr2])


def _sphere_aabbs(scene: Scene):
    """Per-sphere AABB over t in [0, 1] (the motion is enclosed)."""
    c0 = scene.sphere_center.to(torch.float32)
    c1 = c0 + scene.sphere_velocity.to(torch.float32)
    r = scene.sphere_radius.to(torch.float32)[:, None]
    return torch.minimum(c0, c1) - r, torch.maximum(c0, c1) + r


def _tri_aabbs(scene: Scene):
    v0, v1, v2 = (v.to(torch.float32) for v in (scene.tri_v0, scene.tri_v1,
                                                 scene.tri_v2))
    return (torch.minimum(torch.minimum(v0, v1), v2),
            torch.maximum(torch.maximum(v0, v1), v2))


def _near_to_far(tab, lo, hi, valid, group: int, origin: torch.Tensor,
                 within: int = 0):
    """Permute ``group``-sized column groups so a sweep meets them in order
    of increasing distance from ``origin`` (the camera), keyed by each
    group's nearest valid member. With ``within`` > 0 the groups are
    reordered only inside each ``within``-sized segment (blocks inside a
    chunk), keeping the segments' order."""
    col = _near_to_far_order(lo, hi, valid, group, origin, within)
    return tab[:, col], lo[col], hi[col], valid[col]


def _near_to_far_order(lo, hi, valid, group: int, origin: torch.Tensor,
                       within: int = 0) -> torch.Tensor:
    """The column order :func:`_near_to_far` applies: new column -> old."""
    ng = valid.shape[0] // group
    diff = 0.5 * (lo + hi) - origin[None, :]
    d2 = torch.where(valid, _sum3(diff * diff), float("inf"))
    gd = d2.reshape(ng, group).amin(dim=1)
    if within:
        gpw = within // group
        inner = torch.argsort(gd.reshape(-1, gpw), dim=1, stable=True)
        base = torch.arange(ng // gpw, device=gd.device)[:, None] * gpw
        order = (base + inner).reshape(-1)
    else:
        order = torch.argsort(gd, stable=True)
    return (order[:, None] * group
            + torch.arange(group, device=gd.device)[None, :]).reshape(-1)


def _sc_enabled(n_items: int, stream: int, sc_group: int) -> bool:
    """Whether the supercluster level applies to a streamed class: the
    chunk count splits evenly into at least 2 groups of ``sc_group``."""
    if not (sc_group and n_items and stream):
        return False
    n_chunks = n_items // stream
    return n_chunks % sc_group == 0 and n_chunks // sc_group >= 2


def _pick_sc_group(n_chunks: int) -> int:
    """Chunks per supercluster: the first small divisor that yields at
    least 2 groups, 0 if none."""
    for g in (5, 4, 6, 7, 8, 3, 2):
        if n_chunks % g == 0 and n_chunks // g >= 2:
            return g
    return 0


def _resolve_blk(scene: Scene, culling, block_size: int) -> int:
    """Culling block size: ``culling=None`` switches culling on at
    :data:`CULLING_AUTO_THRESHOLD` primitives."""
    if culling is None:
        n = ((scene.sphere_radius.shape[0] if scene.n_spheres else 0)
             + (scene.tri_material.shape[0] if scene.n_triangles else 0))
        culling = n >= CULLING_AUTO_THRESHOLD
    return block_size if culling else 0


def use_patch_order(width: int, height: int) -> bool:
    """Whether the wavefront's camera rays can be laid out in 64x32-pixel
    patches (the image tiles evenly)."""
    return width % 64 == 0 and height % 32 == 0


@functools.lru_cache(maxsize=64)
def _patch_inverse(width: int, height: int) -> np.ndarray:
    """Row-major pixel index -> slot index under the patch layout (static
    per image size): ``flat[_patch_inverse(w, h)]`` is the row-major
    image."""
    p = np.arange(width * height)
    x, y = p % width, p // width
    pid = (y // 32) * (width // 64) + (x // 64)
    return np.asarray(pid * 2048 + (y % 32) * 64 + (x % 64), np.int32)


# --------------------------------------------------------------------------
# the layouts the kernels read
# --------------------------------------------------------------------------

class Tables(NamedTuple):
    """Shared-memory-resident layout: the sphere table [17, n_pad] and the
    triangle table [20, m_pad] (an absent class gives [rows, 0]); culled
    (``blk > 0``), Morton-sorted with per-block bound rows [4, n_pad/blk]
    and [4, m_pad/blk] ([4, 0] otherwise)."""

    stab: torch.Tensor
    ttab: torch.Tensor
    n_pad: int
    m_pad: int
    sblk: torch.Tensor
    tblk: torch.Tensor
    blk: int


class StreamTables(NamedTuple):
    """Streamed layout: Morton-sorted tables padded to a chunk multiple,
    chunks ordered near to far from the camera and blocks near to far
    inside each chunk; chunk bounds [4, n_pad/stream], supercluster bounds
    [4, n_pad/(stream*sc_group)] where :func:`_sc_enabled` holds ([4, 0]
    otherwise) and block rows [4, n_pad/blk] ([4, 0] for ``blk = 0``);
    ``sperm``/``tperm`` [n_pad]/[m_pad] int32 map each column back to its
    column in the scene's own order (the bounce-indexed recorder writes
    that index)."""

    stab: torch.Tensor
    ttab: torch.Tensor
    n_pad: int
    m_pad: int
    scb: torch.Tensor
    tcb: torch.Tensor
    ssc: torch.Tensor
    tsc: torch.Tensor
    sblk: torch.Tensor
    tblk: torch.Tensor
    stream: int
    blk: int
    sc_group: int
    sperm: torch.Tensor
    tperm: torch.Tensor


def _class_parts(scene: Scene, tri: bool):
    """(table, AABB lo, AABB hi, valid mask, poison row) of one class."""
    if tri:
        lo, hi = _tri_aabbs(scene)
        return tri_tables(scene), lo, hi, scene.tri_valid, _TG1V
    lo, hi = _sphere_aabbs(scene)
    return scene_tables(scene), lo, hi, scene.sphere_valid, _CCMR2


def _sorted_padded(scene: Scene, tri: bool, multiple: int):
    """One class Morton-sorted and padded to ``multiple`` columns (poisoned
    table columns, invalid AABBs)."""
    return _sorted_padded_perm(scene, tri, multiple)[:5]


def _sorted_padded_perm(scene: Scene, tri: bool, multiple: int):
    """:func:`_sorted_padded` and its permutation (sorted column -> raw
    column, int64): a padding column k past the raw count keeps its own
    index, so the permutation is one of all the padded columns."""
    tab, lo, hi, valid, poison = _class_parts(scene, tri)
    perm = _morton_perm(lo, hi, valid)
    n = _round_up(perm.shape[0], multiple)
    pad = n - perm.shape[0]
    tab = _pad_poison(tab[:, perm], n, poison)
    valid = torch.nn.functional.pad(valid[perm], (0, pad))
    lo = torch.nn.functional.pad(lo[perm], (0, 0, 0, pad))
    hi = torch.nn.functional.pad(hi[perm], (0, 0, 0, pad))
    perm = torch.cat([perm, torch.arange(perm.shape[0], n,
                                         device=perm.device)])
    return tab, lo, hi, valid, poison, perm


def _empty(rows: int, dev) -> torch.Tensor:
    return torch.zeros((rows, 0), dtype=torch.float32, device=dev)


def _smem_scene_inputs(scene: Scene, unroll: int, blk: int = 0) -> Tables:
    """Shared-memory-resident table prep shared by the megakernel and the
    wavefront kernel: each class padded to an unroll multiple with poisoned
    columns; with ``blk > 0`` first Morton-sorted, padded to a block
    multiple and given per-block bound rows."""
    dev = scene.device
    parts = []
    for tri, rows, present in ((False, _NROWS, scene.n_spheres > 0),
                               (True, _TNROWS, scene.n_triangles > 0)):
        if not present:
            parts.append((_empty(rows, dev), 0, _empty(4, dev)))
            continue
        if blk:
            tab, lo, hi, valid, poison = _sorted_padded(scene, tri, blk)
            brows = _block_rows(lo, hi, valid, blk)
        else:
            tab, poison = ((tri_tables(scene), _TG1V) if tri
                           else (scene_tables(scene), _CCMR2))
            brows = _empty(4, dev)
        n = _round_up(tab.shape[1], unroll)
        parts.append((_pad_poison(tab, n, poison).contiguous(), n,
                      brows.contiguous()))
    (stab, n_pad, sblk), (ttab, m_pad, tblk) = parts
    return Tables(stab, ttab, n_pad, m_pad, sblk, tblk, blk)


def _stream_scene_inputs(scene: Scene, stream: int, blk: int,
                         origin: torch.Tensor,
                         sc_group: int = 0) -> StreamTables:
    """Streamed table prep shared by the megakernel and the wavefront
    kernel: Morton sort, padding to a chunk multiple, chunks near to far
    from ``origin`` and blocks near to far inside each chunk, then the
    chunk, supercluster and block bound rows, and each class's column
    permutation. ``sc_group = 0`` gives no superclusters."""
    dev = scene.device
    parts = []
    for tri, rows, present in ((False, _NROWS, scene.n_spheres > 0),
                               (True, _TNROWS, scene.n_triangles > 0)):
        if not present:
            parts.append((_empty(rows, dev), 0) + (_empty(4, dev),) * 3
                         + (torch.zeros(0, dtype=torch.int32, device=dev),))
            continue
        tab, lo, hi, valid, _, perm = _sorted_padded_perm(scene, tri, stream)
        for group, within in ((stream, 0), (blk, stream))[:2 if blk else 1]:
            col = _near_to_far_order(lo, hi, valid, group, origin, within)
            tab, lo, hi, valid, perm = (tab[:, col], lo[col], hi[col],
                                        valid[col], perm[col])
        n = tab.shape[1]
        sc = (_block_rows(lo, hi, valid, stream * sc_group)
              if _sc_enabled(n, stream, sc_group) else _empty(4, dev))
        brows = _block_rows(lo, hi, valid, blk) if blk else _empty(4, dev)
        parts.append((tab.contiguous(), n,
                      _block_rows(lo, hi, valid, stream).contiguous(),
                      sc.contiguous(), brows.contiguous(),
                      perm.to(torch.int32).contiguous()))
    ((stab, n_pad, scb, ssc, sblk, sperm),
     (ttab, m_pad, tcb, tsc, tblk, tperm)) = parts
    return StreamTables(stab, ttab, n_pad, m_pad, scb, tcb, ssc, tsc, sblk,
                        tblk, stream, blk, sc_group, sperm, tperm)


# --------------------------------------------------------------------------
# the memo of a render's tables
# --------------------------------------------------------------------------

_SCENE_TENSORS = tuple(f.name for f in dataclasses.fields(Scene)
                       if f.name not in _STATIC)


class Memo:
    """A small LRU memo of what a render builds from tensors it only reads.
    A viewport or preview loop renders the same ``Scene`` and ``Camera``
    again and again, a new seed each time; the memo hands each render the
    tables the last one built, unchanged, instead of building them again.

    :meth:`get` keys an entry on the tensors the build reads, each by
    identity (held as a weak reference, so a freed tensor whose address is
    reused never hits) and by its ``_version``, which every in-place write
    bumps (an optimiser's ``add_``, an indexed assignment), and on the
    build's other arguments, the device and, on a card, the current stream.
    ``Scene.replace`` or a new camera brings new tensors, so a miss. A write
    through ``.data`` does not bump ``_version`` and is not seen. Reading
    the key syncs nothing. Where grad mode is on and a keyed tensor requires
    grad, or in inference mode, the memo is bypassed and builds, so no
    cached value holds an autograd graph or is an inference tensor. It
    keeps at most ``size`` entries, and each lookup first drops those whose
    tensors have been freed. Cached values are handed out as they are: the
    renders read them and write into none.

    ``counts`` holds this process's hits, builds (misses) and bypasses."""

    def __init__(self, size: int = 4):
        self.size = size
        self.counts = dict(hits=0, builds=0, bypasses=0)
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def clear(self) -> None:
        """Drop every entry and zero the counts."""
        self._entries.clear()
        self.counts.update(hits=0, builds=0, bypasses=0)

    def get(self, device: torch.device, tensors, args: tuple,
            build: Callable[[], object]):
        """The value ``build()`` gives for ``tensors`` (a tuple) and
        ``args`` (hashable) on ``device``: the cached one if they are
        unchanged since it was built, else a new one, then cached."""
        if torch.is_inference_mode_enabled() or (
                torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            self.counts["bypasses"] += 1
            return build()
        if device.type == "cuda":
            args += (torch.cuda.current_stream(device).cuda_stream,)
        key = (device, args, tuple(map(id, tensors)),
               tuple(t._version for t in tensors))
        for k in [k for k, (refs, _) in self._entries.items()
                  if any(r() is None for r in refs)]:
            del self._entries[k]
        entry = self._entries.get(key)
        if entry is not None and all(
                r() is t for r, t in zip(entry[0], tensors)):
            self._entries.move_to_end(key)
            self.counts["hits"] += 1
            return entry[1]
        value = build()
        self._entries[key] = ([weakref.ref(t) for t in tensors], value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
        self.counts["builds"] += 1
        return value


#: The scene's tables of a forward render (the megakernel's and the
#: wavefront's), keyed on every tensor of the scene and, where the layout
#: reads it (streamed), the camera's origin.
TABLE_MEMO = Memo()
#: What a render builds from its camera or image size alone: the camera
#: vector and the wavefront's slot -> pixel table.
VIEW_MEMO = Memo()


def clear_memos() -> None:
    """Empty both memos and zero their counts."""
    TABLE_MEMO.clear()
    VIEW_MEMO.clear()


def memo_tables(scene: Scene, origin, args: tuple,
                build: Callable[[], object]):
    """``build()``'s tables for ``scene`` through :data:`TABLE_MEMO`, keyed
    on every tensor field of the scene, its static fields, ``args`` and
    the camera's ``origin`` tensor where the build reads it (else None)."""
    tensors = tuple(getattr(scene, f) for f in _SCENE_TENSORS)
    if origin is not None:
        tensors += (origin,)
    return TABLE_MEMO.get(scene.device, tensors,
                          args + tuple(getattr(scene, f) for f in _STATIC),
                          build)


def memo_camera_vector(camera: Camera) -> torch.Tensor:
    """:func:`_camera_vector` (contiguous) through :data:`VIEW_MEMO`."""
    return VIEW_MEMO.get(camera.device,
                         tuple(getattr(camera, k) for k in _VECTORS),
                         ("camera",),
                         lambda: _camera_vector(camera).contiguous())


@contextlib.contextmanager
def tables_stage():
    """The render's ``rayz.tables`` span around its table lookups and any
    build; after it, where the scene's tables were built (a miss or a
    bypass of :data:`TABLE_MEMO`), a flat, empty ``rayz.tables_built``
    span, so a trace counts the builds."""
    counts = TABLE_MEMO.counts
    before = counts["builds"] + counts["bypasses"]
    with span("tables"):
        yield
    if counts["builds"] + counts["bypasses"] != before:
        with span("tables_built"):
            pass


# --------------------------------------------------------------------------
# the layout of each engine's launch (H100)
# --------------------------------------------------------------------------

#: The engines :func:`resolve` lays tables out for: the queue megakernel,
#: the wavefront, the bounce-indexed recorder (``diffkernel``) and the
#: persistent-path recorder (``pathrec``), each with its refusal of a
#: launch past :data:`SHARED_LIMIT` (:meth:`Layout.check`).
ENGINES = {"megakernel": "scene tables need",
           "wavefront": "wavefront launch needs",
           "record": "the record launch needs",
           "record_pp": "scene tables need"}
#: Table modes, in the order of the kernels' ``mode`` argument.
MODES = ("resident", "culled", "streamed")
RESIDENT, CULLED, STREAMED = range(3)

#: Columns per chunk of the streamed recorder: the forward engines' chunk,
#: 16 bytes of bound rows in shared memory per 512 columns.
RECORD_STREAM_CHUNK = 512
#: Columns per culling block inside a streamed chunk of the recorder
#: (``python -m rayz_tpu_torch.tune record`` times chunk x block, PERF.md).
RECORD_STREAM_BLOCK = STREAM_BLOCK


class Layout(NamedTuple):
    """One render's or recording's tables as :func:`resolve` lays them out
    for ``engine``: the mode (:data:`MODES`), the unroll resident tables pad
    to, the culling block (0: none), the chunk (0: resident), the chunks a
    supercluster (0: none), whether streamed bounds are tested, both
    classes' padded column counts, ``smem``, the dynamic shared memory the
    launch is held to (the wavefront's asks for exactly this; the other
    kernels' C entry points count their own, at most this), and the
    threads a block of the megakernel's queue launch (0 elsewhere)."""

    engine: str
    mode: int
    unroll: int
    blk: int
    stream: int
    sc_group: int
    cull: bool
    n_pad: int
    m_pad: int
    smem: int
    threads: int

    def check(self, engine: str, n_pad: int, m_pad: int) -> None:
        """Refuse a launch of ``engine`` over tables of ``n_pad`` and
        ``m_pad`` columns that are not this layout's, or past one block's
        shared memory."""
        if (self.engine, self.n_pad, self.m_pad) != (engine, n_pad, m_pad):
            raise ValueError(f"tables of {n_pad} and {m_pad} columns for the "
                             f"{engine} are not those of {self}")
        if self.smem > SHARED_LIMIT:
            raise ValueError(f"{ENGINES[engine]} {self.smem} bytes of shared "
                             f"memory (> {SHARED_LIMIT} per block on an H100)")


def _launch_bytes(engine: str, n: int, m: int, *, blk: int = 0,
                  stream: int = 0, sc_group: int = 0,
                  motion: bool = False) -> int:
    """Dynamic shared memory of a launch of ``engine`` over ``n`` sphere and
    ``m`` triangle columns, resident (culled with ``blk``) or streamed in
    chunks of ``stream``: the camera vector (the wavefront's head also
    counts its warps' work), then resident the tables and block rows (the
    recorder: its 16-byte sphere records and the triangle table); streamed,
    the warps' staging (the wavefront's also parks ray states), and the
    chunk and supercluster bound rows (the recorder's only these)."""
    rec = 9 if motion else 4
    if engine == "record":
        return (16 * (n // stream + m // stream) if stream
                else 4 * (rec * n + _TNROWS * m))
    if stream and engine == "wavefront":
        words = WF_HEAD_WORDS + WF_STAGE_WORDS + WF_PARK_WORDS
        for k in (n, m):
            words += 4 * (k // stream)
            if _sc_enabled(k, stream, sc_group):
                words += 4 * (k // (stream * sc_group))
        return 4 * words
    if stream:
        return 4 * (CAM_WORDS + 4 * 32 * rec + 4 * (n // stream + m // stream))
    words = CAM_WORDS + _NROWS * n + _TNROWS * m
    if blk:
        words += 4 * (n // blk + m // blk)
    if engine == "wavefront":
        words += WF_HEAD_WORDS - CAM_WORDS
    return 4 * words


@functools.lru_cache(maxsize=64)
def queue_threads(smem: int) -> int:
    """Threads a block of the resident queue kernel for a launch of
    ``smem`` bytes of dynamic shared memory: of :data:`QUEUE_WIDTHS`, the
    build that keeps the most warps an SM, the narrower on a tie. An SM
    holds as many blocks of a build as its threads, its registers at the
    build's cap and its shared memory allow. The flagship's 18,512 bytes
    keep 8 blocks of 128 threads (32 warps, a tie with one wide block);
    past 28,160 bytes fewer than 8 fit, and the Cornell box's 122,960 hold
    one block: 4 warps narrow, 32 wide."""
    if smem > SHARED_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory exceed one block's "
                         f"{SHARED_LIMIT} on an H100")

    def warps(width):
        threads, regs = width
        blocks = min(SM_THREADS // threads, SM_REGISTERS // (threads * regs),
                     SM_SHARED // (smem + BLOCK_RESERVED))
        return blocks * threads // 32
    return max(QUEUE_WIDTHS, key=warps)[0]


def _queue_bytes(n: int, m: int, motion: bool) -> int:
    """Dynamic shared memory of the resident queue kernel's launch
    (``ResidentSweep::smem_bytes``): the camera vector, the sphere records
    and the triangle table."""
    return 4 * (CAM_WORDS + (9 if motion else 4) * n + _TNROWS * m)


def _layout(scene: Scene, engine: str, unroll: int, blk: int, stream: int,
            cull: bool) -> Layout:
    """The layout of ``engine`` with these sizes: resident (culled with
    ``blk``) padded to the unroll, or streamed in chunks of ``stream``,
    the wavefront's chunks grouped into superclusters."""
    motion = scene.has_motion
    n, m = _padded_counts(scene, 1 if stream else unroll, stream or blk)
    g = (_pick_sc_group(max(n, m) // stream)
         if stream and engine == "wavefront" else 0)
    smem = _launch_bytes(engine, n, m, blk=blk, stream=stream, sc_group=g,
                         motion=motion)
    mode = STREAMED if stream else CULLED if blk else RESIDENT
    threads = 0
    if engine == "megakernel":
        threads = (queue_threads(_queue_bytes(n, m, motion))
                   if mode == RESIDENT and smem <= SHARED_LIMIT
                   else QUEUE_WIDTHS[0][0])
    return Layout(engine, mode, unroll, blk, stream, g, cull, n, m, smem,
                  threads)


def resolve(scene: Scene, engine: str, *, culling: Optional[bool] = None,
            block_size: int = DEFAULT_BLOCK,
            stream: Optional[int] = None) -> Layout:
    """The layout ``engine`` renders or records ``scene`` in: every engine's
    rules, side by side. ``stream=None`` picks resident or streamed, ``0``
    forces resident, ``k`` chunks of k columns (a multiple of 16 for the
    forward engines). The megakernel is resident where :func:`fits_shared`
    holds at this ``culling`` (culled in blocks of ``block_size`` only with
    ``culling=True``); the wavefront where its own launch fits, culled from
    :data:`CULLING_AUTO_THRESHOLD` primitives on unless ``culling`` says
    otherwise; both recorders, in the scene's order, where
    :func:`fits_shared` holds. Else they stream: the forward engines in
    chunks of :data:`DEFAULT_STREAM_CHUNK` and blocks of
    :data:`STREAM_BLOCK` behind bounds tested unless ``culling=False``
    (the wavefront's chunks in superclusters), the recorder in chunks of
    :data:`RECORD_STREAM_CHUNK` and blocks of :data:`RECORD_STREAM_BLOCK`
    (or one a chunk). Refused here: chunk bounds that do not fit, the
    megakernel's forced resident layout and the persistent-path
    recorder's scene that do not; the rest at launch
    (:meth:`Layout.check`)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {list(ENGINES)}")
    if engine.startswith("record"):
        resident = fits_shared(scene)
        if engine == "record_pp" and not resident:
            raise ValueError(
                f"persistent-path recorder: scene tables exceed one block's "
                f"{SHARED_LIMIT} bytes of shared memory on an H100, and this "
                "recorder does not stream; engine='recorded' (the "
                "bounce-indexed recorder, ops/diffkernel.py) streams such "
                "scenes")
        if stream is None:
            stream = 0 if resident else RECORD_STREAM_CHUNK
        stream = stream if engine == "record" else 0
        blk = (RECORD_STREAM_BLOCK if stream % RECORD_STREAM_BLOCK == 0
               else stream)
        layout = _layout(scene, engine, 1, blk if stream else 0, stream, True)
        if layout.smem > SHARED_LIMIT and stream:
            raise ValueError(
                f"streamed recorder: the chunk bounds of "
                f"{sum(_padded_counts(scene, 1))} columns in chunks of "
                f"{stream} exceed {SHARED_LIMIT} bytes of shared memory; use "
                "a larger chunk")
        return layout
    unroll = _resolve_tiling(scene)
    cull = culling is not False
    blk = ((block_size if culling else 0) if engine == "megakernel"
           else _resolve_blk(scene, culling, block_size))
    if not stream:
        layout = _layout(scene, engine, unroll, blk, 0, cull)
        if layout.smem <= SHARED_LIMIT:
            return layout
        if stream is None:
            stream = DEFAULT_STREAM_CHUNK
        elif engine == "megakernel":
            raise ValueError(
                f"scene tables exceed one block's {SHARED_LIMIT} bytes of "
                "shared memory; stream them (stream=None picks that)")
        else:
            return layout
    if stream % 16:
        raise ValueError("stream chunk must be a multiple of 16")
    blk = STREAM_BLOCK if cull and stream % STREAM_BLOCK == 0 else 0
    layout = _layout(scene, engine, unroll, blk, stream, cull)
    cols = layout.n_pad + layout.m_pad
    if layout.smem > SHARED_LIMIT:
        raise ValueError(
            f"streamed megakernel: {cols} columns in chunks of {stream} need "
            f"more than {SHARED_LIMIT} bytes of chunk bounds in shared "
            "memory; use a larger chunk" if engine == "megakernel" else
            f"wavefront: the chunk bounds of {cols} columns in chunks of "
            f"{stream} need {layout.smem} bytes of shared memory (> "
            f"{SHARED_LIMIT}); use a larger chunk")
    return layout


def fits(scene: Scene, engine: str, **kw) -> bool:
    """Whether ``engine`` can run ``scene``: :func:`resolve` refuses nothing
    at these keywords, and the launch fits one block's shared memory."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {list(ENGINES)}")
    try:
        return resolve(scene, engine, **kw).smem <= SHARED_LIMIT
    except ValueError:
        return False


def fits_shared(scene: Scene, culling=None,
                block_size: int = DEFAULT_BLOCK) -> bool:
    """Whether the megakernel can hold the scene in one block's shared
    memory on an H100 (n_pad <= 3,416 spheres or m_pad <= 2,904 triangles,
    culling off), at the layout ``render_megakernel`` resolves: culling off
    unless ``culling=True``. The flagship needs 34.8 KB, the Cornell box
    122.9 KB (above the 48 KB default, so the kernel opts in). Both
    recorders' resident rule too."""
    blk = block_size if culling else 0
    counts = _padded_counts(scene, _resolve_tiling(scene), blk)
    return _launch_bytes("megakernel", *counts, blk=blk) <= SHARED_LIMIT


def fits_stream(scene: Scene, stream: int = DEFAULT_STREAM_CHUNK) -> bool:
    """Whether the streamed megakernel can run the scene in chunks of
    ``stream``: the camera vector, its warps' staging and the chunk bound
    rows fit one block's shared memory. About 7.37 M primitives at the
    default chunk (7.29 M with motion)."""
    return fits(scene, "megakernel", stream=stream)


def sphere_records(stab: torch.Tensor, has_motion: bool):
    """The 16-byte sphere records ``rz::stage_spheres`` writes from the
    sphere table ``stab`` [17, N]: (cx, cy, cz, |c|^2 - r^2) [N, 4] and,
    with motion, (vx, vy, vz, 2 c.v) [N, 4] and |v|^2 [N] (else None)."""
    c = stab[[_CX, _CY, _CZ, _CCMR2]].T.contiguous()
    if not has_motion:
        return c, None, None
    return c, stab[[_VX, _VY, _VZ, _CV2]].T.contiguous(), stab[_VV].clone()


def pack_records(stab: torch.Tensor, sblk: torch.Tensor,
                 has_motion: bool):
    """The streamed megakernel's packed records, built once a render from
    the sorted sphere table ``stab`` [17, N] and its block rows ``sblk``
    [4, N/blk]: :func:`sphere_records` laid out flat in one f32 tensor,
    and the block bounds as records (centre, |c|^2 - r^2) [N/blk, 4]."""
    parts = [x.reshape(-1) for x in sphere_records(stab, has_motion)
             if x is not None]
    return torch.cat(parts), sblk.T.contiguous()


def _scene_bounds(scene: Scene):
    """(lo, extent) of the valid primitives' AABBs (sphere motion
    enclosed): the grid of the wavefront's ray sort."""
    f32 = torch.float32
    big = 3e38
    parts_lo, parts_hi = [], []
    if scene.n_spheres > 0:
        c = scene.sphere_center.to(f32)
        v = scene.sphere_velocity.to(f32)
        r = scene.sphere_radius.to(f32)[:, None]
        valid = scene.sphere_valid[:, None]
        parts_lo.append(torch.where(valid, torch.minimum(c, c + v) - r, big))
        parts_hi.append(torch.where(valid, torch.maximum(c, c + v) + r, -big))
    if scene.n_triangles > 0:
        vs = torch.stack([t.to(f32) for t in (scene.tri_v0, scene.tri_v1,
                                              scene.tri_v2)])
        valid = scene.tri_valid[:, None]
        parts_lo.append(torch.where(valid, vs.amin(0), big))
        parts_hi.append(torch.where(valid, vs.amax(0), -big))
    lo = torch.cat(parts_lo).amin(0)
    hi = torch.cat(parts_hi).amax(0)
    return lo, torch.clamp_min(hi - lo, 1e-6)


def layout_tables(scene: Scene, layout: Layout,
                  origin: Optional[torch.Tensor] = None, *,
                  memo: bool = True):
    """``(tables, extra)`` of ``layout`` for ``scene``: a :class:`Tables` or
    a :class:`StreamTables` (ordered near to far from ``origin`` [3]), and
    the streamed megakernel's packed records, the wavefront's scene bounds
    or None. With ``memo`` they come through :data:`TABLE_MEMO`, keyed on
    the layout and, streamed, ``origin``."""
    def build():
        if layout.mode == STREAMED:
            tabs = _stream_scene_inputs(scene, layout.stream, layout.blk,
                                        origin.to(torch.float32),
                                        layout.sc_group)
        else:
            tabs = _smem_scene_inputs(scene, layout.unroll, layout.blk)
        if layout.engine == "wavefront":
            return tabs, _scene_bounds(scene)
        if layout.engine == "megakernel" and layout.mode == STREAMED:
            return tabs, pack_records(tabs.stab, tabs.sblk, scene.has_motion)
        return tabs, None

    if not memo:
        return build()
    return memo_tables(scene, origin if layout.mode == STREAMED else None,
                       (layout.engine, layout.unroll, layout.blk,
                        layout.stream, layout.sc_group), build)


# --------------------------------------------------------------------------
# the differentiable parameter table of the record/replay estimators
# --------------------------------------------------------------------------

def _diff_material_cols(scene: Scene, mat: torch.Tensor) -> torch.Tensor:
    """Differentiable per-primitive material columns [P, 11]: kind, method,
    fuzz, ior, checker scale, even rgb, odd rgb (checker children resolved
    one level, like the megakernel; a solid texture gets even == odd ==
    its color and scale 1)."""
    dt = scene.sphere_center.dtype
    mat = mat.long()
    kind = scene.mat_kind[mat].to(dt)
    method = scene.mat_method[mat].to(dt)
    fuzz = scene.mat_fuzz[mat]
    ior = scene.mat_ior[mat]

    tex = scene.mat_texture[mat].long()
    solid = scene.tex_kind[tex] == TEX_SOLID
    base = scene.tex_color[tex]
    even = scene.tex_color[scene.tex_even[tex].long()]
    odd = scene.tex_color[scene.tex_odd[tex].long()]
    ev = torch.where(solid[:, None], base, even)
    od = torch.where(solid[:, None], base, odd)
    scale = scene.tex_scale[tex]
    scale = torch.where(solid, torch.ones_like(scale), scale)
    return torch.cat([kind[:, None], method[:, None], fuzz[:, None],
                      ior[:, None], scale[:, None], ev, od], dim=1)


def _diff_tables(scene: Scene) -> torch.Tensor:
    """Per-primitive [N_pad + M_pad, 20] parameter table, built from the
    scene's leaf tensors so autograd reaches them (the differentiable twin
    of :func:`scene_tables` / :func:`tri_tables`).

    Geometry (columns 0:9): a sphere is [center(3), velocity(3), radius, 0,
    0]; a triangle (rows N_pad..) is [v0(3), v1(3), v2(3)], so the replay
    derives its plane from the raw vertices. Material (columns 9:20): see
    :func:`_diff_material_cols`. An absent class contributes no rows, so a
    triangle's row is the sphere count (0 without spheres) plus its
    column, the index the recorders write."""
    parts = []
    if scene.n_spheres > 0:
        zeros = torch.zeros_like(scene.sphere_radius[:, None])
        parts.append(torch.cat([
            scene.sphere_center, scene.sphere_velocity,
            scene.sphere_radius[:, None], zeros, zeros,
            _diff_material_cols(scene, scene.sphere_material)], dim=1))
    if scene.n_triangles > 0:
        parts.append(torch.cat([
            scene.tri_v0, scene.tri_v1, scene.tri_v2,
            _diff_material_cols(scene, scene.tri_material)], dim=1))
    return torch.cat(parts, dim=0)
