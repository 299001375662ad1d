"""Wavefront (bounce-synchronous) forward renderer for large scenes.

PyTorch counterpart of :mod:`rayz_tpu.ops.wavefront`. The persistent
megakernel respawns samples in place, so at large scenes a tile mixes bounce
depths and its bound tests prune little. This engine keeps rays coherent
instead:

* all rays of one bounce are in flight at once, as flat planes;
* one launch per bounce traces and shades them (``csrc/wavefront.cu``): the
  nearest hit through the resident, block-culled or streamed tables
  (superclusters, chunks, blocks), then the megakernel's shading;
* camera rays start in 64x32-pixel patch order; before bounce 1 the rays are
  sorted once by (dead last, origin Morton cell, direction octant), later
  bounces only partition the dead rays to the back (stable), so live tiles
  stay dense and coherent;
* after three synchronous bounces one tail launch runs the survivors to full
  depth, as a ray queue: a lane whose path ends takes the next live ray.

:func:`_wf_bounce_reference` is the plain torch version of one launch (every
column swept; the culled and streamed sweeps are conservative, so they find
the same winners up to exact ties). :func:`_wf_bounce` is the kernel
wrapper: CUDA tensors launch the kernel (counted in :data:`LAUNCHES`) or
raise, CPU tensors take the plain version.

Random draws are keyed as the megakernel's (seed, pixel, sample, bounce,
draw), and the camera ray is the megakernel's spawn, so one ray follows the
same path in both engines: the wavefront image equals the megakernel's for
the same seed, except where an exact tie in a sweep resolves to another
column. The image is summed without atomics: each ray carries its id
through the permutations, its radiance is scattered back to ray order
(unique indices) and the spp slices are added in sample order, the
megakernel's order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.camera import Camera
from ..models.scene import Scene, _round_up
from ..utils.profiling import span
from . import _build, rng
from .integrator import RenderConfig
from .common import Bits, _hit_frame, _key_draws, _nearest, _scatter, _spawn
from .tables import (_BIG, DEFAULT_BLOCK, STREAMED, VIEW_MEMO, Layout,
                     _patch_inverse, fits, layout_tables, memo_camera_vector,
                     resolve, supports_scene, tables_stage, use_patch_order)

__all__ = ["render_wavefront", "supports_wavefront", "LAUNCHES", "ST",
           "WF_BLOCK", "N_SYNC"]

#: Kernel launches made by :func:`_wf_bounce` in this process (never by the
#: plain version).
LAUNCHES = 0

#: Ray state planes: origin xyz, direction xyz, time, throughput rgb.
ST = 10

#: Rays per tile (threads per block of the kernel); the ray count rounds up
#: to whole tiles with rays that are never alive.
WF_BLOCK = 128

#: Synchronous bounces before the tail launch.
N_SYNC = 3

#: Work counters of a launch (``stats``): segments (0), primitive tests (1),
#: bound tests (2), warp votes (3) and those passed (4), the lane slots of
#: primitive tests (6); in the tail launch also its warps' trips (5) and the
#: rays its lanes took after their first (7).
WF_STATS = 8


def supports_wavefront(scene: Scene) -> bool:
    """Scenes the wavefront renders: supported ones whose layout fits
    (about 6.9 M primitives streamed at the default chunk)."""
    return supports_scene(scene) and fits(scene, "wavefront")


class _Rays(NamedTuple):
    """Per-launch ray inputs: the camera vector, the patch slot -> pixel
    table, and the sizes the ray ids decode with."""

    cam: torch.Tensor       # [18]
    slot_pix: torch.Tensor  # [n_px] int32
    n_rays: int             # n_px * spp; later ids are padding
    width: int


# --------------------------------------------------------------------------
# plain torch version
# --------------------------------------------------------------------------

def _ray_keys(seed: int, rays: _Rays, rid: torch.Tensor):
    """(pixel, sample number from 1, slot key) of each ray id."""
    pix = rays.slot_pix[(rid % rays.slot_pix.shape[0]).long()]
    sample = rid // rays.slot_pix.shape[0] + 1
    return pix, sample, rng.slot_key(seed, pix)


def _wf_bounce_reference(tabs, rays: _Rays, st: Optional[torch.Tensor],
                         alive: Optional[torch.Tensor], rid: torch.Tensor, *,
                         bounce: int, loop_bounces: int, t_min: float,
                         jitter: bool, has_motion: bool, seed: int,
                         layout: Optional[Layout] = None, stats=None,
                         bits: Optional[Bits] = None):
    """Plain torch version of one launch (same arguments as
    :func:`_wf_bounce`; ``layout`` and ``stats`` change only what the
    kernel skips or counts and are not read here): ``st`` None spawns every
    ray's camera ray first (padding rays are never alive); then up to
    ``loop_bounces`` bounces, numbered from ``bounce``, run in lockstep over
    all rays, every column of ``tabs`` swept, until none is alive.
    ``bits(key, n)`` replaces the random bits (default
    :func:`rng.draw_bits`).

    Returns (state [10, r_pad], alive [r_pad] int32, radiance added
    [3, r_pad])."""
    bits = rng.draw_bits if bits is None else bits
    f32 = torch.float32
    pix, sample, key0 = _ray_keys(seed, rays, rid)
    if st is None:
        key = rng.step_key(key0, sample, torch.zeros_like(sample))
        o, d, tau = _spawn(rays.cam, (pix % rays.width).to(f32),
                           (pix // rays.width).to(f32), key, jitter, bits)
        ones = torch.ones_like(tau)
        state = [*o, *d, tau, ones, ones.clone(), ones.clone()]
        active = rid < rays.n_rays
    else:
        state = [st[k].clone() for k in range(ST)]
        active = alive > 0
    ox, oy, oz, dx, dy, dz, tau, thx, thy, thz = state
    ar, ag, ab = (torch.zeros_like(tau) for _ in range(3))

    for it in range(loop_bounces):
        if not bool(active.any()):
            break
        key = rng.step_key(key0, sample, torch.full_like(sample, bounce + it))
        o, d = (ox, oy, oz), (dx, dy, dz)
        qb, best, is_tri, a, tau2 = _nearest(tabs.stab, tabs.ttab, o, d, tau,
                                             t_min, has_motion)
        hit = qb < _BIG

        # ---- miss -> sky weighted by throughput ----
        dinv = 1.0 / torch.sqrt(torch.clamp_min(a, 1e-24))
        sky_t = 0.5 * (dy * dinv + 1.0)
        miss = active & ~hit
        ar = torch.where(miss, ar + thx * ((1.0 - sky_t + 0.5) * sky_t), ar)
        ag = torch.where(miss, ag + thy * ((1.0 - sky_t + 0.7) * sky_t), ag)
        ab = torch.where(miss, ab + thz * ((1.0 - sky_t + 1.0) * sky_t), ab)

        # ---- hit: frame, scatter, continue or die ----
        p, nrm, front, mat = _hit_frame(tabs.stab, tabs.ttab, o, d, tau, tau2,
                                        a, qb, best, is_tri, has_motion)
        ndir, att, scattered = _scatter(mat, d, dinv, p, nrm, front,
                                        _key_draws(key, bits))
        cont = active & hit & scattered
        thx = torch.where(cont, thx * att[0], thx)
        thy = torch.where(cont, thy * att[1], thy)
        thz = torch.where(cont, thz * att[2], thz)
        ox, oy, oz = (torch.where(cont, n, c) for n, c in zip(p, o))
        dx, dy, dz = (torch.where(cont, n, c) for n, c in zip(ndir, d))
        active = cont

    state = torch.stack([ox, oy, oz, dx, dy, dz, tau, thx, thy, thz])
    return state, active.to(torch.int32), torch.stack([ar, ag, ab])


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

def _check_inputs(tabs, layout: Layout, rays: _Rays, st, alive,
                  rid) -> None:
    dev = rid.device
    named = [("stab", tabs.stab, torch.float32),
             ("ttab", tabs.ttab, torch.float32),
             ("cam", rays.cam, torch.float32),
             ("slot_pix", rays.slot_pix, torch.int32),
             ("rid", rid, torch.int32)]
    if st is not None:
        named += [("st", st, torch.float32), ("alive", alive, torch.int32)]
    for name, t, dtype in named:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{dev}")
    r_pad = rid.shape[0]
    if rid.dim() != 1 or r_pad == 0 or r_pad % WF_BLOCK:
        raise ValueError(f"rid must be [r_pad], r_pad a multiple of "
                         f"{WF_BLOCK}, got {tuple(rid.shape)}")
    if st is not None and (st.shape != (ST, r_pad)
                           or alive.shape != (r_pad,)):
        raise ValueError(f"st must be [{ST}, r_pad] and alive [r_pad]")
    if rays.cam.shape != (18,) or rays.slot_pix.dim() != 1:
        raise ValueError("cam must be [18] and slot_pix [n_px]")
    if (tabs.stab.shape != (17, tabs.n_pad)
            or tabs.ttab.shape != (20, tabs.m_pad)):
        raise ValueError("tables do not match their padded counts")
    layout.check("wavefront", tabs.n_pad, tabs.m_pad)


def _check_launch(rid: torch.Tensor, bounce: int, loop_bounces: int,
                  stats: Optional[torch.Tensor]) -> None:
    if bounce < 0 or loop_bounces < 1:
        raise ValueError(f"bounces [{bounce}, {bounce + loop_bounces}) are "
                         "not a launch: bounce >= 0 and loop_bounces >= 1")
    if stats is not None and (stats.device != rid.device
                              or stats.dtype != torch.int64
                              or stats.shape != (WF_STATS,)):
        raise ValueError(f"stats must be an int64 [{WF_STATS}] tensor on "
                         "rid's device")


def _tail_counter(loop_bounces: int, dev) -> Optional[torch.Tensor]:
    """The slot counter of a launch that runs ``loop_bounces`` > 1 bounces
    (a zeroed int64 [1] on ``dev``): the kernel takes that launch as a ray
    queue over a persistent grid, whose warps claim slots from it.
    None for a launch of one bounce, a thread per slot."""
    if loop_bounces > 1:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    return None


def _wf_bounce(tabs, rays: _Rays, st: Optional[torch.Tensor],
               alive: Optional[torch.Tensor], rid: torch.Tensor, *,
               bounce: int, loop_bounces: int, t_min: float, jitter: bool,
               has_motion: bool, seed: int, layout: Layout,
               stats: Optional[torch.Tensor] = None):
    """One launch of the wavefront kernel over the rays ``rid`` [r_pad]
    (int32 ray ids, sample * n_px + patch slot; r_pad a multiple of
    :data:`WF_BLOCK`) with their state ``st`` [10, r_pad] and ``alive``
    [r_pad] int32, or ``st=None`` to spawn the camera rays, over the tables
    ``tabs`` of ``layout`` (:func:`~rayz_tpu_torch.ops.tables.resolve`),
    which gives the table mode, the bound tests and the launch's shared
    memory. Runs up to ``loop_bounces`` bounces numbered from ``bounce``:
    one (a bounce launch) a thread per slot, more (the tail launch) as a
    ray queue whose lanes take the next live slot when a path ends
    (:func:`_tail_counter`); the outputs are the same. ``stats`` (int64
    [:data:`WF_STATS`] on the device) receives the kernel's work counters.

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors run the plain version. Returns (state, alive, radiance)."""
    global LAUNCHES
    _check_inputs(tabs, layout, rays, st, alive, rid)
    _check_launch(rid, bounce, loop_bounces, stats)
    kw = dict(bounce=bounce, loop_bounces=loop_bounces, t_min=t_min,
              jitter=jitter, has_motion=has_motion, seed=seed)
    if rid.device.type == "cpu":
        return _wf_bounce_reference(tabs, rays, st, alive, rid, **kw)
    if rid.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {rid.device}")
    lib, _ = _build.load()
    r_pad = rid.shape[0]
    dev = rid.device
    counter = _tail_counter(loop_bounces, dev)
    st_out = torch.empty((ST, r_pad), dtype=torch.float32, device=dev)
    alive_out = torch.empty(r_pad, dtype=torch.int32, device=dev)
    rad = torch.empty((3, r_pad), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    if layout.mode == STREAMED:
        chunk_rows = (tabs.scb, tabs.tcb, tabs.ssc, tabs.tsc)
        stream = (layout.stream, layout.sc_group if tabs.ssc.numel() else 0,
                  layout.sc_group if tabs.tsc.numel() else 0)
    else:
        chunk_rows, stream = (None,) * 4, (0, 0, 0)
    with torch.cuda.device(dev):
        err = lib.rayz_wavefront(
            rays.cam.data_ptr(), ptr(tabs.stab), tabs.n_pad, ptr(tabs.ttab),
            tabs.m_pad, layout.mode, ptr(tabs.sblk), ptr(tabs.tblk),
            layout.blk, *map(ptr, chunk_rows), *stream, int(layout.cull),
            ptr(st), ptr(alive), rid.data_ptr(),
            rays.slot_pix.data_ptr(), st_out.data_ptr(), alive_out.data_ptr(),
            rad.data_ptr(), r_pad, rays.n_rays, rays.slot_pix.shape[0],
            rays.width, bounce, loop_bounces, t_min, int(jitter),
            int(has_motion), seed & rng.MASK, layout.smem, ptr(counter),
            ptr(stats),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "wavefront")
    LAUNCHES += 1
    return st_out, alive_out, rad


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------

def _part(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 6 bits of ``v`` over every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _morton18(cx, cy, cz) -> torch.Tensor:
    """Interleave three 6-bit cell coordinates into an 18-bit Morton code."""
    return _part(cx) | (_part(cy) << 1) | (_part(cz) << 2)


def _sort_key(st: torch.Tensor, alive: torch.Tensor, lo: torch.Tensor,
              extent: torch.Tensor) -> torch.Tensor:
    """Coherence sort key: dead rays last; live rays by the 18-bit Morton
    cell of their origin (a 64^3 grid over the scene bounds), then their
    3-bit direction octant."""
    cell = [torch.clip((st[k] - lo[k]) / extent[k] * 64.0, 0.0, 63.0)
            .to(torch.int32) for k in range(3)]
    octant = ((st[3] < 0).to(torch.int32) | ((st[4] < 0).to(torch.int32) << 1)
              | ((st[5] < 0).to(torch.int32) << 2))
    key = (_morton18(*cell) << 3) | octant
    return torch.where(alive > 0, key, 1 << 24)


def _dead_last(alive: torch.Tensor) -> torch.Tensor:
    """Stable partition order with the live rays first (cumsum + scatter,
    no sort)."""
    live = alive > 0
    pos_a = torch.cumsum(live.to(torch.int64), 0) - 1
    pos = torch.where(live, pos_a,
                      pos_a[-1] + torch.cumsum((~live).to(torch.int64), 0))
    order = torch.empty_like(pos)
    order[pos] = torch.arange(pos.shape[0], device=pos.device)
    return order


def _slot_pixels(camera: Camera) -> torch.Tensor:
    """Patch slot -> flat pixel id (row-major where the image does not tile
    into 64x32 patches), built once for each image size and device
    (:data:`~rayz_tpu_torch.ops.tables.VIEW_MEMO`)."""
    w, h, dev = camera.width, camera.height, camera.device

    def build():
        if use_patch_order(w, h):
            slot2pix = np.argsort(_patch_inverse(w, h)).astype(np.int32)
            return torch.from_numpy(slot2pix).to(dev)
        return torch.arange(w * h, dtype=torch.int32, device=dev)
    return VIEW_MEMO.get(dev, (), ("slots", w, h), build)


def render_wavefront(scene: Scene, camera: Camera, seed: int,
                     config: RenderConfig = RenderConfig(), *,
                     culling: Optional[bool] = None,
                     block_size: int = DEFAULT_BLOCK,
                     stream: Optional[int] = None, sort: bool = True,
                     resort: bool = False,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render [H, W, 3] bounce by bounce (module docstring) on the scene's
    device. Meant for scenes beyond one block's shared memory, where sorted
    rays let the bound tests prune on every bounce.

    * ``stream=None`` keeps the tables in shared memory where the kernel's
      resident layout fits and streams them in chunks of
      :data:`~rayz_tpu_torch.ops.tables.DEFAULT_STREAM_CHUNK` otherwise;
      ``stream=k`` forces chunks of k columns (a multiple of 16).
    * ``culling=None`` culls resident scenes from 2,048 primitives on, in
      blocks of ``block_size``; streamed scenes always test superclusters,
      chunks and blocks (of
      :data:`~rayz_tpu_torch.ops.tables.STREAM_BLOCK`); ``culling=False``
      turns every bound test off. The layout is
      :func:`~rayz_tpu_torch.ops.tables.resolve`'s.
    * ``sort=False`` skips the sort and partitions between the synchronous
      bounces; ``resort=True`` sorts before every one of them instead of
      only before bounce 1.
    * ``stats`` (int64 [:data:`WF_STATS`] on the card) sums the kernel's
      work counters over the render's launches.

    Any of these changes only the order of the work, not the image (up to
    exact ties). The tables and the scene's bounds (keyed on the scene, and
    the camera's origin where streamed), the camera vector and the slot ->
    pixel table come through the memos of :mod:`~rayz_tpu_torch.ops.tables`:
    a render of an unchanged scene builds none of them. (The ray ids are
    made anew: the first sort replaces them, so a cached copy would only
    add its size to the render's peak memory.)"""
    if not supports_scene(scene):
        raise ValueError("wavefront needs a non-empty scene (spheres and/or "
                         "triangles) without nested checker textures")
    if camera.device != scene.device:
        raise ValueError(f"camera is on {camera.device}, scene on "
                         f"{scene.device}")
    dev = scene.device
    h, w = camera.height, camera.width
    n_px, spp, max_depth = h * w, config.spp, config.max_depth
    with tables_stage():
        layout = resolve(scene, "wavefront", culling=culling,
                         block_size=block_size, stream=stream)
        tabs, (lo, extent) = layout_tables(scene, layout, camera.look_from)
        rays = _Rays(memo_camera_vector(camera), _slot_pixels(camera),
                     n_px * spp, w)
        r_pad = _round_up(rays.n_rays, WF_BLOCK)
        rid = torch.arange(r_pad, dtype=torch.int32, device=dev)
    kw = dict(t_min=config.t_min, jitter=config.jitter,
              has_motion=scene.has_motion, seed=int(seed), layout=layout,
              stats=stats)

    def permute(order, *ts):
        return [t[..., order].contiguous() for t in ts]

    n_sync = min(max_depth, N_SYNC)
    with span("bounce"):
        st, alive, radbuf = _wf_bounce(tabs, rays, None, None, rid,
                                       bounce=0, loop_bounces=1, **kw)
    for b in range(1, n_sync):
        if sort:
            with span("sort"):
                if b == 1 or resort:
                    order = torch.argsort(_sort_key(st, alive, lo, extent),
                                          stable=True)
                else:
                    order = _dead_last(alive)
                st, alive, rid, radbuf = permute(order, st, alive, rid,
                                                 radbuf)
        with span("bounce"):
            st, alive, rad = _wf_bounce(tabs, rays, st, alive, rid, bounce=b,
                                        loop_bounces=1, **kw)
            radbuf = radbuf + rad
    if max_depth > n_sync:
        with span("sort"):
            st, alive, rid, radbuf = permute(_dead_last(alive), st, alive,
                                             rid, radbuf)
        with span("tail"):
            _, _, rad = _wf_bounce(tabs, rays, st, alive, rid, bounce=n_sync,
                                   loop_bounces=max_depth - n_sync, **kw)
            radbuf = radbuf + rad

    # back to ray order (ids are unique), then the samples in order
    with span("finish"):
        by_ray = torch.empty((3, r_pad), dtype=torch.float32, device=dev)
        by_ray[:, rid.long()] = radbuf
        per_sample = by_ray[:, :rays.n_rays].reshape(3, spp, n_px)
        acc = torch.zeros((3, n_px), dtype=torch.float32, device=dev)
        for s in range(spp):
            acc = acc + per_sample[:, s]
        img = torch.empty((n_px, 3), dtype=torch.float32, device=dev)
        img[rays.slot_pix.long()] = acc.T
        return (img.reshape(h, w, 3) / float(spp)).to(camera.dtype)
