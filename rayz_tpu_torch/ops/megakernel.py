"""Persistent path-tracing megakernel: host side, wrapper and plain version.

PyTorch counterpart of :mod:`rayz_tpu.ops.megakernel`: ``_kernel`` in its
three table modes, as launched by ``_trace_shard``, the straggler-compacted
``_trace_shard_compact`` and ``_trace_shard_streamed``. Every mode runs the
queue kernel (``csrc/megakernel.cu``, hand-written CUDA for sm_90a; the
per-ray device code is in ``csrc/common.cuh``): a persistent grid whose
lanes take (sample, pixel) items from a counter on the card, then a fold
that adds each pixel's samples in sample order. It is a template on its
segment sweep:

* resident, culling off (the flagship's mode): the full tables in shared
  memory, every column swept in the packed coefficient form
  (``rz::sweep_packed``, the winner settled in the plain version's
  arithmetic), in blocks of 128 threads, or of 1,024 where the tables
  leave 128-thread blocks short of 32 warps an SM
  (:func:`~rayz_tpu_torch.ops.tables.queue_threads`; the Cornell box);
* resident, culled (``culling=True``): Morton-sorted tables and per-block
  bounds in shared memory, each lane sweeping in the packed form the
  blocks its own bound test passes;
* streamed (a scene beyond one block's shared memory): the tables and the
  packed records in device memory behind chunk and block bound tests, each
  tested for its own ray under warp votes, a visited block staged in the
  warp's shared buffer or, where few rays enter it, swept a column per
  lane, in today's arithmetic (the packed form lost there).

* :func:`_queue` is the queue kernel's wrapper and :func:`_fold` the
  fold's. For a CUDA tensor each launches its kernel (counting the launch
  in :data:`LAUNCHES` and :data:`MODE_LAUNCHES`) or raises; only CPU
  tensors take the plain versions, :func:`_queue_reference` (each item
  through :func:`_trace_items_reference`, every column of the tables it is
  given swept) and :func:`_fold_reference`. The culled and streamed modes'
  bounds are conservative, so over the same (sorted) tables the kernel
  finds the plain version's winners up to near ties and grazing roots
  (:mod:`rayz_tpu_torch.ops.sweep`).
* :func:`_trace_queue` runs a render's sample groups through them, and
  :func:`render_megakernel` takes its table layout from
  :func:`~rayz_tpu_torch.ops.tables.resolve`. Every launch takes a
  pixel offset ``p0``: it traces the pixels [p0, p0 + n) of the image,
  keyed by their global ids, which is how
  :func:`render_megakernel_sharded` gives each rank of a mesh its own.
* :func:`_trace_slots_reference` is the one-thread-per-slot order of the
  samples (the JAX kernel's), the oracle of the fold's association.

Random draws are keyed by (seed, pixel, sample, bounce, draw number)
(:mod:`rayz_tpu_torch.ops.rng`), so every schedule reproduces the single
launch bit for bit even on stochastic configs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.camera import Camera
from ..models.scene import Scene
from ..utils.profiling import span
from . import _build, rng
from .common import Bits, _hit_frame, _key_draws, _nearest, _scatter, _spawn
from .integrator import RenderConfig
from .tables import (_BIG, DEFAULT_BLOCK, MODES, RESIDENT, SHARED_LIMIT,
                     STREAMED, Layout, fits_shared, layout_tables,
                     memo_camera_vector, resolve, supports_scene,
                     tables_stage)

__all__ = ["render_megakernel", "render_megakernel_sharded", "LAUNCHES",
           "MODE_LAUNCHES", "MODES"]

#: Kernel launches made by :func:`_queue` and :func:`_fold` in this process
#: (never by the plain version). A run that resets it and reads it back
#: shows which path it took.
LAUNCHES = 0

#: The same launches: the queue's in each table mode, and the folds
#: (:func:`_trace_queue`).
MODE_LAUNCHES = dict.fromkeys(MODES + ("fold",), 0)

#: Items a warp of the queue kernel claims with one atomicAdd (``kRun`` in
#: csrc/megakernel.cu): the queue's counter ends at this many times its
#: atomics.
QUEUE_RUN = 64

#: Slots of the queue launch's ``stats`` counters (see :func:`_queue`).
QUEUE_STATS = 9

#: Most bytes of the queue's per-(sample, pixel) radiance buffer; a render
#: that needs more runs its samples in groups, folded in order.
QUEUE_BYTES = 1 << 28

#: Blocks of the last queue launch's persistent grid (the card's occupancy
#: at the launch's shared memory, or fewer for a small render).
QUEUE_GRID = 0

#: Threads a block of the last queue launch: 128, or in the resident mode
#: the width :func:`~rayz_tpu_torch.ops.tables.queue_threads` picks from
#: the launch's shared memory.
QUEUE_BLOCK = 0

# --------------------------------------------------------------------------
# plain torch version
# --------------------------------------------------------------------------

def _trace_slots_reference(cam: torch.Tensor, stab: torch.Tensor,
                           ttab: torch.Tensor, pix: torch.Tensor, *,
                           width: int, spp: int, max_depth: int, t_min: float,
                           jitter: bool, has_motion: bool, seed: int,
                           bits: Optional[Bits] = None) -> torch.Tensor:
    """The one-thread-per-slot order of the samples, in plain torch: each
    slot of ``pix`` (flat pixel ids, -1 = none) runs its ``spp`` samples in
    turn with persistent respawn, the loop in lockstep over all slots until
    none is alive. The queue's fold adds each pixel's samples in this order
    from 0.0, so its sums are these bit for bit (the oracle of that order;
    the JAX kernel runs its tiles so).

    ``bits(key, n)`` supplies the random bits of draw ``n`` under the
    per-step keys (default :func:`rng.draw_bits`).

    Returns the radiance sums [3, slots]."""
    bits = rng.draw_bits if bits is None else bits
    f32, i32 = torch.float32, torch.int32
    cap = pix.shape[0]
    pp = torch.clamp_min(pix, 0)
    pxf = (pp % width).to(f32)
    pyf = (pp // width).to(f32)

    zf = torch.zeros(cap, dtype=f32, device=pix.device)
    st = [zf.clone() for _ in range(13)]
    st[5] = torch.ones_like(zf)  # direction placeholder, non-zero
    depth = torch.zeros(cap, dtype=i32, device=pix.device)
    samples = torch.where(pix >= 0, spp, 0).to(i32)
    active = torch.zeros(cap, dtype=torch.bool, device=pix.device)
    ox, oy, oz, dx, dy, dz, tau, thx, thy, thz, ar, ag, ab = st
    key0 = rng.slot_key(seed, pix)

    while True:
        alive = active | (samples > 0)
        if not bool(alive.any()):
            break

        # ---- respawn dead slots with the next camera sample ----
        spawn = alive & ~active
        samples = samples - spawn.to(i32)
        depth = torch.where(spawn, max_depth, depth)
        key = rng.step_key(key0, spp - samples, max_depth - depth)
        (nox, noy, noz), (ndx, ndy, ndz), ntau = _spawn(cam, pxf, pyf, key,
                                                        jitter, bits)
        ox = torch.where(spawn, nox, ox)
        oy = torch.where(spawn, noy, oy)
        oz = torch.where(spawn, noz, oz)
        dx = torch.where(spawn, ndx, dx)
        dy = torch.where(spawn, ndy, dy)
        dz = torch.where(spawn, ndz, dz)
        tau = torch.where(spawn, ntau, tau)
        thx = torch.where(spawn, 1.0, thx)
        thy = torch.where(spawn, 1.0, thy)
        thz = torch.where(spawn, 1.0, thz)
        active = active | spawn

        # ---- nearest hit: spheres, then triangles ----
        o, d = (ox, oy, oz), (dx, dy, dz)
        qb, best, is_tri, a, tau2 = _nearest(stab, ttab, o, d, tau, t_min,
                                             has_motion)
        hit = qb < _BIG

        # ---- miss -> sky weighted by throughput ----
        dinv = 1.0 / torch.sqrt(torch.clamp_min(a, 1e-24))
        sky_t = 0.5 * (dy * dinv + 1.0)
        miss = active & ~hit
        ar = torch.where(miss, ar + thx * ((1.0 - sky_t + 0.5) * sky_t), ar)
        ag = torch.where(miss, ag + thy * ((1.0 - sky_t + 0.7) * sky_t), ag)
        ab = torch.where(miss, ab + thz * ((1.0 - sky_t + 1.0) * sky_t), ab)

        # ---- decode the winner: hit point, facing normal, material ----
        (px, py, pz), nrm, front, mat = _hit_frame(
            stab, ttab, o, d, tau, tau2, a, qb, best, is_tri, has_motion)
        ndir, att, scattered = _scatter(mat, d, dinv, (px, py, pz), nrm,
                                        front, _key_draws(key, bits))

        # ---- continue or die ----
        cont = active & hit & scattered
        thx = torch.where(cont, thx * att[0], thx)
        thy = torch.where(cont, thy * att[1], thy)
        thz = torch.where(cont, thz * att[2], thz)
        ox = torch.where(cont, px, ox)
        oy = torch.where(cont, py, oy)
        oz = torch.where(cont, pz, oz)
        dx = torch.where(cont, ndir[0], dx)
        dy = torch.where(cont, ndir[1], dy)
        dz = torch.where(cont, ndir[2], dz)
        depth = depth - cont.to(i32)
        active = cont & (depth > 0)  # depth exhausted -> black

    return torch.stack([ar, ag, ab])


def _trace_items_reference(cam: torch.Tensor, stab: torch.Tensor,
                           ttab: torch.Tensor, pix: torch.Tensor,
                           sample: torch.Tensor, *, width: int,
                           max_depth: int, t_min: float, jitter: bool,
                           has_motion: bool, seed: int,
                           bits: Optional[Bits] = None,
                           hits: Optional[torch.Tensor] = None,
                           rays: Optional[list] = None) -> torch.Tensor:
    """Plain torch version of one queue item: the camera sample numbered
    ``sample`` [I] (1-based, as :func:`_trace_slots_reference` numbers a
    pixel's samples) of pixel ``pix`` [I], traced to its end with the
    kernel's keys. Returns the radiance [3, I] it adds to its pixel: the
    sky term of its miss, or 0 where it is absorbed or runs out of depth.

    ``hits`` [max_depth, I] int32 receives each traced segment's winner as
    the queue kernel records it (a sphere's column, the sphere count plus a
    triangle's column, -1 a miss; entries of segments not traced are left
    as they are); ``rays`` receives, per bounce, the live items and their
    ray (items, origin, direction, time)."""
    bits = rng.draw_bits if bits is None else bits
    f32 = torch.float32
    pxf = (pix % width).to(f32)
    pyf = (pix // width).to(f32)
    key0 = rng.slot_key(seed, pix)
    o, d, tau = _spawn(cam, pxf, pyf,
                       rng.step_key(key0, sample, torch.zeros_like(sample)),
                       jitter, bits)
    o, d = list(o), list(d)
    th = [torch.ones_like(pxf) for _ in range(3)]
    rad = torch.zeros((3, pix.shape[0]), dtype=f32, device=pix.device)
    live = torch.arange(pix.shape[0], device=pix.device)
    for b in range(max_depth):
        if live.numel() == 0:
            break
        key = rng.step_key(key0[live], sample[live],
                           torch.full_like(live, b))
        qb, best, is_tri, a, tau2 = _nearest(stab, ttab, o, d, tau, t_min,
                                             has_motion)
        if hits is not None:
            hits[b, live] = torch.where(is_tri, stab.shape[1] + best,
                                        best).to(hits.dtype)
        if rays is not None:
            rays.append((live, tuple(o), tuple(d), tau))
        hit = qb < _BIG
        dinv = 1.0 / torch.sqrt(torch.clamp_min(a, 1e-24))
        sky_t = 0.5 * (d[1] * dinv + 1.0)
        miss = ~hit
        for c, w in enumerate((0.5, 0.7, 1.0)):
            rad[c, live[miss]] = (th[c] * ((1.0 - sky_t + w) * sky_t))[miss]
        p, nrm, front, mat = _hit_frame(stab, ttab, o, d, tau, tau2, a, qb,
                                        best, is_tri, has_motion)
        ndir, att, scattered = _scatter(mat, d, dinv, p, nrm, front,
                                        _key_draws(key, bits))
        cont = hit & scattered
        o = [x[cont] for x in p]
        d = [x[cont] for x in ndir]
        th = [(t * at)[cont] for t, at in zip(th, att)]
        tau = tau[cont]
        live = live[cont]
    return rad


def _fold_reference(out: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the fold kernel: ``acc`` [3, n] plus the
    samples of ``out`` [s, 3, n], one after another in sample order (the
    association of :func:`_trace_slots_reference`'s running sums)."""
    for s in range(out.shape[0]):
        acc = acc + out[s]
    return acc


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

def _check_bounds(layout: Layout, n_pad: int, m_pad: int, bounds,
                  dev) -> None:
    """A culled or streamed launch's bound rows match its tables."""
    if bounds is None:
        raise ValueError(f"a {MODES[layout.mode]} launch needs its bounds")
    blk, stream = layout.blk, layout.stream
    want = [(bounds.sblk, n_pad // blk if blk else 0),
            (bounds.tblk, m_pad // blk if blk else 0)]
    if layout.mode == STREAMED:
        want += [(bounds.scb, n_pad // stream), (bounds.tcb, m_pad // stream)]
    for t, cols in want:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != (4, cols)):
            raise ValueError(f"bound rows must be contiguous f32 [4, {cols}] "
                             f"on {dev}, got {tuple(t.shape)}")


def _check_tables(cam, stab, ttab, dev, what: str = "cam"):
    for name, t in (("cam", cam), ("stab", stab), ("ttab", ttab)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {what} on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be {torch.float32}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cam.shape != (18,):
        raise ValueError(f"cam must be [18], got {tuple(cam.shape)}")
    if stab.dim() != 2 or stab.shape[0] != 17 or stab.shape[1] % 8:
        raise ValueError(f"stab must be [17, 8k], got {tuple(stab.shape)}")
    if ttab.dim() != 2 or ttab.shape[0] != 20 or ttab.shape[1] % 8:
        raise ValueError(f"ttab must be [20, 8k], got {tuple(ttab.shape)}")


def _check_records(records, blk: int, n_pad: int, has_motion: bool,
                   dev) -> None:
    """The streamed launch's packed records (:func:`pack_records`) match
    its tables."""
    if records is None:
        raise ValueError("a streamed launch needs the packed records "
                         "(tables.pack_records)")
    recs, brecs = records
    want = ((recs, ((9 if has_motion else 4) * n_pad,)),
            (brecs, (n_pad // blk if blk else 0, 4)))
    for t, shape in want:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"packed records must be contiguous f32 "
                             f"{list(shape)} on {dev}, got {tuple(t.shape)}")


def _queue_group(spp: int, n_pix: int) -> int:
    """Samples per queue launch: all ``spp`` unless their radiance buffer
    [samples, 3, n_pix] would pass :data:`QUEUE_BYTES`."""
    return max(1, min(spp, QUEUE_BYTES // (12 * n_pix)))


def _queue_reference(cam, stab, ttab, n_pix: int, s0: int, n_samples: int,
                     *, width: int, max_depth: int, t_min: float,
                     jitter: bool, has_motion: bool, seed: int,
                     bits: Optional[Bits] = None, layout=None, bounds=None,
                     records=None, stats=None,
                     hits: Optional[torch.Tensor] = None,
                     p0: int = 0) -> torch.Tensor:
    """Plain torch version of one queue launch (same arguments as
    :func:`_queue`; ``layout``, ``bounds`` and ``records`` change only which
    columns the kernel skips and how it reads them, and ``stats`` counts
    what only the kernel does, so they are not read here): every (sample,
    pixel) item of samples [s0, s0 + n_samples) of the pixels [p0, p0 +
    n_pix) through
    :func:`_trace_items_reference`, every column of the tables it is given
    swept (the culled and streamed modes' bounds are conservative, so over
    the same sorted tables they leave the same winners up to near ties).
    Returns the radiance [n_samples, 3, n_pix]."""
    dev = cam.device
    pix = torch.arange(p0, p0 + n_pix, dtype=torch.int32, device=dev)
    sample = torch.arange(s0 + 1, s0 + n_samples + 1, dtype=torch.int32,
                          device=dev)
    rad = _trace_items_reference(
        cam, stab, ttab, pix.repeat(n_samples),
        sample.repeat_interleave(n_pix), width=width, max_depth=max_depth,
        t_min=t_min, jitter=jitter, has_motion=has_motion, seed=seed,
        bits=bits, hits=hits)
    return rad.reshape(3, n_samples, n_pix).transpose(0, 1).contiguous()


def _queue(cam: torch.Tensor, stab: torch.Tensor, ttab: torch.Tensor,
           n_pix: int, s0: int, n_samples: int, *, width: int,
           max_depth: int, t_min: float, jitter: bool, has_motion: bool,
           seed: int, layout: Layout, bounds=None, records=None,
           stats: Optional[torch.Tensor] = None,
           hits: Optional[torch.Tensor] = None,
           p0: int = 0) -> torch.Tensor:
    """One launch of the queue kernel over samples [s0, s0 + n_samples) of
    the pixels [p0, p0 + n_pix) of the image (the draws keyed and the
    camera rays made by the global pixel id, the outputs indexed by the
    local one): camera vector ``cam`` [18], sphere table ``stab``
    [17, N] and triangle table ``ttab`` [20, M] (N, M multiples of 8, 0 for
    an absent class). A persistent grid whose lanes take (sample, pixel)
    items from a counter on the card and trace each to its end.

    ``layout`` (:func:`~rayz_tpu_torch.ops.tables.resolve`) is the table
    mode and the launch's sizes: resident (the tables in shared memory,
    every column swept), culled (``bounds``, the :class:`Tables` the tables
    came from, gives their block rows) or streamed (``bounds``, the
    :class:`StreamTables`, gives the chunk and block rows, the tables stay
    in device memory; ``records`` its packed records). ``stats``, an int64
    [:data:`QUEUE_STATS`] tensor on the device, receives the ray segments
    (0), in the culled and streamed modes the primitive tests (1), block
    bound tests (2), chunk bound tests (3) and those that passed (4), the
    re-sweeps in today's arithmetic (5), the lane-trips of the warps that
    ran (6), the items claimed from the counter (7; :data:`QUEUE_RUN` per
    atomic) and, in the resident mode, the segments whose spheres a warp
    swept a column per lane, where few of its lanes traced (8).
    ``hits`` [max_depth, n_samples * n_pix] int32 (culled and streamed)
    receives each traced segment's winner (see
    :func:`_trace_items_reference`).

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors run the plain version. Returns the radiance [n_samples, 3,
    n_pix] each item adds to its pixel."""
    global LAUNCHES, QUEUE_GRID, QUEUE_BLOCK
    dev = cam.device
    _check_tables(cam, stab, ttab, dev)
    if n_pix <= 0 or n_samples <= 0 or s0 < 0 or p0 < 0:
        raise ValueError(f"nothing to trace: pixels [{p0}, {p0 + n_pix}), "
                         f"samples [{s0}, {s0 + n_samples})")
    mode = layout.mode
    n_pad, m_pad = stab.shape[1], ttab.shape[1]
    layout.check("megakernel", n_pad, m_pad)
    if mode != RESIDENT:
        _check_bounds(layout, n_pad, m_pad, bounds, dev)
    if mode == STREAMED:
        _check_records(records, layout.blk, n_pad, has_motion, dev)
    if hits is not None and (
            mode == RESIDENT or hits.device != dev
            or hits.dtype != torch.int32 or not hits.is_contiguous()
            or hits.shape != (max_depth, n_samples * n_pix)):
        raise ValueError("hits must be a contiguous int32 [max_depth, "
                         "n_samples * n_pix] tensor on cam's device, for a "
                         "culled or streamed launch")
    kw = dict(width=width, max_depth=max_depth, t_min=t_min, jitter=jitter,
              has_motion=has_motion, seed=seed, hits=hits, p0=p0)
    if dev.type == "cpu":
        return _queue_reference(cam, stab, ttab, n_pix, s0, n_samples, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no megakernel for device {dev}")
    if stats is not None and (stats.device != dev
                              or stats.dtype != torch.int64
                              or stats.shape != (QUEUE_STATS,)):
        raise ValueError(f"stats must be an int64 [{QUEUE_STATS}] tensor on "
                         "cam's device")
    lib, _ = _build.load()
    out = torch.empty((n_samples, 3, n_pix), dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    grid = ctypes.c_int(0)
    rows = [None] * 6
    if mode != RESIDENT:
        rows[:2] = bounds.sblk, bounds.tblk
    if mode == STREAMED:
        rows[2:] = (bounds.scb, bounds.tcb) + tuple(records)
    with torch.cuda.device(dev):
        err = lib.rayz_megakernel_queue(
            cam.data_ptr(), stab.data_ptr(), n_pad, ttab.data_ptr(), m_pad,
            n_pix, p0, width, max_depth, t_min, int(jitter), int(has_motion),
            seed & rng.MASK, s0, n_samples, counter.data_ptr(),
            out.data_ptr(), None if stats is None else stats.data_ptr(),
            mode, *(None if t is None else t.data_ptr() for t in rows),
            layout.blk, layout.stream, int(layout.cull),
            None if hits is None else hits.data_ptr(), layout.threads,
            ctypes.addressof(grid), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "megakernel_queue")
    LAUNCHES += 1
    MODE_LAUNCHES[MODES[mode]] += 1
    QUEUE_GRID, QUEUE_BLOCK = grid.value, layout.threads
    if stats is not None:
        stats[7] += counter[0]
    return out


def _fold(out: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Add the samples of ``out`` [s, 3, n] to the sums ``acc`` [3, n]
    (float32, contiguous, one device) one after another, in sample order,
    through the fold kernel (in place on ``acc``, which is returned) or, for
    CPU tensors, its plain version (a new tensor)."""
    global LAUNCHES
    if (out.dim() != 3 or acc.shape != out.shape[1:]
            or out.dtype != torch.float32 or acc.dtype != torch.float32
            or out.device != acc.device or not out.is_contiguous()
            or not acc.is_contiguous()):
        raise ValueError(f"fold: out [s, 3, n] and acc [3, n], contiguous "
                         f"f32 on one device; got {tuple(out.shape)} "
                         f"{out.dtype}, {tuple(acc.shape)} {acc.dtype}")
    if out.device.type == "cpu":
        return _fold_reference(out, acc)
    if out.device.type != "cuda":
        raise ValueError(f"no fold kernel for device {out.device}")
    lib, _ = _build.load()
    with torch.cuda.device(out.device):
        err = lib.rayz_fold(out.data_ptr(), out.shape[0], acc.numel(),
                            acc.data_ptr(),
                            torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, err, "fold")
    LAUNCHES += 1
    MODE_LAUNCHES["fold"] += 1
    return acc


def _trace_queue(cam: torch.Tensor, stab: torch.Tensor, ttab: torch.Tensor,
                 n_pix: int, *, width: int, spp: int, max_depth: int,
                 t_min: float, jitter: bool, has_motion: bool, seed: int,
                 layout: Layout, bounds=None, records=None,
                 stats: Optional[torch.Tensor] = None,
                 p0: int = 0) -> torch.Tensor:
    """Trace the ``spp`` samples of the pixels [p0, p0 + n_pix) through the
    queue kernel and fold them: per sample group (:func:`_queue_group`) one
    :func:`_queue` launch in the table mode ``layout`` names, then one
    :func:`_fold` adding the group's samples to each pixel in sample order.
    Keys, sample numbers and the order of the sums are
    :func:`_trace_slots_reference`'s. ``stats`` as :func:`_queue`'s,
    summed over the groups. Returns rgb [3, n_pix] radiance sums."""
    if spp <= 0:
        raise ValueError(f"nothing to trace: {spp} spp")
    acc = torch.zeros((3, max(n_pix, 0)), dtype=torch.float32,
                      device=cam.device)
    group = _queue_group(spp, max(n_pix, 1))
    for s0 in range(0, spp, group):
        with span("queue"):
            out = _queue(cam, stab, ttab, n_pix, s0, min(group, spp - s0),
                         width=width, max_depth=max_depth, t_min=t_min,
                         jitter=jitter, has_motion=has_motion, seed=seed,
                         layout=layout, bounds=bounds, records=records,
                         stats=stats, p0=p0)
        with span("fold"):
            acc = _fold(out, acc)
    return acc


# --------------------------------------------------------------------------
# launch schedule
# --------------------------------------------------------------------------

def _launch_args(scene: Scene, camera: Camera, seed: int, layout: Layout, *,
                 spp: int, max_depth: int, t_min: float, jitter: bool):
    """The queue's tables and keywords for one render in ``layout``: the
    tables it names (with the spheres' packed records where streamed) and
    the camera vector, through the memos of
    :mod:`~rayz_tpu_torch.ops.tables` (keyed on the scene, and the
    camera's origin where the streamed layout reads it), so a render of an
    unchanged scene builds none of them."""
    tabs, records = layout_tables(scene, layout, camera.look_from)
    cam = memo_camera_vector(camera)
    kw = dict(width=camera.width, spp=spp, max_depth=max_depth, t_min=t_min,
              jitter=jitter, has_motion=scene.has_motion, seed=int(seed),
              layout=layout, bounds=tabs, records=records)
    return (cam, tabs.stab, tabs.ttab), kw


def _trace_shard_queue(scene: Scene, camera: Camera, seed: int,
                       n_local: int, layout: Layout, *, spp: int,
                       max_depth: int, t_min: float, jitter: bool,
                       stats: Optional[torch.Tensor] = None,
                       p0: int = 0) -> torch.Tensor:
    """Trace the pixels [p0, p0 + n_local) through the queue kernel and its
    fold in ``layout``: JAX's ``_trace_shard``, ``_trace_shard_compact``
    and ``_trace_shard_streamed``. Returns flat [n_local, 3] radiance sums
    (divide by spp for the image)."""
    with tables_stage():
        args, kw = _launch_args(scene, camera, seed, layout, spp=spp,
                                max_depth=max_depth, t_min=t_min,
                                jitter=jitter)
    return _trace_queue(*args, n_local, stats=stats, p0=p0, **kw).T


def _check_scene(scene: Scene, camera: Camera) -> None:
    """Refuse a scene the megakernel cannot render and a camera on another
    device."""
    if not supports_scene(scene):
        if scene.deep_checker:
            raise ValueError(
                "megakernel resolves only ONE level of checker nesting; this "
                "scene nests checkers inside checkers: render it with the "
                "dense integrator (render, or render_fast with engine 'xla' "
                "or 'auto')")
        raise ValueError("megakernel needs a non-empty scene (spheres and/or "
                         "triangles)")
    if camera.device != scene.device:
        raise ValueError(f"camera is on {camera.device}, scene on "
                         f"{scene.device}")


def render_megakernel(scene: Scene, camera: Camera, seed: int,
                      config: RenderConfig = RenderConfig(), *,
                      budget: Optional[int] = None,
                      passes: Optional[int] = None,
                      culling: Optional[bool] = None,
                      block_size: int = DEFAULT_BLOCK,
                      stream: Optional[int] = None) -> torch.Tensor:
    """Render [H, W, 3] through the megakernel on the scene's device (the
    CUDA kernel on a GPU; the plain version on the CPU).

    Resolved as ``render_pallas`` does, with the H100's limits
    (:func:`~rayz_tpu_torch.ops.tables.resolve`):

    * ``stream=None`` keeps the tables in shared memory where they fit
      (:func:`~rayz_tpu_torch.ops.tables.fits_shared` at this ``culling``)
      and streams them in chunks of
      :data:`~rayz_tpu_torch.ops.tables.DEFAULT_STREAM_CHUNK` otherwise;
      ``stream=k`` forces chunks of k columns (a multiple of 16).
    * ``culling``: resident scenes default to no culling (the full-table
      mode); ``True`` Morton-sorts them into blocks of ``block_size`` behind
      bound tests. Streamed scenes always test chunk and block bounds
      (blocks of :data:`~rayz_tpu_torch.ops.tables.STREAM_BLOCK`) unless
      ``culling=False``.
    * ``budget``/``passes``: JAX's straggler-compacted schedule, accepted
      and ignored: every mode takes the queue (a persistent grid whose lanes
      take (sample, pixel) items from a counter on the card, then an
      in-order fold), which leaves no straggler tail to compact. Every
      schedule renders the same bits."""
    del budget, passes
    with span("dispatch"):
        _check_scene(scene, camera)
        layout = resolve(scene, "megakernel", culling=culling,
                         block_size=block_size, stream=stream)
    h, w = camera.height, camera.width
    flat = _trace_shard_queue(scene, camera, seed, h * w, layout,
                              spp=config.spp, max_depth=config.max_depth,
                              t_min=config.t_min, jitter=config.jitter)
    with span("finish"):
        return (flat.reshape(h, w, 3) / float(config.spp)).to(camera.dtype)


def render_megakernel_sharded(scene: Scene, camera: Camera, seed: int,
                              config: RenderConfig, mesh, *,
                              culling: Optional[bool] = None,
                              block_size: int = DEFAULT_BLOCK,
                              budget: Optional[int] = None,
                              passes: Optional[int] = None) -> torch.Tensor:
    """The megakernel render with the pixels sharded over the 1-D ``mesh``
    (:func:`rayz_tpu_torch.parallel.make_mesh`), JAX's
    ``render_pallas_sharded`` (megakernel.py:1823); returns the full
    [H, W, 3] image on every rank. Call it on every rank of the mesh.

    Each rank makes one :func:`_trace_shard_queue` call over its own pixels
    [p0, p1) (:func:`rayz_tpu_torch.parallel.mesh.shard_range`): the queue
    kernel's launches and their fold at pixel offset ``p0``, its draws keyed
    by the global pixel ids. Then the shards are gathered in order. So the
    image equals :func:`render_megakernel`'s bit for bit (JAX folds the
    seed per device instead). The table modes are JAX's: resident, and
    culled with ``culling=True``; a scene whose tables must stream raises,
    as JAX has no sharded streamed path. ``budget``/``passes`` are
    accepted and ignored, as by :func:`render_megakernel`."""
    from ..parallel.mesh import gather_shards, shard_range

    del budget, passes
    if supports_scene(scene) and not fits_shared(scene, culling, block_size):
        raise ValueError(
            f"scene tables exceed one block's {SHARED_LIMIT} bytes of shared "
            "memory: the sharded megakernel keeps them resident, as JAX's "
            "does (there is no sharded streamed path); render it with "
            "parallel.render_sharded or unsharded with render_megakernel")
    with span("dispatch"):
        _check_scene(scene, camera)
        layout = resolve(scene, "megakernel", culling=culling,
                         block_size=block_size, stream=0)
    h, w = camera.height, camera.width
    p0, p1 = shard_range(h * w, mesh)
    if p1 > p0:
        flat = _trace_shard_queue(scene, camera, seed, p1 - p0, layout,
                                  spp=config.spp, max_depth=config.max_depth,
                                  t_min=config.t_min, jitter=config.jitter,
                                  p0=p0)
    else:  # more ranks than pixels
        flat = torch.zeros((0, 3), dtype=torch.float32, device=camera.device)
    img = gather_shards(flat, h * w, mesh)
    with span("finish"):
        return (img.reshape(h, w, 3) / float(config.spp)).to(camera.dtype)
