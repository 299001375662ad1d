"""Bounce-indexed record/replay: the ``"recorded"`` gradient engine.

PyTorch counterpart of :mod:`rayz_tpu.ops.diffkernel`: ``supports_diff``
(diffkernel.py:100) and the bounce-indexed estimator. The differentiable
parameter table that both record/replay estimators gather from
(``_diff_material_cols`` :607, ``_diff_tables`` :633) is built in
:mod:`.tables`, beside the kernels' tables it is the twin of.

* **Record** (CUDA, non-differentiable): :func:`record_paths` (:464) over
  ``csrc/record.cu``, which replaces ``_record_kernel`` (:130). It traces
  given rays for ``max_depth`` bounces with host-supplied randoms and
  writes each bounce's winning primitive index [depth, R] (-1 on a miss or
  a dead path; spheres [0, N_pad), triangles N_pad + j). Scenes within one
  block's shared memory (:func:`rayz_tpu_torch.ops.tables.fits_shared`)
  record from shared memory, through a persistent ray queue on the packed
  coefficient-form sphere sweep (its paths are the plain recorder's but at
  the near ties and grazing roots :mod:`.sweep`'s rule accepts); larger
  ones stream their tables from device
  memory in the streamed megakernel's layout (Morton-sorted, chunks and
  blocks near to far, as :func:`rayz_tpu_torch.ops.tables.resolve` lays
  them out for ``"record"``), each winner mapped back to its column in the
  scene's order.
  :func:`_record_reference` is its plain torch version.
* **Replay** (torch autograd): :func:`replay_paths` (:666) re-derives each
  bounce from the winner's row of :func:`_diff_tables`, gathered through
  :func:`rayz_tpu_torch.ops.pathrec.gather_rows` (the CUDA gathers, in
  place of the TPU's one-hot matmul), with the recorded randoms; unlike
  the persistent-path replay it recomputes whether a path continues.
* **Render**: :func:`render_diff_flat` (:868) and :func:`render_diff`
  (:945): one recording per sample pass, each pass checkpointed keeping
  only its indices.

Departures from the JAX package: the randoms and the camera rays are the
megakernel's counter-keyed draws (:mod:`.rng`; ``common._make_rand``,
``common._camera_rays``), not ``jax.random``'s, so a recorded path is the path
the megakernel traces for the same seed; seeds are ints; there is no
``interpret``/``tile_sublanes`` plumbing (CPU tensors run the plain
versions, and any ray count is taken); the residency rules are the
H100's, not ``fits_smem_record``'s (sized for the TPU's SMEM); and the
replay-size gate of the JAX training API (``REPLAY_ONEHOT_BUDGET``) has no
counterpart, since no [R, P] one-hot is built.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.camera import Camera
from ..models.scene import Scene
from . import _build, pathrec
from .common import _camera_rays, _hit_frame, _make_rand, _nearest, _scatter
from .integrator import RenderConfig, _pixel_grid
from .tables import (_BIG, _NROWS, _TNROWS, RESIDENT, STREAMED, Layout,
                     StreamTables, _diff_tables, _padded_counts,
                     layout_tables, resolve, supports_scene)

__all__ = ["supports_diff", "record_paths", "replay_paths", "render_diff",
           "render_diff_flat", "RECORD_GROUP", "LAUNCHES"]

#: Sample passes that one resident record launch traces (their rays side
#: by side) in :func:`render_diff_flat`. A launch lasts as long as its
#: longest chain of bounces (0.76% of the flagship's rays bounce 32 times,
#: most 1-3), so a group of passes shares that tail: 2.77 ms a pass alone,
#: 0.81 in groups of 8 on an H100 (PERF.md). The group's rays and randoms
#: are held at once (8 x 168 MB of randoms at the flagship). The streamed
#: recorder takes one pass per launch.
RECORD_GROUP = 8

#: Launches of the record kernel in this process, per table mode (never
#: counted by the plain version).
LAUNCHES = {"resident": 0, "streamed": 0}


def supports_diff(scene: Scene) -> bool:
    """Record/replay covers any non-empty sphere/triangle scene whose
    checker textures nest one level at most: the replay resolves one
    checker level, like the megakernel, and would shade a deeper nest
    differently, so such scenes are refused rather than degraded."""
    return supports_scene(scene)


# --------------------------------------------------------------------------
# record: plain torch version, kernel wrapper, host function
# --------------------------------------------------------------------------

def _reference_bounces(stab, ttab, rays, rand, *, depth: int, t_min: float,
                       has_motion: bool):
    """The plain recorder's bounces over the live rays: yields per bounce
    (bounce, live ray ids, their (origin, direction, time), and their
    nearest hit (q, column of the tables given, is_triangle)), then moves
    them on by the megakernel's hit frame and scatter from the given
    randoms."""
    o = [x.clone() for x in rays[0:3]]
    d = [x.clone() for x in rays[3:6]]
    tau = rays[6]
    live = torch.arange(rays.shape[1], device=rays.device)
    for b in range(depth):
        if live.numel() == 0:
            return
        ol = tuple(x[live] for x in o)
        dl = tuple(x[live] for x in d)
        tl = tau[live]
        qb, best, is_tri, a, tau2 = _nearest(stab, ttab, ol, dl, tl, t_min,
                                             has_motion)
        yield b, live, (ol, dl, tl), qb, best, is_tri
        hit = qb < _BIG
        dinv = 1.0 / torch.sqrt(torch.clamp_min(a, 1e-24))
        p, nrm, front, mat = _hit_frame(stab, ttab, ol, dl, tl, tau2, a, qb,
                                        best, is_tri, has_motion)
        draws = tuple(rand[b, k, live] for k in range(5))
        ndir, _, scattered = _scatter(mat, dl, dinv, p, nrm, front, draws)
        cont = hit & scattered
        for x, new, old in zip(o + d, p + tuple(ndir), ol + dl):
            x[live] = torch.where(cont, new, old)
        live = live[cont]


def _record_reference(stab, ttab, rays, rand, *, depth: int, t_min: float,
                      has_motion: bool, tri_base: int,
                      layout: Optional[Layout] = None,
                      bounds: Optional[StreamTables] = None,
                      stats=None) -> torch.Tensor:
    """Plain torch version of the recorder (same arguments as
    :func:`_record`; of ``bounds`` it reads only the column maps: the
    layout, the bound rows and ``stats`` change only what the kernel skips
    or counts).
    :func:`_reference_bounces` over every column of the tables it is given,
    in their order; a streamed layout's winner is written as its column in
    the scene's order. Returns idx [depth, R] int32."""
    idx = torch.full((depth, rays.shape[1]), -1, dtype=torch.int32,
                     device=rays.device)
    for b, live, _, qb, best, is_tri in _reference_bounces(
            stab, ttab, rays, rand, depth=depth, t_min=t_min,
            has_motion=has_motion):
        if bounds is not None:  # sorted column -> the scene's column
            col = torch.clamp_min(best, 0)
            for tri, perm in ((False, bounds.sperm), (True, bounds.tperm)):
                if perm.numel():
                    best = torch.where(is_tri == tri, perm[torch.clamp_max(
                        col, perm.numel() - 1)].long(), best)
        winner = torch.where(is_tri, best + tri_base, best)
        idx[b, live] = torch.where(qb < _BIG, winner, -1).to(torch.int32)
    return idx


def _exact_ties(scene: Scene, rays, rand, got, want, *, depth: int,
                t_min: float) -> torch.Tensor:
    """Where two recordings of the rays ``rays`` [7, R] differ, ``want``
    the plain recording over the scene-order tables and ``got`` one over a
    sorted layout: for each ray that differs, in ray order, whether at the
    first bounce where the two part both winners lie at the same f32
    distance q from the ray there, as the sweep computes it. Such a tie is
    broken by column order, which the sort changes; any other difference
    is a fault. Returns bool [rays that differ]."""
    tabs = _record_tables(scene, resolve(scene, "record", stream=0))
    stab, ttab = tabs.stab, tabs.ttab
    tri_base = _padded_counts(scene, 1)[0]
    part = got != want
    rid = torch.nonzero(part.any(dim=0)).flatten()
    first = part[:, rid].int().argmax(dim=0)
    tie = torch.zeros(rid.numel(), dtype=torch.bool)

    def q_of(row, ray):
        if row < 0:
            return _BIG
        st, tt = ((stab[:, :0], ttab[:, row - tri_base:row - tri_base + 1])
                  if row >= tri_base else (stab[:, row:row + 1], ttab[:, :0]))
        return float(_nearest(st, tt, *ray, t_min, scene.has_motion)[0])

    for b, live, (ol, dl, tl), *_ in _reference_bounces(
            stab, ttab, rays[:, rid], rand[:, :, rid], depth=depth,
            t_min=t_min, has_motion=scene.has_motion):
        for j in torch.nonzero(first[live] == b).flatten().tolist():
            k = int(live[j])
            ray = (tuple(x[j:j + 1] for x in ol),
                   tuple(x[j:j + 1] for x in dl), tl[j:j + 1])
            qa = q_of(int(want[b, rid[k]]), ray)
            tie[k] = qa < _BIG and qa == q_of(int(got[b, rid[k]]), ray)
    return tie


def _check_record(stab, ttab, rays, rand, depth: int, layout: Layout,
                  bounds) -> None:
    dev = rays.device
    tensors = [("stab", stab), ("ttab", ttab), ("rays", rays), ("rand", rand)]
    if layout.mode == STREAMED:
        if bounds is None:
            raise ValueError("a streamed recording needs its StreamTables "
                             "(bounds)")
        tensors += [(k, getattr(bounds, k))
                    for k in ("scb", "tcb", "sblk", "tblk")]
    for name, t in tensors:
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if stab.dim() != 2 or stab.shape[0] != _NROWS:
        raise ValueError(f"stab must be [17, N], got {tuple(stab.shape)}")
    if ttab.dim() != 2 or ttab.shape[0] != _TNROWS:
        raise ValueError(f"ttab must be [20, M], got {tuple(ttab.shape)}")
    r = rays.shape[1] if rays.dim() == 2 else 0
    if rays.dim() != 2 or rays.shape[0] != 7 or r == 0:
        raise ValueError(f"rays must be a non-empty [7, R], got "
                         f"{tuple(rays.shape)}")
    if depth < 1 or tuple(rand.shape) != (depth, 5, r):
        raise ValueError(f"rand must be [{depth}, 5, {r}] with depth >= 1, "
                         f"got {tuple(rand.shape)}")
    n, m = stab.shape[1], ttab.shape[1]
    layout.check("record", n, m)
    if layout.mode == STREAMED:
        stream, blk = layout.stream, layout.blk
        for what, t, cols in (("chunk", bounds.scb, n // stream),
                              ("chunk", bounds.tcb, m // stream),
                              ("block", bounds.sblk, n // blk),
                              ("block", bounds.tblk, m // blk)):
            if tuple(t.shape) != (4, cols):
                raise ValueError(f"{what} bounds must be [4, {cols}], got "
                                 f"{tuple(t.shape)}")
        for t, cols in ((bounds.sperm, n), (bounds.tperm, m)):
            if t.dtype != torch.int32 or tuple(t.shape) != (cols,) or \
                    t.device != dev or not t.is_contiguous():
                raise ValueError(f"column maps must be contiguous int32 "
                                 f"[{cols}] on {dev}")


def _record_outputs(depth: int, r: int, dev, resident: bool):
    """What a record launch writes: idx [depth, r] int32 and, resident, the
    queue's ray counter [2] int64 (rays claimed, the clock of the last
    claim), zeroed. The resident kernel writes only winners, so its idx
    starts at -1 (a miss or a dead path); the streamed kernel writes every
    index (counter None)."""
    if not resident:
        return torch.empty((depth, r), dtype=torch.int32, device=dev), None
    return (torch.full((depth, r), -1, dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int64, device=dev))


def _record(stab, ttab, rays, rand, *, depth: int, t_min: float,
            has_motion: bool, tri_base: int, layout: Layout,
            bounds: Optional[StreamTables] = None,
            stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Record ``depth`` bounces of the rays ``rays`` [7, R] (origin,
    direction, time) with the randoms ``rand`` [depth, 5, R] through the
    sphere table ``stab`` [17, N] and triangle table ``ttab`` [20, M];
    a triangle winner is written as ``tri_base`` + its column. ``layout``
    (:func:`~rayz_tpu_torch.ops.tables.resolve`) keeps the tables in shared
    memory or streams them from device memory behind the chunk and block
    bounds of ``bounds``, the :class:`StreamTables` they come from, and
    writes each winner's column through its maps ``sperm``/``tperm``.
    ``stats``, an int64 [8] tensor on the device, receives the kernel's
    work counters (segments, primitive columns tested, block tests, chunk
    tests, chunk tests passed; resident also the re-sweeps in today's
    arithmetic (5), the lane-trips of the queue's warps (6) and the
    longest time in ns a warp ran after the ray counter drained (7)).

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors run the plain version. The resident kernel's winners are the
    plain version's but at the near ties and grazing roots that
    :func:`rayz_tpu_torch.ops.sweep.explain_paths` accepts; the streamed
    kernel's equal them. Returns idx [depth, R] int32."""
    _check_record(stab, ttab, rays, rand, depth, layout, bounds)
    streamed = layout.mode == STREAMED
    kw = dict(depth=depth, t_min=t_min, has_motion=has_motion,
              tri_base=tri_base)
    if rays.device.type == "cpu":
        return _record_reference(stab, ttab, rays, rand, bounds=bounds, **kw)
    if rays.device.type != "cuda":
        raise ValueError(f"no record kernel for device {rays.device}")
    if stats is not None and (stats.device != rays.device
                              or stats.dtype != torch.int64
                              or stats.shape != (8,)):
        raise ValueError("stats must be an int64 [8] tensor on the rays' "
                         "device")
    lib, _ = _build.load()
    r = rays.shape[1]
    b = bounds
    dev = rays.device
    idx, counter = _record_outputs(depth, r, dev, not streamed)
    ptrs = ([b.scb, b.tcb, b.sblk, b.tblk, b.sperm, b.tperm] if streamed
            else [None] * 6)
    with torch.cuda.device(dev):
        err = lib.rayz_record(
            stab.data_ptr(), stab.shape[1], ttab.data_ptr(), ttab.shape[1],
            *map(pathrec._ptr, ptrs), layout.stream, layout.blk, tri_base,
            rays.data_ptr(), rand.data_ptr(), r, depth, t_min,
            int(has_motion), idx.data_ptr(), pathrec._ptr(counter),
            pathrec._ptr(stats), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "record")
    LAUNCHES["streamed" if streamed else "resident"] += 1
    return idx


def _record_tables(scene: Scene, layout: Layout,
                   origin: Optional[torch.Tensor] = None):
    """The record kernel's tables for ``layout``, f32 without autograd:
    resident, each class in its own order; streamed, Morton-sorted, chunks
    and blocks near to far from ``origin`` [3]. The order changes which
    columns the kernel may skip, never a winner but at an exact tie."""
    with torch.no_grad():
        return layout_tables(scene, layout, None if origin is None
                             else origin.detach(), memo=False)[0]


def _record_rays(scene: Scene, layout: Layout, tabs, origin, direction,
                 time, rand, *, max_depth: int, t_min: float,
                 stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`record_paths` over the tables :func:`_record_tables` built for
    ``layout``."""
    with torch.no_grad():
        f32 = torch.float32
        rays = torch.cat([origin.T.to(f32), direction.T.to(f32),
                          time[None].to(f32)]).contiguous()
        rand = rand.detach().to(f32).contiguous()
        return _record(tabs.stab, tabs.ttab, rays, rand, depth=max_depth,
                       t_min=t_min, has_motion=scene.has_motion,
                       tri_base=_padded_counts(scene, 1)[0], layout=layout,
                       bounds=tabs if layout.mode == STREAMED else None,
                       stats=stats)


def record_paths(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
                 time: torch.Tensor, rand: torch.Tensor, *, max_depth: int,
                 t_min: float, stream: Optional[int] = None,
                 stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trace the rays ``origin``/``direction`` [R, 3] at ``time`` [R]
    through the scene (diffkernel.py:464), returning per-bounce winner
    indices [max_depth, R] int32: -1 on a miss or a dead path, spheres in
    [0, N_pad), triangles at N_pad + j (the rows of :func:`_diff_tables`).
    ``rand`` [max_depth, 5, R]: a unit vector, the cube-root radius factor
    u^(1/3), the Schlick uniform. Non-differentiable: the inputs are
    detached, and the recording runs in f32 whatever the scene's dtype.

    ``stream=None`` keeps the tables in shared memory where they fit
    (:func:`~rayz_tpu_torch.ops.tables.fits_shared`) and streams them in
    chunks of :data:`~rayz_tpu_torch.ops.tables.RECORD_STREAM_CHUNK`
    otherwise; ``0`` forces shared memory (raising if the tables do not
    fit), an int forces that chunk
    (:func:`~rayz_tpu_torch.ops.tables.resolve`). A streamed layout is
    ordered near to far from the first ray's origin. ``stats`` as
    :func:`_record`."""
    layout = resolve(scene, "record", stream=stream)
    tabs = _record_tables(scene, layout, origin[0])
    return _record_rays(scene, layout, tabs, origin, direction, time, rand,
                        max_depth=max_depth, t_min=t_min, stats=stats)


# --------------------------------------------------------------------------
# replay (eager autograd, one checkpointed step per bounce)
# --------------------------------------------------------------------------

def _replay_bounce(o, d, tau, thr, out, act, row, idx_b, rand_b, **kw):
    """One replayed bounce (the scan body of diffkernel.py:683-831): shade
    the recorded winner (:func:`pathrec._replay_shade`), add the sky on a
    miss of a live path, and continue where the path hit and scattered
    (recomputed, not recorded)."""
    p, ndir, att, scattered, sky = pathrec._replay_shade(
        o, d, tau, row, idx_b, rand_b[0:3].T, rand_b[3], rand_b[4], **kw)
    hit = idx_b >= 0
    miss = act & ~hit
    out = out + torch.where(miss[:, None], thr * sky, 0.0)
    cont = act & hit & scattered
    c3 = cont[:, None]
    thr = torch.where(c3, thr * att, thr)
    o = torch.where(c3, p, o)
    d = torch.where(c3, ndir, d)
    return o, d, thr, out, cont


def _bounces_to_replay(idx: torch.Tensor) -> int:
    """Bounces that can change the radiance: up to the one after the last
    bounce with a recorded hit (a path is live at bounce b only if it hit
    at b - 1), at least one."""
    hits = torch.nonzero((idx >= 0).any(dim=1)).flatten()
    return min(idx.shape[0], int(hits[-1]) + 2) if hits.numel() else 1


def _replay(scene: Scene, tab, origin, direction, time, rand, idx, *,
            t_min: float, remat: bool) -> torch.Tensor:
    """:func:`replay_paths` over a given differentiable table ``tab``."""
    dt = tab.dtype
    o, d, tau, rand = (x.to(dt) for x in (origin, direction, time, rand))
    r = o.shape[0]
    thr = torch.ones((r, 3), dtype=dt, device=o.device)
    out = torch.zeros((r, 3), dtype=dt, device=o.device)
    act = torch.ones(r, dtype=torch.bool, device=o.device)
    step = functools.partial(
        _replay_bounce, t_min=t_min, n_sph_pad=_padded_counts(scene, 1)[0],
        with_sph=scene.n_spheres > 0, with_tri=scene.n_triangles > 0,
        has_motion=scene.has_motion,
        blue=torch.tensor([0.5, 0.7, 1.0], dtype=dt, device=o.device))
    for b in range(_bounces_to_replay(idx)):
        idx_b = idx[b]
        row = pathrec.gather_rows(tab, torch.clamp_min(idx_b, 0))
        args = (o, d, tau, thr, out, act, row, idx_b, rand[b])
        if remat:
            o, d, thr, out, act = checkpoint(step, *args, use_reentrant=False,
                                             preserve_rng_state=False)
        else:
            o, d, thr, out, act = step(*args)
    return out


def replay_paths(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
                 time: torch.Tensor, rand: torch.Tensor, idx: torch.Tensor,
                 *, t_min: float, remat: bool = True) -> torch.Tensor:
    """Re-trace recorded paths differentiably (diffkernel.py:666); returns
    radiance [R, 3] in the scene's dtype.

    Each bounce gathers only the winner's row of :func:`_diff_tables`
    (misses read row 0, whose values stay under the selects) and re-derives
    distance, normal, scatter and attenuation with the recorder's formulas
    and randoms; whether a path continues is recomputed from that scatter.
    Gradients reach centers, radii, velocities, triangle vertices, colors,
    fuzz and IOR with O(R) work per bounce. ``remat=True`` runs each bounce
    under ``torch.utils.checkpoint`` with its gathered rows computed
    outside, so the backward keeps the rows and the carry per bounce and
    its recompute launches no gather. Bounces after the last recorded hit
    but one change nothing and are skipped."""
    return _replay(scene, _diff_tables(scene), origin, direction, time, rand,
                   idx, t_min=t_min, remat=remat)


# --------------------------------------------------------------------------
# the sample passes and the image-level entry point
# --------------------------------------------------------------------------

def render_diff_flat(scene: Scene, camera: Camera, seed: int, px, py, *,
                     spp: int, max_depth: int, t_min: float,
                     jitter: bool) -> torch.Tensor:
    """Record+replay radiance of the flat pixel list (int32 coordinates
    ``px``/``py`` [n]) -> [n, 3], spp-averaged (diffkernel.py:868).

    One recording per sample pass, replayed, the passes summed in order and
    divided by ``spp``. Resident, the passes are recorded in groups of
    :data:`RECORD_GROUP`, one launch over their rays side by side. Each
    pass is checkpointed keeping only its indices [max_depth, n] int32:
    the backward regenerates its rays and randoms (cheap, counter-keyed;
    the group's are the passes' own, copied side by side, so the same
    bits) and replays it again, so the record kernel runs once per group.
    The recorder keeps the tables in shared memory where they fit and
    streams them otherwise (:func:`record_paths`), ordered near to far
    from the camera; its tables are built once for all passes."""
    pix = (py.long() * camera.width + px.long()).to(torch.int32)
    n = pix.shape[0]
    tab = _diff_tables(scene)
    layout = resolve(scene, "record")
    tabs = _record_tables(scene, layout, camera.look_from)
    group = RECORD_GROUP if layout.mode == RESIDENT else 1

    def inputs(s):
        o, d, tm = _camera_rays(camera, seed, pix, s, jitter)
        return o, d, tm, _make_rand(seed, pix, s, max_depth)

    def group_inputs(s0, g):
        """Passes s0 .. s0 + g - 1 side by side: origin and direction
        [g n, 3], time [g n], randoms [depth, 5, g n]."""
        if g == 1:
            return inputs(s0)
        out = None
        for k in range(g):
            o, d, tm, rand = inputs(s0 + k)
            parts = (o.T, d.T, tm, rand)  # the ray index last
            if out is None:
                out = [x.new_empty((*x.shape[:-1], g * n)) for x in parts]
            for buf, x in zip(out, parts):
                buf[..., k * n:(k + 1) * n] = x
        return out[0].T, out[1].T, out[2], out[3]

    def replay_pass(tab, idx, s):
        return _replay(scene, tab, *inputs(s), idx, t_min=t_min, remat=True)

    acc = None
    for s0 in range(0, spp, group):
        g = min(group, spp - s0)
        idx = _record_rays(scene, layout, tabs, *group_inputs(s0, g),
                           max_depth=max_depth, t_min=t_min)
        for k in range(g):
            rad = checkpoint(replay_pass, tab, idx[:, k * n:(k + 1) * n],
                             s0 + k, use_reentrant=False,
                             preserve_rng_state=False)
            acc = rad if acc is None else acc + rad
    return acc.to(camera.dtype) / float(spp)


def render_diff(scene: Scene, camera: Camera, seed: int,
                config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Differentiable [H, W, 3] render by bounce-indexed record/replay
    (diffkernel.py:945): the forward megakernel's estimator, composing with
    autograd in the scene's float leaves, at any scene size
    :func:`record_paths` can record (streamed beyond one block's shared
    memory).

    It records the paths the megakernel traces for the same seed (the same
    camera rays and draws). The replay re-derives each bounce in its own
    rounding, so a near-tie there (a glass coin, a grazing hit or
    reflection) can part from the recorded path: such a pixel differs from
    the megakernel's while its block means agree. The share of such
    channels grows with the samples per pixel, in the plain versions as in
    the kernels, and the persistent-path replay shows it too (PERF.md)."""
    if not supports_diff(scene):
        if scene.deep_checker:
            raise ValueError(
                "record/replay resolves only ONE level of checker nesting; "
                "nested-checker scenes need the dense engine "
                "(engine='dense')")
        raise ValueError("record/replay needs a non-empty scene (spheres "
                         "and/or triangles)")
    if camera.device != scene.device:
        raise ValueError(f"camera is on {camera.device}, scene on "
                         f"{scene.device}")
    px, py = _pixel_grid(camera)
    flat = render_diff_flat(scene, camera, seed, px, py, spp=config.spp,
                            max_depth=config.max_depth, t_min=config.t_min,
                            jitter=config.jitter)
    return flat.reshape(camera.height, camera.width, 3)
