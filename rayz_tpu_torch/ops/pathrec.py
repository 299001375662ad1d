"""Persistent-path record/replay: the port's differentiable renderer.

PyTorch counterpart of :mod:`rayz_tpu.ops.pathrec` (the ``recorded-pp``
estimator), fused and unfused:

* **Record** (CUDA, non-differentiable): :func:`record_pp` (pathrec.py:552)
  over ``csrc/record_pp.cu``, which replaces ``_record_pp_kernel``
  (pathrec.py:186). It runs the megakernel's persistent path loop (respawn
  as soon as a path dies) for a fixed number of iterations and records per
  iteration and slot the winning primitive index and 13 aux rows: the
  scatter randoms, the spawned camera ray, and the spawn/continue flags.
  :func:`_record_slots_reference` is its plain torch version.
* **Gather** (CUDA): :func:`gather_rows` (pathrec.py:1225) and
  :func:`gather_rows_T` (:1157) are ``torch.autograd.Function``\\ s over
  ``csrc/gather.cu``, which replaces ``_gather_fwd_kernel`` (:1095) and
  ``_gather_bwd_kernel`` (:1120); the backward is deterministic.
* **Fused replay** (CUDA, the f32 default): :func:`replay_pp_fused`
  (pathrec.py:1756) gathers every recorded iteration's winner rows once,
  then runs ``csrc/replay_pp.cu``, which replaces ``_fused_fwd_kernel``
  (:1512) and ``_fused_bwd_kernel`` (:1565): the forward replays all
  iterations per slot and saves each entry carry, the backward walks them
  in reverse through a hand-derived adjoint of :func:`_pp_step`.
  :func:`_fused_fwd_reference` and :func:`_fused_bwd_reference` (autograd
  of :func:`_pp_step` per iteration) are their plain versions.
* **Eager replay** (torch autograd, the f64 path and the oracle):
  :func:`replay_pp` (pathrec.py:660) re-derives every value of the
  recorded paths from the raw scene parameters, one checkpointed step per
  recorded iteration. Both replays reach centers, radii, velocities,
  triangle vertices, colors, fuzz and IOR with O(R) work per iteration.
* **Schedule**: :func:`render_diff_pp_flat` (pathrec.py:855) runs the
  straggler-compacted pass schedule of :func:`default_schedule`, with each
  resumed pass's replay carry handed over differentiably, and
  :func:`render_diff_pp` (:1020) renders a whole image.

Departures from the JAX package:

* Draws are the megakernel's counter-keyed numbers (:mod:`.rng`), keyed by
  (seed, pixel, sample, bounce), so a recorded path is the path the
  megakernel traces for the same seed, and :func:`record_pp` takes flat
  pixel ids (-1 = no pixel) instead of float coordinates. A resumed pass
  keeps the seed; the JAX package's per-pass seed XOR (pathrec.py:973) is
  unnecessary because each slot's counters carry on.
* Seeds are ints; there is no ``interpret`` plumbing (CPU tensors run the
  plain versions).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.camera import Camera
from ..models.scene import (DIFFUSE_UNIT_SPHERE, DIFFUSE_UNIT_SPHERE_SURFACE,
                            MAT_DIELECTRIC, MAT_METALLIC, Scene)
from . import _build, rng
from .common import Bits, _hit_frame, _key_draws, _nearest, _scatter, _spawn
from .integrator import RenderConfig, _pixel_grid
from .tables import (_BIG, _NROWS, _TNROWS, Layout, _camera_vector,
                     _diff_tables, fits, layout_tables, resolve,
                     supports_scene)

__all__ = ["render_diff_pp", "render_diff_pp_flat", "record_pp", "replay_pp",
           "replay_pp_fused", "gather_rows", "gather_rows_T",
           "default_iters", "default_k1", "default_schedule", "supports_pp",
           "LAUNCHES", "REPLAY_STEPS"]

#: Kernel launches made in this process by the wrappers of the recorder, of
#: the two gather kernels and of the two fused replay kernels (never by
#: their plain versions).
LAUNCHES = {"record_pp": 0, "gather_fwd": 0, "gather_bwd": 0,
            "replay_fwd": 0, "replay_bwd": 0}

#: Steps run in this process by the eager replay (one gather per step).
REPLAY_STEPS = 0

# aux plane rows (per iteration, per slot), as pathrec.py:118-124
_AUX_UX, _AUX_UY, _AUX_UZ, _AUX_CB, _AUX_US = 0, 1, 2, 3, 4  # scatter randoms
_AUX_OX, _AUX_OY, _AUX_OZ = 5, 6, 7                          # spawn origin
_AUX_DX, _AUX_DY, _AUX_DZ = 8, 9, 10                         # spawn direction
_AUX_TAU = 11                                                # spawn time
_AUX_FLG = 12                                                # spawn + 2*cont
_AUX_ROWS = 13

_ST_ROWS = 10  # replay carry: ox oy oz dx dy dz tau thx thy thz (:1322)

# Slots pad to whole tiles of _TILE_SUBLANES * 128 as in the JAX package
# (pathrec.py:884-887), which the default schedule's capacities follow.
_TILE_SUBLANES = 16


# --------------------------------------------------------------------------
# policies (pathrec.py:127-183)
# --------------------------------------------------------------------------

def supports_pp(scene: Scene) -> bool:
    """Scenes the recorder takes: supported ones whose tables fit one
    block's shared memory on an H100."""
    return supports_scene(scene) and fits(scene, "record_pp")


def default_iters(spp: int, max_depth: int = 32) -> int:
    """Single-pass iteration budget: 4x the sample count plus 4 full-depth
    paths of headroom, capped at the exhaustive ``spp * max_depth``."""
    return min(spp * max_depth, 4 * spp + 4 * max_depth)


def default_k1(spp: int, max_depth: int = 32) -> int:
    """First-pass budget of the compacted schedule: 3.5x the sample count,
    floored at 16 and capped at the exhaustive bound."""
    return min(spp * max_depth, max(16, (7 * spp) // 2))


def slot_layout(n_px: int) -> tuple:
    """(block, r_pad): the slot block of a recording of ``n_px`` pixels
    (:func:`render_diff_pp_flat`'s, JAX's tile of up to 16 x 128 slots)
    and the slot count padded to it."""
    block = min(_TILE_SUBLANES, max(1, -(-n_px // 128))) * 128
    return block, -(-n_px // block) * block


def default_schedule(spp: int, max_depth: int, r_pad: int,
                     block: int) -> list:
    """Compaction pass schedule [(iters, capacity), ...]: a lean full-width
    pass (:func:`default_k1`), a depth-length pass at half capacity, and
    the rest of the exhaustive budget at 1/16 capacity. A slot never idles
    while it has work, so budgets summing to ``spp * max_depth`` guarantee
    every sample finishes unless more slots straggle than a capacity."""
    def cblk(x):
        return max(block, min(-(-x // block) * block, r_pad))

    k_exh = spp * max_depth
    k1 = default_k1(spp, max_depth)
    sch = [(k1, r_pad)]
    used = k1
    if used < k_exh:
        k2 = min(k_exh - used, max(k1, max_depth))
        sch.append((k2, cblk(r_pad // 2)))
        used += k2
    if used < k_exh:
        sch.append((k_exh - used, cblk(r_pad // 16)))
    return sch


def _default_carry(r: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Fresh-recording replay carry [_ST_ROWS, r]: o = 0, d = z, tau = 0,
    thr = 1 (pathrec.py:1748, for r slots). Every live slot's first
    iteration is a spawn, so this matters only for resumed passes."""
    st0 = torch.zeros((_ST_ROWS, r), dtype=dtype, device=device)
    st0[5] = 1.0
    st0[7:10] = 1.0
    return st0


# --------------------------------------------------------------------------
# record: plain torch version, kernel wrapper, host function
# --------------------------------------------------------------------------

def _record_slots_reference(cam, stab, ttab, pix, *, width: int, spp: int,
                            max_depth: int, t_min: float, jitter: bool,
                            has_motion: bool, seed: int, iters: int,
                            init_state=None, want_state: bool = False,
                            bits: Optional[Bits] = None, layout=None,
                            stats=None):
    """Plain torch version of the recorder (same arguments as
    :func:`_record_slots`; ``layout`` and ``stats`` are the kernel's, so
    they are not read here), lockstep over all slots like the TPU tile.
    ``bits(key, n)`` supplies draw ``n`` under the per-step keys (default
    :func:`rng.draw_bits`); returning zeros reproduces what the JAX Pallas
    interpreter draws. A slot with no work writes index -2 and zero aux."""
    bits = rng.draw_bits if bits is None else bits
    f32, i32 = torch.float32, torch.int32
    dev, cap, n = pix.device, pix.shape[0], stab.shape[1]
    pp = torch.clamp_min(pix, 0)
    pxf = (pp % width).to(f32)
    pyf = (pp // width).to(f32)
    if init_state is not None:
        st, cnt, frm = init_state
        ox, oy, oz, dx, dy, dz, tau = st.unbind()
        depth, samples, active = cnt[0], cnt[1], cnt[2] > 0
    else:
        ox = oy = oz = dx = dy = dz = tau = torch.zeros(cap, dtype=f32,
                                                        device=dev)
        depth = torch.zeros(cap, dtype=i32, device=dev)
        samples = torch.where(pix >= 0, spp, 0).to(i32)
        active = torch.zeros(cap, dtype=torch.bool, device=dev)
        frm = torch.full((cap,), -1, dtype=i32, device=dev)
    key0 = rng.slot_key(seed, pix)
    idx = torch.full((iters, cap), -2, dtype=i32, device=dev)
    aux = torch.zeros((iters, _AUX_ROWS, cap), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    for k in range(iters):
        work = active | (samples > 0)
        if not bool(work.any()):
            break  # every later iteration is idle: -2 and zeros
        spawn = work & ~active
        samples = samples - spawn.to(i32)
        depth = torch.where(spawn, max_depth, depth)
        key = rng.step_key(key0, spp - samples, max_depth - depth)
        no, nd, ntau = _spawn(cam, pxf, pyf, key, jitter, bits)
        ox, oy, oz = (torch.where(spawn, new, old)
                      for new, old in zip(no, (ox, oy, oz)))
        dx, dy, dz = (torch.where(spawn, new, old)
                      for new, old in zip(nd, (dx, dy, dz)))
        tau = torch.where(spawn, ntau, tau)
        for row, v in zip(range(_AUX_OX, _AUX_TAU + 1),
                          (ox, oy, oz, dx, dy, dz, tau)):
            aux[k, row] = torch.where(spawn, v, zero)

        # the scatter randoms the replay consumes (draws 5-8)
        draws = _key_draws(key, bits)
        for row, v in zip(range(_AUX_UX, _AUX_US + 1), draws):
            aux[k, row] = torch.where(work, v, zero)

        o, d = (ox, oy, oz), (dx, dy, dz)
        qb, best, is_tri, a, tau2 = _nearest(stab, ttab, o, d, tau, t_min,
                                             has_motion)
        hit = qb < _BIG
        dinv = 1.0 / torch.sqrt(torch.clamp_min(a, 1e-24))
        p, nrm, front, mat = _hit_frame(stab, ttab, o, d, tau, tau2, a, qb,
                                        best, is_tri, has_motion)
        ndir, _, scattered = _scatter(mat, d, dinv, p, nrm, front, draws)
        # the last bounce of a path is recorded as not continuing
        cont = work & hit & scattered & (depth > 1)
        winner = torch.where(is_tri, best + n, best)
        idx[k] = torch.where(work, torch.where(hit, winner, -1), -2)
        aux[k, _AUX_FLG] = spawn.to(f32) + 2.0 * cont.to(f32)

        ox, oy, oz = (torch.where(cont, new, old) for new, old in zip(p, o))
        dx, dy, dz = (torch.where(cont, new, old)
                      for new, old in zip(ndir, d))
        depth = depth - cont.to(i32)
        active = cont
        frm = torch.where(cont & ~is_tri, best, -1).to(i32)

    left = samples + active.to(i32)
    if not want_state:
        return idx, aux, left, None
    return idx, aux, left, (torch.stack([ox, oy, oz, dx, dy, dz, tau]),
                            torch.stack([depth, samples, active.to(i32)]),
                            frm)


def _check_record_inputs(cam, stab, ttab, pix, iters, init_state,
                         layout: Layout):
    dev = pix.device
    for name, t, dtype in (("cam", cam, torch.float32),
                           ("stab", stab, torch.float32),
                           ("ttab", ttab, torch.float32),
                           ("pix", pix, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, pix on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cam.shape != (18,):
        raise ValueError(f"cam must be [18], got {tuple(cam.shape)}")
    if stab.dim() != 2 or stab.shape[0] != _NROWS:
        raise ValueError(f"stab must be [17, N], got {tuple(stab.shape)}")
    if ttab.dim() != 2 or ttab.shape[0] != _TNROWS:
        raise ValueError(f"ttab must be [20, M], got {tuple(ttab.shape)}")
    if pix.dim() != 1 or pix.shape[0] == 0:
        raise ValueError(f"pix must be a non-empty [cap], got "
                         f"{tuple(pix.shape)}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if init_state is not None:
        cap = pix.shape[0]
        if len(init_state) != 3:
            raise ValueError("init_state must be the (st, cnt, from) a "
                             "recording returned")
        for name, t, dtype, shape in (
                ("st", init_state[0], torch.float32, (7, cap)),
                ("cnt", init_state[1], torch.int32, (3, cap)),
                ("from", init_state[2], torch.int32, (cap,))):
            if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                    or t.shape != shape):
                raise ValueError(f"init_state {name} must be a contiguous "
                                 f"{dtype} {list(shape)} tensor on {dev}")
    layout.check("record_pp", stab.shape[1], ttab.shape[1])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _record_slots(cam, stab, ttab, pix, *, width: int, spp: int,
                  max_depth: int, t_min: float, jitter: bool,
                  has_motion: bool, seed: int, iters: int, layout: Layout,
                  init_state=None, want_state: bool = False,
                  stats: Optional[torch.Tensor] = None):
    """Record ``iters`` iterations of the slots ``pix`` (flat pixel ids, -1
    = no pixel): camera vector ``cam`` [18], sphere table ``stab`` [17, N],
    triangle table ``ttab`` [20, M] (0 columns for an absent class),
    ``layout`` (:func:`~rayz_tpu_torch.ops.tables.resolve` for
    ``"record_pp"``) holds the launch's shared memory.
    ``init_state`` = (st [7, cap] f32, cnt [3, cap] i32, from [cap] i32)
    to resume (``from``: the sphere column each slot's ray leaves, -1 if
    none, which the kernel tests in the plain version's arithmetic).
    ``stats``, an int64 [8] tensor on the device, counts the kernel's
    re-sweeps in today's arithmetic at index 5 (``rz::settle_winner``; the
    plain version sweeps in that arithmetic only and counts nothing).

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors run the plain version. Returns (idx [iters, cap] i32, aux
    [iters, 13, cap] f32, leftover [cap] i32, (st, cnt) or None)."""
    _check_record_inputs(cam, stab, ttab, pix, iters, init_state, layout)
    kw = dict(width=width, spp=spp, max_depth=max_depth, t_min=t_min,
              jitter=jitter, has_motion=has_motion, seed=seed, iters=iters,
              init_state=init_state, want_state=want_state)
    if pix.device.type == "cpu":
        return _record_slots_reference(cam, stab, ttab, pix, **kw)
    if pix.device.type != "cuda":
        raise ValueError(f"no record kernel for device {pix.device}")
    if stats is not None and (stats.device != pix.device
                              or stats.dtype != torch.int64
                              or stats.shape != (8,)):
        raise ValueError("stats must be an int64 [8] tensor on pix's device")
    lib, _ = _build.load()
    dev, cap = pix.device, pix.shape[0]
    f32, i32 = torch.float32, torch.int32
    idx = torch.empty((iters, cap), dtype=i32, device=dev)
    aux = torch.empty((iters, _AUX_ROWS, cap), dtype=f32, device=dev)
    left = torch.empty(cap, dtype=i32, device=dev)
    state = ((torch.empty((7, cap), dtype=f32, device=dev),
              torch.empty((3, cap), dtype=i32, device=dev),
              torch.empty(cap, dtype=i32, device=dev))
             if want_state else None)
    st_in, cnt_in, from_in = (init_state if init_state is not None
                              else (None, None, None))
    st_out, cnt_out, from_out = state if state is not None else (None,) * 3
    with torch.cuda.device(dev):
        err = lib.rayz_record_pp(
            cam.data_ptr(), stab.data_ptr(), stab.shape[1], ttab.data_ptr(),
            ttab.shape[1], pix.data_ptr(), cap, _ptr(st_in), _ptr(cnt_in),
            _ptr(from_in), idx.data_ptr(), aux.data_ptr(), left.data_ptr(),
            _ptr(st_out), _ptr(cnt_out), _ptr(from_out), iters, width, spp,
            max_depth, t_min, int(jitter),
            int(has_motion), seed & rng.MASK, _ptr(stats),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "record_pp")
    LAUNCHES["record_pp"] += 1
    return idx, aux, left, state


def _scene_record_inputs(scene: Scene, camera: Camera,
                         layout: Optional[Layout] = None):
    """The recorder's inputs in ``layout`` (by default resolved): camera
    vector [18], sphere table [17, N] and triangle table [20, M] (0 columns
    for an absent class, not padded), contiguous, without autograd."""
    layout = resolve(scene, "record_pp") if layout is None else layout
    with torch.no_grad():
        tabs = layout_tables(scene, layout, memo=False)[0]
        cam = _camera_vector(camera).contiguous()
    return cam, tabs.stab, tabs.ttab


def record_pp(scene: Scene, camera: Camera, seed: int, pix: torch.Tensor, *,
              spp: int, max_depth: int, t_min: float, jitter: bool,
              iters: int, init_state=None, want_state: bool = False):
    """Run the persistent-path recorder (pathrec.py:552) over the slots
    ``pix`` (flat int32 pixel ids, -1 = no pixel). ``iters`` rounds up to a
    multiple of 8 as in the JAX package. Returns (idx [iters, cap] i32,
    aux [iters, 13, cap] f32, leftover [cap] i32); with ``want_state=True``
    also the final state (st [7, cap] f32: o, d, tau; cnt [3, cap] i32:
    depth left, samples left, active; from [cap] i32: the sphere column the
    ray leaves, -1 if none), which ``init_state`` takes back to RESUME the
    recording where it stopped, with the same ``seed``. ``init_state`` also
    takes an (st, cnt) pair, as earlier versions returned: it resumes with
    no sphere left (from = -1), so the kernel does not re-test that sphere
    in the plain version's arithmetic.
    Non-differentiable: the tables are built without autograd.

    Triangle winners are recorded as the raw sphere count plus their
    column, the row of :func:`_diff_tables`: the tables are not padded to
    an unroll multiple here (the megakernel's are)."""
    ig = 8 if iters >= 8 else 1
    iters = -(-iters // ig) * ig  # round UP: extra budget, never less
    layout = resolve(scene, "record_pp")
    if init_state is not None and len(init_state) == 2:
        init_state = (*init_state, torch.full_like(pix, -1))
    cam, stab, ttab = _scene_record_inputs(scene, camera, layout)
    idx, aux, left, state = _record_slots(
        cam, stab, ttab, pix,
        width=camera.width, spp=spp, max_depth=max_depth, t_min=t_min,
        jitter=jitter, has_motion=scene.has_motion, seed=int(seed),
        iters=iters, layout=layout, init_state=init_state,
        want_state=want_state)
    if want_state:
        return idx, aux, left, state
    return idx, aux, left


# --------------------------------------------------------------------------
# row gather: plain versions, kernel wrappers, autograd
# --------------------------------------------------------------------------

def _check_gather(tab, idx):
    if tab.dim() != 2 or tab.shape[0] == 0:
        raise ValueError(f"tab must be a non-empty [P, C], got "
                         f"{tuple(tab.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be an int32 [R], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if tab.device != idx.device:
        raise ValueError(f"tab is on {tab.device}, idx on {idx.device}")


def _gather_fwd_reference(tab, idx, transposed: bool):
    """Plain version of the forward: ``tab[idx]``, zero rows for indices
    outside [0, P); [R, C], or [C, R] when ``transposed``."""
    ok = (idx >= 0) & (idx < tab.shape[0])
    rows = tab[torch.where(ok, idx, 0).long()]
    rows = torch.where(ok[:, None], rows, torch.zeros((), dtype=tab.dtype,
                                                      device=tab.device))
    return rows.T.contiguous() if transposed else rows


def _gather_bwd_reference(g, idx, p: int, transposed: bool):
    """Plain version of the backward: ``d_tab[p] = sum g[r]`` over idx[r] =
    p, accumulated in f64 (``index_add_``) and cast back; indices outside
    [0, P) add nothing."""
    g = g.T if transposed else g
    ok = (idx >= 0) & (idx < p)
    acc = torch.zeros((p + 1, g.shape[1]), dtype=torch.float64,
                      device=g.device)
    acc.index_add_(0, torch.where(ok, idx, p).long(), g.to(torch.float64))
    return acc[:p].to(g.dtype)


def _gather_fwd(tab, idx, transposed: bool):
    """Forward wrapper: the CUDA kernel for CUDA tensors (or raise), the
    plain version for CPU tensors."""
    _check_gather(tab, idx)
    if idx.device.type == "cpu":
        return _gather_fwd_reference(tab, idx, transposed)
    if idx.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {idx.device}")
    if tab.dtype != torch.float32 or not tab.is_contiguous():
        raise ValueError("the gather kernel takes a contiguous f32 table")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    (p, c), r = tab.shape, idx.shape[0]
    if c % 4:
        raise ValueError(f"the gather kernel moves rows as float4s: C must "
                         f"be a multiple of 4, got {c}")
    # its vector loads need 16-byte alignment, which a view may lack
    tab, idx = (x if x.data_ptr() % 16 == 0 else x.clone()
                for x in (tab, idx))
    out = torch.empty((c, r) if transposed else (r, c), dtype=torch.float32,
                      device=idx.device)
    if r == 0:
        return out
    lib, _ = _build.load()
    with torch.cuda.device(idx.device):
        err = lib.rayz_gather_fwd(
            tab.data_ptr(), p, c, idx.data_ptr(), r, int(transposed),
            out.data_ptr(), torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(lib, err, "gather_fwd")
    LAUNCHES["gather_fwd"] += 1
    return out


#: The backward kernel's shape (csrc/gather.cu): warps per block, table
#: rows and columns per block, sorted positions per block where the table
#: has more than one row block; the blocks per SM the one-row-block plan
#: aims for (three fit one SM's shared memory, two waves of them); and the
#: most rays one warp sums there, so that a row most rays hit (a ground
#: sphere) is spread over many warps.
_BWD_WARPS, _BWD_ROWS, _BWD_COLS, _BWD_PIECE = 8, 512, 4, 4096
_BWD_BLOCKS_PER_SM = 6
_BWD_WARP_RAYS = 4096


def _bwd_plan(r: int, c: int, sms: int):
    """(tiles, span) of the backward launch on a table of one row block: R
    rays cut into ``tiles`` contiguous tiles of ``span`` rays (a multiple
    of one block's lanes, the last tile maybe short): enough for the
    (tile, column group) blocks to fill ``sms`` SMs about twice over, with
    at least 8 chunks of 32 rays per warp, and for no warp to sum more
    than :data:`_BWD_WARP_RAYS` rays. One tile needs no second pass."""
    unit = 32 * _BWD_WARPS
    groups = -(-c // _BWD_COLS)
    tiles = max(1, min(-(-_BWD_BLOCKS_PER_SM * sms // groups),
                       r // (8 * unit)),
                -(-r // (_BWD_WARPS * _BWD_WARP_RAYS)))
    span = -(-r // (tiles * unit)) * unit
    return -(-r // span), span


def _gather_bwd(g, idx, p: int, transposed: bool):
    """Backward wrapper (deterministic): the CUDA kernel's fixed-order
    partial tables, added in order, over contiguous ray tiles for a table
    of one row block and over pieces of a stable counting sort by row
    block for a larger one; the plain version for CPU tensors."""
    if idx.device.type == "cpu":
        return _gather_bwd_reference(g, idx, p, transposed)
    if idx.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {idx.device}")
    if g.dtype != torch.float32:
        raise ValueError(f"the gather kernel takes f32 cotangents, got "
                         f"{g.dtype}")
    g, idx = g.contiguous(), idx.contiguous()
    r = idx.shape[0]
    c = g.shape[0] if transposed else g.shape[1]
    d_tab = torch.empty((p, c), dtype=torch.float32, device=g.device)
    if r == 0:
        return d_tab.zero_()
    lib, _ = _build.load()
    dev = g.device
    if p <= _BWD_ROWS:
        tiles, span = _bwd_plan(r, c, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        partial = (torch.empty((tiles, p, c), dtype=torch.float32,
                               device=dev) if tiles > 1 else None)
        work = None
    else:
        tiles, span = 0, 0
        pieces = -(-r // _BWD_PIECE) + -(-p // _BWD_ROWS)
        partial = torch.empty((pieces, _BWD_ROWS, c), dtype=torch.float32,
                              device=dev)
        work = torch.empty(lib.rayz_gather_bwd_work(r, p), dtype=torch.int32,
                           device=dev)
    stride_r, stride_c = (1, r) if transposed else (c, 1)
    with torch.cuda.device(dev):
        err = lib.rayz_gather_bwd(
            g.data_ptr(), stride_r, stride_c, idx.data_ptr(), r, p, c, tiles,
            span, _ptr(partial), _ptr(work), d_tab.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(lib, err, "gather_bwd")
    LAUNCHES["gather_bwd"] += 1
    return d_tab


class _GatherRows(torch.autograd.Function):
    """rows = tab[idx] with the table cotangent scatter-added back; saves
    only the indices."""

    @staticmethod
    def forward(ctx, tab, idx, transposed):
        ctx.save_for_backward(idx)
        ctx.p, ctx.transposed = tab.shape[0], transposed
        return _gather_fwd(tab, idx, transposed)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _gather_bwd(g, idx, ctx.p, ctx.transposed), None, None


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]`` ([P, C], [R] int32 -> [R, C]) through the gather
    kernels, differentiable in ``tab`` (pathrec.py:1225). An index outside
    [0, P) gives a zero row and no cotangent. f64 tables take plain torch
    indexing instead, exactly as the JAX package routes them to
    ``jnp.take`` (pathrec.py:1233): that is the package's dtype dispatch
    for its small f64 oracle path, not a fallback on failure (there,
    ``idx`` must lie in [0, P))."""
    if tab.dtype == torch.float64:
        return tab[idx.long()]
    return _GatherRows.apply(tab.contiguous(), idx, False)


def gather_rows_T(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx].T`` ([P, C], [R] int32 -> [C, R]), the same kernel pair in
    the rays-on-columns layout (pathrec.py:1157) that the fused replay
    consumes. Unlike the JAX function, R is not padded to a lane block."""
    return _GatherRows.apply(tab.contiguous(), idx, True)


# --------------------------------------------------------------------------
# replay (eager autograd, one checkpointed step per recorded iteration)
# --------------------------------------------------------------------------

def _safe_sqrt(x):
    """sqrt with a zero (not NaN) gradient at and below 0: the inner where
    keeps the untaken branch's derivative finite."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _vmin(x, c: float):
    """``jnp.minimum(x, c)``: at a tie each side gets half the gradient
    (``torch.clamp_max`` would pass all of it)."""
    return torch.minimum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def _vmax(x, c: float):
    """``jnp.maximum(x, c)``, with the same tie rule as :func:`_vmin`."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def _replay_shade(o, d, tau, row, idx_t, u3, cb, us, *, t_min: float,
                  n_sph_pad: int, with_sph: bool, with_tri: bool,
                  has_motion: bool, blue: torch.Tensor):
    """The shading of one replayed bounce, shared by the two eager replays
    (the scan bodies of pathrec.py:690-830 and diffkernel.py:700-818, term
    for term): re-derive the hit distance, point and facing normal from the
    winner ``row`` [R, 20] (``idx_t`` the recorded indices, -1 a miss), then
    the material scatter from the recorded randoms ``u3`` [R, 3], ``cb``
    and ``us``. Returns (hit point, new direction, attenuation, scattered,
    sky colour along ``d``)."""
    hit = idx_t >= 0
    a = (d * d).sum(-1)

    if with_sph:
        c = row[:, 0:3]
        if has_motion:
            c = c + tau[:, None] * row[:, 3:6]
        rad = row[:, 6]
        co = c - o
        half_b = (d * co).sum(-1)
        c_term = (co * co).sum(-1) - rad * rad
        disc = half_b * half_b - a * c_term
        rt = _safe_sqrt(disc)
        q1 = half_b - rt
        q2 = half_b + rt
        q = torch.where(q1 >= t_min * a, q1, q2)
        t_sph = q / a
    if with_tri:
        v0 = row[:, 0:3]
        pn = torch.linalg.cross(row[:, 3:6] - v0, row[:, 6:9] - v0, dim=-1)
        ndd = (pn * d).sum(-1)
        ndd_safe = torch.where(ndd.abs() > 0.0, ndd, 1.0)
        t_tri = (pn * (v0 - o)).sum(-1) / ndd_safe

    if with_sph and with_tri:
        is_tri = torch.clamp_min(idx_t, 0) >= n_sph_pad
        t_hit = torch.where(is_tri, t_tri, t_sph)
    else:
        t_hit = t_tri if with_tri else t_sph
    ts = torch.where(hit, t_hit, 1.0)
    p = o + ts[:, None] * d

    if with_sph and with_tri:
        nrm = torch.where(is_tri[:, None], pn, p - c)
    else:
        nrm = pn if with_tri else p - c
    ninv = torch.rsqrt(torch.clamp_min((nrm * nrm).sum(-1), 1e-24))
    nrm = nrm * ninv[:, None]
    front = (nrm * d).sum(-1) < 0.0
    nrm = torch.where(front[:, None], nrm, -nrm)

    kind, method, fuzz, ior = row[:, 9], row[:, 10], row[:, 11], row[:, 12]
    isc = 1.0 / row[:, 13]
    par = torch.floor(p * isc[:, None]).sum(-1)
    even_par = par - 2.0 * torch.floor(par * 0.5) < 0.5
    albedo = torch.where(even_par[:, None], row[:, 14:17], row[:, 17:20])

    # ---- diffuse ----
    s = u3 * cb[:, None]
    flip = torch.where((s * nrm).sum(-1) > 0.0, 1.0, -1.0)
    off = torch.where(
        (method == DIFFUSE_UNIT_SPHERE)[:, None], nrm + s,
        torch.where((method == DIFFUSE_UNIT_SPHERE_SURFACE)[:, None],
                    nrm + u3, s * flip[:, None]))
    tg = p + off
    nz_tgt = (tg.abs() <= 1e-8).all(-1)
    tg = torch.where(nz_tgt[:, None], nrm, tg)
    dif = tg - p

    # ---- metallic ----
    ddn = (d * nrm).sum(-1)
    rf = d - 2.0 * ddn[:, None] * nrm
    rinv = torch.rsqrt(torch.clamp_min((rf * rf).sum(-1), 1e-24))
    # jnp.minimum's tie rule: d/d fuzz is 0.5 at fuzz == 1 (clamp_max: 1)
    met = rf * rinv[:, None] + _vmin(fuzz, 1.0)[:, None] * u3
    metal_ok = (met * nrm).sum(-1) > 0.0

    # ---- dielectric ----
    eta = torch.where(front, 1.0 / ior, ior)
    dinv = torch.rsqrt(torch.clamp_min(a, 1e-24))
    ud = d * dinv[:, None]
    cos_t = -(ud * nrm).sum(-1)
    sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
    cannot = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    refl_p = r0 + (1.0 - r0) * om2 * om2 * om
    do_refl = cannot | (refl_p > us)
    pp = (ud + cos_t[:, None] * nrm) * eta[:, None]
    parm = -_safe_sqrt(1.0 - (pp * pp).sum(-1))
    diel = torch.where(do_refl[:, None], rf, pp + parm[:, None] * nrm)

    is_m = kind == MAT_METALLIC
    is_d = kind == MAT_DIELECTRIC
    ndir = torch.where(is_d[:, None], diel,
                       torch.where(is_m[:, None], met, dif))
    att = torch.where(is_d[:, None], 1.0, albedo)
    scattered = (~is_m | metal_ok) & ((ndir * ndir).sum(-1) > 1e-20)

    # ---- the sky along d (the reference's exact formula) ----
    sky_t = 0.5 * (d[:, 1] * dinv + 1.0)
    sky = (1.0 - sky_t[:, None] + blue) * sky_t[:, None]
    return p, ndir, att, scattered, sky


def _replay_step(o, d, tau, thr, out, row, idx_t, aux_t, *, t_min: float,
                 n_sph_pad: int, with_sph: bool, with_tri: bool,
                 has_motion: bool, blue: torch.Tensor):
    """One replay iteration (the scan body of pathrec.py:690-830): respawn
    from the recorded ray, shade the recorded winner ``row`` [R, 20] with
    the recorded randoms (:func:`_replay_shade`), add the sky on a recorded
    miss, and advance the carry under the recorded continue flag."""
    flg = aux_t[_AUX_FLG]
    spawn = (flg == 1.0) | (flg == 3.0)
    cont = flg >= 2.0
    sp3 = spawn[:, None]
    o = torch.where(sp3, aux_t[_AUX_OX:_AUX_OZ + 1].T, o)
    d = torch.where(sp3, aux_t[_AUX_DX:_AUX_DZ + 1].T, d)
    tau = torch.where(spawn, aux_t[_AUX_TAU], tau)
    thr = torch.where(sp3, 1.0, thr)

    p, ndir, att, _, sky = _replay_shade(
        o, d, tau, row, idx_t, aux_t[_AUX_UX:_AUX_UZ + 1].T, aux_t[_AUX_CB],
        aux_t[_AUX_US], t_min=t_min, n_sph_pad=n_sph_pad, with_sph=with_sph,
        with_tri=with_tri, has_motion=has_motion, blue=blue)
    miss = idx_t == -1  # active (>= -1) and no winner
    out = out + torch.where(miss[:, None], thr * sky, 0.0)

    # state updates gated by the RECORDED continue flag
    c3 = cont[:, None]
    thr = torch.where(c3, thr * att, thr)
    o = torch.where(c3, p, o)
    d = torch.where(c3, ndir, d)
    return o, d, tau, thr, out


def replay_pp(scene: Scene, idx: torch.Tensor, aux: torch.Tensor, *,
              t_min: float, init_carry: Optional[torch.Tensor] = None,
              return_final: bool = False):
    """Differentiably re-trace a persistent-path recording
    (pathrec.py:660); returns the per-slot radiance SUM over all samples
    [R, 3] in the scene's dtype (the caller divides by spp).
    ``init_carry`` [_ST_ROWS, R] (o, d, tau, thr) replays a resumed
    recording from a given carry; ``return_final=True`` also returns the
    final carry in that layout. Both are differentiable.

    Control (spawn, hit, continue) comes from the recording; every value is
    re-derived from the raw scene parameters of :func:`_diff_tables`. Each
    step runs under ``torch.utils.checkpoint`` with the gathered winner
    rows computed outside it, so the backward keeps only the rows and the
    carry per step and its recompute launches no gather (JAX's
    ``save_only_these_names("pp_rows")`` policy, pathrec.py:839-846).
    Iterations in which no slot is live are skipped: they change nothing.
    Miss and idle lanes gather row 0 (``idx`` clamped at 0), whose values
    stay under the recorded-control selects."""
    global REPLAY_STEPS
    dt, dev = scene.dtype, idx.device
    tab = _diff_tables(scene)
    with_sph, with_tri = scene.n_spheres > 0, scene.n_triangles > 0
    r = idx.shape[1]
    aux = aux.detach().to(dt)
    ic = (_default_carry(r, dt, dev) if init_carry is None
          else init_carry.to(dt))
    o, d, tau, thr = ic[0:3].T, ic[3:6].T, ic[6], ic[7:10].T
    out = torch.zeros((r, 3), dtype=dt, device=dev)
    step = functools.partial(
        _replay_step, t_min=t_min,
        n_sph_pad=int(scene.sphere_radius.shape[0]) if with_sph else 0,
        with_sph=with_sph, with_tri=with_tri, has_motion=scene.has_motion,
        blue=torch.tensor([0.5, 0.7, 1.0], dtype=dt, device=dev))
    for t in _live_iterations(idx):
        idx_t = idx[t]
        row = gather_rows(tab, torch.clamp_min(idx_t, 0))
        o, d, tau, thr, out = checkpoint(
            step, o, d, tau, thr, out, row, idx_t, aux[t],
            use_reentrant=False, preserve_rng_state=False)
        REPLAY_STEPS += 1
    if return_final:
        return out, torch.cat([o.T, d.T, tau[None], thr.T], dim=0)
    return out


def _live_iterations(idx: torch.Tensor) -> list:
    """Recorded iterations in which some slot is live (idx >= -1); the
    others change nothing."""
    return torch.nonzero((idx >= -1).any(dim=1)).flatten().tolist()


# --------------------------------------------------------------------------
# fused replay: the step, plain versions, kernel wrappers, autograd
# --------------------------------------------------------------------------

class _ReplayCfg(NamedTuple):
    """Static configuration of the fused replay (JAX's ``kcfg``)."""

    t_min: float
    n_sph_pad: int     # sphere rows of the table; triangles follow
    with_sph: bool
    with_tri: bool
    has_motion: bool


def _replay_cfg(scene: Scene, t_min: float) -> _ReplayCfg:
    return _ReplayCfg(
        t_min=float(t_min),
        n_sph_pad=int(scene.sphere_radius.shape[0]) if scene.n_spheres else 0,
        with_sph=scene.n_spheres > 0, with_tri=scene.n_triangles > 0,
        has_motion=bool(scene.has_motion))


def _pp_step(st, row, aux, hit, miss, is_tri, *, has_motion: bool,
             with_sph: bool, with_tri: bool, t_min: float):
    """One fused replay iteration on [R] components, term for term
    ``_pp_step_c`` (pathrec.py:1325-1506): ``st`` the 10 carry components
    BEFORE respawn, ``row`` the 20 winner-row components, ``aux`` the 13
    recorded aux rows, ``hit``/``miss``/``is_tri`` masks from the raw index.
    Returns (new carry, radiance to add), tuples of [R] tensors.

    Unlike :func:`_replay_step`, it keeps the fused kernels' raw-index
    semantics: miss and idle lanes read an all-zero row, ``is_tri`` is not
    clamped, ``ior`` and the checker scale are floored at 1e-6 so a zero
    row's 1/x stays finite, and spawn is read from the flag's low bit."""
    ox, oy, oz, dx, dy, dz, tau, thx, thy, thz = st
    ux, uy, uz, cb, us, sox, soy, soz, sdx, sdy, sdz, stau, flg = aux
    spawn = flg - 2.0 * torch.floor(flg * 0.5) >= 0.5
    cont = flg >= 2.0

    ox = torch.where(spawn, sox, ox)
    oy = torch.where(spawn, soy, oy)
    oz = torch.where(spawn, soz, oz)
    dx = torch.where(spawn, sdx, dx)
    dy = torch.where(spawn, sdy, dy)
    dz = torch.where(spawn, sdz, dz)
    tau = torch.where(spawn, stau, tau)
    thx = torch.where(spawn, 1.0, thx)
    thy = torch.where(spawn, 1.0, thy)
    thz = torch.where(spawn, 1.0, thz)

    a = dx * dx + dy * dy + dz * dz

    if with_sph:
        cx, cy, cz = row[0], row[1], row[2]
        if has_motion:
            cx = cx + tau * row[3]
            cy = cy + tau * row[4]
            cz = cz + tau * row[5]
        rad = row[6]
        cox, coy, coz = cx - ox, cy - oy, cz - oz
        half_b = dx * cox + dy * coy + dz * coz
        c_term = cox * cox + coy * coy + coz * coz - rad * rad
        disc = half_b * half_b - a * c_term
        rt = _safe_sqrt(disc)
        q1 = half_b - rt
        q2 = half_b + rt
        q = torch.where(q1 >= t_min * a, q1, q2)
        t_sph = q / a
    if with_tri:
        v0x, v0y, v0z = row[0], row[1], row[2]
        e1x, e1y, e1z = row[3] - v0x, row[4] - v0y, row[5] - v0z
        e2x, e2y, e2z = row[6] - v0x, row[7] - v0y, row[8] - v0z
        pnx = e1y * e2z - e1z * e2y
        pny = e1z * e2x - e1x * e2z
        pnz = e1x * e2y - e1y * e2x
        ndd = pnx * dx + pny * dy + pnz * dz
        ndd_safe = torch.where(ndd.abs() > 0.0, ndd, 1.0)
        t_tri = (pnx * (v0x - ox) + pny * (v0y - oy)
                 + pnz * (v0z - oz)) / ndd_safe

    if with_sph and with_tri:
        t_hit = torch.where(is_tri, t_tri, t_sph)
    else:
        t_hit = t_tri if with_tri else t_sph
    ts = torch.where(hit, t_hit, 1.0)
    px_ = ox + ts * dx
    py_ = oy + ts * dy
    pz_ = oz + ts * dz

    if with_sph and with_tri:
        nx = torch.where(is_tri, pnx, px_ - cx)
        ny = torch.where(is_tri, pny, py_ - cy)
        nz = torch.where(is_tri, pnz, pz_ - cz)
    elif with_tri:
        nx, ny, nz = pnx, pny, pnz
    else:
        nx, ny, nz = px_ - cx, py_ - cy, pz_ - cz
    ninv = torch.rsqrt(_vmax(nx * nx + ny * ny + nz * nz, 1e-24))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    front = nx * dx + ny * dy + nz * dz < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    kind, method, fuzz = row[9], row[10], row[11]
    ior = _vmax(row[12], 1e-6)
    isc = 1.0 / _vmax(row[13], 1e-6)
    par = (torch.floor(px_ * isc) + torch.floor(py_ * isc)
           + torch.floor(pz_ * isc))
    even_par = par - 2.0 * torch.floor(par * 0.5) < 0.5
    alr = torch.where(even_par, row[14], row[17])
    alg = torch.where(even_par, row[15], row[18])
    alb = torch.where(even_par, row[16], row[19])

    # ---- diffuse ----
    sx, sy, sz = ux * cb, uy * cb, uz * cb
    flip = torch.where(sx * nx + sy * ny + sz * nz > 0.0, 1.0, -1.0)
    m0 = method == DIFFUSE_UNIT_SPHERE
    m1 = method == DIFFUSE_UNIT_SPHERE_SURFACE
    offx = torch.where(m0, nx + sx, torch.where(m1, nx + ux, sx * flip))
    offy = torch.where(m0, ny + sy, torch.where(m1, ny + uy, sy * flip))
    offz = torch.where(m0, nz + sz, torch.where(m1, nz + uz, sz * flip))
    tgx, tgy, tgz = px_ + offx, py_ + offy, pz_ + offz
    nz_tgt = ((tgx.abs() <= 1e-8) & (tgy.abs() <= 1e-8)
              & (tgz.abs() <= 1e-8))
    tgx = torch.where(nz_tgt, nx, tgx)
    tgy = torch.where(nz_tgt, ny, tgy)
    tgz = torch.where(nz_tgt, nz, tgz)
    difx, dify, difz = tgx - px_, tgy - py_, tgz - pz_

    # ---- metallic ----
    ddn = dx * nx + dy * ny + dz * nz
    rfx = dx - 2.0 * ddn * nx
    rfy = dy - 2.0 * ddn * ny
    rfz = dz - 2.0 * ddn * nz
    rinv = torch.rsqrt(_vmax(rfx * rfx + rfy * rfy + rfz * rfz, 1e-24))
    fz = _vmin(fuzz, 1.0)
    mex = rfx * rinv + fz * ux
    mey = rfy * rinv + fz * uy
    mez = rfz * rinv + fz * uz

    # ---- dielectric ----
    eta = torch.where(front, 1.0 / ior, ior)
    dinv = torch.rsqrt(_vmax(a, 1e-24))
    udx, udy, udz = dx * dinv, dy * dinv, dz * dinv
    cos_t = -(udx * nx + udy * ny + udz * nz)
    sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
    cannot = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    refl_p = r0 + (1.0 - r0) * om2 * om2 * om
    do_refl = cannot | (refl_p > us)
    ppx = (udx + cos_t * nx) * eta
    ppy = (udy + cos_t * ny) * eta
    ppz = (udz + cos_t * nz) * eta
    parm = -_safe_sqrt(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))
    dlx = torch.where(do_refl, rfx, ppx + parm * nx)
    dly = torch.where(do_refl, rfy, ppy + parm * ny)
    dlz = torch.where(do_refl, rfz, ppz + parm * nz)

    is_m = kind == float(MAT_METALLIC)
    is_d = kind == float(MAT_DIELECTRIC)
    ndirx = torch.where(is_d, dlx, torch.where(is_m, mex, difx))
    ndiry = torch.where(is_d, dly, torch.where(is_m, mey, dify))
    ndirz = torch.where(is_d, dlz, torch.where(is_m, mez, difz))
    atr = torch.where(is_d, 1.0, alr)
    atg = torch.where(is_d, 1.0, alg)
    atb = torch.where(is_d, 1.0, alb)

    # ---- recorded miss -> sky (the reference's exact formula) ----
    sky_t = 0.5 * (dy * dinv + 1.0)
    skyr = (1.0 - sky_t + 0.5) * sky_t
    skyg = (1.0 - sky_t + 0.7) * sky_t
    skyb = (1.0 - sky_t + 1.0) * sky_t
    out_add = (torch.where(miss, thx * skyr, 0.0),
               torch.where(miss, thy * skyg, 0.0),
               torch.where(miss, thz * skyb, 0.0))

    # state update gated by the RECORDED continue flag
    new_st = (torch.where(cont, px_, ox), torch.where(cont, py_, oy),
              torch.where(cont, pz_, oz),
              torch.where(cont, ndirx, dx), torch.where(cont, ndiry, dy),
              torch.where(cont, ndirz, dz), tau,
              torch.where(cont, thx * atr, thx),
              torch.where(cont, thy * atg, thy),
              torch.where(cont, thz * atb, thz))
    return new_st, out_add


def _step_inputs(rowsT, aux, idx, t: int, cfg: _ReplayCfg):
    """Iteration ``t``'s rows [20, R], aux [13, R] and masks."""
    r = idx.shape[1]
    i = idx[t]
    return (rowsT[:, t * r:(t + 1) * r], aux[t], i >= 0, i == -1,
            i >= cfg.n_sph_pad)


def _step_kw(cfg: _ReplayCfg) -> dict:
    return dict(has_motion=cfg.has_motion, with_sph=cfg.with_sph,
                with_tri=cfg.with_tri, t_min=cfg.t_min)


def _fused_fwd_reference(rowsT, aux, idx, st0, cfg: _ReplayCfg):
    """Plain version of the forward kernel: ``rowsT`` [20, K*R] (iteration
    t's rows in columns t*R..), ``aux`` [K, 13, R], ``idx`` [K, R] i32,
    ``st0`` [10, R] -> (radiance sums [3, R], final carry [10, R], entry
    carries [10, K, R]). Iterations with no live slot are skipped, as JAX
    skips them (pathrec.py:1537); their entry carries stay zero."""
    k_it, r = idx.shape
    st = tuple(st0.unbind())
    out = [torch.zeros_like(st0[0]) for _ in range(3)]
    st_entry = st0.new_zeros((_ST_ROWS, k_it, r))
    for t in _live_iterations(idx):
        st_entry[:, t] = torch.stack(st)
        row, aux_t, hit, miss, is_tri = _step_inputs(rowsT, aux, idx, t, cfg)
        st, add = _pp_step(st, tuple(row.unbind()), tuple(aux_t.unbind()),
                           hit, miss, is_tri, **_step_kw(cfg))
        out = [o + a for o, a in zip(out, add)]
    return torch.stack(out), torch.stack(st), st_entry


def _fused_bwd_reference(rowsT, aux, idx, st_entry, g_out, g_fin,
                         cfg: _ReplayCfg):
    """Plain version of the backward kernel: walks the live iterations in
    reverse, recomputes :func:`_pp_step` from the saved entry carry and
    applies its vector-Jacobian product by ``torch.autograd.grad`` with the
    cotangents (carry, ``g_out``), as JAX applies ``jax.vjp`` inside its
    kernel (pathrec.py:1606-1615). Returns (row cotangents [20, K*R] in
    ``rowsT``'s layout, zero on idle iterations; initial-carry cotangent
    [10, R])."""
    r = idx.shape[1]
    drows = torch.zeros_like(rowsT)
    d_st = g_fin.clone()
    for t in reversed(_live_iterations(idx)):
        row, aux_t, hit, miss, is_tri = _step_inputs(rowsT, aux, idx, t, cfg)
        with torch.enable_grad():
            st = st_entry[:, t].detach().requires_grad_(True)
            row = row.detach().requires_grad_(True)
            new_st, add = _pp_step(tuple(st.unbind()), tuple(row.unbind()),
                                   tuple(aux_t.unbind()), hit, miss, is_tri,
                                   **_step_kw(cfg))
            d_st, d_row = torch.autograd.grad(
                new_st + add, (st, row),
                grad_outputs=tuple(d_st.unbind()) + tuple(g_out.unbind()))
        drows[:, t * r:(t + 1) * r] = d_row
    return drows, d_st


def _check_replay(rowsT, aux, idx, st0):
    k_it, r = idx.shape
    want = (("rowsT", rowsT, (20, k_it * r)),
            ("aux", aux, (k_it, _AUX_ROWS, r)), ("st0", st0, (_ST_ROWS, r)))
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.dtype != torch.float32 or t.device != idx.device:
            raise ValueError(f"{name} must be f32 on {idx.device}, got "
                             f"{t.dtype} on {t.device}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")


def _replay_args(cfg: _ReplayCfg, dev) -> tuple:
    return (cfg.n_sph_pad, int(cfg.with_sph), int(cfg.with_tri),
            int(cfg.has_motion), cfg.t_min,
            torch.cuda.current_stream(dev).cuda_stream)


def _fused_fwd(rowsT, aux, idx, st0, cfg: _ReplayCfg):
    """Forward wrapper: the CUDA kernel for CUDA tensors (or raise), the
    plain version for CPU tensors. Same arguments and results as
    :func:`_fused_fwd_reference`; the kernel writes entry carries only on
    live lanes (idx >= -1)."""
    _check_replay(rowsT, aux, idx, st0)
    if idx.device.type == "cpu":
        return _fused_fwd_reference(rowsT, aux, idx, st0, cfg)
    if idx.device.type != "cuda":
        raise ValueError(f"no replay kernel for device {idx.device}")
    rowsT, aux, idx, st0 = (t.contiguous() for t in (rowsT, aux, idx, st0))
    (k_it, r), dev = idx.shape, idx.device
    out = torch.empty((3, r), dtype=torch.float32, device=dev)
    fin = torch.empty((_ST_ROWS, r), dtype=torch.float32, device=dev)
    st_entry = torch.empty((_ST_ROWS, k_it, r), dtype=torch.float32,
                           device=dev)
    lib, _ = _build.load()
    with torch.cuda.device(dev):
        err = lib.rayz_replay_fwd(
            rowsT.data_ptr(), aux.data_ptr(), idx.data_ptr(), st0.data_ptr(),
            k_it, r, out.data_ptr(), fin.data_ptr(), st_entry.data_ptr(),
            *_replay_args(cfg, dev))
    _build.check(lib, err, "replay_fwd")
    LAUNCHES["replay_fwd"] += 1
    return out, fin, st_entry


def _fused_bwd(rowsT, aux, idx, st_entry, g_out, g_fin, cfg: _ReplayCfg):
    """Backward wrapper: the CUDA kernel (hand-derived adjoint) for CUDA
    tensors (or raise), the plain version for CPU tensors. Same arguments
    and results as :func:`_fused_bwd_reference`."""
    k_it, r = idx.shape
    _check_replay(rowsT, aux, idx, g_fin)
    if idx.device.type == "cpu":
        return _fused_bwd_reference(rowsT, aux, idx, st_entry, g_out, g_fin,
                                    cfg)
    if idx.device.type != "cuda":
        raise ValueError(f"no replay kernel for device {idx.device}")
    if st_entry.shape != (_ST_ROWS, k_it, r) or g_out.shape != (3, r):
        raise ValueError(f"st_entry must be [10, {k_it}, {r}] and g_out "
                         f"[3, {r}]")
    rowsT, aux, idx, st_entry, g_out, g_fin = (
        t.contiguous() for t in (rowsT, aux, idx, st_entry, g_out.float(),
                                 g_fin.float()))
    dev = idx.device
    drows = torch.empty_like(rowsT)
    dst0 = torch.empty((_ST_ROWS, r), dtype=torch.float32, device=dev)
    lib, _ = _build.load()
    with torch.cuda.device(dev):
        err = lib.rayz_replay_bwd(
            rowsT.data_ptr(), aux.data_ptr(), idx.data_ptr(),
            st_entry.data_ptr(), g_out.data_ptr(), g_fin.data_ptr(), k_it, r,
            drows.data_ptr(), dst0.data_ptr(), *_replay_args(cfg, dev))
    _build.check(lib, err, "replay_bwd")
    LAUNCHES["replay_bwd"] += 1
    return drows, dst0


class _FusedReplay(torch.autograd.Function):
    """(out [3, R], fin [10, R]) of the fused replay, differentiable in the
    gathered rows and the initial carry (JAX's ``_fused_replay`` custom
    VJP, pathrec.py:1627-1745). The recorded aux and indices get no
    gradient. An unused output's cotangent arrives as zeros (autograd
    materializes it), as the last pass's final carry does."""

    @staticmethod
    def forward(ctx, rowsT, aux, idx, st0, cfg):
        out, fin, st_entry = _fused_fwd(rowsT, aux, idx, st0, cfg)
        ctx.save_for_backward(rowsT, aux, idx, st_entry)
        ctx.cfg = cfg
        return out, fin

    @staticmethod
    def backward(ctx, g_out, g_fin):
        rowsT, aux, idx, st_entry = ctx.saved_tensors
        drows, dst0 = _fused_bwd(rowsT, aux, idx, st_entry, g_out, g_fin,
                                 ctx.cfg)
        return drows, None, None, dst0, None


def replay_pp_fused(scene: Scene, idx: torch.Tensor, aux: torch.Tensor, *,
                    t_min: float, init_carry: Optional[torch.Tensor] = None,
                    return_final: bool = False):
    """Fused-kernel equivalent of :func:`replay_pp` (pathrec.py:1756): the
    same estimator and gradients, f32 only. One :func:`gather_rows_T` over
    the RAW indices of all iterations (miss and idle lanes get zero rows),
    then the replay kernels (:class:`_FusedReplay`). Returns the radiance
    sums [R, 3], and with ``return_final=True`` also the final carry
    [10, R]; ``init_carry`` [10, R] replays a resumed recording."""
    k_it, r = idx.shape
    tab = _diff_tables(scene).float()
    rowsT = gather_rows_T(tab, idx.reshape(-1))
    st0 = (_default_carry(r, device=idx.device) if init_carry is None
           else init_carry.float())
    out, fin = _FusedReplay.apply(rowsT, aux.detach().float(), idx, st0,
                                  _replay_cfg(scene, t_min))
    if return_final:
        return out.T, fin
    return out.T


# --------------------------------------------------------------------------
# the compacted pass schedule and the image-level entry point
# --------------------------------------------------------------------------

def render_diff_pp_flat(scene: Scene, camera: Camera, seed: int, px, py, *,
                        spp: int, max_depth: int, t_min: float, jitter: bool,
                        iters: Optional[int] = None,
                        return_leftover: bool = False,
                        fused: Optional[bool] = None,
                        compact: Optional[bool] = None):
    """Record+replay radiance of the flat pixel list (int32 coordinates
    ``px``/``py`` [n]) -> [n, 3], spp-averaged (pathrec.py:855).

    ``iters=None`` runs the :func:`default_schedule` of recording passes: a
    lean full-width pass, then passes that gather the unfinished slots into
    compact arrays and RESUME their recording (recorder state and the
    replay's carry hand over; the carry differentiably) with budgets
    summing to ``spp * max_depth``; each pass's radiance is added back into
    its original slots. An explicit ``iters`` keeps one pass; with
    ``compact=True`` it adds one resume pass of R/8 slots.
    ``return_leftover=True`` also returns the number of samples left
    unfinished (0 unless more slots straggle than a pass holds).

    ``fused=None`` resolves to ``scene.dtype == torch.float32`` as in JAX
    (pathrec.py:920-921): f32 scenes replay through the fused kernels
    (:func:`replay_pp_fused`), f64 scenes through the eager
    :func:`replay_pp`, which ``fused=False`` also selects."""
    if fused is None:
        fused = scene.dtype == torch.float32
    k_exh = spp * max_depth
    n_px = px.shape[0]
    block, r_pad = slot_layout(n_px)
    if iters is None:
        if compact is None:
            compact = True
        schedule = (default_schedule(spp, max_depth, r_pad, block)
                    if compact else [(default_iters(spp, max_depth), r_pad)])
    else:
        schedule = [(iters, r_pad)]
        if compact and iters < k_exh:
            cap = max(block, r_pad // 8)
            cap = max(block, min(-(-cap // block) * block, r_pad))
            schedule.append((k_exh - iters, cap))
    dev = scene.device
    pix = torch.full((r_pad,), -1, dtype=torch.int32, device=dev)
    pix[:n_px] = (py.long() * camera.width + px.long()).to(torch.int32)

    def _replay(idx_, aux_, **kw):
        rep = replay_pp_fused if fused else replay_pp
        return rep(scene, idx_, aux_, t_min=t_min, **kw)

    rec_kw = dict(spp=spp, max_depth=max_depth, t_min=t_min, jitter=jitter)
    n_pass = len(schedule)
    rec = record_pp(scene, camera, seed, pix, iters=schedule[0][0],
                    want_state=n_pass > 1, **rec_kw)
    idx, aux, left = rec[:3]
    if n_pass == 1:
        rad = _replay(idx, aux)
        leftover = left[:n_px].sum()
    else:
        # each resume pass gathers the previous pass's unfinished slots
        # (recorder state + the replay's final carry) into a compact array
        # and adds its radiance back into the original slots; invalid and
        # overflowing slots go to a spare row r_pad (torch scatters wrap or
        # assert on out-of-range indices, where JAX's drop them)
        rad, fin_cur = _replay(idx, aux, return_final=True)
        rad = torch.cat([rad, rad.new_zeros((1, 3))])
        st_cur, cnt_cur, from_cur = rec[3]
        left_cur, pix_cur, map_cur = left, pix, None
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        for j, (kj, capj) in enumerate(schedule[1:]):
            last = j == n_pass - 2
            strag = left_cur > 0
            pos = torch.cumsum(strag, 0, dtype=torch.int64) - 1
            dest = torch.where(strag & (pos < capj), pos, capj)
            scat = torch.full((capj + 1,), -1, dtype=torch.int64, device=dev)
            scat[dest] = torch.arange(left_cur.shape[0], device=dev)
            scat = scat[:capj]
            valid_c = scat >= 0
            safe = torch.clamp_min(scat, 0)
            orig = safe if map_cur is None else map_cur[safe]
            cpix = torch.where(valid_c, pix_cur[safe], -1).to(torch.int32)
            cst = torch.where(valid_c, st_cur[:, safe], 0.0).contiguous()
            # invalid compact slots: zero counters -> idle from iteration 0
            ccnt = torch.where(valid_c, cnt_cur[:, safe], 0).to(torch.int32)
            cfrom = torch.where(valid_c, from_cur[safe], -1).to(torch.int32)
            st0 = torch.where(valid_c, fin_cur[:, safe],
                              _default_carry(capj, fin_cur.dtype, dev))
            recj = record_pp(scene, camera, seed, cpix, iters=kj,
                             init_state=(cst, ccnt.contiguous(),
                                         cfrom.contiguous()),
                             want_state=not last, **rec_kw)
            idxj, auxj, leftj = recj[:3]
            if last:
                radj = _replay(idxj, auxj, init_carry=st0)
            else:
                radj, fin_cur = _replay(idxj, auxj, init_carry=st0,
                                        return_final=True)
                st_cur, cnt_cur, from_cur = recj[3]
            rad = rad.index_add(0, torch.where(valid_c, orig, r_pad), radj)
            overflow = overflow + torch.where(strag & (pos >= capj),
                                              left_cur, 0).sum()
            left_cur, pix_cur, map_cur = leftj, cpix, orig
        leftover = left_cur.sum() + overflow
    img = rad[:n_px].to(camera.dtype) / float(spp)
    if return_leftover:
        return img, leftover
    return img


def render_diff_pp(scene: Scene, camera: Camera, seed: int,
                   config: RenderConfig = RenderConfig(), *,
                   iters: Optional[int] = None, return_leftover: bool = False,
                   compact: Optional[bool] = None):
    """Differentiable [H, W, 3] render by persistent-path record/replay
    (pathrec.py:1020): the forward megakernel's estimator, composing with
    autograd in the scene's float leaves. Options as
    :func:`render_diff_pp_flat`; with ``return_leftover=True`` returns
    ``(image, leftover)``.

    It records the paths the megakernel traces for the same seed. The
    replay re-derives each bounce in its own rounding, so a near-tie there
    (a glass coin, a grazing hit or reflection) can part from the recorded
    path: such a pixel differs from the megakernel's while its block means
    agree, as with :func:`rayz_tpu_torch.ops.diffkernel.render_diff`
    (PERF.md)."""
    if not supports_scene(scene):
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
    h, w = camera.height, camera.width
    px, py = _pixel_grid(camera)
    res = render_diff_pp_flat(
        scene, camera, seed, px, py, spp=config.spp,
        max_depth=config.max_depth, t_min=config.t_min, jitter=config.jitter,
        iters=iters, return_leftover=return_leftover, compact=compact)
    if return_leftover:
        flat, left = res
        return flat.reshape(h, w, 3), left
    return res.reshape(h, w, 3)
