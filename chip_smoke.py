"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (nvcc, sm_90a), prints
the resident sphere sweep's registers and SASS instructions per column,
checks each kernel against its plain torch version on the card (the
resident megakernel and the recorder, whose packed FMA sweep may part from
the plain arithmetic at a near tie, on at least 99.9% of pixels and
lane-iterations, every difference explained by ``ops/sweep.py``'s rule),
and drives the port's main paths: on the flagship ``random_bouncing``
scene at 512x512, depth 32, the forward render (64 spp through
``render_fast(engine="auto")``: one queue launch and its fold, with the
queue's idle lanes, re-sweeps and atomics per item), the
``recorded-pp`` train step (bench.py's ``fwdbwd`` shape: two value-and-
gradient micro-batches of 32 spp through the recorder, the gathers and the
fused replay kernels, then two ``make_train_step`` steps) and the same step
through ``engine="recorded"`` (the bounce-indexed record kernel, the
gathers and the eager replay); the forward render of large scenes,
``render_fast(engine="auto")`` on ``sphere_field`` at 100k, 10k and 64k
spheres (512x288, 16 spp, depth 8: scripts/bench_culling.py's defaults),
which resolves to the wavefront engine, then the streamed megakernel on the
100k scene; one ``engine="recorded"`` value and gradient on the 100k
scene through the streamed record kernel; and the dense integrator, plain
torch (the flagship at 2 spp through ``render_fast(engine="xla")`` against
the megakernel's image and its peak memory at 2 and 8 spp, one
``engine="dense"`` value and gradient, a nested-checker scene through
``"auto"``, ``fit`` with its defaults); then the pixel-sharded paths, two
ranks sharing the card over gloo (the flagship through
``render_megakernel_sharded``, each rank's queue launch at its pixel
offset, the image assembled on rank 0 against the one-process render bit
for bit, and a full-width ``"recorded-pp"`` mesh train step against this
process's gradients), then a world of one over NCCL; then the scripts:
``rayz_tpu_torch.scripts.gpu_check``'s whole list (each stochastic engine
and table mode at one seed against the dense integrator at another, with
the oracle's noise floor, and the three gradient lines) at 64 wide, 256
spp, and a row of each bench script (``bench_configs``' first config,
``bench_culling``'s 10k row), every kernel of the port launched. The
flagship's queue launch is also split in two at a pixel offset and held
against the one launch. The gather forward is held bit for bit against its plain version and timed at
the shape the train step launches it. Before them the wavefront kernel
is held against its plain version launch by launch in its three table
modes, the record kernel in its two, the megakernel's culled and streamed
modes against the full-table megakernel and their plain versions, the two
engines against each other, and the new paths against the golden image.
For each main path
it resets the launch counters, runs it, and shows that it went through its
kernels; then it times it (the train step also once through the eager
replay, for comparison). One line per phase; the line before the last is a
JSON summary of the kernels (times, launches, the least time the card could
take from this run's inputs, and a PyTorch call's time where one computes
the same function), the last line is ``{"ok": true, "device": {...}}``. Any
failed phase raises, so the script exits non-zero and prints no result; so
does a machine without a GPU. Imports torch, numpy and ``rayz_tpu_torch``
only (never JAX).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.io.image import read_ppm, write_ppm
from rayz_tpu_torch.ops import _build, diffkernel as dk
from rayz_tpu_torch.ops import megakernel as mk, pathrec as pr, rng
from rayz_tpu_torch.ops import sweep as sw
from rayz_tpu_torch.ops import tables as tb, wavefront as wf
from rayz_tpu_torch.scripts import bench_configs, bench_culling, card
from rayz_tpu_torch.scripts import gpu_check
from rayz_tpu_torch.scripts.gpu_check import forced_stream
# shared with tune ab: the gathers' shapes and synthetic indices,
# the sweep's ptxas and SASS facts, the wavefront's per-launch times
from rayz_tpu_torch.tune import (GATHER_BWD_SHAPES, GATHER_FWD_SHAPES,
                                 gather_indices, ptxas_facts, sass_sweep,
                                 wavefront_launches)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden_deterministic.ppm")

# tolerances (see PERF.md "Port on H100" for the measured values)
GOLDEN_MAX_STEP, GOLDEN_MAX_FRAC = 1, 0.005  # tests/test_golden.py allowance
STOCHASTIC_ATOL = 1e-4      # per channel, real random draws ...
STOCHASTIC_MAX_FRAC = 0.01  # ... on all but this share of channels
BLOCK_MEAN_ATOL = 0.01      # 8x8 block means, real random draws

RECORD_AUX_ATOL = 1e-6      # recorder kernel vs plain, real random draws
MATCH_FRAC = 0.999          # share of active lane-iterations with equal idx
GATHER_BWD_RTOL = 1e-4      # of the sum of |g| over each table row's rays
# pixel_loss and its gradients through the fused replay, kernels vs plain
# versions, relative to each field's largest entry: the hand-derived
# adjoint sums its terms in another order than autograd
GRAD_RTOL = 5e-4
# The fused replay vs the eager replay (the other formulation of the same
# step, as tests/test_pathrec.py's fused-vs-scan check, whose bound this
# is): loss and each gradient field within EAGER_TOL * max(1, largest
# |eager|), the images within STOCHASTIC_ATOL on all but
# STOCHASTIC_MAX_FRAC of the channels. The two formulations round
# differently on the card (the eager step reduces its dot products with
# torch.sum), and a ray that re-hits the radius-1000 ground it left picks
# its root at the rounding level, so such a pixel may differ by ~0.2.
EAGER_TOL = 5e-4
# Fused replay kernels vs plain versions, real draws, slot by slot: the
# radiance, final and entry carries within REPLAY_RTOL * max(1, |plain|)
# (each operation rounds as torch's does; carries reach |x| ~ 1000 on the
# ground spheres), the row and initial-carry cotangents within
# REPLAY_GRAD_RTOL of the largest entry of their group (geometry rows 0-8,
# material rows 9-19; origin, direction, time, throughput; the bound of
# tests/test_pathrec.py's fused-vs-scan check). At most REPLAY_MAX_FRAC of
# the slots with a pixel may fall outside: a ray that re-hits the surface
# it left (a self-hit on a ground sphere of radius 1000, which the
# recording kept) chooses its root at the rounding level, and a long chain
# of bounces amplifies the adjoint's other summation order; both packages
# see such slots against float64 (0.2% of the slots at the first pass's
# config in a CPU emulation of the kernels, which on the other slots were
# as close to float64 as the plain version).
REPLAY_RTOL = 1e-4
REPLAY_GRAD_RTOL = 5e-4
REPLAY_MAX_FRAC = 5e-3

# The wavefront kernel vs its plain version on the same inputs, launch by
# launch: the share of rays whose state, alive flag and radiance are bit-
# identical. Only a ray whose sweep meets an exact tie between two columns
# may differ (the bound tests change the order the columns are met in).
WF_STATE_MATCH = 0.9999
# Two table modes, or the two engines, for the same seed: the share of
# pixels that are identical (the same paths, up to exact ties).
PIXEL_MATCH = 0.999
# The resident queue kernel (the packed FMA sweep with the narrow grazing
# band) against the plain full-table render of sphere_field 3,000
# (coordinates to 55, radii 0.08: its float32 c_term is at the rounding
# level of the small spheres, so near ties are common): the share of
# identical pixels, between the sound reading (99.67% on the H100) and
# what a wrong sweep gives; every differing pixel is also explained.
FIELD_PIXEL_MATCH = 0.99

# The H100 SXM's published peaks (NVIDIA's data sheet): FP32 outside
# the tensor cores, and device memory.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The fewest FP32 operations of one primitive test, from csrc/common.cuh (a
# square root counts as one): a sphere (+ its motion), a triangle's plane
# test.
SPHERE_OPS, MOTION_OPS, TRI_OPS = 20, 10, 14

LARGE = dict(width=512, spp=16, depth=8)  # scripts/bench_culling.py:58-60
LARGE_NS = (100_000, 10_000, 64_000)     # the first is the main path

FLAGSHIP = dict(width=512, height=512, spp=64, depth=32)
RUNS = 5
MICRO_SPP = 32   # the train step's micro-batch (bench.py MICRO)
TRAIN_RUNS = 3


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


@contextlib.contextmanager
def plain_version():
    """Route the megakernel's launches (the queue in every table mode and
    its fold) to their plain torch versions (on the same CUDA tensors) for
    a comparison run."""
    names = ("_queue", "_fold")
    kernels = [getattr(mk, n) for n in names]
    for n in names:
        setattr(mk, n, getattr(mk, n + "_reference"))
    try:
        yield
    finally:
        for n, k in zip(names, kernels):
            setattr(mk, n, k)


@contextlib.contextmanager
def plain_pathrec():
    """Route the recorder's, the gathers' and the fused replay's launches to
    their plain torch versions (on the same CUDA tensors) for a comparison
    run."""
    names = ("_record_slots", "_gather_fwd", "_gather_bwd", "_fused_fwd",
             "_fused_bwd")
    kernels = [getattr(pr, n) for n in names]
    for n in names:
        setattr(pr, n, getattr(pr, n + "_reference"))
    try:
        yield
    finally:
        for n, k in zip(names, kernels):
            setattr(pr, n, k)


@contextlib.contextmanager
def eager_replay():
    """Route the f32 default of render_diff_pp_flat (the fused replay) to
    the eager replay, which takes the same arguments, for one timing of the
    unfused train step."""
    fused = pr.replay_pp_fused
    pr.replay_pp_fused = pr.replay_pp
    try:
        yield
    finally:
        pr.replay_pp_fused = fused


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn`` over ``n`` calls after a warm-up
    call, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def slot_pix(n: int, r_pad: int, dev) -> torch.Tensor:
    """Flat pixel ids of n pixels in r_pad slots, -1 past the image."""
    pix = torch.arange(r_pad, dtype=torch.int32, device=dev)
    return torch.where(pix < n, pix, -1)


def record_both(scene, cam, seed, pix, **kw):
    """The recorder through its kernel and through its plain version."""
    k = pr.record_pp(scene, cam, seed, pix, **kw)
    with plain_pathrec():
        p = pr.record_pp(scene, cam, seed, pix, **kw)
    torch.cuda.synchronize()
    return k, p


def active_match(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of lane-iterations active in either recording (idx >= -1)
    whose winner index agrees."""
    act = (a >= -1) | (b >= -1)
    return float((a == b)[act].double().mean())


def record_agreement(k, p, scene, cam, seed, pix, what: str, **kw) -> dict:
    """The recorder kernel's recording ``k`` against the plain recorder's
    ``p`` of the same slots, both fresh or both resumed from the
    ``init_state`` in ``kw`` (record_pp's idx, aux, leftover, state):
    the share of active lane-iterations with equal indices (at least
    MATCH_FRAC); every slot whose indices differ explained by the near-tie
    rule (``sweep.explain``) at its first difference; the aux rows equal
    within RECORD_AUX_ATOL on every iteration before a slot's first
    difference; leftover and state equal on the slots that never differ."""
    frac = active_match(k[0], p[0])
    part = k[0] != p[0]
    differ = part.any(dim=0)
    first = torch.where(differ, part.int().argmax(dim=0), part.shape[0])
    before = (torch.arange(part.shape[0], device=part.device)[:, None]
              < first[None, :])
    err = float(((k[1] - p[1]).abs().amax(dim=1) * before).max())
    same = ~differ
    rest = torch.equal(k[2][same], p[2][same])
    if len(k) > 3 and k[3] is not None:
        rest = rest and all(torch.equal(a[..., same], b[..., same])
                            for a, b in zip(k[3], p[3]))
    ex = sw.explain(scene, cam, seed, pix, k[0], p[0], p[1], **kw)
    n_diff = int(differ.sum())
    explained = ex is None or bool(ex.all())
    if frac < MATCH_FRAC or not explained or err > RECORD_AUX_ATOL or not rest:
        raise AssertionError(
            f"{what}: idx agree on {frac:.6%} of active lane-iterations, "
            f"{n_diff} slots differ ({0 if ex is None else int(ex.sum())} "
            f"explained), aux max abs {err:.3g} before the first difference, "
            f"leftover/state of the other slots equal: {rest}")
    return dict(frac=frac, slots=n_diff, err=err)


def explain_pixels(scene, cam, seed: int, cfg, img, ref, what: str,
                   min_share: float = PIXEL_MATCH) -> dict:
    """The resident megakernel's image ``img`` against ``ref`` (its plain
    version's, or another schedule's) for the same seed: the share of
    pixels bit-identical (at least ``min_share``), and for each pixel that
    differs, its samples recorded by the recorder kernel (the same sweep
    and draws, so the same paths) and the plain recorder: the two
    recordings must differ for that pixel, and the near-tie rule must
    accept the first difference."""
    same = (img == ref).all(dim=-1).flatten()
    share = float(same.double().mean())
    pix = torch.nonzero(~same).flatten().to(torch.int32)
    out = dict(share=share, pixels=int(pix.numel()),
               max_abs=float((img - ref).abs().max()))
    if share < min_share:
        raise AssertionError(f"{what}: {share:.5%} of pixels identical")
    if pix.numel() == 0:
        return out
    kw = dict(spp=cfg.spp, max_depth=cfg.max_depth, t_min=cfg.t_min,
              jitter=cfg.jitter)
    iters = -(-cfg.spp * cfg.max_depth // 8) * 8
    k, p = record_both(scene, cam, seed, pix, iters=iters, **kw)
    differ = (k[0] != p[0]).any(dim=0)
    ex = sw.explain(scene, cam, seed, pix, k[0], p[0], p[1], **kw)
    if (int(k[2].sum()) or int(p[2].sum()) or not bool(differ.all())
            or ex is None or not bool(ex.all())):
        raise AssertionError(
            f"{what}: {int(pix.numel())} pixels differ; their recordings "
            f"differ on {int(differ.sum())}, explained "
            f"{0 if ex is None else int(ex.sum())}; leftover "
            f"{int(k[2].sum())}, {int(p[2].sum())}")
    return out


def train_params(scene) -> dict:
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in rtt.extract_params(scene).items()}


def loss_and_grads(scene, cam, seed, target, cfg, engine="recorded-pp"):
    """pixel_loss and its gradients over the default trainable fields
    (None where a field does not reach the loss)."""
    params = train_params(scene)
    loss, left = rtt.pixel_loss(params, scene, cam, seed, target, cfg,
                                engine, return_leftover=True)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), int(left), dict(zip(params, grads))


def record_phase(dev) -> float:
    """Recorder kernel vs plain version with real draws (the near-tie rule
    for the indices that differ, ``record_agreement``); returns the largest
    aux difference before a slot's first difference."""
    scene, cam = rtt.scenes.random_bouncing(width=64, height=36, device=dev)
    n = cam.width * cam.height
    pix = slot_pix(n, 4096, dev)
    kw = dict(spp=8, max_depth=8, t_min=1e-3, jitter=True)
    k, p = record_both(scene, cam, 5, pix, iters=32, want_state=True, **kw)
    agr = record_agreement(k, p, scene, cam, 5, pix, "record", **kw)
    err = agr["err"]
    # one resumed pass: 8 iterations, then 24 more from the saved state,
    # equal to the 32-iteration recording (draws are keyed by counters)
    a = pr.record_pp(scene, cam, 5, pix, iters=8, want_state=True, **kw)
    rk, rp = record_both(scene, cam, 5, pix, iters=24, init_state=a[3],
                         want_state=True, **kw)
    resumed = record_agreement(rk, rp, scene, cam, 5, pix, "resumed record",
                               init_state=a[3], **kw)
    err = max(err, resumed["err"])
    if not torch.equal(torch.cat([a[0], rk[0]]), k[0]):
        raise AssertionError("8 + 24 resumed iterations != 32 in one pass")
    phase("record", f"random_bouncing 64x36 8spp d8, 32 iterations: idx "
                    f"agree on {agr['frac']:.6%} of active lane-iterations "
                    f"({agr['slots']} slots differ, each a near tie or a "
                    f"grazing root by the rule), aux max abs {err:.3g} "
                    f"before a first difference, leftover "
                    f"{int(k[2].sum())}; resumed 8+24 == 32 in one pass, "
                    f"the resumed 24 vs plain from the same state: "
                    f"{resumed['frac']:.6%} ({resumed['slots']} slots "
                    "differ, all explained)")

    scene, cam = rtt.scenes.cornell_box(width=48, device=dev)
    pix = slot_pix(cam.width * cam.height, 4096, dev)
    kw = dict(spp=4, max_depth=8, t_min=1e-3, jitter=True)
    k, p = record_both(scene, cam, 6, pix, iters=32, **kw)
    agr = record_agreement(k, p, scene, cam, 6, pix, "cornell record", **kw)
    n_sph = int(scene.sphere_radius.shape[0])
    tri_hits = int((k[0] >= n_sph).sum())
    if tri_hits == 0:
        raise AssertionError("cornell record: no triangle winners")
    phase("record", f"cornell_box 48x48 4spp d8 ({n_sph} sphere rows, "
                    f"{tri_hits} triangle winners): idx agree on "
                    f"{agr['frac']:.5%} of active lane-iterations "
                    f"({agr['slots']} slots differ, all explained)")
    return max(err, agr["err"])


def gather_bwd_shape(r: int, p: int, dev, g) -> tuple:
    """The backward at one shape in both layouts: bit-identical across two
    launches, within GATHER_BWD_RTOL of the f64 sum. Returns (max abs err,
    kernel ms, plain ms, bound ms, bound by, index_add_ ms, relative err)
    in the [C, R] layout the fused replay uses."""
    c = 20
    idx = gather_indices(r, p, dev, g)
    tgt = torch.where((idx >= 0) & (idx < p), idx.long(), p)
    grc = torch.randn((r, c), device=dev, generator=torch.Generator(
        device=dev).manual_seed(r))
    worst = 0.0
    for transposed in (False, True):
        gin = grc.T.contiguous() if transposed else grc
        d1 = pr._gather_bwd(gin, idx, p, transposed)
        d2 = pr._gather_bwd(gin, idx, p, transposed)
        if not torch.equal(d1, d2):
            raise AssertionError(f"gather backward R={r} P={p} is not "
                                 "deterministic")
        ref = torch.zeros((p + 1, c), dtype=torch.float64, device=dev)
        ref.index_add_(0, tgt, grc.double())
        mag = torch.zeros_like(ref).index_add_(0, tgt, grc.double().abs())
        rel = float(((d1.double() - ref[:p]).abs()
                     / mag[:p].clamp_min(1e-30)).max())
        if rel > GATHER_BWD_RTOL:
            raise AssertionError(f"gather backward R={r} P={p} off the f64 "
                                 f"sum by {rel} of the row's sum of |g|")
        worst = max(worst, rel)
        err = float((d1.double() - ref[:p]).abs().max())
        del ref, mag
    acc = torch.zeros((p + 1, c), dtype=torch.float32, device=dev)
    out = (err, event_ms(lambda: pr._gather_bwd(gin, idx, p, True), 10),
           event_ms(lambda: pr._gather_bwd_reference(gin, idx, p, True), 3),
           *bound(nbytes(gin, idx, d1), 0.0),
           event_ms(lambda: acc.index_add_(0, tgt, grc), 10), worst)
    del gin, grc
    torch.cuda.empty_cache()
    return out


def device_ms(fn, n: int) -> float:
    """Mean device milliseconds of the kernels ``fn`` launches, over ``n``
    calls after a warm-up, by torch.profiler: at a shape where a launch
    takes less device time than its host wrapper, CUDA events around a
    loop time the host's enqueueing instead."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        total += ev.cuda_time_total if us is None else us
    return total / 1e3 / n


def gather_fwd_shape(r: int, p: int, transposed: bool, dev, g) -> tuple:
    """The forward at one shape: bit-identical to the plain version and to
    index_select (over the table with a zero row appended; its transpose
    for the [C, R] layout, taken outside the timing) in both layouts.
    Returns (0.0, kernel ms, plain ms, bound ms, bound by, index_select
    ms, the other layout's kernel ms, kernel device ms, index_select
    device ms) in the path's layout: CUDA events, then torch.profiler's
    device time."""
    c = 20
    idx = gather_indices(r, p, dev, g)
    tab = torch.from_numpy(g.standard_normal((p, c)).astype(np.float32))
    tab = tab.to(dev)
    tgt = torch.where((idx >= 0) & (idx < p), idx.long(), p)
    tab_z = torch.cat([tab, torch.zeros((1, c), device=dev)])
    tab_zt = tab_z.T.contiguous()

    def library(t):
        return (torch.index_select(tab_zt, 1, tgt) if t
                else torch.index_select(tab_z, 0, tgt))
    ms = {}
    for t in (False, True):
        out = pr._gather_fwd(tab, idx, t)
        if not torch.equal(out, pr._gather_fwd_reference(tab, idx, t)):
            raise AssertionError(f"gather forward R={r} P={p} "
                                 f"(transposed={t}) differs from plain")
        if not torch.equal(out, library(t)):
            raise AssertionError(f"gather forward R={r} P={p} "
                                 f"(transposed={t}) differs from "
                                 "index_select")
        del out
        ms[t] = event_ms(lambda t=t: pr._gather_fwd(tab, idx, t), 10)
    out = pr._gather_fwd(tab, idx, transposed)
    res = (0.0, ms[transposed],
           event_ms(lambda: pr._gather_fwd_reference(tab, idx, transposed),
                    3),
           *bound(nbytes(tab, idx, out), 0.0),
           event_ms(lambda: library(transposed), 10), ms[not transposed],
           device_ms(lambda: pr._gather_fwd(tab, idx, transposed), 10),
           device_ms(lambda: library(transposed), 10))
    del out, tgt, idx
    torch.cuda.empty_cache()
    return res


def gather_phase(dev):
    """Gather kernels vs plain versions: the forward at GATHER_FWD_SHAPES,
    the backward at GATHER_BWD_SHAPES; returns {name: (max_abs_err, kernel
    ms, plain ms, bound ms, bound by, library ms)} at the recorded-pp
    flagship pass's shape (the main path's, [C, R]). The library call
    computes the same function in one PyTorch call (index_select over the
    table with a zero row appended, index_add_ into the table and a spare
    row), on indices mapped outside the timing."""
    g = np.random.default_rng(1)
    fwd = [gather_fwd_shape(r, p, t, dev, g) for r, p, t in GATHER_FWD_SHAPES]
    for (r, p, t), f in zip(GATHER_FWD_SHAPES, fwd):
        lay = ("[C, R]", "[R, C]")
        phase("gather", f"forward R={r} P={p}: bit-identical to plain and to "
                        f"index_select in both layouts; {lay[not t]} "
                        f"{f[1]:.4f} ms ({f[3] / f[1]:.1%} of its "
                        f"{f[3]:.4f} ms bound, {f[4]}) vs plain "
                        f"{f[2]:.4f}, index_select {f[5]:.4f} ms; "
                        f"{lay[t]} {f[6]:.4f} ms; device time (profiler) "
                        f"{f[7]:.4f} ms, index_select {f[8]:.4f} ms")
    res = {"gather_fwd": fwd[0][:6]}
    g = np.random.default_rng(0)
    bwd = [gather_bwd_shape(r, p, dev, g) for r, p in GATHER_BWD_SHAPES]
    res["gather_bwd"] = bwd[1][:6]
    for (r, p), b in zip(GATHER_BWD_SHAPES, bwd):
        phase("gather", f"backward R={r} P={p}, both layouts: bit-identical "
                        f"across launches, within {b[6]:.3g} of each row's "
                        f"sum of |g| (f64 plain sum); [C, R] layout "
                        f"{b[1]:.4f} ms vs plain {b[2]:.4f}, index_add_ "
                        f"{b[5]:.4f} ms, bound {b[3]:.4f} ms ({b[4]})")
    return res


ROW_GROUPS = ((0, 9), (9, 20))                   # geometry, material
CARRY_GROUPS = ((0, 3), (3, 6), (6, 7), (7, 10))  # o, d, tau, throughput


def mixed_scene(dev):
    """Spheres and triangles in one table (the replay's sphere-or-triangle
    select), a moving fuzz-1.0 metal, glass, and a fuzzy metal quad."""
    b = rtt.SceneBuilder()
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_diffuse(color=(0.5, 0.5, 0.5)))
    b.add_sphere((-0.7, 0, -2), 0.45,
                 b.add_metallic(color=(0.9, 0.8, 0.7), fuzz=1.0),
                 velocity=(0.1, 0.05, 0.0))
    b.add_sphere((0.7, 0, -2), 0.45, b.add_dielectric(1.5))
    b.add_triangle((-0.4, 0.8, -2.5), (0.4, 0.8, -2.5), (0, 1.5, -2.5),
                   b.add_diffuse(color=(0.8, 0.2, 0.2)))
    b.add_quad((-1.5, -0.5, -3), (3, 0, 0), (0, 2.5, 0),
               b.add_metallic(color=(0.7, 0.8, 0.9), fuzz=0.3))
    cam = rtt.make_camera(width=64, height=36, vfov=60.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1), device=dev)
    return b.build(device=dev), cam


def replay_rows(scene, idx):
    with torch.no_grad():
        return pr.gather_rows_T(pr._diff_tables(scene).float(),
                                idx.reshape(-1))


def replay_compare(idx, k, p, dk, dp):
    """Kernel (k = forward outputs, dk = backward) vs plain (p, dp) results
    of the fused replay pair. Returns (share of the slots with a pixel that
    are apart, value error, cotangent error, max abs error of the values,
    of the cotangents), the last four over the slots that agree; raises
    past the tolerances."""
    k_it, r = idx.shape
    live = idx >= -1
    ste_k = torch.where(live, k[2], 0.0)  # the kernel skips idle lanes
    ste_p = torch.where(live, p[2], 0.0)
    drk, drp = (d.reshape(20, k_it, r) for d in (dk[0], dp[0]))
    if not all(bool(torch.isfinite(a).all())
               for a in (k[0], k[1], ste_k, dk[0], dk[1])):
        raise AssertionError("replay kernels: non-finite output")
    pairs = ((k[0], p[0]), (k[1], p[1]), (ste_k, ste_p))
    val = torch.stack([((a - b).abs() / b.abs().clamp_min(1.0))
                       .reshape(-1, r).amax(dim=0) for a, b in pairs])
    val = val.amax(dim=0)
    same = val <= REPLAY_RTOL
    grad = torch.zeros(r, dtype=torch.float32, device=idx.device)
    for a, b, groups in ((drk, drp, ROW_GROUPS),
                         (dk[1], dp[1], CARRY_GROUPS)):
        for lo, hi in groups:
            scale = max(float(b[lo:hi, ..., same].abs().max()), 1e-30)
            d = (a[lo:hi] - b[lo:hi]).abs().reshape(-1, r).amax(dim=0)
            grad = torch.maximum(grad, d / scale)
    ok = same & (grad <= REPLAY_GRAD_RTOL)
    frac = float((~ok)[live.any(dim=0)].double().mean())
    if frac > REPLAY_MAX_FRAC:
        raise AssertionError(
            f"replay kernels vs plain: {frac:.3%} of the slots apart "
            f"(> {REPLAY_MAX_FRAC}): values up to {float(val.max()):.3g} "
            f"relative, cotangents {float(grad.max()):.3g} of the group's "
            "largest")
    err_val, err_grad = (max(float((a - b).abs()[..., ok].max())
                             for a, b in x)
                         for x in (pairs, ((drk, drp), (dk[1], dp[1]))))
    return (frac, float(val[ok].max()), float(grad[ok].max()), err_val,
            err_grad)


def replay_pair(scene, idx, aux, st0, seed: int):
    """Both fused replay kernels against their plain versions on one
    recording, with seeded numpy cotangents (replay_compare). Returns its
    result, the plain final carry and the share of slots with a nonzero
    initial-carry cotangent."""
    cfg = pr._replay_cfg(scene, 1e-3)
    rows = replay_rows(scene, idx)
    k = pr._fused_fwd(rows, aux, idx, st0, cfg)
    p = pr._fused_fwd_reference(rows, aux, idx, st0, cfg)
    r = idx.shape[1]
    g = np.random.default_rng(seed)
    g_out, g_fin = (torch.from_numpy(g.standard_normal((n, r)).astype(
        np.float32)).to(idx.device) for n in (3, 10))
    dk = pr._fused_bwd(rows, aux, idx, k[2], g_out, g_fin, cfg)
    dp = pr._fused_bwd_reference(rows, aux, idx, p[2], g_out, g_fin, cfg)
    torch.cuda.synchronize()
    resumed = float((dp[1] != 0).any(dim=0).double().mean())
    return replay_compare(idx, k, p, dk, dp), p[1], resumed


def replay_phase(dev) -> list:
    """The fused replay kernels against their plain versions, real draws,
    on four scenes: a fresh 16-iteration pass and its resumed remainder
    (from the plain final carry, so the initial-carry cotangent is live).
    Returns the largest absolute differences [values, cotangents]."""
    three = rtt.scenes.three_sphere(width=64, height=36, device=dev)
    cases = (
        ("random_bouncing 64x36 8spp d8",
         rtt.scenes.random_bouncing(width=64, height=36, device=dev), 8),
        ("cornell_box 48x48 4spp d8 (triangles)",
         rtt.scenes.cornell_box(width=48, device=dev), 4),
        ("three_sphere 64x36 8spp d8 (fuzz-1.0 metal, glass bubble)",
         three, 8),
        ("mixed spheres+triangles 64x36 8spp d8 (motion)",
         mixed_scene(dev), 8))
    worst = [0.0, 0.0]
    for label, (scene, cam), spp in cases:
        pix = slot_pix(cam.width * cam.height, 4096, dev)
        kw = dict(spp=spp, max_depth=8, t_min=1e-3, jitter=True)
        first = pr.record_pp(scene, cam, 21, pix, iters=16, want_state=True,
                             **kw)
        rest = pr.record_pp(scene, cam, 21, pix, iters=spp * 8 - 16,
                            init_state=first[3], **kw)
        cfg = pr._replay_cfg(scene, 1e-3)
        tri = (int((first[0] >= cfg.n_sph_pad).sum())
               + int((rest[0] >= cfg.n_sph_pad).sum())) if cfg.with_tri else 0
        c1, fin, _ = replay_pair(scene, first[0], first[1],
                                 pr._default_carry(4096, device=dev), 1)
        c2, _, resumed = replay_pair(scene, rest[0], rest[1], fin, 2)
        if not resumed > 0:
            raise AssertionError(f"replay {label}: no slot resumed mid-path")
        frac, val, grad, err_val, err_grad = (max(a, b)
                                              for a, b in zip(c1, c2))
        worst = [max(worst[0], err_val), max(worst[1], err_grad)]
        phase("replay", f"{label}, passes of 16 + {spp * 8 - 16} "
                        f"iterations: {frac:.3%} of the slots apart; on the "
                        f"rest values within {val:.3g} relative, cotangents "
                        f"within {grad:.3g} of their group's largest, max "
                        f"abs {err_val:.3g} / {err_grad:.3g}; {tri} "
                        "triangle winners, "
                        f"{resumed:.2%} of slots carry a nonzero "
                        "initial-carry cotangent")
    return worst


def replay_flagship(scene, cam, dev) -> dict:
    """Both replay kernels and their plain versions at the train step's
    first pass (262,144 slots, 112 iterations, spp 32): CUDA-event ms of
    the kernels, host-clock ms of one plain run, the differences; and the
    gathers at that pass's K*R rows. Returns {name: (err, ms, plain ms)}."""
    n = cam.width * cam.height
    pix = slot_pix(n, -(-n // 2048) * 2048, dev)
    idx, aux, _ = pr.record_pp(scene, cam, 1, pix, spp=MICRO_SPP,
                               max_depth=FLAGSHIP["depth"], t_min=1e-3,
                               jitter=True, iters=pr.default_k1(MICRO_SPP))
    cfg = pr._replay_cfg(scene, 1e-3)
    tab = pr._diff_tables(scene).detach().float()
    flat = idx.reshape(-1)
    rows = pr._gather_fwd(tab, flat, True)
    gf_ms = event_ms(lambda: pr._gather_fwd(tab, flat, True), 3)
    st0 = pr._default_carry(idx.shape[1], device=dev)
    f_ms = event_ms(lambda: pr._fused_fwd(rows, aux, idx, st0, cfg), 3)
    k = pr._fused_fwd(rows, aux, idx, st0, cfg)
    p, pf_s = timed(lambda: pr._fused_fwd_reference(rows, aux, idx, st0,
                                                     cfg))
    g = np.random.default_rng(3)
    g_out, g_fin = (torch.from_numpy(g.standard_normal((m, idx.shape[1]))
                                     .astype(np.float32)).to(dev)
                    for m in (3, 10))
    b_ms = event_ms(lambda: pr._fused_bwd(rows, aux, idx, k[2], g_out,
                                          g_fin, cfg), 3)
    dk = pr._fused_bwd(rows, aux, idx, k[2], g_out, g_fin, cfg)
    dp, pb_s = timed(lambda: pr._fused_bwd_reference(rows, aux, idx, p[2],
                                                      g_out, g_fin, cfg))
    frac, val, grad, err_val, err_grad = replay_compare(idx, k, p, dk, dp)
    gb_ms = event_ms(lambda: pr._gather_bwd(dk[0], flat, tab.shape[0], True),
                     3)
    live = float((idx >= -1).double().mean())
    phase("replay", f"flagship pass 1 ({idx.shape[1]} slots, {idx.shape[0]} "
                    f"iterations, {live:.2%} of lane-iterations live): "
                    f"forward {f_ms:.3f} ms vs plain {pf_s * 1e3:.2f} ms, "
                    f"backward {b_ms:.3f} ms vs plain {pb_s * 1e3:.2f} ms; "
                    f"{frac:.3%} of the slots apart, on the rest values "
                    f"within {val:.3g} relative, cotangents within "
                    f"{grad:.3g} of their group's largest, max abs "
                    f"{err_val:.3g} / {err_grad:.3g}; gathers at K*R = "
                    f"{flat.shape[0]}: forward {gf_ms:.3f} ms, backward "
                    f"{gb_ms:.3f} ms")
    # bytes this pass needs: the per-iteration rows, aux and entry carries
    # for live lane-iterations only (both kernels skip idle ones; the
    # backward still writes their zero row cotangents), the rest whole
    fwd_bytes = nbytes(idx, st0, k[0], k[1]) + live * nbytes(rows, aux, k[2])
    bwd_bytes = (nbytes(idx, g_out, g_fin, *dk)
                 + live * nbytes(rows, aux, k[2]))
    return {"replay_fwd": (err_val, f_ms, pf_s * 1e3,
                           *bound(fwd_bytes, 0.0)),
            "replay_bwd": (err_grad, b_ms, pb_s * 1e3,
                           *bound(bwd_bytes, 0.0))}


def grad_diff(la, ga, lb, gb, what: str, floor: float = 1e-12) -> float:
    """Largest difference of two (loss, gradients) results, relative to
    the larger of ``floor`` and the loss or each field's largest entry."""
    worst = abs(float(la - lb)) / max(abs(float(lb)), floor)
    for name, b in gb.items():
        a = ga[name]
        if (a is None) != (b is None):
            raise AssertionError(f"{what} {name}: reached the loss in only "
                                 "one of the two runs")
        if b is not None:
            scale = max(float(b.abs().max()), floor)
            worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def grad_phase(dev) -> float:
    """pixel_loss and its gradients (the fused replay, the f32 default)
    through the kernels vs through the plain versions, and the fused
    kernels vs the eager replay with its per-step gathers; returns the
    largest relative difference."""
    scene, cam = rtt.scenes.random_bouncing(width=64, height=36, device=dev)
    cfg = rtt.RenderConfig(spp=4, max_depth=8)
    target = rtt.render_fast(scene, cam, 11, cfg)
    before = dict(pr.LAUNCHES)
    lk, leftk, gk = loss_and_grads(scene, cam, 3, target, cfg)
    if not all(pr.LAUNCHES[k] > before[k] for k in pr.LAUNCHES):
        raise AssertionError(f"grad: pixel_loss launched {pr.LAUNCHES} "
                             f"(before {before})")
    with plain_pathrec():
        lp, leftp, gp = loss_and_grads(scene, cam, 3, target, cfg)
    worst = grad_diff(lk, gk, lp, gp, "grad")
    if worst > GRAD_RTOL or leftk or leftp:
        raise AssertionError(f"grad: kernels vs plain {worst} > {GRAD_RTOL} "
                             f"(leftover {leftk}, {leftp})")
    px, py = pr._pixel_grid(cam)

    def flat(fused: bool):
        params = train_params(scene)
        img, left = pr.render_diff_pp_flat(
            rtt.inject_params(scene, params), cam, 3, px, py, spp=cfg.spp,
            max_depth=cfg.max_depth, t_min=cfg.t_min, jitter=cfg.jitter,
            fused=fused, return_leftover=True)
        loss = torch.mean((img - target.reshape(img.shape)) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), int(left), dict(zip(params, grads)), img

    steps = pr.REPLAY_STEPS
    lu, leftu, gu, imgu = flat(False)
    steps = pr.REPLAY_STEPS - steps
    lf, leftf, gf, imgf = flat(True)
    unfused = grad_diff(lf, gf, lu, gu, "fused vs eager", floor=1.0)
    off = float(((imgf - imgu).abs() > STOCHASTIC_ATOL).double().mean())
    if (unfused > EAGER_TOL or off >= STOCHASTIC_MAX_FRAC or leftu or leftf
            or not steps):
        raise AssertionError(f"grad: fused vs eager replay {unfused} (> "
                             f"{EAGER_TOL}?), {off:.4%} of channels off; "
                             f"leftover {leftf}, {leftu}; {steps} eager "
                             "steps")
    phase("grad", f"random_bouncing 64x36 4spp d8 pixel_loss(recorded-pp) "
                  f"{float(lk):.6g}: loss and gradients, kernels vs plain, "
                  f"within {worst:.3g} relative; fused kernels vs the eager "
                  f"replay ({steps} steps, per-step gathers): loss and "
                  f"gradients within {unfused:.3g} of max(1, largest), "
                  f"{off:.4%} of channels > {STOCHASTIC_ATOL}; leftover 0")
    return worst


def smi_clocks() -> str:
    """The card's name, power limit, SM clock and power draw now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def flagship_kernels(scene, cam, cfg, img, dev) -> dict:
    """Kernel 1 as the main path runs it: the flagship's one queue launch
    (all 64 samples) and its fold, each against its plain version on the
    same inputs; the queue's counters (segments, the warps' lane-trips,
    re-sweeps, atomics, the segments the drain swept a column per lane);
    the bounds over this render's segments. Then the preview's 1-spp
    launch: its time, its items against the plain version and its
    counters."""
    n = cam.width * cam.height
    args, kw = mk._launch_args(scene, cam, 1, tb.resolve(scene, "megakernel"),
                               spp=cfg.spp, max_depth=cfg.max_depth,
                               t_min=cfg.t_min, jitter=cfg.jitter)
    del kw["spp"]
    stats = torch.zeros(mk.QUEUE_STATS, dtype=torch.int64, device=dev)
    out = mk._queue(*args, n, 0, cfg.spp, stats=stats, **kw)
    q_ms = event_ms(lambda: mk._queue(*args, n, 0, cfg.spp, **kw), 3)
    out_p, p_s = timed(lambda: mk._queue_reference(*args, n, 0, cfg.spp,
                                                   **kw))
    items = float((out == out_p).all(dim=1).double().mean())
    queue_err = float((out - out_p).abs().max())

    def zeros():
        return torch.zeros((3, n), dtype=torch.float32, device=dev)

    acc = mk._fold(out, zeros())
    f_ms = event_ms(lambda: mk._fold(out, zeros()), 5)
    acc_p, fp_s = timed(lambda: mk._fold_reference(out, zeros()))
    fold_err = float((acc - acc_p).abs().max())
    lib_ms = event_ms(lambda: out.sum(dim=0), 5)
    kimg = (acc.T.reshape(img.shape) / float(cfg.spp)).to(img.dtype)
    pimg = (mk._fold_reference(out_p, zeros()).T.reshape(img.shape)
            / float(cfg.spp)).to(img.dtype)
    if fold_err != 0.0 or not torch.equal(kimg, img):
        raise AssertionError(f"flagship fold: kernel vs plain {fold_err}, "
                             "queue + fold image == render_fast's: "
                             f"{torch.equal(kimg, img)}")
    ex = explain_pixels(scene, cam, 1, cfg, kimg, pimg,
                        "flagship queue vs plain")
    off = offset_launches(args, kw, n, cfg.spp, out, out_p, acc)
    st = [int(x) for x in stats.tolist()]
    seg, resweeps, lane_trips, claimed = st[0], st[5], st[6], st[7]
    st1 = torch.zeros_like(stats)
    one = mk._queue(*args, n, 0, 1, stats=st1, **kw)
    one_ms = event_ms(lambda: mk._queue(*args, n, 0, 1, **kw), 10)
    one_p = mk._queue_reference(*args, n, 0, 1, **kw)
    one_items = float((one == one_p).all(dim=1).double().mean())
    st1 = [int(x) for x in st1.tolist()]
    q_bound = bound(nbytes(*args, out), seg * args[1].shape[1]
                    * prim_ops(scene))
    f_bound = bound(nbytes(out) + 2 * nbytes(acc), out.numel())
    r_bound = bound(nbytes(*args, acc), seg * args[1].shape[1]
                    * prim_ops(scene))
    phase("flagship", f"queue launch (512x512 {cfg.spp}spp d"
                      f"{cfg.max_depth}, one launch, grid {mk.QUEUE_GRID} "
                      f"blocks): kernel {q_ms:.3f} ms, plain {p_s * 1e3:.1f} "
                      f"ms; {items:.4%} of the {out.shape[0] * n} items' "
                      f"radiance bit-identical to plain, image "
                      f"{ex['share']:.4%} of pixels ({ex['pixels']} differ, "
                      f"all explained by the near-tie rule); fold {f_ms:.4f} "
                      f"ms (plain {fp_s * 1e3:.3f}, torch.sum {lib_ms:.4f}), "
                      f"bit-identical to plain")
    phase("flagship", f"row 1 at a pixel offset (the sharded path's launch): "
                      f"two launches of {off['half']} and {n - off['half']} "
                      f"pixels (p0 = 0 and {off['half']}) equal the one "
                      f"launch bit for bit, their folds its sums; the p0 = "
                      f"{off['half']} launch vs its plain version "
                      f"{off['items']:.4%} of items bit-identical (the plain "
                      f"version at p0 equals the plain launch's rows, so "
                      f"every difference is one explained above), max abs "
                      f"{off['err']:.3g}; kernel {off['ms']:.3f} ms for "
                      f"those pixels, the one launch {q_ms:.3f} ms (PERF.md "
                      f"row 1 before the offset: 34.403 ms)")
    phase("flagship", f"queue counters: {seg} segments in {lane_trips} "
                      f"lane-trips of the warps that ran (idle lanes "
                      f"{1 - seg / lane_trips:.4f}); {resweeps} re-sweeps in "
                      f"today's arithmetic ({resweeps / seg:.3g} of "
                      f"segments); {claimed // mk.QUEUE_RUN} atomics for "
                      f"{out.shape[0] * n} items "
                      f"({claimed / mk.QUEUE_RUN / (out.shape[0] * n):.4f} "
                      f"per item); the drain swept {st[8]} segments a "
                      f"column per lane ({st[8] / seg:.4f} of segments), "
                      f"lane efficiency {seg / lane_trips:.4f} (segments / "
                      f"lane-trips)")
    phase("flagship", f"the 1-spp launch (the preview's): kernel {one_ms:.3f}"
                      f" ms, {one_items:.4%} of its {n} items' radiance "
                      f"bit-identical to plain; {st1[0]} segments in "
                      f"{st1[6]} lane-trips (lane efficiency "
                      f"{st1[0] / st1[6]:.4f}), {st1[8]} swept a column per "
                      f"lane ({st1[8] / st1[0]:.4f} of segments), {st1[5]} "
                      f"re-sweeps")
    if one_items < PIXEL_MATCH or not 0 < st1[8] <= st1[0]:
        raise AssertionError(f"flagship 1-spp launch: {one_items:.5%} of "
                             f"items equal to plain, {st1[8]} of {st1[0]} "
                             "segments swept a column per lane")
    phase("flagship", f"row 1 as the main path runs it: {2} launches, "
                      f"{q_ms + f_ms:.3f} ms of kernel time; bound "
                      f"{r_bound[0]:.4f} ms ({r_bound[1]}: {seg} segments x "
                      f"{args[1].shape[1]} columns x {prim_ops(scene)} ops), "
                      f"{r_bound[0] / (q_ms + f_ms):.1%} of the time; "
                      f"{kw['layout'].smem} "
                      "B of shared memory admitted per block "
                      f"({4 * (20 + 9 * args[1].shape[1])} B used)")
    return dict(queue_err=max(queue_err, off["err"]),
                queue=(q_ms, p_s * 1e3, *q_bound),
                fold=(fold_err, f_ms, fp_s * 1e3, *f_bound, lib_ms))


def record_flagship(scene, cam, dev):
    """The recorder at the train step's first pass (262,144 slots, spp 32,
    112 iterations): kernel ms, plain ms, idx agreement by the near-tie
    rule, aux error, re-sweeps."""
    n = cam.width * cam.height
    pix = slot_pix(n, -(-n // 2048) * 2048, dev)
    kw = dict(spp=MICRO_SPP, max_depth=FLAGSHIP["depth"], t_min=1e-3,
              jitter=True)
    iters = pr.default_k1(MICRO_SPP)
    k_ms = event_ms(lambda: pr.record_pp(scene, cam, 1, pix, iters=iters,
                                         **kw), 3)
    k = pr.record_pp(scene, cam, 1, pix, iters=iters, **kw)
    stats = torch.zeros(8, dtype=torch.int64, device=dev)
    pr._record_slots(*pr._scene_record_inputs(scene, cam), pix,
                     width=cam.width, has_motion=scene.has_motion, seed=1,
                     iters=iters, layout=tb.resolve(scene, "record_pp"),
                     stats=stats, **kw)
    with plain_pathrec():
        p, p_s = timed(lambda: pr.record_pp(scene, cam, 1, pix, iters=iters,
                                            **kw))
    agr = record_agreement(k, p, scene, cam, 1, pix, "flagship record", **kw)
    live = int((k[0] >= -1).sum())
    resweeps = int(stats[5])
    phase("record", f"flagship pass 1 (262144 slots, {iters} iterations): "
                    f"kernel {k_ms:.3f} ms, plain {p_s * 1e3:.2f} ms; idx "
                    f"agree on {agr['frac']:.6%} of active lane-iterations "
                    f"({agr['slots']} slots differ, all explained by the "
                    f"near-tie rule), aux max abs {agr['err']:.3g} before a "
                    f"first difference; {resweeps} re-sweeps in today's "
                    f"arithmetic ({resweeps / live:.3g} of {live} live "
                    "lane-iterations)")
    stab = pr._scene_record_inputs(scene, cam)[1]
    per = SPHERE_OPS + (MOTION_OPS if scene.has_motion else 0)
    return (agr["err"], k_ms, p_s * 1e3,
            *bound(nbytes(stab, pix, *k), live * stab.shape[1] * per))


def micro_batches(params, scene, cam, target, cfg, engine: str, micro: int,
                  seed: int):
    """bench.py's fwdbwd: ``micro`` value-and-gradient calls of pixel_loss,
    gradients summed. Returns (last loss, leftovers, gradients)."""
    total, lefts, loss = None, [], None
    for i in range(micro):
        loss, left = rtt.pixel_loss(params, scene, cam, seed * micro + i,
                                    target, cfg, engine, return_leftover=True)
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        total = g if total is None else [
            a if b is None else a + b for a, b in zip(total, g)]
        lefts.append(left)
    return loss.detach(), [int(x) for x in lefts], dict(zip(params, total))


def check_grads(what: str, loss, grads) -> None:
    """Finite loss and gradients, and nonzero centre and colour gradients."""
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{what}: loss {float(loss)}")
    for name, g in grads.items():
        if g is not None and not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: gradient {name} not finite")
    for name in ("sphere_center", "tex_color"):
        if grads[name] is None or not bool((grads[name] != 0).any()):
            raise AssertionError(f"{what}: gradient {name} is zero")


def train_phase(scene, cam, target, smi: str) -> dict:
    """The slice's main path: bench.py's fwdbwd (two value-and-gradient
    micro-batches of spp 32, gradients summed), counted, checked and
    timed; then two make_train_step steps."""
    f = FLAGSHIP
    cfg = rtt.RenderConfig(spp=MICRO_SPP, max_depth=f["depth"])
    params = train_params(scene)
    micro = f["spp"] // MICRO_SPP

    def fwdbwd(seed):
        return micro_batches(params, scene, cam, target, cfg, "recorded-pp",
                             micro, seed)

    for k in pr.LAUNCHES:
        pr.LAUNCHES[k] = 0
    steps0 = pr.REPLAY_STEPS
    torch.cuda.reset_peak_memory_stats()
    (loss, lefts, grads), first_s = timed(lambda: fwdbwd(0))
    launches = dict(pr.LAUNCHES)
    steps = pr.REPLAY_STEPS - steps0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if lefts != [0] * micro:
        raise AssertionError(f"train: leftover {lefts}, expected 0")
    n = f["width"] * f["height"]
    passes = len(pr.default_schedule(MICRO_SPP, f["depth"],
                                     -(-n // 2048) * 2048, 2048))
    # each pass records once, gathers all its rows once, replays through
    # the fused pair, and sends its row cotangents back through the gather
    want = {k: passes * micro for k in pr.LAUNCHES}
    if launches != want or steps:
        raise AssertionError(f"train: launches {launches}, expected {want}; "
                             f"{steps} eager replay steps, expected 0")
    check_grads("train", loss, grads)
    rays = f["width"] * f["height"] * f["spp"]
    phase("train", f"fwdbwd 512x512 2x{MICRO_SPP}spp d{f['depth']}: loss "
                   f"{float(loss):.6g}, leftover {lefts}, launches "
                   f"{launches} ({passes} passes x {micro} micro-batches); "
                   "gradients finite "
                   f"(|d sphere_center| sum "
                   f"{float(grads['sphere_center'].abs().sum()):.4g}, "
                   f"|d tex_color| sum "
                   f"{float(grads['tex_color'].abs().sum()):.4g}); first run {first_s:.2f} s, peak "
                   f"{peak_gb:.3f} GB allocated")

    secs = [timed(lambda s=s: fwdbwd(s))[1] for s in range(1, TRAIN_RUNS + 1)]
    mrays = [rays / s / 1e6 for s in secs]
    phase("train", f"forward+backward Mrays/s median "
                   f"{statistics.median(mrays):.4f} (runs "
                   + ", ".join(f"{m:.4f}" for m in mrays)
                   + f"; {TRAIN_RUNS} after 1 warm-up; seconds "
                   + ", ".join(f"{s:.3f}" for s in secs)
                   + f") | peak {peak_gb:.3f} GB | {smi}")
    sp = kernel_split(lambda: micro_batches(params, scene, cam, target, cfg,
                                            "recorded-pp", 1, 7),
                      (("recorder", ("record_pp",)), ("gathers", ("gather",)),
                       ("replay pair", ("replay_",))), "glue")
    dev_ms = sum(v for k, v in sp.items() if k != "wall")
    phase("train", f"one micro-batch (value and gradient, {MICRO_SPP} spp): "
                   f"device time {dev_ms:.2f} ms in {sp['wall']:.2f} ms of "
                   f"host clock (idle {1 - dev_ms / sp['wall']:.3f}): "
                   + ", ".join(f"{k} {v:.2f} ms" for k, v in sp.items()
                               if k != "wall"))
    with eager_replay():
        torch.cuda.reset_peak_memory_stats()
        _, eager_s = timed(lambda: fwdbwd(TRAIN_RUNS + 1))
    phase("train", f"the same fwdbwd through the eager replay (fused=False), "
                   f"one run: {rays / eager_s / 1e6:.4f} Mrays/s "
                   f"({eager_s:.3f} s), peak "
                   f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    before = {k: v.detach().clone() for k, v in params.items()}
    step = rtt.make_train_step(torch.optim.Adam(list(params.values()),
                                                lr=1e-3), cfg,
                               engine="recorded-pp", with_leftover=True)
    losses = []
    for s in range(2):
        _, tl, tleft = step(params, scene, cam, 100 + s, target)
        if int(tleft) or not bool(torch.isfinite(tl)):
            raise AssertionError(f"train step {s}: loss {float(tl)}, "
                                 f"leftover {int(tleft)}")
        losses.append(float(tl))
    moved = max(float((params[k].detach() - before[k]).abs().max())
                for k in params if params[k].numel())
    if not moved > 0.0:
        raise AssertionError("train steps left the parameters unchanged")
    phase("train", f"make_train_step x2 (Adam, lr 1e-3, spp {MICRO_SPP}): "
                   f"losses {losses}, parameters moved by up to {moved:.3g}")
    return dict(launches=launches, mrays=statistics.median(mrays),
                peak_gb=peak_gb)


def golden_check(img) -> tuple:
    buf = io.BytesIO()
    write_ppm(img, buf)
    u8 = read_ppm(io.BytesIO(buf.getvalue())).astype(np.int32)
    diff = np.abs(u8 - read_ppm(GOLDEN).astype(np.int32))
    step, frac = int(diff.max()), float((diff > 0).mean())
    if step > GOLDEN_MAX_STEP or frac >= GOLDEN_MAX_FRAC:
        raise AssertionError(f"golden drift: max step {step}, {frac:.4%} of "
                             "channels off")
    return step, frac


def golden_scene(dev):
    b = rtt.SceneBuilder()
    e = b.add_solid_texture((0.2, 0.3, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.5, e, o)
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_metallic(texture=checker, fuzz=0.0))
    b.add_sphere((0, 0, -2), 0.5, b.add_metallic(color=(0.9, 0.6, 0.3),
                                                 fuzz=0.0))
    b.add_sphere((-1.1, 0, -2.4), 0.45, b.add_metallic(color=(0.6, 0.8, 0.9),
                                                       fuzz=0.0))
    b.add_triangle((0.6, -0.2, -1.6), (1.4, -0.2, -1.9), (1.0, 0.7, -1.8),
                   b.add_metallic(color=(0.8, 0.8, 0.8), fuzz=0.0))
    cam = rtt.make_camera(width=96, height=64, vfov=55.0, focus_dist=1.0,
                          defocus_angle=0.0, look_from=(0, 0.2, 0.6),
                          look_at=(0, 0, -2), device=dev)
    cfg = rtt.RenderConfig(spp=1, max_depth=8, jitter=False)
    return b.build(device=dev), cam, cfg


def agreement(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Share of channels differing by more than STOCHASTIC_ATOL, the largest
    difference, and the largest 8x8 block-mean difference."""
    d = (a - b).abs()
    h8, w8 = (a.shape[0] // 8) * 8, (a.shape[1] // 8) * 8
    blk = (a - b)[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8, 3).mean((1, 3))
    return dict(frac=float((d > STOCHASTIC_ATOL).double().mean()),
                max_abs=float(d.max()), block=float(blk.abs().max()))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: float, flops: float):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the FP32 rate; and which
    of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def prim_ops(scene) -> int:
    """FP32 operations of one primitive test of the scene's larger class."""
    return (TRI_OPS if scene.n_triangles > scene.n_spheres
            else SPHERE_OPS + (MOTION_OPS if scene.has_motion else 0))


def floor_ops(scene, stats) -> int:
    """The operations bound of a culled or streamed launch: one primitive
    test per ray segment it traced (``stats[0]``), the least any nearest-hit
    search does. The tests a kernel's own bound hierarchy leaves (and its
    bound tests) are not counted: they grow with the work the hierarchy
    wastes, and would raise the bound of a kernel that prunes badly."""
    return int(stats[0]) * prim_ops(scene)


def state_match(k, p):
    """Share of rays whose state, alive flag and radiance agree bit for
    bit, and the largest difference of state and radiance."""
    same = (k[0] == p[0]).all(0) & (k[1] == p[1]) & (k[2] == p[2]).all(0)
    err = max(float((k[0] - p[0]).abs().max()),
              float((k[2] - p[2]).abs().max()))
    return float(same.double().mean()), err


@contextlib.contextmanager
def compare_wavefront(records: list):
    """Run every wavefront launch through the kernel and, on the same
    inputs, through its plain version; record (tail launch?, share of rays
    bit-identical, largest difference, the plain version's seconds). The
    render goes on with the kernel's outputs."""
    kernel = wf._wf_bounce

    def both(tabs, rays, st, alive, rid, **kw):
        k = kernel(tabs, rays, st, alive, rid, **kw)
        p, p_s = timed(lambda: wf._wf_bounce_reference(tabs, rays, st, alive,
                                                       rid, **kw))
        records.append((kw["loop_bounces"] > 1, *state_match(k, p), p_s))
        return k

    wf._wf_bounce = both
    try:
        yield
    finally:
        wf._wf_bounce = kernel


@contextlib.contextmanager
def capture_wavefront(calls: list):
    """Record the arguments of every wavefront launch (the launch runs)."""
    kernel = wf._wf_bounce

    def spy(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    wf._wf_bounce = spy
    try:
        yield
    finally:
        wf._wf_bounce = kernel


def same_pixels(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).all(dim=-1).double().mean())


def wavefront_phase(dev) -> float:
    """The wavefront kernel against its plain version after every launch
    (synchronous bounces and the tail), real draws, in its three table
    modes; returns the largest difference."""
    field3k = rtt.scenes.sphere_field(n=3000, width=128, device=dev)
    field20k = rtt.scenes.sphere_field(n=20000, width=128, device=dev)
    box = rtt.scenes.cornell_box(width=64, device=dev)
    cfg = rtt.RenderConfig(spp=2, max_depth=8)
    cases = (("resident", field3k, dict(culling=False), 0),
             ("resident-culled", field3k, {}, 1),
             ("streamed, default chunk", field20k, {}, 2),
             ("streamed triangles, chunk 128", box, dict(stream=128), 2))
    worst = 0.0
    for label, (scene, cam), kw, want_mode in cases:
        tabs = tb.resolve(scene, "wavefront", **kw)
        if tabs.mode != want_mode:
            raise AssertionError(f"wavefront {label}: resolved mode "
                                 f"{tabs.mode}, expected {want_mode}")
        recs = []
        with compare_wavefront(recs):
            img = wf.render_wavefront(scene, cam, 9, cfg, **kw)
        torch.cuda.synchronize()
        share = min(r[1] for r in recs)
        err = max(r[2] for r in recs)
        if share < WF_STATE_MATCH or len(recs) != 4 or not recs[-1][0]:
            raise AssertionError(f"wavefront {label}: ray states identical "
                                 f"on {share:.6%} (< {WF_STATE_MATCH}), "
                                 f"launches {recs}")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"wavefront {label}: image not finite")
        worst = max(worst, err)
        extra = ""
        if want_mode == 2:
            extra = (f"; chunk {tabs.stream}, block {tabs.blk}, "
                     f"superclusters of {tabs.sc_group}")
        phase("wavefront", f"{label} ({tabs.n_pad} sphere + {tabs.m_pad} "
                           f"triangle columns{extra}), {cam.width}x"
                           f"{cam.height} 2spp d8, 3 synchronous launches "
                           "and the tail: ray states bit-identical to plain "
                           "on " + ", ".join(f"{r[1]:.4%}" for r in recs)
                           + f"; max abs difference {err:.3g}")
    return worst


def mode_compare(scene, cam, cfg, seed, dev, label: str, **layout) -> tuple:
    """The culled or streamed queue launch (``layout``: ``culling=True``
    or ``stream``, as ``tables.resolve`` takes them) over the whole image and all ``cfg.spp`` samples (one
    sample group, as its path launches it), kernel (CUDA events) against
    its plain version on the same sorted tables: the share of pixels
    bit-identical after the fold (at least PIXEL_MATCH), every item whose
    radiance differs also differing in its recorded winners, and every
    item whose winners differ explained by the near-tie rule
    (``sweep.explain_items``); then the bound (bytes read and written once;
    one primitive test per ray segment, ``floor_ops``). Returns (err, ms,
    plain ms, bound ms, bound by)."""
    args, kw = mk._launch_args(scene, cam, seed,
                               tb.resolve(scene, "megakernel", **layout),
                               spp=cfg.spp, max_depth=cfg.max_depth,
                               t_min=cfg.t_min, jitter=cfg.jitter)
    del kw["spp"]
    n, ns = cam.width * cam.height, cfg.spp
    hk = torch.full((cfg.max_depth, ns * n), -2, dtype=torch.int32,
                    device=dev)
    hp = hk.clone()
    stats = torch.zeros(mk.QUEUE_STATS, dtype=torch.int64, device=dev)
    k_out = mk._queue(*args, n, 0, ns, stats=stats, hits=hk, **kw)
    k_ms = event_ms(lambda: mk._queue(*args, n, 0, ns, **kw), 3)
    p_out, p_s = timed(lambda: mk._queue_reference(*args, n, 0, ns,
                                                   hits=hp, **kw))
    zeros = torch.zeros((3, n), dtype=torch.float32, device=dev)
    kp = float((mk._fold_reference(k_out, zeros)
                == mk._fold_reference(p_out, zeros)).all(0).double().mean())
    err = float((k_out - p_out).abs().max())
    rad_diff = (k_out != p_out).any(dim=1).flatten()
    hit_diff = (hk != hp).any(dim=0)
    ekw = {k: kw[k] for k in ("width", "max_depth", "t_min", "jitter",
                              "has_motion", "seed")}
    ex = sw.explain_items(*args, n, 0, hk, hp, **ekw)
    n_ex = 0 if ex is None else int(ex.sum())
    if (kp < PIXEL_MATCH or bool((rad_diff & ~hit_diff).any())
            or n_ex != int(hit_diff.sum())):
        raise AssertionError(
            f"megakernel {label} kernel vs plain: {kp:.5%} of pixels "
            f"identical, {int(rad_diff.sum())} items' radiance and "
            f"{int(hit_diff.sum())} items' winners differ, {n_ex} explained, "
            f"{int((rad_diff & ~hit_diff).sum())} radiance differences with "
            "equal winners")
    tabs = kw["bounds"]
    inputs = [*args, tabs.sblk, tabs.tblk]
    if layout.get("stream"):
        inputs += [tabs.scb, tabs.tcb, tabs.ssc, *kw["records"]]
    b_ms, b_by = bound(nbytes(*inputs, k_out), floor_ops(scene, stats))
    st = [int(x) for x in stats.tolist()]
    seg = max(st[0], 1)
    phase("megakernel", f"{label} queue launch ({scene.n_spheres} spheres, "
                        f"{cam.width}x{cam.height} {ns}spp d{cfg.max_depth}, "
                        f"grid {mk.QUEUE_GRID} blocks) vs plain: {kp:.4%} of "
                        f"pixels identical, {int(hit_diff.sum())} of "
                        f"{ns * n} items' winners differ, all explained by "
                        f"the near-tie rule, max abs {err:.3g}; kernel "
                        f"{k_ms:.3f} ms, plain {p_s * 1e3:.1f} ms, bound "
                        f"{b_ms:.4f} ms ({b_by}); {st[0]} segments, "
                        f"{st[1] / seg:.1f} primitive, {st[2] / seg:.1f} "
                        f"block and {st[3] / seg:.1f} chunk tests per segment"
                        f" ({st[4]} chunk tests passed), {st[5]} re-sweeps, "
                        f"idle lanes {1 - st[0] / max(st[6], 1):.4f}")
    return err, k_ms, p_s * 1e3, b_ms, b_by


def field_reference(scene, cam, cfg, seed: int):
    """The full-table render of the plain version (today's arithmetic,
    every column swept), which the culled and streamed megakernel and the
    wavefront equal up to exact ties."""
    with plain_version():
        return rtt.render_megakernel(scene, cam, seed, cfg, culling=False)


def megakernel_modes_phase(dev) -> tuple:
    """The culled and streamed megakernel (one queue launch and one fold a
    render) against the plain full-table render (same seed), each on at
    least PIXEL_MATCH of the pixels (the culled mode's packed sweep parts
    from today's arithmetic only at near ties, which ``mode_compare``
    explains item by item below; the streamed mode tests columns in
    today's arithmetic behind conservative bounds); the resident
    megakernel (the queue, the packed FMA sweep with the narrow grazing
    band; this scene's float32 c_term is rounding-level at its small
    spheres: coordinates reach 55, radii 0.08) against it on at least
    FIELD_PIXEL_MATCH, every differing pixel explained by the near-tie
    rule; then the culled kernel against its plain version on the launch
    at its path's shape (all 16 samples), every difference explained.
    Returns the culled render's queue launches and the culled launch's
    ``mode_compare``."""
    scene, cam = rtt.scenes.sphere_field(n=3000, width=128, device=dev)
    cfg = rtt.RenderConfig(spp=16, max_depth=8)
    ref = field_reference(scene, cam, cfg, 5)
    launches = {}
    for mode, kw in (("culled", dict(culling=True)),
                     ("streamed", dict(stream=tb.DEFAULT_STREAM_CHUNK))):
        for k in mk.MODE_LAUNCHES:
            mk.MODE_LAUNCHES[k] = 0
        img = rtt.render_megakernel(scene, cam, 5, cfg, **kw)
        torch.cuda.synchronize()
        launches[mode] = dict(mk.MODE_LAUNCHES)
        share = same_pixels(img, ref)
        want = dict.fromkeys(mk.MODE_LAUNCHES, 0)
        want.update({mode: 1, "fold": 1})
        if share < PIXEL_MATCH or launches[mode] != want:
            raise AssertionError(f"megakernel {mode}: {share:.5%} of pixels "
                                 f"as the plain full-table render, "
                                 f"launches {launches[mode]}")
        phase("megakernel", f"{mode}: sphere_field 3000 128x72 16spp d8, "
                            f"launches {launches[mode]}, {share:.4%} of "
                            "pixels identical to the plain full-table render")
    img = rtt.render_megakernel(scene, cam, 5, cfg, culling=False)
    ex = explain_pixels(scene, cam, 5, cfg, img, ref, "sphere_field queue",
                        min_share=FIELD_PIXEL_MATCH)
    phase("megakernel", f"resident (queue): sphere_field 3000 128x72 16spp "
                        f"d8, {ex['share']:.4%} of pixels identical to the "
                        f"plain full-table render, the {ex['pixels']} others "
                        "each explained by the near-tie rule")
    return launches["culled"]["culled"], mode_compare(
        scene, cam, cfg, 5, dev, "culled", culling=True)


def engines_phase(dev) -> None:
    """The wavefront against the plain full-table megakernel, same seed:
    the same paths; and against the resident megakernel."""
    scene, cam = rtt.scenes.sphere_field(n=3000, width=128, device=dev)
    cfg = rtt.RenderConfig(spp=16, max_depth=8)
    a = wf.render_wavefront(scene, cam, 11, cfg)
    share = same_pixels(a, field_reference(scene, cam, cfg, 11))
    if share < PIXEL_MATCH:
        raise AssertionError(f"wavefront vs the plain megakernel: "
                             f"{share:.5%} of pixels identical")
    b = rtt.render_megakernel(scene, cam, 11, cfg)
    phase("engines", f"sphere_field 3000 128x72 16spp d8, seed 11: wavefront "
                     f"(resident-culled) vs the plain full-table megakernel "
                     f"{share:.4%} of pixels identical; vs the resident "
                     f"kernel (queue) {same_pixels(a, b):.4%}, max abs "
                     f"{float((a - b).abs().max()):.3g}")


def large_golden_phase(dev) -> None:
    """The golden image through the four new paths, kernels on the card."""
    scene, cam, cfg = golden_scene(dev)
    for label, fn in (
            ("wavefront resident", lambda: wf.render_wavefront(
                scene, cam, 0, cfg)),
            ("wavefront streamed (chunk 128)", lambda: wf.render_wavefront(
                scene, cam, 0, cfg, stream=128)),
            ("megakernel culled", lambda: rtt.render_megakernel(
                scene, cam, 0, cfg, culling=True)),
            ("megakernel streamed (chunk 128)", lambda: rtt.render_megakernel(
                scene, cam, 0, cfg, stream=128))):
        launches = wf.LAUNCHES + mk.LAUNCHES
        img = fn()
        torch.cuda.synchronize()
        if wf.LAUNCHES + mk.LAUNCHES == launches:
            raise AssertionError(f"golden {label}: no kernel launched")
        step, frac = golden_check(img)
        phase("golden", f"{label}: max step {step}, {frac:.4%} channels off")


def wavefront_main_path(scene, cam, cfg, dev) -> tuple:
    """The large main path's render at its own shape (512x288, 16 spp:
    2,359,296 rays): every launch, the three synchronous bounces and the
    tail, against its plain version on the same inputs (host clock); then
    the bounce-1 launch timed by CUDA events, with its bound (bytes read
    and written once; one primitive test per ray segment, ``floor_ops``).
    Returns (err, ms, plain ms, bound ms, bound by) of the bounce-1
    launch."""
    calls, recs = [], []
    with capture_wavefront(calls), compare_wavefront(recs):
        wf.render_wavefront(scene, cam, 1, cfg)
    torch.cuda.synchronize()
    if min(r[1] for r in recs) < WF_STATE_MATCH or len(recs) != 4 \
            or not recs[-1][0]:
        raise AssertionError(f"wavefront at the main path's shape: "
                             f"launches {recs}")
    args, kw = calls[1]
    stats = torch.zeros(8, dtype=torch.int64, device=dev)
    k = wf._wf_bounce(*args, **{**kw, "stats": stats})
    k_ms = event_ms(lambda: wf._wf_bounce(*args, **kw), 3)
    tabs, rays, st, alive, rid = args
    b_ms, b_by = bound(nbytes(tabs.stab, tabs.ttab, tabs.scb, tabs.tcb,
                              tabs.ssc, tabs.tsc, tabs.sblk, tabs.tblk,
                              rays.cam, rays.slot_pix, st, alive, rid, *k),
                       floor_ops(scene, stats))
    s = [int(x) for x in stats.tolist()]
    phase("wavefront", f"{cam.width}x{cam.height} {cfg.spp}spp render on "
                       f"{scene.n_spheres} spheres, 3 synchronous launches "
                       "and the tail (" + ", ".join(
                           str(a[4].shape[0]) for a, _ in calls)
                       + " rays): ray states bit-identical to plain on "
                       + ", ".join(f"{r[1]:.4%}" for r in recs)
                       + f"; max abs difference {max(r[2] for r in recs):.3g}"
                       "; plain " + ", ".join(f"{r[3] * 1e3:.1f}"
                                              for r in recs) + " ms")
    phase("wavefront", f"bounce-1 launch of that render ({rid.shape[0]} "
                       f"rays, {s[0]} live): kernel {k_ms:.3f} ms, plain "
                       f"{recs[1][3] * 1e3:.1f} ms; {s[1]} primitive tests "
                       f"({s[1] / max(s[0], 1):.1f} per ray), {s[2]} bound "
                       f"tests, warp votes {s[3]} of which {s[4]} passed; "
                       f"bound {b_ms:.4f} ms ({b_by})")
    return (max(r[2] for r in recs), k_ms, recs[1][3] * 1e3, b_ms, b_by)


def large_phase(dev, smi: str) -> dict:
    """The large-scene main path: render_fast(engine="auto") on
    sphere_field at LARGE_NS spheres, 512x288, 16 spp, depth 8: resolves to
    the wavefront, 4 launches per render, image finite and not black;
    Mrays/s (median of 5 after a warm-up), peak memory, the share of chunk
    votes that pruned. On the first scene, each launch of the render timed
    and every launch of one render held against its plain version
    (``wavefront_main_path``). On every scene the streamed megakernel (one
    queue launch and one fold), timed the same way, its image against the
    wavefront's, and its Mrays/s against the wavefront's (the crossover);
    on the first its queue launch at the render's shape (all 16 samples)
    against its plain version (``mode_compare``). Returns the
    main path's launch count, the kernel timing of the wavefront and the
    streamed megakernel's queue launches."""
    cfg = rtt.RenderConfig(spp=LARGE["spp"], max_depth=LARGE["depth"])
    out = {}
    for i, n in enumerate(LARGE_NS):
        scene, cam = rtt.scenes.sphere_field(n=n, width=LARGE["width"],
                                             device=dev)
        rays = cam.width * cam.height * cfg.spp
        eng = rtt.pick_engine(scene, "auto")
        if eng != "wavefront" or tb.fits_shared(scene):
            raise AssertionError(f"sphere_field {n}: auto resolved to {eng}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wf.LAUNCHES = 0
        img, first_s = timed(lambda: rtt.render_fast(scene, cam, 0, cfg,
                                                     engine="auto"))
        launches = wf.LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 1e9
        if launches != 4:
            raise AssertionError(f"sphere_field {n}: {launches} wavefront "
                                 "launches, expected 3 synchronous + 1 tail")
        if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0.0
                and float(img.min()) >= 0.0
                and img.shape == (cam.height, cam.width, 3)):
            raise AssertionError(f"sphere_field {n}: image not finite, "
                                 "non-negative and non-black")
        secs = [timed(lambda s=s: rtt.render_fast(scene, cam, s, cfg))[1]
                for s in range(1, RUNS + 1)]
        if wf.LAUNCHES != 4 * (RUNS + 1):
            raise AssertionError(f"sphere_field {n}: {wf.LAUNCHES} launches "
                                 f"in {RUNS + 1} renders")
        mr = [rays / s / 1e6 for s in secs]
        stats = torch.zeros(8, dtype=torch.int64, device=dev)
        wf.render_wavefront(scene, cam, 0, cfg, stats=stats)
        st = [int(x) for x in stats.tolist()]
        tabs, _ = tb.layout_tables(scene, tb.resolve(scene, "wavefront"),
                                   cam.look_from, memo=False)
        phase("large", f"sphere_field {n} ({tabs.n_pad} columns, "
                       f"{nbytes(tabs.stab) / 1e6:.2f} MB of tables, "
                       f"{tabs.n_pad // tabs.stream} chunks in superclusters "
                       f"of {tabs.sc_group}) {cam.width}x{cam.height} "
                       f"{cfg.spp}spp d{cfg.max_depth}: render_fast(auto) -> "
                       f"{eng}, {launches} launches, mean "
                       f"{float(img.mean()):.4f}; Mrays/s median "
                       f"{statistics.median(mr):.3f} (runs "
                       + ", ".join(f"{m:.3f}" for m in mr)
                       + f"; first {first_s:.3f} s); peak {peak:.3f} GB; "
                       f"{st[0]} segments, {st[1] / max(st[0], 1):.1f} "
                       f"primitive tests per segment; chunk votes {st[3]}, "
                       f"{1.0 - st[4] / max(st[3], 1):.4%} pruned | {smi}")
        if i == 0:
            out["launches"] = launches
            wl = wavefront_launches(scene, cam, cfg)
            ws = wl["stats"]
            phase("large", f"sphere_field {n} render_wavefront, each launch "
                           "by CUDA events (median of 3 renders): "
                           + ", ".join(f"{ms:.3f}" for ms in wl["launch_ms"])
                           + f" ms (bounce 0, 1, 2, the tail; sum "
                           f"{sum(wl['launch_ms']):.3f}); render span "
                           f"{wl['span_ms']:.3f} ms, of it sorts, permutes "
                           f"and scatter-back {wl['glue_ms']:.3f}; "
                           f"{ws[1] / max(ws[0], 1):.1f} primitive and "
                           f"{ws[2] / max(ws[0], 1):.1f} bound tests per "
                           f"segment, warp votes {ws[3]} ({ws[4]} passed), "
                           f"{1 - ws[1] / max(ws[6], 1):.4f} of the sweeps' "
                           f"lane slots idle | {smi}")
            out["wavefront"] = wavefront_main_path(scene, cam, cfg, dev)
        # the streamed megakernel on the same scene: what auto would give
        # if it picked the megakernel here (the crossover)
        for k in mk.MODE_LAUNCHES:
            mk.MODE_LAUNCHES[k] = 0
        mimg, m_first = timed(lambda: rtt.render_megakernel(scene, cam, 0,
                                                            cfg))
        modes = dict(mk.MODE_LAUNCHES)
        share = same_pixels(mimg, img)
        if (modes != dict(resident=0, culled=0, streamed=1, fold=1)
                or share < PIXEL_MATCH
                or not bool(torch.isfinite(mimg).all())):
            raise AssertionError(f"streamed megakernel at {n}: launches "
                                 f"{modes}, {share:.5%} of pixels as the "
                                 "wavefront's")
        msecs = [timed(lambda s=s: rtt.render_megakernel(
            scene, cam, s, cfg))[1] for s in range(1, RUNS + 1)]
        mmr = [rays / s / 1e6 for s in msecs]
        phase("large", f"render_megakernel (streamed, chunk "
                       f"{tb.DEFAULT_STREAM_CHUNK}, block {tb.STREAM_BLOCK})"
                       f" on sphere_field {n}: one queue launch and one "
                       f"fold, {share:.4%} of pixels as the wavefront's; "
                       f"Mrays/s median {statistics.median(mmr):.3f} (runs "
                       + ", ".join(f"{m:.3f}" for m in mmr)
                       + f"; first {m_first:.3f} s), "
                       f"{statistics.median(mmr) / statistics.median(mr):.3f}"
                       f"x the wavefront's | {smi}")
        if i == 0:
            out["mk_launches"] = modes["streamed"]
            out["megakernel_streamed"] = mode_compare(
                scene, cam, cfg, 1, dev, "streamed",
                stream=tb.DEFAULT_STREAM_CHUNK)
    return out


# ---- the bounce-indexed "recorded" engine (ops/diffkernel.py) ----

# record kernel vs plain version on the same tables, streamed: every index
# equal (the streamed layout's kernel and plain version sweep the same
# sorted columns). Resident (the packed FMA sweep) every index equal or
# explained by ops/sweep.py's near-tie rule, and at least MATCH_FRAC of the
# (bounce, ray) indices where either recording has a hit equal
RECORD_MATCH = 1.0
# render_diff vs the megakernel, per channel: STOCHASTIC_MAX_FRAC is the CPU
# tests' bound at 4 spp; a pixel of 16 spp averages four times as many
# paths, each as likely to part from the recorded one in the replay
DIFF_SPP = 16
DIFF_MAX_FRAC = STOCHASTIC_MAX_FRAC * DIFF_SPP / 4


@contextlib.contextmanager
def plain_recorded():
    """Route the record kernel's launches, and the gathers', to their plain
    torch versions (on the same CUDA tensors) for a comparison run."""
    kernel = dk._record
    dk._record = dk._record_reference
    try:
        with plain_pathrec():
            yield
    finally:
        dk._record = kernel


@contextlib.contextmanager
def host_draws():
    """render_diff's camera rays and randoms made by torch on the CPU and
    moved to the card."""
    make_rand, camera_rays = dk._make_rand, dk._camera_rays

    def rand(seed, pix, sample, depth):
        return make_rand(seed, pix.cpu(), sample, depth).to(pix.device)

    def rays(cam, seed, pix, sample, jitter):
        return tuple(x.to(pix.device) for x in camera_rays(
            cam.to("cpu"), seed, pix.cpu(), sample, jitter))

    dk._make_rand, dk._camera_rays = rand, rays
    try:
        yield
    finally:
        dk._make_rand, dk._camera_rays = make_rand, camera_rays


def draws_off_host(cam, seed: int, cfg) -> tuple:
    """Values of render_diff's camera rays and randoms (all sample passes)
    that torch on the card rounds otherwise than torch on the CPU: (count,
    total, largest difference)."""
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32,
                       device=cam.device)
    off = total = 0
    worst = 0.0
    for s in range(cfg.spp):
        card = (*dk._camera_rays(cam, seed, pix, s, cfg.jitter),
                dk._make_rand(seed, pix, s, cfg.max_depth))
        host = (*dk._camera_rays(cam.to("cpu"), seed, pix.cpu(), s,
                                 cfg.jitter),
                dk._make_rand(seed, pix.cpu(), s, cfg.max_depth))
        for a, b in zip(card, host):
            d = (a.cpu() - b).abs()
            off += int((d > 0).sum())
            total += d.numel()
            worst = max(worst, float(d.max()))
    return off, total, worst


def record_inputs(scene, cam, seed: int, depth: int, dev, sample: int = 0,
                  passes: int = 1):
    """render_diff's inputs of ``passes`` sample passes from ``sample`` on
    over the whole image, side by side as one record launch takes a group
    of them: the camera rays and the [depth, 5, R] randoms."""
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev)
    parts = [(*dk._camera_rays(cam, seed, pix, s, True),
              dk._make_rand(seed, pix, s, depth))
             for s in range(sample, sample + passes)]
    return tuple(torch.cat([p[k] for p in parts], dim=-1 if k == 3 else 0)
                 for k in range(4))


def record_compare(scene, inputs, depth: int, stream=None,
                   what: str = "record"):
    """One record launch against its plain version on the same inputs, by
    its table mode's rule (RECORD_MATCH): streamed every index equal;
    resident every index equal or explained by the near-tie rule
    (``sweep.explain_paths``), at least MATCH_FRAC of the indices where
    either recording has a hit equal. Returns (share of equal indices,
    kernel idx, stats, share equal where either has a hit, rays that
    differ)."""
    stats = torch.zeros(8, dtype=torch.int64, device=inputs[0].device)
    before = dict(dk.LAUNCHES)
    k = dk.record_paths(scene, *inputs, max_depth=depth, t_min=1e-3,
                        stream=stream, stats=stats)
    resident = dk.LAUNCHES["resident"] > before["resident"]
    with plain_recorded():
        p = dk.record_paths(scene, *inputs, max_depth=depth, t_min=1e-3,
                            stream=stream)
    torch.cuda.synchronize()
    share = float((k == p).double().mean())
    hit = (k >= 0) | (p >= 0)
    live = float((k == p)[hit].double().mean())
    if not resident:
        if share < RECORD_MATCH:
            raise AssertionError(f"{what}: {share:.6%} of indices as plain")
        return share, k, stats, live, 0
    o, d, tm, rand = inputs
    rays = torch.cat([o.T, d.T, tm[None]]).float().contiguous()
    ex = sw.explain_paths(scene, rays, rand.float().contiguous(), k, p,
                          t_min=1e-3)
    n_diff = 0 if ex is None else ex.numel()
    n_ok = 0 if ex is None else int(ex.sum())
    if live < MATCH_FRAC or n_ok != n_diff:
        raise AssertionError(f"{what}: {share:.6%} of indices as plain "
                             f"({live:.6%} where either has a hit), "
                             f"{n_diff} rays differ, {n_ok} explained by the "
                             "near-tie rule")
    return share, k, stats, live, n_diff


def scene_order_split(scene, inputs, depth: int, k) -> tuple:
    """A streamed (sorted) recording ``k`` against the plain recorder over
    the tables in the scene's own order: (indices that differ, rays that
    differ, of them those that part at an exact f32 tie). Raises unless
    every differing ray parts at a tie."""
    layout = tb.resolve(scene, "record", stream=0)
    raw = dk._record_tables(scene, layout)
    stab, ttab = raw.stab, raw.ttab
    o, d, tm, rand = inputs
    rays = torch.cat([o.T, d.T, tm[None]]).float().contiguous()
    rand = rand.float().contiguous()
    want = dk._record_reference(stab, ttab, rays, rand, depth=depth,
                                t_min=1e-3, has_motion=scene.has_motion,
                                tri_base=layout.n_pad)
    tie = dk._exact_ties(scene, rays, rand, k, want, depth=depth, t_min=1e-3)
    if not bool(tie.all()):
        raise AssertionError(f"streamed record: {int((~tie).sum())} of "
                             f"{tie.numel()} rays part from the scene order "
                             "at no tie")
    return int((k != want).sum()), tie.numel(), int(tie.sum())


def diff_record_phase(dev) -> dict:
    """The record kernel against its plain version with real draws
    (render_diff's rays and randoms), resident and streamed, and on one
    flagship launch of diffkernel.RECORD_GROUP passes (512x512, d32,
    resident); render_diff against the megakernel; the golden. Returns
    the largest share of unequal indices per table mode, and the flagship
    launch's (share unequal, ms, plain ms, bound ms, bound by)."""
    mixed, mcam = mixed_scene(dev)
    cases = [
        ("random_bouncing 64x36 d8",
         rtt.scenes.random_bouncing(width=64, height=36, device=dev), None,
         "resident"),
        ("cornell_box 48x48 d8 (tables > 48 KB)",
         rtt.scenes.cornell_box(width=48, device=dev), None, "resident"),
        ("mixed spheres+triangles 64x36 d8 (motion)", (mixed, mcam), None,
         "resident"),
        ("mixed, chunk 128", (mixed, mcam), 128, "streamed")]
    field = rtt.scenes.sphere_field(n=20_000, width=128, device=dev)
    cases += [(f"sphere_field 20000 128x72 d8, chunk {c}", field, c,
               "streamed") for c in (128, tb.RECORD_STREAM_CHUNK)]
    worst = dict(resident=0.0, streamed=0.0)
    for label, (scene, cam), stream, mode in cases:
        before = dict(dk.LAUNCHES)
        share, k, st, live, n_diff = record_compare(
            scene, record_inputs(scene, cam, 5, 8, dev), 8, stream,
            f"record {label}")
        if dk.LAUNCHES[mode] != before[mode] + 1:
            raise AssertionError(f"record {label}: launches {dk.LAUNCHES} "
                                 f"(before {before})")
        worst[mode] = max(worst[mode], 1.0 - share)
        s = [int(x) for x in st.tolist()]
        split = ""
        if stream:
            n_idx, n_rays, n_tie = scene_order_split(
                scene, record_inputs(scene, cam, 5, 8, dev), 8, k)
            split = (f"; vs the scene-order plain recorder {n_idx} indices "
                     f"on {n_rays} rays differ, {n_tie} of them parting at "
                     "an exact f32 tie")
        else:
            split = (f"; {live:.4%} where either has a hit, {n_diff} rays "
                     "differ, all explained by the near-tie rule; "
                     f"{s[5]} re-sweeps, idle lanes "
                     f"{1 - s[0] / max(s[6], 1):.4f}")
        phase("record", f"{label} ({mode}): indices equal to plain on "
                        f"{share:.4%}; {s[0]} segments, "
                        f"{s[1] / max(s[0], 1):.1f} columns and "
                        f"{s[2] / max(s[0], 1):.1f} block bounds tested per "
                        f"segment, chunk tests {s[3]} ({s[4]} passed)"
                        + split)
    # the flagship's pass at full width: the path of the recorded step
    scene, cam = rtt.scenes.random_bouncing(width=FLAGSHIP["width"],
                                            height=FLAGSHIP["height"],
                                            device=dev)
    g = dk.RECORD_GROUP
    flag = record_pass_kernel(scene, cam, dev, FLAGSHIP["depth"], passes=g)
    err, k_ms, p_ms, b_ms, b_by, st, _, _ = flag
    s = [int(x) for x in st.tolist()]
    worst["resident"] = max(worst["resident"], err)
    phase("record", f"one flagship launch of {g} passes ({cam.width}x"
                    f"{cam.height} = {cam.width * cam.height} rays each, "
                    f"d{FLAGSHIP['depth']}, resident, the ray queue): "
                    f"kernel {k_ms:.3f} ms ({k_ms / g:.3f} a pass), plain "
                    f"{p_ms:.1f} ms, {1 - err:.4%} of indices equal to "
                    f"plain, every difference explained; {s[0]} segments "
                    f"in {s[6]} lane-trips (idle lanes "
                    f"{1 - s[0] / max(s[6], 1):.4f}), {s[5]} re-sweeps, "
                    f"{s[7] / 1e3:.1f} us from the ray counter's last claim "
                    f"to the last warp's end; bound {b_ms:.4f} ms ({b_by}: "
                    f"{s[0]} segments x every column)")
    # the given-draw scatter: render_diff records the megakernel's paths
    # for the same seed, as the persistent-path recorder (hashed draws)
    # does. A pixel parts from the megakernel's where the replay, which
    # re-derives each bounce in its own rounding, resolves a near-tie (a
    # glass coin, a grazing hit) otherwise than the recorder did: the plain
    # versions part as often, and so does the image from draws made on the
    # CPU, so neither the kernels nor the card's rounding of the draws is
    # the cause
    scene, cam = rtt.scenes.random_bouncing(width=128, height=72,
                                            device=dev)
    cfg = rtt.RenderConfig(spp=DIFF_SPP, max_depth=8)
    img = rtt.render_diff(scene, cam, 7, cfg)
    agr = agreement(img, rtt.render_megakernel(scene, cam, 7, cfg))
    app = agreement(img, pr.render_diff_pp(scene, cam, 7, cfg))
    with plain_recorded(), plain_version():
        plain = agreement(rtt.render_diff(scene, cam, 7, cfg),
                          rtt.render_megakernel(scene, cam, 7, cfg,
                                                passes=0))
    with host_draws():
        himg = rtt.render_diff(scene, cam, 7, cfg)
    host = agreement(himg, rtt.render_megakernel(scene, cam, 7, cfg))
    same = agreement(himg, img)
    off, total, off_max = draws_off_host(cam, 7, cfg)
    for what, a in (("megakernel", agr), ("render_diff_pp", app),
                    ("megakernel, plain versions", plain),
                    ("megakernel, draws made on the CPU", host)):
        if a["frac"] >= DIFF_MAX_FRAC or a["block"] > BLOCK_MEAN_ATOL:
            raise AssertionError(f"render_diff vs {what}: {a}")
    phase("record", f"render_diff, random_bouncing 128x72 {DIFF_SPP}spp d8, "
                    f"seed 7, channels off by > {STOCHASTIC_ATOL} (bound "
                    f"{DIFF_MAX_FRAC:.0%}) and 8x8 block means: vs "
                    f"render_megakernel {agr['frac']:.4%}, "
                    f"{agr['block']:.3g}; vs render_diff_pp "
                    f"{app['frac']:.4%}, {app['block']:.3g}; plain versions "
                    f"on the card {plain['frac']:.4%}, {plain['block']:.3g}; "
                    f"from draws made on the CPU vs the megakernel "
                    f"{host['frac']:.4%}, vs from the card's draws "
                    f"{same['frac']:.4%}; {off} of {total} draw and camera "
                    f"ray values rounded otherwise on the card than on the "
                    f"CPU (largest {off_max:.3g})")
    scene, cam, cfg = golden_scene(dev)
    for label, chunk in (("resident", 0), ("streamed (chunk 128)", 128)):
        before = dict(dk.LAUNCHES)
        mode = "streamed" if chunk else "resident"
        if chunk:
            with forced_stream(chunk):
                gimg = rtt.render_diff(scene, cam, 0, cfg)
        else:
            gimg = rtt.render_diff(scene, cam, 0, cfg)
        want = -(-cfg.spp // dk.RECORD_GROUP) if mode == "resident" \
            else cfg.spp
        if dk.LAUNCHES[mode] != before[mode] + want:
            raise AssertionError(f"golden render_diff {label}: launches "
                                 f"{dk.LAUNCHES} (before {before})")
        step, frac = golden_check(gimg)
        phase("golden", f"render_diff {label}: max step {step}, "
                        f"{frac:.4%} channels off")
    return worst, flag[:5]


def recorded_grad_phase(dev) -> float:
    """pixel_loss(engine="recorded") and its gradients through the record
    and gather kernels vs through their plain versions."""
    scene, cam = rtt.scenes.random_bouncing(width=64, height=36, device=dev)
    cfg = rtt.RenderConfig(spp=4, max_depth=8)
    target = rtt.render_fast(scene, cam, 11, cfg)
    before = dk.LAUNCHES["resident"], pr.LAUNCHES["gather_bwd"]
    lk, _, gk = loss_and_grads(scene, cam, 3, target, cfg, "recorded")
    if (dk.LAUNCHES["resident"], pr.LAUNCHES["gather_bwd"]) <= before:
        raise AssertionError("grad: the recorded pixel_loss launched no "
                             "record or gather kernel")
    with plain_recorded():
        lp, _, gp = loss_and_grads(scene, cam, 3, target, cfg, "recorded")
    worst = grad_diff(lk, gk, lp, gp, "recorded grad")
    if worst > GRAD_RTOL:
        raise AssertionError(f"recorded grad: kernels vs plain {worst}")
    phase("grad", f"random_bouncing 64x36 4spp d8 pixel_loss(recorded) "
                  f"{float(lk):.6g}: loss and gradients, kernels vs plain, "
                  f"within {worst:.3g} relative")
    return worst


def kernel_split(fn, buckets=(("record", ("record_kernel", "record_queue",
                                           "sort")),
                               ("gathers", ("gather",))),
                 rest: str = "replay") -> dict:
    """Device time (ms) of the kernels ``fn`` launches, by torch.profiler,
    in ``buckets`` (the first whose name fragments a kernel's name holds;
    by default the record kernel with its table prep, the streamed
    layout's sorts, and the gathers) and ``rest`` (by default the eager
    replay); and the run's host-clock ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, secs = timed(fn)
    split = {k: 0.0 for k, _ in buckets}
    split[rest] = 0.0
    for ev in prof.key_averages():
        ms = getattr(ev, "device_time_total", None)
        ms = (ev.cuda_time_total if ms is None else ms) / 1e3
        name = ev.key
        if name.startswith("ProfilerStep"):
            continue
        key = next((k for k, frags in buckets
                    if any(f in name.lower() for f in frags)), rest)
        split[key] += ms
    split["wall"] = secs * 1e3
    return split


def split_line(fwd: dict, bwd: dict) -> str:
    tot = sum(fwd[k] + bwd[k] for k in ("record", "gathers", "replay"))
    wall = fwd["wall"] + bwd["wall"]
    return (f"device time of one pass {tot:.1f} ms in {wall:.1f} ms of "
            f"host clock (idle {1 - tot / wall:.3f}): recorder "
            f"{fwd['record'] + bwd['record']:.2f} ms (table sorts included), "
            f"gathers {fwd['gathers'] + bwd['gathers']:.2f}, "
            f"replay forward {fwd['replay']:.1f}, replay backward "
            f"{bwd['replay']:.1f} ({bwd['replay'] / max(tot, 1e-9):.1%})")


def one_pass_split(scene, cam, target, seed: int, cfg) -> str:
    """The device-time split of one sample pass of the recorded train
    step (forward, then backward), profiled."""
    params = train_params(scene)
    one = rtt.RenderConfig(spp=1, max_depth=cfg.max_depth)
    out = {}

    def fwd():
        out["loss"] = rtt.pixel_loss(params, scene, cam, seed, target, one,
                                     "recorded")

    f = kernel_split(fwd)
    b = kernel_split(lambda: torch.autograd.grad(
        out["loss"], list(params.values()), allow_unused=True))
    return split_line(f, b)


def record_pass_kernel(scene, cam, dev, depth: int, stream=None,
                       passes: int = 1) -> tuple:
    """One record launch over the whole image for ``passes`` sample passes
    (render_diff's group), kernel (CUDA events, the tables built
    beforehand as render_diff builds them once per render) vs plain (host
    clock), by its mode's rule (:func:`record_compare`), with its bound:
    bytes read and written once, and resident every live segment against
    every column (the rule of rows 1 and 5, which sweep the same tables),
    streamed one primitive test per live segment (:func:`floor_ops`).
    Streamed, it is also held against the scene-order plain recorder.
    Returns (share unequal, ms, plain ms, bound ms, bound by, stats, table
    prep ms, the scene-order split)."""
    inputs = record_inputs(scene, cam, 1, depth, dev, passes=passes)
    share, k, st, _, _ = record_compare(scene, inputs, depth, stream,
                                        "record pass at full width")
    layout = tb.resolve(scene, "record", stream=stream)
    tabs, prep_s = timed(lambda: dk._record_tables(scene, layout,
                                                   inputs[0][0]))
    k_ms = event_ms(lambda: dk._record_rays(scene, layout, tabs, *inputs,
                                            max_depth=depth, t_min=1e-3), 3)
    with plain_recorded():
        _, p_s = timed(lambda: dk.record_paths(scene, *inputs,
                                               max_depth=depth, t_min=1e-3,
                                               stream=stream))
    stab, ttab = tabs.stab, tabs.ttab
    bounds = tabs if layout.mode == tb.STREAMED else None
    rows = () if bounds is None else (bounds.scb, bounds.tcb, bounds.sblk,
                                      bounds.tblk, bounds.sperm, bounds.tperm)
    per = SPHERE_OPS + (MOTION_OPS if scene.has_motion else 0)
    ops = (floor_ops(scene, st) if bounds is not None else int(st[0]) * (
        stab.shape[1] * per + ttab.shape[1] * TRI_OPS))
    b_ms, b_by = bound(nbytes(stab, ttab, *rows, *inputs, k), ops)
    split = (scene_order_split(scene, inputs, depth, k) if bounds is not None
             else None)
    return 1.0 - share, k_ms, p_s * 1e3, b_ms, b_by, st, prep_s * 1e3, split


def recorded_train_phase(scene, cam, target, smi: str, pp_mrays: float):
    """The recorded engine's main path at full width: bench.py's fwdbwd
    shape through engine="recorded" (two value-and-gradient micro-batches of 32 spp,
    gradients summed), counted, checked and timed; then two
    make_train_step steps. Returns the record launches."""
    f = FLAGSHIP
    cfg = rtt.RenderConfig(spp=MICRO_SPP, max_depth=f["depth"])
    params = train_params(scene)
    micro = f["spp"] // MICRO_SPP

    def fwdbwd(seed):
        return micro_batches(params, scene, cam, target, cfg, "recorded",
                             micro, seed)

    for k in dk.LAUNCHES:
        dk.LAUNCHES[k] = 0
    for k in pr.LAUNCHES:
        pr.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    (loss, _, grads), first_s = timed(lambda: fwdbwd(0))
    launches = dict(dk.LAUNCHES)
    gathers = {k: pr.LAUNCHES[k] for k in ("gather_fwd", "gather_bwd")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one record launch per group of passes; per replayed bounce one
    # gather forward, one more in the pass's recompute, and one backward
    # unless no gradient reaches its rows (a pass's last bounce adds only
    # the sky)
    groups = -(-MICRO_SPP // dk.RECORD_GROUP) * micro
    if (launches != {"resident": groups, "streamed": 0}
            or gathers["gather_fwd"] % 2
            or not 0 < gathers["gather_bwd"] <= gathers["gather_fwd"] // 2
            or gathers["gather_fwd"] > 2 * MICRO_SPP * micro * f["depth"]):
        raise AssertionError(f"train-recorded: record launches {launches}, "
                             f"gathers {gathers}")
    check_grads("train-recorded", loss, grads)
    rays = f["width"] * f["height"] * f["spp"]
    phase("train-recorded", f"fwdbwd 512x512 2x{MICRO_SPP}spp "
                            f"d{f['depth']}: loss {float(loss):.6g}, record "
                            f"launches {launches}, gathers {gathers} (per "
                            "replayed bounce two forward, the pass's "
                            "recompute being one, and one backward where a "
                            "gradient reaches the rows); gradients "
                            "finite (|d sphere_center| sum "
                            f"{float(grads['sphere_center'].abs().sum()):.4g}"
                            ", |d tex_color| sum "
                            f"{float(grads['tex_color'].abs().sum()):.4g}); "
                            f"first run {first_s:.2f} s, peak {peak_gb:.3f} "
                            "GB allocated")
    secs = [timed(lambda s=s: fwdbwd(s))[1] for s in range(1, TRAIN_RUNS + 1)]
    mrays = [rays / s / 1e6 for s in secs]
    phase("train-recorded", f"forward+backward Mrays/s median "
                            f"{statistics.median(mrays):.4f} (runs "
                            + ", ".join(f"{m:.4f}" for m in mrays)
                            + f"; {TRAIN_RUNS} after 1 warm-up; seconds "
                            + ", ".join(f"{s:.3f}" for s in secs)
                            + f"); recorded-pp in this run "
                            f"{pp_mrays:.4f} | peak {peak_gb:.3f} GB | {smi}")
    phase("train-recorded", one_pass_split(scene, cam, target, 5, cfg))
    before = {k: v.detach().clone() for k, v in params.items()}
    step = rtt.make_train_step(torch.optim.Adam(list(params.values()),
                                                lr=1e-3), cfg,
                               engine="recorded")
    losses = [float(step(params, scene, cam, 100 + s, target)[1])
              for s in range(2)]
    moved = max(float((params[k].detach() - before[k]).abs().max())
                for k in params if params[k].numel())
    if not (all(np.isfinite(losses)) and moved > 0.0):
        raise AssertionError(f"recorded train steps: losses {losses}, "
                             f"moved {moved}")
    phase("train-recorded", f"make_train_step x2 (engine recorded, Adam, lr "
                            f"1e-3, spp {MICRO_SPP}): losses {losses}, "
                            f"parameters moved by up to {moved:.3g}")
    return launches["resident"]


def large_train_phase(dev, smi: str) -> tuple:
    """The recorded engine beyond one block's shared memory: one
    value-and-gradient of pixel_loss(engine="recorded") on sphere_field
    100k, 512x288, 16 spp, depth 8, through the streamed recorder (16
    launches); recorded-pp refuses the scene. Then one 1-spp pass's record
    launch held against its plain version. Returns the streamed record
    launches and that launch's line."""
    n = LARGE_NS[0]
    scene, cam = rtt.scenes.sphere_field(n=n, width=LARGE["width"],
                                         device=dev)
    cfg = rtt.RenderConfig(spp=LARGE["spp"], max_depth=LARGE["depth"])
    target = rtt.render_fast(scene, cam, 0, cfg)
    try:
        rtt.pixel_loss(train_params(scene), scene, cam, 1, target, cfg,
                       "recorded-pp")
    except ValueError as e:
        if "'recorded'" not in str(e):
            raise
    else:
        raise AssertionError("recorded-pp did not refuse the 100k scene")

    def vg(seed):
        return loss_and_grads(scene, cam, seed, target, cfg, "recorded")

    for k in dk.LAUNCHES:
        dk.LAUNCHES[k] = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (loss, _, grads), first_s = timed(lambda: vg(0))
    launches = dict(dk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"resident": 0, "streamed": cfg.spp}:
        raise AssertionError(f"train-large: record launches {launches}")
    check_grads("train-large", loss, grads)
    rays = cam.width * cam.height * cfg.spp
    secs = [timed(lambda s=s: vg(s))[1] for s in range(1, TRAIN_RUNS + 1)]
    mr = [rays / s / 1e6 for s in secs]
    phase("train-large", f"sphere_field {n} {cam.width}x{cam.height} "
                         f"{cfg.spp}spp d{cfg.max_depth}, pixel_loss("
                         f"recorded) value and gradient: record launches "
                         f"{launches} (chunk {tb.RECORD_STREAM_CHUNK}), "
                         f"loss {float(loss):.6g}, gradients finite; "
                         "recorded-pp refuses the scene; Mrays/s median "
                         f"{statistics.median(mr):.4f} (runs "
                         + ", ".join(f"{m:.4f}" for m in mr)
                         + f"; first {first_s:.2f} s); peak {peak:.3f} GB "
                         f"| {smi}")
    phase("train-large", one_pass_split(scene, cam, target, 5, cfg))
    err, k_ms, p_ms, b_ms, b_by, st, prep_ms, split = record_pass_kernel(
        scene, cam, dev, cfg.max_depth, tb.RECORD_STREAM_CHUNK)
    s = [int(x) for x in st.tolist()]
    cols = sum(tb._padded_counts(scene, 1, tb.RECORD_STREAM_CHUNK))
    if s[1] > 0.05 * cols * s[0]:
        raise AssertionError(f"streamed record: {s[1] / s[0]:.1f} of {cols} "
                             "columns tested per segment (more than 5%)")
    phase("record", f"one streamed pass at {cam.width}x{cam.height} on "
                    f"{n} spheres ({cam.width * cam.height} rays, "
                    f"d{cfg.max_depth}; chunk {tb.RECORD_STREAM_CHUNK}, "
                    f"blocks of {tb.RECORD_STREAM_BLOCK}): kernel "
                    f"{k_ms:.3f} ms, plain {p_ms:.1f} ms, {1 - err:.4%} of "
                    f"indices equal; table prep {prep_ms:.2f} ms (host "
                    f"clock, once per render); {s[0]} segments, "
                    f"{s[1] / max(s[0], 1):.1f} of {cols} columns and "
                    f"{s[2] / max(s[0], 1):.1f} block bounds tested per "
                    f"segment, chunk tests {s[3]}, "
                    f"{1.0 - s[4] / max(s[3], 1):.4%} pruned; vs the "
                    f"scene-order plain recorder {split[0]} indices on "
                    f"{split[1]} rays differ, {split[2]} parting at an exact "
                    f"f32 tie; bound {b_ms:.4f} ms ({b_by})")
    return launches["streamed"], (err, k_ms, p_ms, b_ms, b_by)


#: The dense integrator's phase: the flagship scene at full width through
#: render_fast(engine="xla"), spp cut to 2, in chunks of 65,536 rays; one
#: value and gradient of pixel_loss(engine="dense") at spp 1; its peak
#: memory again at 8 spp.
DENSE = dict(spp=2, chunk=65_536, grad_spp=1, peak_spp=8)
#: Share of channels of the dense render within STOCHASTIC_ATOL of the
#: megakernel's at the same seed: the two trace the same paths but round
#: differently, so a near tie (a glass coin, a grazing hit) parts a path,
#: more often the deeper the paths.
DENSE_MATCH = 0.9


def offset_launches(args, kw, n: int, spp: int, out, out_p, acc) -> dict:
    """Row 1 at a pixel offset: the flagship's queue launch split in two
    halves, the second at p0 = n/2, against the one launch ``out`` (bit
    for bit), its folds against the one fold ``acc``, and the p0 launch
    against its plain version at p0 (which must equal the plain launch's
    rows ``out_p``)."""
    half = n // 2
    lo = mk._queue(*args, half, 0, spp, **kw)
    hi = mk._queue(*args, n - half, 0, spp, p0=half, **kw)
    ms = event_ms(lambda: mk._queue(*args, n - half, 0, spp, p0=half, **kw),
                  3)
    plain = mk._queue_reference(*args, n - half, 0, spp, p0=half, **kw)
    sums = torch.cat([mk._fold(x, torch.zeros((3, x.shape[2]),
                                              device=x.device))
                      for x in (lo, hi)], dim=1)
    checks = {"halves == one launch": torch.equal(torch.cat([lo, hi], 2),
                                                  out),
              "folded halves == one fold": torch.equal(sums, acc),
              "plain at p0 == plain rows": torch.equal(plain,
                                                       out_p[:, :, half:])}
    if not all(checks.values()):
        raise AssertionError(f"row 1 at a pixel offset: {checks}")
    return dict(half=half, ms=ms, err=float((hi - plain).abs().max()),
                items=float((hi == plain).all(dim=1).double().mean()))


def kernel_launches() -> int:
    """Launches counted by every kernel wrapper of the port."""
    return (mk.LAUNCHES + wf.LAUNCHES + sum(pr.LAUNCHES.values())
            + sum(dk.LAUNCHES.values()))


def reset_launches() -> None:
    mk.LAUNCHES = 0
    wf.LAUNCHES = 0
    for counts in (mk.MODE_LAUNCHES, pr.LAUNCHES, dk.LAUNCHES):
        for k in counts:
            counts[k] = 0


def nested_checker_scene(dev):
    """tests/test_render.py's six-deep checker scene: nested checkers,
    which only the dense integrator shades."""
    b = rtt.SceneBuilder()
    cur = b.add_solid_texture((0.9, 0.1, 0.1))
    other = b.add_solid_texture((0.1, 0.1, 0.9))
    for lvl in range(5):
        cur = b.add_checker_texture(1.6 / (2 ** lvl), cur, other)
    b.add_sphere((0, -100.5, -2), 100.0, b.add_diffuse(texture=cur))
    b.add_sphere((0, 0, -2), 0.5, b.add_diffuse(texture=cur))
    cam = rtt.make_camera(width=64, height=64, vfov=55.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          device=dev)
    return b.build(device=dev), cam


def dense_peaks(scene, cam, cfg, peak: int, smi: str) -> None:
    """The dense render's peak memory at DENSE["peak_spp"] against ``peak``,
    the one at ``cfg.spp`` with the same chunk: within 5%, and below half
    of what the stacked form (every pass's [H*W, 3] radiance kept, then a
    concatenated copy) would add for the extra passes."""
    cfg8 = cfg._replace(spp=DENSE["peak_spp"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    img, sec = timed(lambda: rtt.render_fast(scene, cam, 1, cfg8,
                                             engine="xla"))
    peak8 = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("dense 8-spp image not finite")
    stacked = 2 * 12 * cam.width * cam.height * (cfg8.spp - cfg.spp)
    grow = peak8 - peak
    if abs(grow) > 0.05 * peak or grow > stacked / 2:
        raise AssertionError(f"dense peak {peak} B at {cfg.spp} spp, "
                             f"{peak8} B at {cfg8.spp}: it grows with spp")
    phase("dense", f"peak memory of render_fast(xla) {cam.width}x"
                   f"{cam.height} d{cfg.max_depth}, chunks of "
                   f"{cfg.chunk_size}: {peak} B at {cfg.spp} spp, {peak8} B "
                   f"at {cfg8.spp} spp ({grow:+d} B, "
                   f"{grow / peak:+.4%}; the stacked form would add about "
                   f"{stacked} B); {cfg8.spp} spp in {sec * 1e3:.1f} ms | "
                   f"{smi}")


def dense_phase(dev, smi: str) -> None:
    """The dense integrator on the card (plain torch, no kernel of the
    port): the golden, independent of the matmul precision setting; the
    flagship at full width through render_fast(engine="xla") against the
    megakernel's image at the same seed; one value and gradient of
    pixel_loss(engine="dense"); a nested-checker scene through
    render_fast("auto") against the same render on the CPU; fit with its
    defaults."""
    scene, cam, cfg = golden_scene(dev)
    img = rtt.render(scene, cam, 0, cfg)
    step, frac = golden_check(img)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        loose = rtt.render(scene, cam, 0, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    if not torch.equal(img, loose):
        raise AssertionError("the dense render depends on the matmul "
                             "precision setting")
    phase("dense", f"golden through render: max step {step}, {frac:.4%} of "
                   "channels off; the same bits with TF32 matmuls allowed")

    f = FLAGSHIP
    scene, cam = rtt.scenes.random_bouncing(width=f["width"],
                                            height=f["height"], device=dev)
    cfg = rtt.RenderConfig(spp=DENSE["spp"], max_depth=f["depth"],
                           chunk_size=DENSE["chunk"])
    rays = f["width"] * f["height"] * cfg.spp
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    img, sec = timed(lambda: rtt.render_fast(scene, cam, 1, cfg,
                                             engine="xla"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    dense_peaks(scene, cam, cfg, torch.cuda.max_memory_allocated(), smi)
    if kernel_launches():
        raise AssertionError("the dense render launched a kernel of the port")
    if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
            and img.shape == (f["height"], f["width"], 3)):
        raise AssertionError("dense flagship image not finite/shaped")
    ref = rtt.render_megakernel(scene, cam, 1, cfg)
    share = float(((img - ref).abs() <= STOCHASTIC_ATOL).double().mean())
    mean_diff = float((img.mean((0, 1)) - ref.mean((0, 1))).abs().max())
    if share < DENSE_MATCH or mean_diff > BLOCK_MEAN_ATOL:
        raise AssertionError(f"dense vs megakernel: {share:.4%} of channels "
                             f"within {STOCHASTIC_ATOL}, image means "
                             f"{mean_diff} apart")
    phase("dense", f"render_fast(xla) {f['width']}x{f['height']} "
                   f"{cfg.spp}spp d{cfg.max_depth}, chunks of {cfg.chunk_size}: "
                   f"{sec * 1e3:.1f} ms wall, {rays / sec / 1e6:.4f} "
                   f"Mrays/s, peak {peak:.3f} GB, "
                   f"no kernel launched; {share:.4%} of channels within "
                   f"{STOCHASTIC_ATOL} of the megakernel's image at the same "
                   f"seed, image means within {mean_diff:.3g} | {smi}")

    gcfg = cfg._replace(spp=DENSE["grad_spp"])
    target = rtt.render_fast(scene, cam, 0, gcfg)
    params = train_params(scene)

    def value_and_grad():
        loss = rtt.pixel_loss(params, scene, cam, 3, target, gcfg, "dense")
        return loss, torch.autograd.grad(loss, list(params.values()),
                                         allow_unused=True)
    torch.cuda.reset_peak_memory_stats()
    (loss, grads), sec = timed(value_and_grad)
    loss = loss.detach()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_grads("dense", loss, dict(zip(params, grads)))
    phase("dense", f"pixel_loss(dense) value and gradient {f['width']}x"
                   f"{f['height']} {gcfg.spp}spp d{gcfg.max_depth}, remat, "
                   f"chunks of {gcfg.chunk_size}: {sec * 1e3:.1f} ms, peak "
                   f"{peak:.3f} GB, loss {loss.item():.6g}, gradients finite "
                   f"({', '.join(k for k, g in zip(params, grads) if g is not None)})")

    scene, cam = nested_checker_scene(dev)
    cfg = rtt.RenderConfig(spp=4, max_depth=4)
    if rtt.pick_engine(scene, "auto") != "xla":
        raise AssertionError("auto did not pick the dense integrator for "
                             "nested checkers")
    img = rtt.render_fast(scene, cam, 5, cfg)
    ref = rtt.render_fast(scene.to("cpu"), cam.to("cpu"), 5, cfg)
    share = float(((img.cpu() - ref).abs() <= STOCHASTIC_ATOL).double()
                  .mean())
    agr = agreement(img.cpu(), ref)
    if share < DENSE_MATCH or agr["block"] > BLOCK_MEAN_ATOL:
        raise AssertionError(f"nested checkers, card vs CPU: {share:.4%} "
                             f"of channels within {STOCHASTIC_ATOL}, {agr}")
    phase("dense", f"six-deep checker 64x64 {cfg.spp}spp d{cfg.max_depth} "
                   f"through render_fast(auto) = xla: {share:.4%} of channels "
                   f"within {STOCHASTIC_ATOL} of the same render on the CPU")
    # the recorders cannot shade nested checkers: allow_dense degrades, loud
    params = {"tex_color": scene.tex_color.clone().requires_grad_(True)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss = rtt.pixel_loss(params, scene, cam, 6, img, cfg, "recorded",
                              allow_dense=True)
    dense = rtt.pixel_loss(params, scene, cam, 6, img, cfg, "dense")
    if (not any(issubclass(w.category, RuntimeWarning) for w in caught)
            or loss.item() != dense.item()):
        raise AssertionError("allow_dense did not degrade to the dense "
                             "engine with a RuntimeWarning")
    phase("dense", "pixel_loss(engine='recorded', allow_dense=True) on it: "
                   "RuntimeWarning, the dense engine's loss "
                   f"{loss.item():.6g}")

    scene, cam = rtt.scenes.random_bouncing(width=64, height=36, device=dev)
    cfg = rtt.RenderConfig(spp=2, max_depth=8)
    target = rtt.render_fast(scene, cam, 0, cfg)
    _, hist = rtt.fit(scene, cam, target, config=cfg, steps=2)
    if len(hist) != 2 or not all(np.isfinite(hist)):
        raise AssertionError(f"fit with its defaults: {hist}")
    phase("dense", f"fit(defaults: engine dense, every trainable field) on "
                   f"random_bouncing 64x36 {cfg.spp}spp d{cfg.max_depth}, 2 "
                   f"Adam steps: losses {hist[0]:.6g}, {hist[1]:.6g}")


#: Ranks of the sharded phase, sharing the one card over gloo (NCCL takes
#: one rank per device), and the seconds they may take together.
SHARDED_RANKS = 2
SHARDED_LIMIT_S = 420
#: The mesh train step against this process: the loss relative to the
#: single-process pixel_loss's, and each gradient field, relative to its
#: largest entry, against the same two pixel shares differentiated here and
#: added (the ranks' arithmetic but for the transport). Against the
#: single-process gradients the bound is GRAD_RTOL: a field's gradient sums
#: millions of terms of both signs in float32, and split in two shares it
#: sums them in another order.
MESH_RTOL = 1e-5


def sharded_rank(rank: int, port: int, out: str) -> None:
    """One of SHARDED_RANKS processes that share the card over gloo: the
    flagship at full width through render_megakernel_sharded (its pixel
    shard, counted, then timed), the image assembled on rank 0, and one
    "recorded-pp" mesh train step at 32 spp (counted; SGD at lr 0 keeps
    the all-reduced gradients in .grad). Rank 0 saves what it saw to
    ``out``."""
    from rayz_tpu_torch import parallel
    from rayz_tpu_torch.parallel.mesh import shard_range

    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(f"127.0.0.1:{port}", SHARDED_RANKS, rank,
                        backend="gloo", device="cuda")
    try:
        mesh = parallel.make_mesh("cuda")
        dev = torch.device("cuda", torch.cuda.current_device())
        f = FLAGSHIP
        scene, cam = rtt.scenes.random_bouncing(width=f["width"],
                                                height=f["height"],
                                                device=dev)
        cfg = rtt.RenderConfig(spp=f["spp"], max_depth=f["depth"])
        reset_launches()
        img = mk.render_megakernel_sharded(scene, cam, 1, cfg, mesh)
        torch.cuda.synchronize()
        render_launches = dict(mk.MODE_LAUNCHES)
        wall = [timed(lambda: mk.render_megakernel_sharded(
            scene, cam, 1, cfg, mesh))[1] * 1e3 for _ in range(3)]
        p0, p1 = shard_range(cam.width * cam.height, mesh)
        full = parallel.assemble_global_image(img.reshape(-1, 3)[p0:p1])
        if (full is None) != (rank != 0):
            raise AssertionError(f"rank {rank}: assemble_global_image gave "
                                 f"{'None' if full is None else 'an image'}")
        target = rtt.render_megakernel(scene, cam, 0, cfg)
        params = train_params(scene)
        opt = torch.optim.SGD(list(params.values()), lr=0.0)
        step = rtt.make_train_step(opt, cfg._replace(spp=MICRO_SPP), mesh,
                                   engine="recorded-pp", with_leftover=True)
        reset_launches()
        (_, loss, left), step_s = timed(
            lambda: step(params, scene, cam, 5, target))
        if rank == 0:
            torch.save({
                "img": torch.from_numpy(full), "pixels": (p0, p1),
                "render_launches": render_launches, "render_ms": wall,
                "loss": loss.cpu(), "left": int(left),
                "grads": {k: p.grad.cpu() for k, p in params.items()},
                "step_launches": dict(pr.LAUNCHES), "step_s": step_s}, out)
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(out: str) -> float:
    """Spawn the sharded ranks and wait for them (at most
    SHARDED_LIMIT_S); a rank that fails, or the time running out, stops
    them all and raises. Returns the wall seconds."""
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ctx = tmp.start_processes(sharded_rank, args=(port, out),
                              nprocs=SHARDED_RANKS, join=False,
                              start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > SHARDED_LIMIT_S:
                raise AssertionError(f"sharded ranks still running after "
                                     f"{SHARDED_LIMIT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return time.perf_counter() - t0


def split_grads(scene, cam, seed: int, target, cfg) -> dict:
    """The mesh step's gradients computed in this process: each rank's
    pixels (round-robin over SHARDED_RANKS) differentiated on its own, the
    shares added in rank order and divided by H*W*3, as the all-reduce
    and the step do."""
    from rayz_tpu_torch.diff import inverse

    n = cam.width * cam.height
    total = None
    for r in range(SHARDED_RANKS):
        params = train_params(scene)
        pix = torch.arange(r, n, SHARDED_RANKS, dtype=torch.int32,
                           device=cam.device)
        loss, _ = inverse._shard_loss(params, scene, cam, seed, target, cfg,
                                      "recorded-pp", None, False, pix)
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(params.values(), g)]
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return {k: x / (n * 3) for k, x in zip(params, total)}


def sharded_phase(dev, smi: str) -> None:
    """The pixel-sharded paths on the one card: two ranks over gloo (the
    flagship through render_megakernel_sharded, its image assembled on rank
    0 against this process's render bit for bit; a "recorded-pp" mesh step
    at full width against this process's pixel_loss), then a world of one
    over NCCL, the backend of a machine with a card per rank, rendering
    the flagship the same way. One card shows no scaling: the wall time of
    two ranks sharing it is printed as that."""
    from rayz_tpu_torch import parallel

    f = FLAGSHIP
    out = os.path.join(ROOT, "build", "sharded", "rank0.pt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    torch.cuda.empty_cache()
    wall_s = run_ranks(out)
    got = torch.load(out, weights_only=True)

    scene, cam = rtt.scenes.random_bouncing(width=f["width"],
                                            height=f["height"], device=dev)
    cfg = rtt.RenderConfig(spp=f["spp"], max_depth=f["depth"])
    img = rtt.render_fast(scene, cam, 1, cfg)
    want = {"resident": 1, "culled": 0, "streamed": 0, "fold": 1}
    if got["render_launches"] != want:
        raise AssertionError(f"sharded render launches "
                             f"{got['render_launches']}, expected {want}")
    if not torch.equal(got["img"].reshape(img.shape), img.cpu()):
        raise AssertionError("two ranks' assembled image differs from the "
                             "single-process render")
    phase("sharded", f"{SHARDED_RANKS} ranks over gloo on one card, "
                     f"render_megakernel_sharded 512x512 {cfg.spp}spp "
                     f"d{cfg.max_depth}: rank 0 traced pixels "
                     f"{got['pixels']} in {got['render_launches']['resident']}"
                     f" queue launch and {got['render_launches']['fold']} "
                     "fold at its offset; the image assembled on rank 0 "
                     "equals the single-process render bit for bit; wall "
                     "time of two ranks sharing one card (no scaling "
                     "figure): " + ", ".join(f"{t:.1f}" for t in
                                             got["render_ms"])
                     + " ms a render, the gather through host memory "
                     f"included | {smi}")

    target = rtt.render_megakernel(scene, cam, 0, cfg)
    mcfg = cfg._replace(spp=MICRO_SPP)
    loss, left, grads = loss_and_grads(scene, cam, 5, target, mcfg)
    split = split_grads(scene, cam, 5, target, mcfg)

    def rel(a, b):  # a field with no rows (no triangles here) agrees
        if not b.numel():
            return 0.0
        return float((a - b.cpu()).abs().max()
                     / b.abs().max().clamp_min(1e-30).cpu())
    rel_loss = abs(float(got["loss"]) - loss.item()) / loss.item()
    rel_split = {k: rel(got["grads"][k], g) for k, g in split.items()}
    rel_one = {k: rel(got["grads"][k], g) for k, g in grads.items()
               if g is not None}
    if (got["left"] or left or rel_loss > MESH_RTOL
            or max(rel_split.values()) > MESH_RTOL
            or max(rel_one.values()) > GRAD_RTOL):
        raise AssertionError(f"mesh step vs this process: leftover "
                             f"{got['left']} / {left}, loss {rel_loss}, "
                             f"gradients vs the same shares {rel_split}, vs "
                             f"one share {rel_one}")
    if not all(got["step_launches"].values()):
        raise AssertionError(f"mesh step launches {got['step_launches']}")
    phase("sharded", f"make_train_step(mesh, recorded-pp) 512x512 "
                     f"{MICRO_SPP}spp d{cfg.max_depth} over the two ranks: "
                     f"loss {float(got['loss']):.6g}, leftover 0, within "
                     f"{rel_loss:.3g} of the single-process pixel_loss "
                     f"(bound {MESH_RTOL}); gradients within "
                     f"{max(rel_split.values()):.3g} of the two shares "
                     f"differentiated here and added (bound {MESH_RTOL}), "
                     f"within {max(rel_one.values()):.3g} of the single-"
                     f"process ones (bound {GRAD_RTOL}: float32 sums in "
                     f"another order; by field {rel_one}); rank 0 launches "
                     f"{got['step_launches']}, {got['step_s']:.3f} s; both "
                     f"ranks took {wall_s:.1f} s from spawn to exit")

    try:
        mesh = parallel.make_mesh("cuda")
        backend = torch.distributed.get_backend(mesh.get_group())
        reset_launches()
        one = mk.render_megakernel_sharded(scene, cam, 1, cfg, mesh)
        torch.cuda.synchronize()
        launches = dict(mk.MODE_LAUNCHES)
        full = parallel.assemble_global_image(one.reshape(-1, 3))
    finally:
        torch.distributed.destroy_process_group()
    if launches != want or not torch.equal(one, img) or not np.array_equal(
            full.reshape(img.shape), img.cpu().numpy()):
        raise AssertionError(f"world of one over {backend}: launches "
                             f"{launches}, image equal "
                             f"{torch.equal(one, img)}")
    phase("sharded", f"a world of one over {backend} (the store in memory): "
                     "render_megakernel_sharded equals the single-process "
                     "render bit for bit, and so does the assembled image")


#: gpu_check's size in the parity phase: 64 wide keeps its 256-spp
#: tolerances (the mean absolute error's expected value, and so the noise
#: floor, does not depend on the width); the recorded engines at 64 spp
PARITY = dict(width=64, spp=256)


def launch_counts() -> dict:
    """Every kernel's launch counter by name: the megakernel's modes and
    fold, the wavefront, the recorded-pp kernels, the record kernel's two
    modes."""
    return {**{f"megakernel_{k}": v for k, v in mk.MODE_LAUNCHES.items()},
            "wavefront": wf.LAUNCHES, **pr.LAUNCHES,
            **{f"record_{k}": v for k, v in dk.LAUNCHES.items()}}


def parity_phase(dev, smi: str) -> None:
    """gpu_check's whole list at PARITY: each stochastic engine and table
    mode at one seed against the dense integrator at another, within
    Monte-Carlo error and with the oracle's noise floor below each
    tolerance, then the three gradient lines, and the triangle line again
    on the plain versions and through the eager replay. Counted: every
    kernel of the port must launch."""
    lines = []

    def out(line: str) -> None:
        lines.append(line)
        phase("parity", line)

    reset_launches()
    checks = gpu_check.Checks(PARITY["width"], PARITY["spp"], dev, out=out)
    ok, secs = timed(checks.run)
    counts = launch_counts()
    # the triangle line's finite difference of the same frozen recording
    # through other implementations of the replay: the kernels' plain
    # versions on the card, and the eager replay (autograd of plain torch)
    name, fields, kw = gpu_check.FD_LINES["tri_vertices"]
    for what, ctx in (("plain", plain_pathrec), ("eager", eager_replay)):
        with ctx():
            ok &= checks.grad_fd(f"tri_vertices[{what}]", name, fields,
                                 min(PARITY["width"], 64), **kw)
    fails = [ln for ln in lines if not ln.startswith("OK")]
    if not ok or fails:
        raise AssertionError(f"gpu_check: {fails}")
    idle = [k for k, v in counts.items() if not v]
    if idle:
        raise AssertionError(f"gpu_check launched no {idle}: {counts}")
    phase("parity", f"{len(lines)} checks OK at {PARITY['width']} wide, "
                    f"{PARITY['spp']} spp (recorded {min(PARITY['spp'], 64)})"
                    f" in {secs:.1f} s; launches {counts} | {smi}")


def script_line(what: str, row: dict, want: set, counts: dict) -> str:
    """A bench script's row through JSON and back, with its keys, its
    finite positive rates, and the launches it made, checked."""
    line = json.dumps(row)
    back = json.loads(line)
    rates = [v for k, v in back.items() if isinstance(v, float)]
    if (set(back) != want or not rates
            or not all(np.isfinite(rates)) or min(rates) <= 0):
        raise AssertionError(f"{what}: {line}")
    if not all(counts.values()):
        raise AssertionError(f"{what} launched no {counts}")
    return line


def scripts_phase(dev) -> None:
    """The bench scripts' own functions on the card: bench_configs' first
    config and bench_culling's 10k row (512x288, 16 spp, depth 8, 5 seeds),
    each JSON line checked, each counted."""
    reset_launches()
    row = bench_configs.config_row(*bench_configs.CONFIGS[0], device=dev)
    want = {"config", "width", "height", "spp", "depth", "fwd_mrays_per_s",
            "engine", "device"}
    counts = {k: mk.MODE_LAUNCHES[k] for k in ("resident", "fold")}
    phase("scripts", "bench_configs " + script_line(
        "bench_configs", row, want, counts) + f"; launches {counts}")

    reset_launches()
    row = bench_culling.culling_row(10_000, device=dev)
    want = {"n_spheres", "width", "spp", "depth", "fits_shared", "seeds",
            "speedup", "best_speedup", "auto", "device"}
    for mode in ("brute_force", "culling_on", "wavefront"):
        want |= {mode, mode + "_median", mode + "_digest"}
    counts = {"streamed": mk.MODE_LAUNCHES["streamed"],
              "fold": mk.MODE_LAUNCHES["fold"], "wavefront": wf.LAUNCHES}
    if row["fits_shared"] or row["auto"] != "wavefront":
        raise AssertionError(f"bench_culling 10k: {row}")
    phase("scripts", "bench_culling " + script_line(
        "bench_culling", row, want, counts) + f"; launches {counts}")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device: this smoke test runs "
                           "on an NVIDIA GPU only")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    smi = card(dev)
    phase("card", f"{smi} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | python {sys.version.split()[0]}")

    # ---- 2. build ----
    lib, info = _build.load()
    regs = [ln.split(":", 1)[-1].strip() for ln in info.log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    phase("build", f"{'compiled' if info.compiled else 'reused'} "
                   f"{', '.join(_build._SOURCES)} into {info.path.name} in "
                   f"{info.seconds:.2f} s; " + " | ".join(regs))

    # the sphere sweep of rows 1 and 5: registers and spills, and the
    # instructions a column issues in the sweep loop (SASS)
    for name, regs in ptxas_facts(info.log).items():
        phase("sweep", f"{name} ptxas: {regs}")
    for name, ops in sass_sweep(info.path).items():
        phase("sweep", f"{name}<true> sweep loop, per column: "
                       f"{ops['total']:.3f} instructions ("
                       + ", ".join(f"{k} {v:g}" for k, v in ops.items()
                                   if k != "total") + ")")

    # ---- 3. RNG: CUDA hash against ops/rng.py on 2^20 counters ----
    r = np.random.default_rng(0)
    n = 1 << 20
    cols = [torch.from_numpy(r.integers(lo, hi, n).astype(np.int32)).to(dev)
            for lo, hi in ((-1, 1 << 20), (0, 65), (0, 33), (0, 9))]
    pix, sample, bounce, draw = cols
    out = torch.empty(n, dtype=torch.int32, device=dev)
    seed = 12345
    _build.check(lib, lib.rayz_rng_bits(
        seed, *(c.data_ptr() for c in cols), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "rng_bits")
    key = rng.step_key(rng.slot_key(seed, pix), sample, bounce)
    want = torch.empty(n, dtype=torch.int64, device=dev)
    for d in range(9):
        sel = draw == d
        want[sel] = rng.draw_bits(key[sel], d)
    got = out.to(torch.int64) & rng.MASK
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"rng: {bad} of {n} CUDA draws differ from "
                             "ops/rng.py")
    phase("rng", f"{n} counters: CUDA hash == torch hash bit for bit")

    # ---- 4. golden scene: the queue vs golden and vs the plain version ----
    scene, cam, cfg = golden_scene(dev)
    img = rtt.render_megakernel(scene, cam, 0, cfg)
    torch.cuda.synchronize()
    step, frac = golden_check(img)
    with plain_version():
        ref = rtt.render_megakernel(scene, cam, 0, cfg)
    ex = explain_pixels(scene, cam, 0, cfg, img, ref, "golden")
    max_err = ex["max_abs"]
    phase("golden", f"queue: max step {step}, {frac:.4%} channels off "
                    f"golden; kernel vs plain {ex['share']:.4%} of pixels "
                    f"identical ({ex['pixels']} explained), max abs "
                    f"{ex['max_abs']:.3g}")

    # ---- 5. random_bouncing 64x36, 16 spp, depth 8, real random bits ----
    scene, cam = rtt.scenes.random_bouncing(width=64, height=36, device=dev)
    cfg = rtt.RenderConfig(spp=16, max_depth=8)
    queue = rtt.render_fast(scene, cam, 3, cfg)
    with plain_version():
        ref = rtt.render_fast(scene, cam, 3, cfg)
    torch.cuda.synchronize()
    agr = agreement(queue, ref)
    if agr["frac"] >= STOCHASTIC_MAX_FRAC or agr["block"] > BLOCK_MEAN_ATOL:
        raise AssertionError(f"random_bouncing kernel vs plain: {agr}")
    ex = explain_pixels(scene, cam, 3, cfg, queue, ref, "random_bouncing")
    max_err = max(max_err, agr["max_abs"])
    phase("stochastic", "random_bouncing 64x36 16spp d8, the queue vs "
                        f"plain: {ex['share']:.4%} of pixels identical "
                        f"({ex['pixels']} explained), {agr['frac']:.4%} "
                        f"channels > {STOCHASTIC_ATOL}, max abs "
                        f"{agr['max_abs']:.3g}, 8x8 block means within "
                        f"{agr['block']:.3g}")

    # the triangle sweep with tables above 48 KB (the shared-memory opt-in)
    scene, cam = rtt.scenes.cornell_box(width=48, device=dev)
    cfg = rtt.RenderConfig(spp=4, max_depth=8)
    kimg = rtt.render_megakernel(scene, cam, 4, cfg)
    with plain_version():
        ref = rtt.render_megakernel(scene, cam, 4, cfg)
    agr = agreement(kimg, ref)
    if agr["frac"] >= STOCHASTIC_MAX_FRAC or agr["block"] > BLOCK_MEAN_ATOL:
        raise AssertionError(f"cornell_box kernel vs plain: {agr}")
    ex = explain_pixels(scene, cam, 4, cfg, kimg, ref, "cornell_box")
    max_err = max(max_err, agr["max_abs"])
    phase("stochastic", f"cornell_box 48x48 4spp d8 "
                        f"({tb.resolve(scene, 'megakernel').smem} B of "
                        f"tables): the queue vs plain "
                        f"{ex['share']:.4%} of pixels identical "
                        f"({ex['pixels']} explained), {agr['frac']:.4%} "
                        f"channels > {STOCHASTIC_ATOL}, max abs "
                        f"{agr['max_abs']:.3g}")

    # ---- 6. the main path: flagship through render_fast(engine="auto") ----
    f = FLAGSHIP
    scene, cam = rtt.scenes.random_bouncing(width=f["width"],
                                            height=f["height"], device=dev)
    cfg = rtt.RenderConfig(spp=f["spp"], max_depth=f["depth"])
    rays = f["width"] * f["height"] * f["spp"]
    mk.LAUNCHES = 0
    for k in mk.MODE_LAUNCHES:
        mk.MODE_LAUNCHES[k] = 0
    img = rtt.render_fast(scene, cam, 1, cfg, engine="auto")
    torch.cuda.synchronize()
    launches, modes = mk.LAUNCHES, dict(mk.MODE_LAUNCHES)
    if launches != 2 or modes["resident"] != 1 or modes["fold"] != 1:
        raise AssertionError(f"main path made {launches} kernel launches "
                             f"({modes}), expected one queue launch and one "
                             "fold")
    if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
            and img.shape == (f["height"], f["width"], 3)):
        raise AssertionError("flagship image not finite/non-negative/shaped")
    phase("flagship", f"render_fast(auto): {launches} kernel launches "
                      f"({modes['resident']} queue, {modes['fold']} fold, "
                      f"persistent grid of {mk.QUEUE_GRID} blocks), image "
                      f"{tuple(img.shape)} finite, mean "
                      f"{float(img.mean()):.4f}")

    def run(seed):
        return rtt.render_fast(scene, cam, seed, cfg)
    timed(lambda: run(0))  # warm-up
    mrays = [rays / timed(lambda s=s: run(s))[1] / 1e6
             for s in range(1, RUNS + 1)]
    phase("flagship", f"queue: Mrays/s median {statistics.median(mrays):.3f} "
                      "(runs " + ", ".join(f"{m:.3f}" for m in mrays)
                      + f"; {RUNS} after 1 warm-up) | {smi_clocks()}")
    flag = flagship_kernels(scene, cam, cfg, img, dev)
    max_err = max(max_err, flag["queue_err"])

    # ---- 7-10. recorder, gathers, fused replay, small gradient ----
    rec_err = record_phase(dev)
    gather = gather_phase(dev)
    replay_err = replay_phase(dev)
    grad_phase(dev)
    rec10_err, rec10 = diff_record_phase(dev)
    recorded_grad_phase(dev)

    # ---- 11. the gradient main path: the flagship recorded-pp step ----
    scene, cam = rtt.scenes.random_bouncing(width=f["width"],
                                            height=f["height"], device=dev)
    flag_err, *rec = record_flagship(scene, cam, dev)
    replay = replay_flagship(scene, cam, dev)
    torch.cuda.empty_cache()
    target = rtt.render_fast(scene, cam, 0, cfg)
    train = train_phase(scene, cam, target, smi)
    torch.cuda.empty_cache()
    rec_launches = recorded_train_phase(scene, cam, target, smi,
                                        train["mrays"])
    del target
    torch.cuda.empty_cache()

    # ---- 12-15. large scenes: the wavefront kernel vs plain in its three
    # table modes, the megakernel's culled and streamed modes, the two
    # engines, the golden; then the large-scene main path ----
    wf_err = wavefront_phase(dev)
    culled_launches, culled = megakernel_modes_phase(dev)
    engines_phase(dev)
    large_golden_phase(dev)
    large = large_phase(dev, smi)
    torch.cuda.empty_cache()
    streamed_launches, large_rec = large_train_phase(dev, smi)
    torch.cuda.empty_cache()

    # ---- 16. the dense integrator (plain torch) ----
    dense_phase(dev, smi)
    torch.cuda.empty_cache()

    # ---- 17. the pixel-sharded paths ----
    sharded_phase(dev, smi)

    # ---- 18-19. the scripts: gpu_check's parity list, the bench rows ----
    parity_phase(dev, smi)
    torch.cuda.empty_cache()
    scripts_phase(dev)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound_ms,
              bound_by, library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"rayz_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    tl = train["launches"]
    wf_kernel = large["wavefront"]
    phase("time", f"{time.perf_counter() - t_start:.1f} s from the start to "
                  "the summary, the kernels' build included")
    print(smi)
    print(json.dumps({"kernels": [
        entry("megakernel", "megakernel.cu", "rayz_tpu/ops/megakernel.py:459",
              modes["resident"], max_err, *flag["queue"]),
        entry("fold", "megakernel.cu", "rayz_tpu/ops/megakernel.py:459",
              modes["fold"], *flag["fold"]),
        entry("megakernel_culled", "megakernel.cu",
              "rayz_tpu/ops/megakernel.py:767", culled_launches, *culled),
        entry("megakernel_streamed", "megakernel.cu",
              "rayz_tpu/ops/megakernel.py:883", large["mk_launches"],
              *large["megakernel_streamed"]),
        entry("wavefront", "wavefront.cu", "rayz_tpu/ops/wavefront.py:127",
              large["launches"], max(wf_err, wf_kernel[0]), *wf_kernel[1:]),
        entry("record_pp", "record_pp.cu", "rayz_tpu/ops/pathrec.py:186",
              tl["record_pp"], max(rec_err, flag_err), *rec),
        entry("gather_fwd", "gather.cu", "rayz_tpu/ops/pathrec.py:1095",
              tl["gather_fwd"], *gather["gather_fwd"]),
        entry("gather_bwd", "gather.cu", "rayz_tpu/ops/pathrec.py:1120",
              tl["gather_bwd"], *gather["gather_bwd"]),
        *(entry(name, "replay_pp.cu", replaces, tl[name],
                max(small, replay[name][0]), *replay[name][1:])
          for name, replaces, small in (
              ("replay_fwd", "rayz_tpu/ops/pathrec.py:1512", replay_err[0]),
              ("replay_bwd", "rayz_tpu/ops/pathrec.py:1565", replay_err[1]))),
        entry("record", "record.cu", "rayz_tpu/ops/diffkernel.py:130",
              rec_launches, max(rec10_err["resident"], rec10[0]),
              *rec10[1:]),
        entry("record_streamed", "record.cu",
              "rayz_tpu/ops/diffkernel.py:285", streamed_launches,
              max(rec10_err["streamed"], large_rec[0]), *large_rec[1:]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
