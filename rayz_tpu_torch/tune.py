"""Tuning measurements of the port on one NVIDIA GPU.

    python -m rayz_tpu_torch.tune tiling [--ns 10000,100000]
        [--chunks 512,1024,2048] [--blocks 32,64,128]
    python -m rayz_tpu_torch.tune record [--n 100000] [--chunks 256,512,1024]
        [--blocks 16,32,64]
    python -m rayz_tpu_torch.tune ab TREE [TREE ...] [--rounds 4]
        [--part all|wavefront]

``tiling`` sweeps the streamed layout's chunk and block sizes on
``sphere_field`` at 512x288, 16 spp, depth 8 (the large-scene path of
``chip_smoke.py``): for every (chunk, block) it renders through the
wavefront and the streamed megakernel, prints Mrays/s (median of 5 after a
warm-up, synced), the wavefront's work counters and the share of pixels
equal to the default layout's image. The block inside a chunk is set by
rebinding ``tables.STREAM_BLOCK``, which the layout resolver reads, for
the sweep.

``record`` times the bounce-indexed recorder's streamed launch on one
1-spp pass of ``sphere_field`` (512x288, depth 8: one sample pass of
``chip_smoke.py``'s large recorded step) for every chunk x block: the
kernel's CUDA-event milliseconds (mean of 5 after a warm-up, tables built
beforehand), the table prep's host-clock milliseconds, its work counters
and the share of indices equal to the first setting's (they differ only at
exact ties).

``ab`` times several checkouts of this package against each other in one
process tree: every TREE is a directory holding a ``rayz_tpu_torch``
package; each round runs one child process per tree, in alternating order,
which builds that tree's kernels (once, into ``TREE/build/kernels``) and
prints the flagship and the Cornell box forward (``random_bouncing`` and
``cornell_box`` 512x512, 64 spp, depth 32, through ``render_fast``: the
tree's default schedule), the flagship's queue launch at 64 and 1 spp
(``flagship_queue``: CUDA-event ms, counters, the drain's column sweeps and
the image's digest) and the streamed megakernel and ``render_fast``
(the wavefront) on ``sphere_field`` 100k, with a digest of each image, and
each of the wavefront render's four launches (``wavefront_launches``: CUDA
events, work counters, the tail's live-lane share) on the 100k field and
on the Next Week's final scene (the benchmark's ``next_week_final``); the
``recorded-pp`` train step at bench.py's ``fwdbwd`` shape (two
value-and-gradient micro-batches of 32 spp on the flagship, gradients
summed) and the ``"recorded"`` engine's value and gradient at 2 spp (host
clock, Mrays/s, median of 3 after a warm-up; and its peak memory); then
the megakernel's culled and streamed renders (``mode_render``:
``render_megakernel(culling=True)`` on ``sphere_field`` 3,000 at 128x72
and the streamed 100k render, both 16 spp, d8; each launch of a render
bracketed by CUDA events, their sum, the render's span, Mrays/s and work
counters), the recorder's first flagship pass (``record_pp``, 262,144
slots, 112 iterations), the bounce-indexed recorder's resident launch on one
flagship pass and on the tree's ``RECORD_GROUP`` passes side by side
(``record_resident``: ms a pass, idle lanes, the tail after its ray
counter drained), its streamed pass on the 100k scene (``record_paths``,
1 spp, depth 8, its tables built in the call), the gather forward at
:data:`GATHER_FWD_SHAPES` in each path's layout and the gather backward at
:data:`GATHER_BWD_SHAPES` in the [C, R] layout, each in CUDA-event
milliseconds; and once per tree the sweep kernels' ptxas report and the
sphere and triangle sweeps' SASS instructions per column (``sass_sweep``).
The child runs this file's code against the tree's package, so trees that
predate a measurement are measured too. ``--part wavefront`` runs only the
wavefront's part (the kernels' ptxas report and the launches of both
scenes, ``wavefront_part``). Lines start with ``[tiling]``, ``[record]``
or ``[ab]``; each names the card and its power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

RUNS = 5
LARGE = dict(width=512, spp=16, depth=8)  # scripts/bench_culling.py:58-60
#: The gather backward's shapes (rays R, table rows P), here and in
#: chip_smoke.py: a synthetic replay step, the recorded-pp flagship pass's
#: K*R rows (112 iterations x 262,144 slots) and the large recorded step's
#: pass (sphere_field 100k at 512x288: 147,456 rays, 100,352 rows).
GATHER_BWD_SHAPES = ((262_144, 512), (29_360_128, 512), (147_456, 100_352))
#: The gather forward's shapes (rays R, table rows P, whether its path
#: takes the [C, R] layout),
#: here and in chip_smoke.py: the recorded-pp flagship pass's one gather of
#: K*R rows in the [C, R] layout the fused replay reads (the main path's),
#: the "recorded" step's per-bounce [R, C] gather, and the large recorded
#: step's on sphere_field 100k's table.
GATHER_FWD_SHAPES = ((29_360_128, 512, True), (262_144, 512, False),
                     (147_456, 100_352, False))


def gather_indices(r: int, p: int, dev, g) -> torch.Tensor:
    """R synthetic winner rows of a table of P rows from the numpy
    generator ``g``: 40% on row 0 (as a ground sphere takes them), 15% on
    rows 1-3, the rest uniform, 512 with no row (-1) and 64 past the
    table (P + 3). Returns int32 [R] on ``dev``."""
    u = g.random(r)
    idx = np.where(u < 0.4, 0, np.where(u < 0.55, g.integers(1, 4, r),
                                        g.integers(4, p, r)))
    idx[g.integers(0, r, 512)] = -1
    idx[g.integers(0, r, 64)] = p + 3
    return torch.from_numpy(idx.astype(np.int32)).to(dev)


#: Square roots, the sphere sweep's; reciprocals, the triangle sweep's.
_ROOTS, _RCP = ("MUFU.RSQ", "MUFU.SQRT"), ("MUFU.RCP",)
#: Kernels whose sweep ``sass_sweep`` dissects, by a pattern of their
#: mangled names, and the opcodes that mark the sweep's loop: the sphere
#: sweep with motion (the megakernel is the queue as a template on its
#: sweep, resident at 128 threads and culled; the resident bounce-indexed
#: recorder sweeps packed records as the ray queue ``record_queue``), and
#: the triangle sweep of the resident queue without motion at the width
#: the Cornell box takes (any build but the 128-thread one).
SWEEP_KERNELS = (("record_pp", "record_pp_kernelILb1", _ROOTS),
                 ("megakernel_queue<ResidentSweep<true>>",
                  "ResidentSweepILb1E(E|Li128E)", _ROOTS),
                 ("megakernel_queue<CulledSweep<true>>", "CulledSweepILb1",
                  _ROOTS),
                 ("record_queue", "record_queueILb1", _ROOTS),
                 ("megakernel_queue<ResidentSweep<false>> triangles",
                  "ResidentSweepILb0E(?!Li128E)", _RCP))
#: The sweep loops' #pragma unroll.
SWEEP_UNROLL = 8
#: Further kernels whose ptxas report ``ptxas_facts`` keeps: the streamed
#: wavefront's bounce launches (a thread per slot) and, in trees that have
#: it, its tail launch's ray queue, without motion (the 100k scene's) and
#: with it (the Next Week's), and the queue kernel on its culled and
#: streamed sweeps without motion (``sphere_field``'s).
REPORT_KERNELS = (("wavefront_kernel<false, streamed>",
                   "wavefront_kernelILb0ELi2E(EE|Lb0E)"),
                  ("wavefront_kernel<true, streamed>",
                   "wavefront_kernelILb1ELi2E(EE|Lb0E)"),
                  ("wavefront_kernel<false, streamed, tail>",
                   "wavefront_kernelILb0ELi2ELb1E"),
                  ("wavefront_kernel<true, streamed, tail>",
                   "wavefront_kernelILb1ELi2ELb1E"),
                  ("megakernel_queue<CulledSweep<false>>",
                   "CulledSweepILb0E"),
                  ("megakernel_queue<StreamSweep<false>>",
                   "StreamSweepILb0E"))


def ptxas_facts(log: str) -> dict:
    """Registers, stack and spills ptxas reported for SWEEP_KERNELS and
    REPORT_KERNELS."""
    import re
    lines = log.splitlines()
    out = {}
    for name, frag, *_ in SWEEP_KERNELS + REPORT_KERNELS:
        for i, ln in enumerate(lines):
            if "Function properties for" in ln and re.search(frag, ln):
                out[name] = " ".join(x.split(":", 1)[-1].strip()
                                     for x in lines[i + 1:i + 3])
    return out


def sass_sweep(lib_path) -> dict:
    """Instructions per column of each SWEEP_KERNELS sweep, from
    ``cuobjdump -sass`` of a built kernel library: the smallest loop (a
    backward branch, under 1,500 instructions) that reads shared memory
    and holds an unroll's worth of the entry's marking opcodes (square
    roots for spheres, reciprocals for triangles), its opcodes counted and
    divided by the unroll. Predicated instructions issue whether their
    predicate holds or not; a branch's target block issues only when
    taken."""
    import collections
    import re
    from rayz_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :")[1].strip()
            funcs[cur] = []
        elif cur is not None:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if m:
                funcs[cur].append((int(m.group(1), 16), m.group(2).strip()))

    def opcode(t):
        return re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]

    out = {}
    for name, frag, marks in SWEEP_KERNELS:
        ins = next((v for k, v in funcs.items() if re.search(frag, k)), None)
        if ins is None:
            continue
        best = None
        for addr, t in ins:
            m = re.search(r"BRA.*?0x([0-9a-f]+)", t)
            if not (m and int(m.group(1), 16) < addr):
                continue
            lo = int(m.group(1), 16)
            body = [opcode(x) for a, x in ins if lo <= a <= addr]
            marked = sum(o in marks for o in body)
            lds = sum(o.startswith("LDS") for o in body)
            if marked >= SWEEP_UNROLL and lds and len(body) < 1500 and (
                    best is None or len(body) < len(best)):
                best = body
        if best is None:
            continue
        ops = collections.Counter(o.split(".")[0] if not o.startswith("LD")
                                  else o for o in best)
        out[name] = {k: v / SWEEP_UNROLL for k, v in ops.most_common()}
        out[name]["total"] = len(best) / SWEEP_UNROLL
    return out


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _mrays(rays: int, fn) -> list:
    """Mrays/s of ``fn(seed)`` for seeds 1..RUNS after a warm-up (seed 0)."""
    fn(0)
    return [rays / _timed(lambda s=s: fn(s)) / 1e6 for s in range(1, RUNS + 1)]


def _digest(img: torch.Tensor) -> str:
    return hashlib.sha256(img.float().cpu().numpy().tobytes()).hexdigest()[:12]


def tiling(ns, chunks, blocks) -> None:
    import rayz_tpu_torch as rtt
    from rayz_tpu_torch.ops import tables as tb

    card = _card()
    cfg = rtt.RenderConfig(spp=LARGE["spp"], max_depth=LARGE["depth"])
    default = (tb.DEFAULT_STREAM_CHUNK, tb.STREAM_BLOCK)
    for n in ns:
        scene, cam = rtt.scenes.sphere_field(n=n, width=LARGE["width"])
        rays = cam.width * cam.height * cfg.spp
        ref = {}
        for chunk, blk in [default] + [(c, b) for c in chunks for b in blocks
                                       if (c, b) != default]:
            tb.STREAM_BLOCK = blk
            try:
                res = {}
                for eng, fn in (("wavefront", rtt.render_wavefront),
                                ("megakernel", rtt.render_megakernel)):
                    def run(s, fn=fn):
                        return fn(scene, cam, s, cfg, stream=chunk)
                    img = run(0)
                    if eng not in ref:
                        ref[eng] = img
                    same = float((img == ref[eng]).all(-1).double().mean())
                    res[eng] = (statistics.median(_mrays(rays, run)), same)
                stats = torch.zeros(8, dtype=torch.int64, device="cuda")
                rtt.render_wavefront(scene, cam, 0, cfg, stream=chunk,
                                     stats=stats)
            finally:
                tb.STREAM_BLOCK = default[1]
            st = [int(x) for x in stats.tolist()]
            print(f"[tiling] sphere_field {n} chunk {chunk} block {blk}: "
                  f"wavefront {res['wavefront'][0]:.3f} Mrays/s "
                  f"({res['wavefront'][1]:.4%} of pixels as chunk "
                  f"{default[0]}/block {default[1]}), streamed megakernel "
                  f"{res['megakernel'][0]:.3f} ({res['megakernel'][1]:.4%}); "
                  f"wavefront per render {st[0]} segments, "
                  f"{st[1] / max(st[0], 1):.1f} primitive and "
                  f"{st[2] / max(st[0], 1):.1f} bound tests per segment, "
                  f"chunk votes {st[3]} ({1 - st[4] / max(st[3], 1):.2%} "
                  f"pruned) | {card}", flush=True)


def _event_ms(fn, n: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def record(n, chunks, blocks) -> None:
    import rayz_tpu_torch as rtt
    from rayz_tpu_torch.ops import diffkernel as dk, tables as tb

    card = _card()
    depth = LARGE["depth"]
    scene, cam = rtt.scenes.sphere_field(n=n, width=LARGE["width"])
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32,
                       device="cuda")
    inputs = (*dk._camera_rays(cam, 1, pix, 0, True),
              dk._make_rand(1, pix, 0, depth))
    default = tb.RECORD_STREAM_BLOCK
    ref = None
    for chunk in chunks:
        for blk in blocks:
            if chunk % blk:
                continue
            tb.RECORD_STREAM_BLOCK = blk
            try:
                t0 = time.perf_counter()
                layout = tb.resolve(scene, "record", stream=chunk)
                tabs = dk._record_tables(scene, layout, cam.look_from)
                torch.cuda.synchronize()
                prep = (time.perf_counter() - t0) * 1e3
                stats = torch.zeros(8, dtype=torch.int64, device="cuda")
                idx = dk._record_rays(scene, layout, tabs, *inputs,
                                      max_depth=depth, t_min=1e-3,
                                      stats=stats)
                ms = _event_ms(lambda: dk._record_rays(
                    scene, layout, tabs, *inputs, max_depth=depth,
                    t_min=1e-3))
            finally:
                tb.RECORD_STREAM_BLOCK = default
            ref = idx if ref is None else ref
            st = [int(x) for x in stats.tolist()]
            print(f"[record] sphere_field {n} chunk {chunk} block {blk}: "
                  f"kernel {ms:.3f} ms, table prep {prep:.2f} ms; {st[0]} "
                  f"segments, {st[1] / max(st[0], 1):.1f} columns and "
                  f"{st[2] / max(st[0], 1):.1f} block bounds per segment, "
                  f"chunk tests {1 - st[4] / max(st[3], 1):.2%} pruned; "
                  f"{float((idx == ref).double().mean()):.6%} of indices as "
                  f"the first | {card}", flush=True)


def record_resident(scene, cam, depth: int = 32) -> dict:
    """The bounce-indexed recorder's resident launch on one flagship pass
    (262,144 rays, seed 1, sample 0) and on the tree's ``RECORD_GROUP``
    passes side by side (1 where the tree records a pass a launch), its
    tables built beforehand: per group size, the CUDA-event ms per pass
    and the launch's counters (segments, re-sweeps, lane-trips of the
    warps that ran, the ns between the ray counter draining and the
    launch's end, where the tree's kernel counts them)."""
    from rayz_tpu_torch.ops import diffkernel as dk, tables as tb
    dev = cam.device
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev)
    layout = tb.resolve(scene, "record", stream=0)
    tabs = dk._record_tables(scene, layout, cam.look_from)
    groups = sorted({1, getattr(dk, "RECORD_GROUP", 1)})
    passes = [(*dk._camera_rays(cam, 1, pix, s, True),
               dk._make_rand(1, pix, s, depth))
              for s in range(groups[-1])]
    out = {}
    for g in groups:
        o, d, tm = (torch.cat([p[k] for p in passes[:g]]) for k in range(3))
        rand = torch.cat([p[3] for p in passes[:g]], dim=2)
        stats = torch.zeros(8, dtype=torch.int64, device=dev)
        dk._record_rays(scene, layout, tabs, o, d, tm, rand,
                        max_depth=depth, t_min=1e-3, stats=stats)
        ms = _event_ms(lambda: dk._record_rays(
            scene, layout, tabs, o, d, tm, rand, max_depth=depth,
            t_min=1e-3))
        st = [int(x) for x in stats.tolist()]
        out[str(g)] = dict(ms_per_pass=ms / g, segments=st[0],
                           resweeps=st[5], lane_trips=st[6],
                           tail_us=st[7] / 1e3)
        del o, d, tm, rand
    return out


def wavefront_launches(scene, cam, cfg, runs: int = 3) -> dict:
    """A render through ``render_wavefront`` with each of its launches
    bracketed by CUDA events (median ms per launch over ``runs`` renders
    after a warm-up), the device span of the whole render (its sorts,
    permutes and scatter-back are the span less the launches), and the
    work counters of one render, summed ([8]: segments, primitive tests,
    bound tests, votes, votes passed, and where the tree's kernel counts
    them, at 6 the lane slots its warps spent on primitive tests, at 5
    and 7 the tail's warp trips and the rays its lanes took after their
    first) and launch by launch (``launch_stats``)."""
    from rayz_tpu_torch.ops import wavefront as wf
    kernel = wf._wf_bounce
    marks, counted = [], []

    def timed_launch(*a, **kw):
        if kw.get("stats") is not None:
            counted.append(torch.zeros_like(kw["stats"]))
            kw = dict(kw, stats=counted[-1])
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        res = kernel(*a, **kw)
        e.record()
        marks.append((s, e))
        return res

    per, spans = [], []
    wf._wf_bounce = timed_launch
    try:
        for k in range(runs + 1):
            marks.clear()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            wf.render_wavefront(scene, cam, k, cfg)
            e.record()
            torch.cuda.synchronize()
            if k:
                per.append([a.elapsed_time(b) for a, b in marks])
                spans.append(s.elapsed_time(e))
        stats = torch.zeros(8, dtype=torch.int64, device=cam.device)
        wf.render_wavefront(scene, cam, 0, cfg, stats=stats)
    finally:
        wf._wf_bounce = kernel
    launch_stats = [[int(x) for x in c.tolist()] for c in counted]
    launch_ms = [statistics.median(x) for x in zip(*per)]
    return dict(launch_ms=launch_ms, span_ms=statistics.median(spans),
                glue_ms=statistics.median(spans) - sum(launch_ms),
                stats=[sum(c) for c in zip(*launch_stats)],
                launch_stats=launch_stats)


def next_week_scene():
    """The Next Week's final scene and its render settings as the
    benchmark's ``next_week_final.render`` runs them (800x800, 16 spp,
    depth 40; ``benchmark/configs/next_week_final.json`` through
    ``benchmark.scene``, read from beside this file's package)."""
    import rayz_tpu_torch as rtt
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.append(root)
    from benchmark import scene as bs
    with open(os.path.join(root, "benchmark", "configs",
                           "next_week_final.json")) as fh:
        cfg = json.load(fh)
    scene, cam = bs.program_scene(bs.inputs(cfg), cfg, "cuda")
    return scene, cam, rtt.RenderConfig(spp=16, max_depth=cfg["max_depth"],
                                        t_min=cfg["t_min"])


def wavefront_part() -> dict:
    """The wavefront's measurements: the wavefront kernels' ptxas report
    and ``wavefront_launches`` on ``sphere_field`` 100k (512x288, 16 spp,
    depth 8) and on the Next Week's final scene (``next_week_scene``)."""
    import rayz_tpu_torch as rtt
    from rayz_tpu_torch.ops import _build
    _, info = _build.load()
    field, fcam = rtt.scenes.sphere_field(n=100_000, width=LARGE["width"])
    fcfg = rtt.RenderConfig(spp=LARGE["spp"], max_depth=LARGE["depth"])
    return {"ptxas": {k: v for k, v in ptxas_facts(info.log).items()
                      if k.startswith("wavefront")},
            "wavefront_launches": wavefront_launches(field, fcam, fcfg),
            "next_week_launches": wavefront_launches(*next_week_scene())}


def _queue_stats(dev) -> torch.Tensor:
    """Zeroed counters for a queue launch of the tree under test: as many
    slots as its ``megakernel.QUEUE_STATS`` (8 in trees that predate it)."""
    from rayz_tpu_torch.ops import megakernel as mk
    return torch.zeros(getattr(mk, "QUEUE_STATS", 8), dtype=torch.int64,
                       device=dev)


def flagship_queue(scene, cam) -> dict:
    """The flagship's queue launch as the render and the preview run it
    (512x512, depth 32, seed 1; 64 and 1 spp, one launch each), its tables
    built beforehand: per spp the CUDA-event ms of the launch (mean of
    10 after a warm-up), its counters (segments, re-sweeps, lane-trips,
    and where the tree's kernel counts them the segments its drain swept
    a column per lane) and the digest of ``render_fast``'s image."""
    import rayz_tpu_torch as rtt
    from rayz_tpu_torch.ops import megakernel as mk, tables as tb
    n = cam.width * cam.height
    out = {}
    for spp in (64, 1):
        cfg = rtt.RenderConfig(spp=spp, max_depth=32)
        args, kw = mk._launch_args(scene, cam, 1,
                                   tb.resolve(scene, "megakernel"), spp=spp,
                                   max_depth=32, t_min=cfg.t_min,
                                   jitter=cfg.jitter)
        del kw["spp"]
        stats = _queue_stats(cam.device)
        mk._queue(*args, n, 0, spp, stats=stats, **kw)
        ms = _event_ms(lambda: mk._queue(*args, n, 0, spp, **kw), 10)
        st = [int(x) for x in stats.tolist()]
        out[str(spp)] = dict(ms=ms, segments=st[0], resweeps=st[5],
                             lane_trips=st[6],
                             columns=st[8] if len(st) > 8 else None,
                             digest=_digest(rtt.render_fast(scene, cam, 1,
                                                            cfg)))
    return out


def mode_render(scene, cam, cfg, runs: int = 3, **kw) -> dict:
    """One ``render_megakernel`` (keywords ``kw``: a culled or streamed
    mode) with each of its kernel launches bracketed by CUDA events, over
    ``runs`` renders after a warm-up: the launches per render, the median of
    their summed ms, the render's device span and Mrays/s; then the work
    counters of one render (``_queue_stats``: segments, primitive tests,
    block bound tests, chunk bound tests and how many passed, re-sweeps,
    lane-trips) and the image's digest. The launches are those of the wrappers
    ``_queue`` and ``_fold``."""
    import rayz_tpu_torch as rtt
    from rayz_tpu_torch.ops import megakernel as mk
    names = ("_queue", "_fold")
    real = {n: getattr(mk, n) for n in names}
    marks, stats = [], []

    def wrap(name):
        def launch(*a, **k):
            if stats and name != "_fold":
                k = dict(k, stats=stats[0])
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            res = real[name](*a, **k)
            e.record()
            marks.append((s, e))
            return res
        return launch

    per, spans, secs, counts = [], [], [], []
    rays = cam.width * cam.height * cfg.spp
    for n in names:
        setattr(mk, n, wrap(n))
    try:
        for k in range(runs + 1):
            marks.clear()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.record()
            img = rtt.render_megakernel(scene, cam, k, cfg, **kw)
            e.record()
            torch.cuda.synchronize()
            if k:
                secs.append(time.perf_counter() - t0)
                per.append(sum(a.elapsed_time(b) for a, b in marks))
                spans.append(s.elapsed_time(e))
                counts.append(len(marks))
        stats.append(_queue_stats(cam.device))
        img = rtt.render_megakernel(scene, cam, 0, cfg, **kw)
    finally:
        for n in names:
            setattr(mk, n, real[n])
    return dict(launches=counts[-1], kernel_ms=statistics.median(per),
                span_ms=statistics.median(spans),
                mrays=statistics.median(rays / x / 1e6 for x in secs),
                stats=[int(x) for x in stats[0].tolist()],
                digest=_digest(img))


#: The megakernel's culled and streamed paths ``mode_render`` measures:
#: ``render_megakernel(culling=True)`` on ``sphere_field`` 3,000 at 128x72
#: (chip_smoke.py's culled phase) and ``render_megakernel`` on
#: ``sphere_field`` 100k at 512x288, which streams (both 16 spp, d8).
MODE_PATHS = (("culled", 3_000, 128, dict(culling=True)),
              ("streamed", 100_000, LARGE["width"], {}))


def render() -> None:
    """One A/B child: the measurements the module docstring lists, on
    this tree's package; prints one JSON line."""
    import rayz_tpu_torch as rtt

    from rayz_tpu_torch.ops import _build

    scene, cam = rtt.scenes.random_bouncing(width=512, height=512)
    cfg = rtt.RenderConfig(spp=64, max_depth=32)
    _, info = _build.load()
    out = {"ptxas": ptxas_facts(info.log), "sass": sass_sweep(info.path)}

    def run(s):
        return rtt.render_fast(scene, cam, s, cfg)
    out["forward"] = _mrays(512 * 512 * 64, run)
    out["forward_digest"] = _digest(run(1))
    out["flagship_queue"] = flagship_queue(scene, cam)
    box, bcam = rtt.scenes.cornell_box(width=512)

    def crun(s):
        return rtt.render_fast(box, bcam, s, cfg)
    out["cornell"] = _mrays(512 * 512 * 64, crun)
    out["cornell_digest"] = _digest(crun(1))
    field, fcam = rtt.scenes.sphere_field(n=100_000, width=LARGE["width"])
    fcfg = rtt.RenderConfig(spp=LARGE["spp"], max_depth=LARGE["depth"])

    for label, fn in (("streamed", rtt.render_megakernel),
                      ("wavefront", rtt.render_fast)):
        def frun(s, fn=fn):
            return fn(field, fcam, s, fcfg)
        out[label] = _mrays(fcam.width * fcam.height * fcfg.spp, frun)
        out[label + "_digest"] = _digest(frun(1))
    out["wavefront_launches"] = wavefront_launches(field, fcam, fcfg)
    out["next_week_launches"] = wavefront_launches(*next_week_scene())
    for label, n, width, kw in MODE_PATHS:
        mscene, mcam = ((field, fcam) if n == 100_000 else
                        rtt.scenes.sphere_field(n=n, width=width))
        out["mode_" + label] = mode_render(mscene, mcam, fcfg, **kw)

    rcfg = rtt.RenderConfig(spp=2, max_depth=32)
    target = rtt.render_fast(scene, cam, 0, rcfg)

    def vg(s):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in rtt.extract_params(scene).items()}
        loss = rtt.pixel_loss(params, scene, cam, s, target, rcfg,
                              "recorded")
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    vg(0)
    torch.cuda.reset_peak_memory_stats()
    out["recorded_step"] = [512 * 512 * rcfg.spp / _timed(lambda s=s: vg(s))
                            / 1e6 for s in range(1, 4)]
    out["recorded_step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["record_resident"] = record_resident(scene, cam)

    from rayz_tpu_torch.ops import diffkernel as dk, pathrec as pr
    # bench.py's fwdbwd: two value-and-gradient micro-batches of 32 spp
    # through recorded-pp, gradients summed
    mcfg = rtt.RenderConfig(spp=32, max_depth=32)
    full = rtt.render_fast(scene, cam, 0, cfg)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in rtt.extract_params(scene).items()}

    def fwdbwd(s):
        for m in range(2):
            loss = rtt.pixel_loss(params, scene, cam, 2 * s + m, full, mcfg,
                                  "recorded-pp")
            loss.backward()
    fwdbwd(0)
    out["recorded_pp_step"] = [512 * 512 * 64 / _timed(lambda s=s: fwdbwd(s))
                               / 1e6 for s in range(1, 4)]
    pix = torch.arange(512 * 512, dtype=torch.int32, device="cuda")
    out["record_pp"] = _event_ms(lambda: pr.record_pp(
        scene, cam, 1, pix, spp=32, max_depth=32, t_min=1e-3, jitter=True,
        iters=pr.default_k1(32)), 3)
    pix = torch.arange(fcam.width * fcam.height, dtype=torch.int32,
                       device="cuda")
    inputs = (*dk._camera_rays(fcam, 1, pix, 0, True),
              dk._make_rand(1, pix, 0, LARGE["depth"]))
    out["record_streamed"] = _event_ms(lambda: dk.record_paths(
        field, *inputs, max_depth=LARGE["depth"], t_min=1e-3), 3)
    g = np.random.default_rng(1)
    out["gather_fwd"] = []
    for r, p, t in GATHER_FWD_SHAPES:
        idx = gather_indices(r, p, "cuda", g)
        tab = torch.randn((p, 20), device="cuda")
        out["gather_fwd"].append(_event_ms(
            lambda: pr._gather_fwd(tab, idx, t), 10))
        torch.cuda.empty_cache()
    g = np.random.default_rng(0)
    out["gather_bwd"] = []
    for r, p in GATHER_BWD_SHAPES:
        idx = gather_indices(r, p, "cuda", g)
        cot = torch.randn((20, r), device="cuda")
        out["gather_bwd"].append(_event_ms(
            lambda: pr._gather_bwd(cot, idx, p, True), 10))
        del cot
    print(json.dumps(out), flush=True)


#: The forward measurements of ``render``: the flagship and the Cornell
#: box through ``render_fast`` (the main path; 512x512, 64 spp, depth 32),
#: and the 100k-sphere scene through the streamed megakernel and
#: ``render_fast`` (the wavefront).
_FORWARD = ("forward", "cornell", "streamed", "wavefront")


def _child(tree: str, what: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    return subprocess.run([sys.executable, os.path.abspath(__file__), what],
                          cwd=tree, env=env, capture_output=True, text=True,
                          timeout=900)


def _record_line(res: dict) -> str:
    """The resident record pass of one A/B child, as text."""
    return "resident record, " + "; ".join(
        f"{g} per launch {v['ms_per_pass']:.3f} ms a pass, {v['segments']} "
        f"segments, re-sweeps {v['resweeps']}"
        + (f", idle lanes {1 - v['segments'] / v['lane_trips']:.4f}, "
           f"tail {v['tail_us']:.1f} us" if v["lane_trips"] else "")
        for g, v in res["record_resident"].items())


def _queue_line(res: dict) -> str:
    """The flagship's queue launches of one A/B child, as text."""
    return "flagship queue launch, " + "; ".join(
        f"{spp} spp {v['ms']:.4f} ms (digest {v['digest']}), "
        f"{v['segments']} segments, lane efficiency "
        f"{v['segments'] / v['lane_trips']:.4f}, re-sweeps {v['resweeps']}"
        + ("" if v["columns"] is None else
           f", {v['columns']} swept a column per lane "
           f"({v['columns'] / v['segments']:.4f})")
        for spp, v in res["flagship_queue"].items())


def tail_share(stats) -> str:
    """The tail launch's live-lane share from its counters: segments over
    32 lanes a warp trip (slots 0 and 5), and the rays its lanes took
    after their first (7); "not counted" in a tree whose kernel does not
    count its trips."""
    if not stats[5]:
        return "live-lane share not counted"
    return (f"live-lane share {stats[0] / (32 * stats[5]):.4f} ({stats[0]} "
            f"segments, {stats[5]} warp trips), {stats[7]} rays taken after "
            "a lane's first")


def _wavefront_line(res: dict, key: str = "wavefront_launches",
                    label: str = "wavefront") -> str:
    """A wavefront render's launches of one A/B child, as text."""
    wl = res[key]
    s = wl["stats"]
    return (f"{label} launches " + ", ".join(
        f"{ms:.3f}" for ms in wl["launch_ms"])
        + f" ms (sum {sum(wl['launch_ms']):.3f}), render span "
        f"{wl['span_ms']:.3f} ms, sorts/permutes/scatter {wl['glue_ms']:.3f} "
        f"ms; {s[0]} segments, {s[1] / max(s[0], 1):.1f} primitive and "
        f"{s[2] / max(s[0], 1):.1f} bound tests per segment, votes {s[3]} "
        f"({s[4]} passed)"
        + (f", sweep lanes idle {1 - s[1] / s[6]:.4f}" if s[6] else "")
        + ("; tail " + tail_share(wl["launch_stats"][-1])
           if len(wl["launch_stats"]) > 3 else ""))


def _wavefront_lines(res: dict) -> str:
    """The 100k field's and the Next Week's wavefront launches."""
    return (_wavefront_line(res) + "; " + _wavefront_line(
        res, "next_week_launches", "next week"))


def _wavefront_series(runs: list) -> list:
    """(name, values over rounds) of each wavefront launch of both
    scenes, and their sums."""
    out = []
    for key, label in (("wavefront_launches", "wavefront"),
                       ("next_week_launches", "next week")):
        out += [(f"{label} launches (sum) ms",
                 [sum(r[key]["launch_ms"]) for r in runs])]
        out += [(f"{label} launch {i} ms",
                 [r[key]["launch_ms"][i] for r in runs])
                for i in range(len(runs[0][key]["launch_ms"]))]
    return out


def _mode_line(res: dict) -> str:
    """The megakernel's culled and streamed renders of one A/B child."""
    parts = []
    for label, n, _, _ in MODE_PATHS:
        m = res["mode_" + label]
        s = m["stats"]
        seg = max(s[0], 1)
        parts.append(
            f"{label} sphere_field {n}: {m['launches']} launches, kernels "
            f"{m['kernel_ms']:.3f} ms, span {m['span_ms']:.3f} ms, "
            f"{m['mrays']:.3f} Mrays/s (digest {m['digest']}); {s[0]} "
            f"segments, {s[1] / seg:.1f} primitive, {s[2] / seg:.1f} block "
            f"and {s[3] / seg:.1f} chunk tests per segment ({s[4]} chunk "
            f"tests passed), re-sweeps {s[5]}"
            + (f", idle lanes {1 - s[0] / s[6]:.4f}" if s[6] else ""))
    return "megakernel modes: " + "; ".join(parts)


def ab(trees, rounds: int, part: str = "all") -> None:
    card = _card()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from rayz_tpu_torch.ops import _build; "
         "print(_build.load()[1].seconds)"], cwd=t,
        env=dict(os.environ, PYTHONPATH=os.path.abspath(t)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for t in trees]
    built = []
    for t, proc in zip(trees, builds):
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"[ab] {t}: build failed, left out:\n{log[-4000:]}",
                  flush=True)
        else:
            built.append(t)
    trees = built
    runs = {t: [] for t in trees}
    for k in range(rounds):
        for t in (trees if k % 2 == 0 else trees[::-1]):
            proc = _child(t, "render" if part == "all" else part)
            if proc.returncode:
                raise RuntimeError(f"{t} failed:\n{proc.stdout}{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[t].append(res)
            if part == "wavefront":
                print(f"[ab] round {k} {t}: " + _wavefront_lines(res)
                      + f" | {card}", flush=True)
                continue
            print(f"[ab] round {k} {t}: "
                  + ", ".join(f"{key} {statistics.median(res[key]):.3f} "
                              f"(digest {res[key + '_digest']})"
                              for key in _FORWARD)
                  + " Mrays/s; recorded-pp step "
                  f"{statistics.median(res['recorded_pp_step']):.4f}, "
                  f"recorded step "
                  f"{statistics.median(res['recorded_step']):.4f} Mrays/s; "
                  f"record_pp first pass {res['record_pp']:.3f} ms; "
                  f"streamed record pass "
                  f"{res['record_streamed']:.3f} ms; gather forward "
                  + ", ".join(f"{ms:.4f}" for ms in res["gather_fwd"])
                  + " ms; gather backward "
                  + ", ".join(f"{ms:.4f}" for ms in res["gather_bwd"])
                  + f" ms; recorded step peak "
                  f"{res['recorded_step_peak_gb']:.3f} GB | {card}",
                  flush=True)
            print(f"[ab] round {k} {t}: " + _queue_line(res) + f" | {card}",
                  flush=True)
            print(f"[ab] round {k} {t}: " + _record_line(res)
                  + "; " + _wavefront_lines(res) + f" | {card}", flush=True)
            print(f"[ab] round {k} {t}: " + _mode_line(res) + f" | {card}",
                  flush=True)
    for t in trees:
        first = runs[t][0]
        if part == "wavefront":
            print(f"[ab] {t}: ptxas {first['ptxas']}; " + "; ".join(
                f"{key} median {statistics.median(vals):.4f} (rounds "
                f"{min(vals):.4f}-{max(vals):.4f})"
                for key, vals in _wavefront_series(runs[t])) + f" | {card}",
                flush=True)
            continue

        def ops(v):
            return ", ".join(f"{o} {n:g}" for o, n in v.items()
                             if o != "total")
        print(f"[ab] {t}: ptxas {first['ptxas']}; sweeps per column "
              + "; ".join(f"{k} {v['total']:.3f} instructions ({ops(v)})"
                          for k, v in first["sass"].items())
              + f" | {card}", flush=True)
        line = []
        series = [(f"record_resident, {g} per launch, ms a pass",
                   [r["record_resident"][g]["ms_per_pass"]
                    for r in runs[t]]) for g in first["record_resident"]]
        series += [(f"flagship queue launch, {spp} spp, ms",
                    [r["flagship_queue"][spp]["ms"] for r in runs[t]])
                   for spp in first["flagship_queue"]]
        series += _wavefront_series(runs[t])
        series += [(f"megakernel {label} render, kernel ms",
                    [r["mode_" + label]["kernel_ms"] for r in runs[t]])
                   for label, *_ in MODE_PATHS]
        series += [(f"{key} Mrays/s",
                    [statistics.median(r[key]) for r in runs[t]])
                   for key in _FORWARD + ("recorded_pp_step", "recorded_step")]
        series += [(f"{key} ms", [r[key] for r in runs[t]])
                   for key in ("record_pp", "record_streamed")]
        series += [(f"gather forward R={r_} P={p_} "
                    f"{'[C, R]' if t_ else '[R, C]'} ms",
                    [r["gather_fwd"][i] for r in runs[t]])
                   for i, (r_, p_, t_) in enumerate(GATHER_FWD_SHAPES)]
        series += [(f"gather backward R={r_} P={p_} ms",
                    [r["gather_bwd"][i] for r in runs[t]])
                   for i, (r_, p_) in enumerate(GATHER_BWD_SHAPES)]
        for key, vals in series:
            line.append(f"{key} median {statistics.median(vals):.4f} "
                        f"(rounds {min(vals):.4f}-{max(vals):.4f})")
        print(f"[ab] {t}: " + "; ".join(line) + f" | {card}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rayz_tpu_torch.tune")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tiling")
    t.add_argument("--ns", default="10000,100000")
    t.add_argument("--chunks", default="512,1024,2048")
    t.add_argument("--blocks", default="32,64,128")
    rc = sub.add_parser("record")
    rc.add_argument("--n", type=int, default=100_000)
    rc.add_argument("--chunks", default="256,512,1024")
    rc.add_argument("--blocks", default="16,32,64")
    a = sub.add_parser("ab")
    a.add_argument("trees", nargs="+")
    a.add_argument("--rounds", type=int, default=4)
    a.add_argument("--part", choices=("all", "wavefront"), default="all")
    sub.add_parser("render")
    sub.add_parser("wavefront")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("these measurements run on an NVIDIA GPU only")
    if args.cmd == "tiling":
        ints = [[int(x) for x in s.split(",")]
                for s in (args.ns, args.chunks, args.blocks)]
        tiling(*ints)
    elif args.cmd == "record":
        record(args.n, *([int(x) for x in s.split(",")]
                         for s in (args.chunks, args.blocks)))
    elif args.cmd == "ab":
        ab(args.trees, args.rounds, args.part)
    elif args.cmd == "wavefront":
        print(json.dumps(wavefront_part()), flush=True)
    else:
        render()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
