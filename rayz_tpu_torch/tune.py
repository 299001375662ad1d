"""Tuning measurements of the port on one NVIDIA GPU.

    python -m rayz_tpu_torch.tune tiling [--ns 10000,100000]
        [--chunks 512,1024,2048] [--blocks 32,64,128]
    python -m rayz_tpu_torch.tune ab TREE [TREE ...] [--rounds 4]

``tiling`` sweeps the streamed layout's chunk and block sizes on
``sphere_field`` at 512x288, 16 spp, depth 8 (the large-scene path of
``chip_smoke.py``): for every (chunk, block) it renders through the
wavefront and the streamed megakernel, prints Mrays/s (median of 5 after a
warm-up, synced), the wavefront's work counters and the share of pixels
equal to the default layout's image. The block inside a chunk is set by
rebinding ``STREAM_BLOCK`` in the two engine modules for the sweep.

``ab`` times the megakernel of several checkouts of this package against
each other in one process tree: every TREE is a directory holding a
``rayz_tpu_torch`` package; each round runs one child process per tree, in
alternating order, which builds that tree's kernels (once, into
``TREE/build/kernels``) and prints the flagship forward (``random_bouncing``
512x512, 64 spp, depth 32, compacted and single launch) and the streamed
megakernel on ``sphere_field`` 100k, with a digest of each image. Lines
start with ``[tiling]`` or ``[ab]``; each names the card and its power
limit.
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

import torch

RUNS = 5
LARGE = dict(width=512, spp=16, depth=8)  # scripts/bench_culling.py:58-60


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
    from rayz_tpu_torch.ops import megakernel as mk, tables as tb
    from rayz_tpu_torch.ops import wavefront as wf

    card = _card()
    cfg = rtt.RenderConfig(spp=LARGE["spp"], max_depth=LARGE["depth"])
    default = (tb.DEFAULT_STREAM_CHUNK, tb.STREAM_BLOCK)
    for n in ns:
        scene, cam = rtt.scenes.sphere_field(n=n, width=LARGE["width"])
        rays = cam.width * cam.height * cfg.spp
        ref = {}
        for chunk, blk in [default] + [(c, b) for c in chunks for b in blocks
                                       if (c, b) != default]:
            wf.STREAM_BLOCK = mk.STREAM_BLOCK = blk
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
                wf.STREAM_BLOCK = mk.STREAM_BLOCK = default[1]
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


def render() -> None:
    """One A/B child: this tree's megakernel on the flagship and on the
    100k field; prints one JSON line."""
    import rayz_tpu_torch as rtt

    scene, cam = rtt.scenes.random_bouncing(width=512, height=512)
    cfg = rtt.RenderConfig(spp=64, max_depth=32)
    out = {}
    for label, kw in (("compact", {}), ("single", dict(passes=0))):
        def run(s, kw=kw):
            return rtt.render_megakernel(scene, cam, s, cfg, **kw)
        out[label] = _mrays(512 * 512 * 64, run)
        out[label + "_digest"] = _digest(run(1))
    field, fcam = rtt.scenes.sphere_field(n=100_000, width=LARGE["width"])
    fcfg = rtt.RenderConfig(spp=LARGE["spp"], max_depth=LARGE["depth"])

    def frun(s):
        return rtt.render_megakernel(field, fcam, s, fcfg)
    out["streamed"] = _mrays(fcam.width * fcam.height * fcfg.spp, frun)
    out["streamed_digest"] = _digest(frun(1))
    print(json.dumps(out), flush=True)


def _child(tree: str, what: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    return subprocess.run([sys.executable, "-m", "rayz_tpu_torch.tune", what],
                          cwd=tree, env=env, capture_output=True, text=True,
                          timeout=900)


def ab(trees, rounds: int) -> None:
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
            proc = _child(t, "render")
            if proc.returncode:
                raise RuntimeError(f"{t} failed:\n{proc.stdout}{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[t].append(res)
            print(f"[ab] round {k} {t}: compact "
                  f"{statistics.median(res['compact']):.3f}, single "
                  f"{statistics.median(res['single']):.3f}, streamed 100k "
                  f"{statistics.median(res['streamed']):.3f} Mrays/s "
                  f"(digests {res['compact_digest']} {res['single_digest']} "
                  f"{res['streamed_digest']}) | {card}", flush=True)
    for t in trees:
        line = []
        for key in ("compact", "single", "streamed"):
            meds = [statistics.median(r[key]) for r in runs[t]]
            line.append(f"{key} median {statistics.median(meds):.3f} "
                        f"(rounds {min(meds):.3f}-{max(meds):.3f})")
        print(f"[ab] {t}: " + "; ".join(line) + f" | {card}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rayz_tpu_torch.tune")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tiling")
    t.add_argument("--ns", default="10000,100000")
    t.add_argument("--chunks", default="512,1024,2048")
    t.add_argument("--blocks", default="32,64,128")
    a = sub.add_parser("ab")
    a.add_argument("trees", nargs="+")
    a.add_argument("--rounds", type=int, default=4)
    sub.add_parser("render")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("these measurements run on an NVIDIA GPU only")
    if args.cmd == "tiling":
        ints = [[int(x) for x in s.split(",")]
                for s in (args.ns, args.chunks, args.blocks)]
        tiling(*ints)
    elif args.cmd == "ab":
        ab(args.trees, args.rounds)
    else:
        render()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
