"""Headline benchmark of the port: forward AND forward+backward Mrays/s on
the RTIOW final scene at the real BASELINE config, the counterpart of the
repository's ``bench.py`` on one NVIDIA GPU.

Config 3 of BASELINE.json: ~500 random spheres (80% moving), 512x512, 64
spp, depth 32.

* ``fwd``: ``render_fast(engine="auto")``, which resolves to the queue
  megakernel with its tables in shared memory (one queue launch and one
  fold, ``ops/megakernel.py``).
* ``fwdbwd``: two value-and-gradient micro-batches of the pixel-L2 loss at
  32 spp through ``pixel_loss(engine="recorded-pp")`` (the persistent-path
  recorder, the gathers and the fused replay pair, ``ops/pathrec.py``),
  gradients summed: one full forward render plus the scene-parameter
  gradients. The compaction schedule must finish every sample (leftover
  0, checked before timing), or the number would measure a truncated
  estimator.

Rays are camera rays (pixels x spp) over wall-clock seconds. Each run
ends in ``torch.cuda.synchronize()`` and includes copying the result (the
image; the loss and the gradients) to the host, as ``bench.py``'s
``jax.device_get`` does. One warm-up, then RUNS seeds; best, median and
stdev of each metric, with the engine's knobs and the card's name and
power limit.

Run:  python -m rayz_tpu_torch.bench

Prints ONE JSON line with ``bench.py``'s keys and ``device``.
``vs_baseline`` divides by the same ESTIMATED ~1.0 Mrays/s single-thread
CPU reference as ``bench.py`` (the reference publishes no numbers).
"""

from __future__ import annotations

import json
import statistics
import time

import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.ops import diffkernel as dk
from rayz_tpu_torch.ops import megakernel as mk
from rayz_tpu_torch.ops import pathrec as pr
from rayz_tpu_torch.ops import tables
from rayz_tpu_torch.scripts import card, resolve, sync

REFERENCE_BASELINE_MRAYS = 1.0  # documented ESTIMATE, see module docstring

WIDTH = 512
HEIGHT = 512
SPP = 64
DEPTH = 32
RUNS = 5
MICRO = 32  # spp of a fwdbwd micro-batch (bench.py's MICRO)


def _measure(fn, dev, runs: int):
    """Per-run wall-clock seconds over seeds 1..runs, each synced."""
    times = []
    for seed in range(1, runs + 1):
        sync(dev)
        st = time.perf_counter()
        fn(seed)
        sync(dev)
        times.append(time.perf_counter() - st)
    return times


def _stats(times, rays):
    mrays = sorted(rays / t / 1e6 for t in times)
    return {
        "best": round(mrays[-1], 3),
        "median": round(statistics.median(mrays), 3),
        "stdev": round(statistics.pstdev(mrays), 3),
        "runs": len(mrays),
    }


def engine_knobs(scene, camera, micro: int, depth: int) -> dict:
    """What the two metrics ran: the engine ``pick_engine`` resolves, its
    table mode, the queue's persistent grid and threads a block (read after
    a launch), the resident recorder's passes a launch, and the compaction
    schedule (iterations, slots) of a ``recorded-pp`` micro-batch."""
    engine = rtt.pick_engine(scene)
    mode = None
    if engine == "megakernel":
        mode = tables.MODES[tables.resolve(scene, "megakernel").mode]
    block, r_pad = pr.slot_layout(camera.width * camera.height)
    return {
        "engine": engine,
        "table_mode": mode,
        "queue_grid": mk.QUEUE_GRID,
        "queue_block": mk.QUEUE_BLOCK,
        "record_group": dk.RECORD_GROUP,
        "compact_schedule": pr.default_schedule(micro, depth, r_pad, block),
    }


def run(width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
        depth: int = DEPTH, runs: int = RUNS, micro: int = MICRO,
        device="cuda") -> dict:
    """Measure both metrics; returns the JSON line's dict. Runs on the card
    unless ``device="cpu"`` (the plain versions; small sizes only)."""
    dev = resolve(device)
    scene, camera = rtt.scenes.random_bouncing(width=width, height=height,
                                               device=dev)
    config = rtt.RenderConfig(spp=spp, max_depth=depth, t_min=1e-3)
    rays = height * width * spp

    # ---- forward ----
    def run_fwd(seed: int):
        return rtt.render_fast(scene, camera, seed, config,
                               engine="auto").cpu()

    target = run_fwd(0).to(dev)  # the warm-up; the fwdbwd target
    fwd_stats = _stats(_measure(run_fwd, dev, runs), rays)
    fwd_mrays = fwd_stats["best"]

    # ---- forward+backward: micro-batches of the recorded-pp pixel loss ----
    micro_cfg = rtt.RenderConfig(spp=micro, max_depth=depth, t_min=1e-3)
    n_micro = spp // micro
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in rtt.extract_params(scene).items()}
    with torch.no_grad():
        _, leftover = rtt.render_diff_pp(scene, camera, 0, micro_cfg,
                                         return_leftover=True)
    leftover = int(leftover)
    if leftover:
        raise RuntimeError(f"the compaction schedule truncated {leftover} "
                           "samples: fwdbwd would measure a cheaper "
                           "estimator")

    def run_fwdbwd(seed: int):
        total = None
        for i in range(n_micro):
            loss = rtt.pixel_loss(params, scene, camera, seed * n_micro + i,
                                  target, micro_cfg, "recorded-pp")
            g = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
            total = g if total is None else [
                a if b is None else b if a is None else a + b
                for a, b in zip(total, g)]
        return loss.detach().cpu(), {k: None if x is None else x.cpu()
                                     for k, x in zip(params, total)}

    run_fwdbwd(0)  # warm-up
    fwdbwd_stats = _stats(_measure(run_fwdbwd, dev, runs), rays)
    fwdbwd_mrays = fwdbwd_stats["best"]

    return {
        "metric": "fwd_mrays_per_s",
        "value": fwd_mrays,
        "unit": "Mrays/s",
        "vs_baseline": round(fwd_mrays / REFERENCE_BASELINE_MRAYS, 3),
        "fwd_mrays_per_s": fwd_mrays,
        "fwdbwd_mrays_per_s": fwdbwd_mrays,
        "fwd_stats": fwd_stats,
        "fwdbwd_stats": fwdbwd_stats,
        "engine_knobs": engine_knobs(scene, camera, micro, depth),
        "fwdbwd_engine": "recorded-pp",
        "fwdbwd_leftover": leftover,
        "config": f"random_bouncing {width}x{height} {spp}spp d{depth}",
        "baseline_note": ("vs_baseline divides by bench.py's ESTIMATED ~1.0 "
                          "Mrays/s single-thread CPU reference (the "
                          "reference publishes no numbers)"),
        "device": card(dev),
    }


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
