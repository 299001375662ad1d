"""Culling and streaming scaling benchmark on the card: the counterpart of
``scripts/bench_culling.py``.

Renders the ``sphere_field`` stress scene at several primitive counts and
records forward Mrays/s (best and median over :data:`SEEDS` after one
warm-up, each run synced and copied to the host) for each row:

* ``brute_force``: ``render_megakernel(culling=False)``, every column
  swept; the tables in shared memory where they fit (``fits_shared``),
  else streamed in chunks with no bound test, as the JAX row streams
  beyond its own budget;
* ``culling_on``: ``culling=True``, Morton-sorted blocks behind bound
  tests (streamed: chunks and blocks);
* ``wavefront``: ``render_wavefront``, bounce by bounce with sorted rays.

Each row also gives each image's digest (equal digests: equal images),
whether the tables fit one block's shared memory, and ``auto``, the
engine ``pick_engine`` picks for the scene.

Run:  python -m rayz_tpu_torch.scripts.bench_culling [--width 512]
      [--spp 16] [--depth 8] [--counts 512 2048 ...] [--out FILE]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import rayz_tpu_torch as rtt
from rayz_tpu_torch.ops.tables import fits_shared
from rayz_tpu_torch.scripts import card, resolve, sync

SEEDS = (1, 2, 3, 4, 5)
# The least interval the clock tells from zero: a render timed below it
# counts as taking it, so no rate or speedup divides by zero.
_TICK = time.get_clock_info("perf_counter").resolution


def _time_fn(run, dev, seeds=SEEDS):
    """(best, median) seconds over ``seeds`` after one warm-up, and the
    digest of the first seed's image."""
    run(0)
    times, digest = [], None
    for s in seeds:
        sync(dev)
        t0 = time.perf_counter()
        img = run(s)
        sync(dev)
        times.append(max(time.perf_counter() - t0, _TICK))
        if digest is None:
            digest = hashlib.sha256(img.numpy().tobytes()).hexdigest()[:16]
    times.sort()
    return times[0], times[len(times) // 2], digest


def culling_row(n: int, width: int = 512, spp: int = 16, depth: int = 8,
                device="cuda", seeds=SEEDS) -> dict:
    """The row of ``sphere_field(n)`` at ``width`` (16:9), ``spp``,
    ``depth``."""
    dev = resolve(device)
    scene, camera = rtt.scenes.sphere_field(n, width=width, device=dev)
    config = rtt.RenderConfig(spp=spp, max_depth=depth, t_min=1e-3)
    rays = camera.width * camera.height * spp
    row = {"n_spheres": n, "width": width, "spp": spp, "depth": depth,
           "fits_shared": fits_shared(scene), "seeds": len(seeds)}
    renders = {
        "brute_force": lambda s: rtt.render_megakernel(
            scene, camera, s, config, culling=False),
        "culling_on": lambda s: rtt.render_megakernel(
            scene, camera, s, config, culling=True),
        "wavefront": lambda s: rtt.render_wavefront(scene, camera, s,
                                                    config),
    }
    # Speedups are ratios of the unrounded best times: a rate rounded to
    # 3 decimals can be 0.0 for a slow plain render.
    best = {}
    for key, render in renders.items():
        best[key], med, digest = _time_fn(lambda s: render(s).cpu(), dev,
                                          seeds)
        row[key] = round(rays / best[key] / 1e6, 3)
        row[key + "_median"] = round(rays / med / 1e6, 3)
        row[key + "_digest"] = digest
        if key == "culling_on":
            row["speedup"] = round(best["brute_force"] / best["culling_on"],
                                   2)
    row["best_speedup"] = round(
        best["brute_force"] / min(best["culling_on"], best["wavefront"]), 2)
    row["auto"] = rtt.pick_engine(scene)
    row["device"] = card(dev)
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--counts", type=int, nargs="+",
                   default=[512, 2048, 10000, 16000, 64000, 100000])
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    rows = []
    for n in args.counts:
        row = culling_row(n, args.width, args.spp, args.depth, args.device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"unit": "Mrays/s", "rows": rows,
                       "knobs": "render_megakernel/render_wavefront "
                                "defaults (the queue kernel and its fold in "
                                "every table mode; streamed chunks of 512 "
                                "in blocks of 32)"}, f, indent=1)


if __name__ == "__main__":
    main()
