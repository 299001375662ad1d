"""Forward Mrays/s of every BASELINE.json render config on the card: the
counterpart of ``scripts/bench_configs.py``.

Configs (BASELINE.md): (1) two_sphere 256x256 4spp d8, (2) three_sphere
512x512 16spp d16, (3) random_bouncing 512x512 64spp d32, (4) cornell_box
512x512 64spp d32. Each renders through ``render_fast(engine="auto")``:
one warm-up, then the best of seeds 1-3, each synced and copied to the
host. One JSON line per config, with the engine ``pick_engine`` resolved
and the card's name and power limit.

Run:  python -m rayz_tpu_torch.scripts.bench_configs [--out FILE]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import rayz_tpu_torch as rtt
from rayz_tpu_torch.scripts import card, resolve, sync

CONFIGS = [
    ("two_sphere", dict(width=256, height=256), 4, 8),
    ("three_sphere", dict(width=512, height=512), 16, 16),
    ("random_bouncing", dict(width=512, height=512), 64, 32),
    ("cornell_box", dict(width=512, height=512), 64, 32),
]
SEEDS = (1, 2, 3)


def config_row(name: str, kw: dict, spp: int, depth: int,
               device="cuda") -> dict:
    """One config's row: forward Mrays/s, the best of :data:`SEEDS` after
    one warm-up."""
    dev = resolve(device)
    scene, camera = rtt.scenes.SCENES[name](**kw, device=dev)
    config = rtt.RenderConfig(spp=spp, max_depth=depth, t_min=1e-3)

    def run(seed):
        return rtt.render_fast(scene, camera, seed, config,
                               engine="auto").cpu()

    run(0)  # warm-up
    best = float("inf")
    for s in SEEDS:
        sync(dev)
        t0 = time.perf_counter()
        run(s)
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    rays = camera.width * camera.height * spp
    return {"config": name, "width": camera.width, "height": camera.height,
            "spp": spp, "depth": depth,
            "fwd_mrays_per_s": round(rays / best / 1e6, 3),
            "engine": rtt.pick_engine(scene), "device": card(dev)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    rows = []
    for cfg in CONFIGS:
        row = config_row(*cfg, device=args.device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"unit": "Mrays/s", "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
