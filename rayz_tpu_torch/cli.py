"""Command-line renderer, mirroring the reference CLI: positional image
width, optional output path (default: PPM to stdout), timed render printing
rays/s and us/ray in the reference's format. Extras beyond the reference:
scene selection, spp/depth/seed flags, the engine and the dense
integrator's chunk size, PNG output by extension, and the device to render
on.

Usage:
    python -m rayz_tpu_torch 512 out.ppm
    python -m rayz_tpu_torch 512 out.png --scene cornell_box --spp 64 --depth 32
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import RenderConfig, render_fast, scenes, write_png, write_ppm
from .ops.engine import ENGINES, pick_engine


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch sees no CUDA device; pass --device cpu "
            "to render with the plain torch version instead")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rayz_tpu_torch", description=__doc__)
    p.add_argument("width", type=int, help="image width in pixels")
    p.add_argument("output", nargs="?", default=None,
                   help="output path (.ppm or .png); default: PPM to stdout")
    p.add_argument("--scene", default="random_bouncing", choices=sorted(scenes.SCENES))
    p.add_argument("--height", type=int, default=None,
                   help="image height (default: the scene's own aspect — "
                        "16:9 like the reference, or square)")
    p.add_argument("--spp", type=int, default=10,
                   help="samples per pixel (reference default 10)")
    p.add_argument("--depth", type=int, default=50,
                   help="max bounces (reference default 50)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--t-min", type=float, default=1e-3)
    p.add_argument("--chunk", type=int, default=None,
                   help="rays per chunk of the dense integrator (memory "
                        "bound; engine xla)")
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="render engine; auto picks the megakernel for scenes "
                        "whose tables fit one block's shared memory, the "
                        "wavefront for larger ones and the dense integrator "
                        "(xla) for nested checker textures and beyond the "
                        "streamed tables' limits")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernel (and fails "
                        "without a GPU); cpu runs the plain torch version")
    args = p.parse_args(argv)

    dev = _device(args.device)
    scene, camera = scenes.SCENES[args.scene](width=args.width,
                                              height=args.height, device=dev)
    cfg = RenderConfig(spp=args.spp, max_depth=args.depth, t_min=args.t_min,
                       chunk_size=args.chunk)
    engine = pick_engine(scene, args.engine)

    def run():
        img = render_fast(scene, camera, args.seed, cfg, engine=engine)
        _sync(dev)
        return img

    # Build the kernels and warm up outside the timed region (the reference
    # has no compile step).
    run()
    st = time.perf_counter()
    img = run()
    dur = time.perf_counter() - st

    # camera-ray count, matching the reference's metric (one ray counted per
    # pixel-sample)
    rays = camera.height * camera.width * args.spp
    print(
        f"Finished render ({dur:.2f}s): {rays / dur:.2f} rps and "
        f"{dur / rays * 1e6:.2f} us per ray",
        file=sys.stderr,
    )

    img = img.cpu()
    if args.output is None:
        write_ppm(img, sys.stdout.buffer)
    elif args.output.endswith(".png"):
        write_png(img, args.output)
    else:
        write_ppm(img, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
