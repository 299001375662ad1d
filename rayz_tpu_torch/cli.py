"""Command-line renderer, mirroring the reference CLI: positional image
width, optional output path (default: PPM to stdout), timed render printing
rays/s and us/ray in the reference's format. Extras beyond the reference:
scene selection, spp/depth/seed flags, the engine and the dense
integrator's chunk size, PNG output by extension, the device to render
on, progress by sample chunks, and pixel-sharded rendering over several
processes.

Usage:
    python -m rayz_tpu_torch 512 out.ppm
    python -m rayz_tpu_torch 512 out.png --scene cornell_box --spp 64 --depth 32
    torchrun --nproc-per-node 2 -m rayz_tpu_torch 512 out.png --sharded
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed

from . import RenderConfig, render_fast, scenes, write_png, write_ppm
from .ops import rng
from .ops.engine import ENGINES, pick_engine
from .ops.megakernel import render_megakernel_sharded
from .parallel import initialize, is_primary_host, make_mesh, render_sharded
from .parallel.multihost import rank_device


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


def chunk_sizes(spp: int) -> list:
    """The sample chunks of ``--progress`` (JAX's rule, rayz_tpu/cli.py):
    at least 16 spp a chunk where the spp allow it, at most 10 chunks,
    the remainder spread over the first ones."""
    n = (max(1, min(10, spp // 16)) if spp >= 16 else min(spp, 10))
    base, extra = divmod(spp, n)
    return [base + (1 if i < extra else 0) for i in range(n)]


def chunk_seed(seed: int, i: int) -> int:
    """Seed of ``--progress``'s chunk ``i``: the run seed and the chunk
    number hashed together (JAX's ``fold_in(key, i)``), so the chunks draw
    independent samples."""
    key = rng.hash32(torch.tensor(int(seed) & rng.MASK, dtype=torch.int64))
    return int(rng.hash32(key ^ (i + 1)))


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
    p.add_argument("--sharded", action="store_true",
                   help="shard the pixels over the ranks of the launcher "
                        "(torchrun --nproc-per-node N -m rayz_tpu_torch ... "
                        "--sharded), one device each; rank 0 prints the "
                        "timing and writes the image")
    p.add_argument("--progress", action="store_true",
                   help="print in-render progress (the reference's "
                        "'Progress: X.XX%%' line on stderr) by rendering the "
                        "spp in chunks, each with its own seed, averaged "
                        "with spp weights")
    args = p.parse_args(argv)

    dev = _device(args.device)
    if args.sharded:
        initialize(device=dev.type)
        dev = rank_device(dev.type)
        mesh = make_mesh(dev.type)
    try:
        return _render(args, dev, mesh if args.sharded else None)
    finally:
        if args.sharded:
            torch.distributed.destroy_process_group()


def _render(args, dev: torch.device, mesh) -> int:
    """Render and write the image (rank 0 only, on a mesh)."""
    scene, camera = scenes.SCENES[args.scene](width=args.width,
                                              height=args.height, device=dev)
    cfg = RenderConfig(spp=args.spp, max_depth=args.depth, t_min=args.t_min,
                       chunk_size=args.chunk)
    engine = pick_engine(scene, args.engine)

    if mesh is not None:
        def render(verbose=True):
            if engine == "megakernel":
                return render_megakernel_sharded(scene, camera, args.seed,
                                                 cfg, mesh)
            return render_sharded(scene, camera, args.seed, cfg, mesh)
    elif args.progress and args.spp > 1:
        sizes = chunk_sizes(args.spp)

        def render(verbose=True):
            acc, done = None, 0
            for i, s in enumerate(sizes):
                if verbose:
                    print(f"\rProgress: {100.0 * done / args.spp:.2f}%",
                          end="", file=sys.stderr)
                img = render_fast(scene, camera, chunk_seed(args.seed, i),
                                  cfg._replace(spp=s), engine=engine)
                acc = img * s if acc is None else acc + img * s
                done += s
            if verbose:
                print("\rProgress: 100.00%", file=sys.stderr)
            return acc / args.spp
    else:
        def render(verbose=True):
            return render_fast(scene, camera, args.seed, cfg, engine=engine)

    def run(verbose=True):
        img = render(verbose)
        _sync(dev)
        return img

    # Build the kernels and warm up outside the timed region (the reference
    # has no compile step; the progress line stays quiet in the warm-up).
    run(verbose=False)
    st = time.perf_counter()
    img = run()
    dur = time.perf_counter() - st
    if not is_primary_host():
        return 0

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
