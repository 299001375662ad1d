"""Renders back to back: ``render_fast`` at the mix's samples per pixel,
a new seed each, the image synchronised and copied to the host.

The check: a sample of the window's renders, drawn from the run's seed by
reservoir sampling (``check.renders`` of them), and in each a sample of
``check.pixels`` pixels. The reference traces those pixels' paths from the
same seeds in float64; the number compared, ``pixel_gap``, is the largest
over the sampled renders of the mean absolute gap over their pixels'
channels.
"""

from __future__ import annotations

import torch

from benchmark import scene as bs
from benchmark.harness import request_seeds
from benchmark.reference import tracer as ref


class Traffic:
    def __init__(self, cell, seed: int, device):
        import rayz_tpu_torch as rtt

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.spp, self.engine = int(tr["spp"]), tr["engine"]
        self.arrays = bs.inputs(cfg)
        self.scene, self.camera = bs.program_scene(self.arrays, cfg, device)
        self.config = rtt.RenderConfig(spp=self.spp,
                                       max_depth=cfg["max_depth"],
                                       t_min=cfg["t_min"])
        width, height = cfg["resolution"]
        self.rays = width * height * self.spp
        self.check_cfg = cell.workload["check"]
        self.limit = cell.workload["limits"]["pixel_gap"]
        self.seeds = request_seeds(seed, 1)
        self.pick = request_seeds(seed, 2)
        # the images' places on the host, page-locked and reused (a fresh
        # pageable tensor a render faults in its pages every time): one
        # for each render the check keeps, one for the rest
        k = int(self.check_cfg["renders"])
        self.kept = [None] * k
        self.slots = [torch.empty((height, width, 3), dtype=torch.float32,
                                  pin_memory=self.device.type == "cuda")
                      for _ in range(k + 1)]
        warm = request_seeds(seed, 3)
        for _ in range(int(tr["warmup"])):
            self.render(int(warm.integers(2 ** 31 - 1)), self.slots[-1])

    def render(self, s: int, out: torch.Tensor) -> torch.Tensor:
        """One render, synchronised and copied into ``out`` on the host."""
        import rayz_tpu_torch as rtt

        img = rtt.render_fast(self.scene, self.camera, s, self.config,
                              engine=self.engine)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return out.copy_(img)

    def request(self, i: int):
        """Render ``i``; by reservoir sampling it replaces the ``j``-th
        kept render, its image copied straight into that one's place."""
        s = int(self.seeds.integers(2 ** 31 - 1))
        k = len(self.kept)
        j = i if i < k else int(self.pick.integers(i + 1))
        img = self.render(s, self.slots[min(j, k)])
        if j < k:
            self.kept[j] = (s, img)
        return self.rays, True

    def check(self):
        """Free the program's state, then judge the kept renders."""
        kept = [(s, _pixels_of(img)) for s, img in filter(None, self.kept)]
        self.scene = self.camera = self.kept = self.slots = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        gaps, per_ray = pixel_gaps(self.cfg, self.arrays, self.spp, kept,
                                   self.seed, int(self.check_cfg["pixels"]),
                                   self.device)
        failed = sum(g > self.limit for g in gaps)
        return {"pixel_gap": max(gaps)}, failed, \
            {"segments_per_ray": per_ray}


def _pixels_of(img: torch.Tensor):
    flat = img.reshape(-1, 3)
    return lambda pix: flat[pix.cpu()]


def check_pixels(seed: int, k: int, n_pixels: int, count: int):
    """The pixels checked in the ``k``-th kept render."""
    g = request_seeds(seed, 100 + k)
    return torch.as_tensor(g.choice(n_pixels, size=min(count, n_pixels),
                                    replace=False))


def pixel_gaps(cfg, arrays, spp: int, kept, seed: int, count: int, device,
               dtype=torch.float64):
    """For each kept (render seed, pixel values function), the mean
    absolute gap between its values and the reference's at the checked
    pixels. Returns (gaps, reference segments per camera ray)."""
    sc = ref.Scene(arrays, dtype, device)
    cam = ref.Camera(cfg, dtype, device)
    n_pixels = cam.width * cam.height
    gaps, segments, paths = [], 0, 0
    for k, (s, values) in enumerate(kept):
        pix = check_pixels(seed, k, n_pixels, count).to(device)
        want, seg = ref.render_pixels(sc, cam, s, pix, spp,
                                      cfg["max_depth"], cfg["t_min"])
        got = values(pix).to(device=device, dtype=torch.float64)
        gaps.append(float((got - want.to(torch.float64)).abs().mean()))
        segments += seg
        paths += pix.numel() * spp
    return gaps, segments / max(paths, 1)


def control_gaps(cell, seed: int, device, renders: int,
                 dtype=torch.bfloat16):
    """The control: the reference in ``dtype`` put in the program's place
    for ``renders`` requests of the cell's seeds, judged as a run is."""
    cfg = cell.config
    arrays = bs.inputs(cfg)
    spp = int(cell.traffic["spp"])
    seeds = request_seeds(seed, 1)
    low_sc = ref.Scene(arrays, dtype, device)
    low_cam = ref.Camera(cfg, dtype, device)

    def low(s):
        return lambda pix: ref.render_pixels(low_sc, low_cam, s, pix, spp,
                                             cfg["max_depth"],
                                             cfg["t_min"])[0]

    kept = [(s, low(s)) for s in
            (int(seeds.integers(2 ** 31 - 1)) for _ in range(renders))]
    return pixel_gaps(cfg, arrays, spp, kept, seed,
                      int(cell.workload["check"]["pixels"]), device)[0]
