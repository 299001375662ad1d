"""Train steps back to back: ``make_train_step`` with Adam over the mix's
``fields``, each step a new seed, its loss and leftover synchronised and
copied to the host. A step whose leftover is not 0 truncated its
estimator: it counts as failed.

The mix's ``start_seed`` fixes the fit every run makes: the target (the
reference's render of the configuration's scene in float32 at
``target_spp``), the perturbed trainable numbers it starts from, and a
pool of ``pool`` step seeds. The run's seed orders the pool: every run
makes the same steps in another order (fits drawn whole from the run's
seed changed the work by up to 15% from seed to seed, each seed alike in
two runs). Set-up builds the one step object the window drives, and
drives it through its first ``check_steps`` steps. Those steps are what
the check compares: each step's loss, the first gradient as Adam holds it
after one step (its first moment over 1 - beta1), and the parameters'
change after the last of them. The
reference follows the same steps from the same perturbed numbers, target
and seeds in float64, its own Adam included.

Numbers compared: ``loss_gap``, the relative gap of the first step's
loss (a later step's loss is not compared: it renders parameters that
the two sides moved apart, see PERF.md); ``albedo_grad_gap``, the
relative gap of the norms of the first gradient of the albedo leaf
(:data:`ALBEDO`); ``change_gap``, the gap of the norms of the change, the
worst leaf, against the reference's norm of that leaf or of the median
leaf, whichever is larger (leaves whose reference gradient is under a
thousandth of the median leaf's are left out, as are empty ones);
``check_leftover``, the leftover summed over the checked steps, limit 0.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterator

import numpy as np
import torch

from benchmark import scene as bs
from benchmark.harness import request_seeds
from benchmark.reference import tracer as ref

BETAS = (0.9, 0.999)
EPS = 1e-8
# The leaf whose gradient is compared: the albedos enter a path's radiance
# as factors, with no singular term (PERF.md: the geometry and IOR leaves'
# norms are carried by a few grazing hits).
ALBEDO = "tex_color"
_ARRAY = {"sphere_center": "sph_c", "sphere_radius": "sph_r",
          "tri_v0": "tri_v0", "tri_v1": "tri_v1", "tri_v2": "tri_v2",
          "tex_color": "tex_color", "mat_fuzz": "mat_fuzz",
          "mat_ior": "mat_ior"}


def perturb(arrays, spec: dict, seed: int, dtype=np.float32):
    """The trainable arrays moved from the configuration's values by
    ``seed``: centres, radii and vertices by N(0, s) absolute, solid colours by
    N(0, s) relative (kept in [0, 1]), metal fuzz and dielectric IOR by
    N(0, s) absolute (fuzz in [0, 1], IOR above 1.01), each rounded to the
    configuration's dtype."""
    g = request_seeds(seed, 4)
    out = {}
    for field, key in _ARRAY.items():
        a = arrays[key].copy()
        s = float(spec.get(field, 0.0))
        if field in ("sphere_center", "sphere_radius", "tri_v0", "tri_v1",
                     "tri_v2"):
            a = a + s * g.standard_normal(a.shape)
        elif field == "tex_color":
            solid = arrays["tex_kind"] == 0
            noise = 1.0 + s * g.standard_normal(a.shape)
            a = np.where(solid[:, None], np.clip(a * noise, 0.0, 1.0), a)
        elif field == "mat_fuzz":
            metal = arrays["mat_kind"] == ref.MAT_KINDS["metal"]
            a = np.where(metal, np.clip(a + s * g.standard_normal(a.shape),
                                        0.0, 1.0), a)
        elif field == "mat_ior":
            glass = arrays["mat_kind"] == ref.MAT_KINDS["dielectric"]
            a = np.where(glass, np.maximum(
                a + s * g.standard_normal(a.shape), 1.01), a)
        out[key] = a.astype(dtype).astype(np.float64)
    return out


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().to(torch.float64)))
            for k, v in tensors.items() if v.numel()}


def gaps(prog: dict, want: dict) -> dict:
    """The numbers compared, from two sides' readings (see module doc)."""
    g_ref = want["grad"]
    median = float(np.median(list(g_ref.values())))
    counted = [k for k, v in g_ref.items() if v >= 1e-3 * median]
    med = float(np.median([want["change"][k] for k in counted]))
    change = max(abs(prog["change"][k] - want["change"][k])
                 / max(want["change"][k], med) for k in counted)
    loss = abs(prog["loss"][0] - want["loss"][0]) / abs(want["loss"][0])
    albedo = abs(prog["grad"][ALBEDO] - g_ref[ALBEDO]) / g_ref[ALBEDO]
    return {"loss_gap": loss, "albedo_grad_gap": albedo,
            "change_gap": change}


def reference_readings(cfg, tr, arrays, start, target, seeds, device,
                       dtype=torch.float64):
    """The reference's losses, first gradient norms and change norms over
    the steps ``seeds``, from the perturbed numbers ``start``, with Adam
    worked out here. Returns (readings, segments of the first step)."""
    fields = tr["fields"]
    p0 = {f: torch.as_tensor(start[_ARRAY[f]]).to(device=device,
                                                   dtype=dtype)
          for f in fields}
    params = {f: t.clone().requires_grad_(True) for f, t in p0.items()}
    m = {f: torch.zeros_like(t) for f, t in p0.items()}
    v = {f: torch.zeros_like(t) for f, t in p0.items()}
    cam = ref.Camera(cfg, dtype, device)
    tgt = target.to(device=device, dtype=dtype)
    out = {"loss": []}
    segments0 = None
    for k, s in enumerate(seeds, start=1):
        sc = ref.Scene(arrays, dtype, device, params)
        loss, seg = ref.loss_and_grad(sc, cam, s, tgt, int(tr["spp"]),
                                      cfg["max_depth"], cfg["t_min"])
        segments0 = seg if segments0 is None else segments0
        out["loss"].append(loss)
        grads = {f: torch.zeros_like(t) if t.grad is None else t.grad
                 for f, t in params.items()}
        if k == 1:
            out["grad"] = norms(grads)
        with torch.no_grad():
            lr = float(tr["lr"])
            for f, t in params.items():
                m[f].mul_(BETAS[0]).add_(grads[f], alpha=1 - BETAS[0])
                v[f].mul_(BETAS[1]).addcmul_(grads[f], grads[f],
                                              value=1 - BETAS[1])
                den = (v[f].sqrt() / (1 - BETAS[1] ** k) ** 0.5).add_(EPS)
                t.addcdiv_(m[f], den, value=-lr / (1 - BETAS[0] ** k))
                t.grad = None
    out["change"] = norms({f: t.detach() - p0[f] for f, t in params.items()})
    return out, segments0


def make_target(cfg, tr, arrays, device) -> torch.Tensor:
    """The target [H, W, 3]: the reference's float32 render of the
    configuration's scene at ``target_spp``, on a seed drawn from the
    mix's ``start_seed``."""
    width, height = cfg["resolution"]
    with torch.no_grad():
        img, _ = ref.render_pixels(
            ref.Scene(arrays, torch.float32, device),
            ref.Camera(cfg, torch.float32, device),
            int(request_seeds(tr["start_seed"], 5).integers(2 ** 31 - 1)),
            torch.arange(width * height, device=device),
            int(tr["target_spp"]), cfg["max_depth"], cfg["t_min"])
    return img.reshape(height, width, 3).contiguous()


def step_seeds(seed: int, tr) -> Iterator[int]:
    """The steps' seeds: the mix's pool in the order the run's seed draws,
    over again if a window outlasts it; the checked steps take the first."""
    pool = request_seeds(tr["start_seed"], 1).integers(2 ** 31 - 1,
                                                       size=int(tr["pool"]))
    order = request_seeds(seed, 1).permutation(len(pool))
    return itertools.cycle(int(pool[i]) for i in order)


class Traffic:
    def __init__(self, cell, seed: int, device):
        import rayz_tpu_torch as rtt

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.seed = cfg, tr, seed
        self.device = torch.device(device)
        self.arrays = bs.inputs(cfg)
        width, height = cfg["resolution"]
        self.rays = width * height * int(tr["spp"])
        # the target is the reference's work: its seconds are not set-up
        t = time.perf_counter()
        self.target = make_target(cfg, tr, self.arrays, device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        self.reference_s = time.perf_counter() - t
        self.start = perturb(self.arrays, tr["perturb"], tr["start_seed"])
        self.scene, self.camera = bs.program_scene(self.arrays, cfg, device,
                                                   self.start)
        fields = tuple(tr["fields"])
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in
                       rtt.extract_params(self.scene, fields).items()}
        p0 = {k: v.detach().clone() for k, v in self.params.items()}
        self.opt = torch.optim.Adam(list(self.params.values()),
                                    lr=float(tr["lr"]), betas=BETAS, eps=EPS)
        self.step = rtt.make_train_step(
            self.opt, rtt.RenderConfig(spp=int(tr["spp"]),
                                       max_depth=cfg["max_depth"],
                                       t_min=cfg["t_min"]),
            engine=tr["engine"], with_leftover=True)
        self.seeds = step_seeds(seed, tr)
        self.check_seeds = [next(self.seeds)
                            for _ in range(int(tr["check_steps"]))]
        self.readings = {"loss": []}
        self.leftover = 0
        for k, s in enumerate(self.check_seeds, start=1):
            loss, left = self._step(s)
            self.readings["loss"].append(loss)
            self.leftover += left
            if k == 1:
                self.readings["grad"] = norms({
                    f: self.opt.state[p]["exp_avg"] / (1 - BETAS[0])
                    if p in self.opt.state else torch.zeros_like(p)
                    for f, p in self.params.items()})
        self.readings["change"] = norms({f: p.detach() - p0[f]
                                         for f, p in self.params.items()})

    def _step(self, s: int):
        self.params, loss, left = self.step(self.params, self.scene,
                                            self.camera, s, self.target)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return float(loss.cpu()), int(left.cpu())

    def request(self, i: int):
        _, left = self._step(next(self.seeds))
        return self.rays, left == 0

    def check(self):
        """Free the program's state, then follow the checked steps with
        the reference."""
        target = self.target.cpu()
        self.step = self.opt = self.params = self.scene = self.camera = None
        self.target = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want, segments = reference_readings(
            self.cfg, self.tr, self.arrays, self.start, target,
            self.check_seeds, self.device)
        numbers = gaps(self.readings, want)
        numbers["check_leftover"] = self.leftover
        return numbers, 0, {"segments_per_step": segments,
                            "grad_norms": {"program": self.readings["grad"],
                                           "reference": want["grad"]}}


def control_readings(cell, seed: int, device, dtype=torch.bfloat16):
    """The control: the reference in ``dtype`` put in the program's place
    over the cell's checked steps, judged against the float64 reference."""
    cfg, tr = cell.config, cell.traffic
    arrays = bs.inputs(cfg)
    target = make_target(cfg, tr, arrays, device).cpu()
    start = perturb(arrays, tr["perturb"], tr["start_seed"])
    seeds = step_seeds(seed, tr)
    steps = [next(seeds) for _ in range(int(tr["check_steps"]))]
    low, _ = reference_readings(cfg, tr, arrays, start, target, steps,
                                device, dtype)
    want, _ = reference_readings(cfg, tr, arrays, start, target, steps,
                                 device)
    return gaps(low, want)
