"""On-card statistical parity checks of the port's stochastic engines and
of its gradients: the counterpart of ``scripts/tpu_check.py``.

``chip_smoke.py`` holds each kernel against its plain version, the engines
against each other and the dense integrator against the megakernel, all
at one seed: they share the kernels' draws (``ops/rng.py``), so a bias
that a kernel and its plain version share (a draw, a sampling routine, a
scatter rule) passes every one of those checks. Here each engine renders
at :data:`ENGINE_SEED` and the dense integrator (:func:`rayz_tpu_torch.
render`, plain torch) at :data:`ORACLE_SEED`, an independent stream: their
images must agree in mean absolute error within Monte-Carlo noise. (At
the engine's own seed the dense integrator traces the same paths, and the
check would pass by construction.) Beside each check stands the oracle's
noise floor, the error of the dense render at :data:`FLOOR_SEED` against
the oracle; a check whose floor is not below its tolerance cannot see a
bias at that size and fails.

The gradient lines (``tpu_check.py:142-352``): finite differences of the
fused replay's loss on one frozen ``record_pp`` recording, for shading
parameters and triangle vertices, and the fused replay's velocity and
centre gradients against the eager replay's on the same recording.

Run:  python -m rayz_tpu_torch.scripts.gpu_check [--width 128] [--spp 256]
      [--device cuda]

One ``OK``/``FAIL``/``SKIP`` line per check; exits non-zero on any
failure. ``SKIP`` only where a ``supports_*``/``fits`` predicate
refuses the scene. Runs on the card unless ``--device cpu`` is given (the
kernels' plain versions, at small sizes only).
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.models.scene import DIFFUSE_UNIT_SPHERE
from rayz_tpu_torch.ops import diffkernel as dk, pathrec as pr
from rayz_tpu_torch.ops.tables import fits, supports_scene
from rayz_tpu_torch.ops.wavefront import supports_wavefront
from rayz_tpu_torch.scripts import card, resolve

ENGINE_SEED = 1
ORACLE_SEED = 2   # never ENGINE_SEED: the dense integrator shares its draws
FLOOR_SEED = 3
GRAD_SEED = 7     # the gradient lines' recordings
DIRECTION_SEED = 3  # the finite differences' random direction
T_MIN = 1e-3
#: the dense oracle's rays per chunk (chip_smoke.py's [dense] phase)
ORACLE_CHUNK = 65_536
#: the chunk of the forced streamed modes, as chip_smoke.py streams the
#: golden scene's recorder
STREAM_CHUNK = 128

#: (engine, scene, depth, engine keywords) at the run's spp: the
#: megakernel and the wavefront as tpu_check.py:250-256 and :64-90
#: (``checker_two_ior``), then the table modes the port's main paths run,
#: which tpu_check.py never reached
FORWARD = (
    ("megakernel", "two_sphere", 8, {}),
    ("megakernel", "three_sphere", 16, {}),
    ("megakernel", "random_bouncing", 16, {}),
    ("megakernel", "cornell_box", 8, {}),
    ("megakernel", "checker_two_ior", 12, {}),
    ("wavefront", "three_sphere", 16, {}),
    ("wavefront", "random_bouncing", 16, {}),
    ("wavefront", "cornell_box", 8, {}),
    ("megakernel", "random_bouncing", 16, {"culling": True}),
    ("megakernel", "random_bouncing", 16, {"stream": STREAM_CHUNK}),
    ("wavefront", "random_bouncing", 16, {"stream": STREAM_CHUNK}),
)
#: the recorded engines at min(spp, 64) (tpu_check.py:259-264), then the
#: recorder with its tables streamed
RECORDED = (
    ("recorded", "three_sphere", 12, {}),
    ("recorded-pp", "three_sphere", 12, {}),
    ("recorded", "sphere_grid", 6, {}),
    ("recorded-pp", "sphere_grid", 6, {}),
    ("recorded", "cornell_box", 8, {}),
    ("recorded-pp", "cornell_box", 8, {}),
    ("recorded", "three_sphere", 12, {"stream": STREAM_CHUNK}),
)
#: the finite-difference lines at min(width, 64) (tpu_check.py:266-271):
#: label -> (scene, fields, keywords of :meth:`Checks.grad_fd`); then the
#: velocity line
FD_LINES = {
    "shading": ("sphere_grid", ("tex_color", "mat_fuzz"), {}),
    "tri_vertices": ("cornell_box", ("tri_v0", "tri_v1", "tri_v2"),
                     dict(spp=2, depth=8, iters=16, eps=3e-4)),
}
GRADS = (*FD_LINES, "velocity")
GRAD_TOL = 5e-2      # relative, finite difference vs autograd
VELOCITY_TOL = 1e-3  # relative, fused vs eager replay


def forward_tol(spp: int) -> float:
    """tpu_check.py's rule: 0.02 at 256 spp (~3 sigma of Monte-Carlo noise
    on these scenes), scaled by 1/sqrt(spp)."""
    return 0.02 * (256.0 / spp) ** 0.5


def recorded_tol(spp: int) -> float:
    """The same rule at the recorded engines' min(spp, 64)."""
    return forward_tol(min(spp, 64))


@contextlib.contextmanager
def forced_stream(chunk: int):
    """Have record_paths stream every scene in chunks of ``chunk``, as it
    does the scenes beyond one block's shared memory: the recorder's
    layout is resolved with that chunk wherever it is left to the rule."""
    resolve = dk.resolve

    def forced(scene, engine, **kw):
        if engine == "record" and kw.get("stream") is None:
            kw["stream"] = chunk
        return resolve(scene, engine, **kw)
    dk.resolve = forced
    try:
        yield
    finally:
        dk.resolve = resolve


def checker_two_ior(width: int, device="cuda"):
    """tpu_check.py:64-90: a checker floor and two dielectrics of distinct
    refractive index, square, 55 degrees."""
    b = rtt.SceneBuilder()
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.45, even, odd)
    b.add_sphere((0, -100.5, -2), 100.0, b.add_diffuse(texture=checker))
    b.add_sphere((-0.55, 0, -2), 0.5, b.add_dielectric(1.5))
    b.add_sphere((0.55, 0, -2), 0.5, b.add_dielectric(1.0 / 1.5))
    camera = rtt.make_camera(width=width, height=width, vfov=55.0,
                             focus_dist=1.0, look_from=(0, 0, 0),
                             look_at=(0, 0, -1), device=device)
    return b.build(device=device), camera


def moving_scene(width: int, device="cuda"):
    """tpu_check.py's ``_moving_scene``: moving spheres with solid diffuse
    (UNIT_SPHERE) and metal materials, so every value the perturbed fields
    touch responds smoothly under a frozen recording."""
    b = rtt.SceneBuilder()
    g = b.add_diffuse(color=(0.5, 0.5, 0.5), method=DIFFUSE_UNIT_SPHERE)
    b.add_sphere((0, -100.5, -2), 100.0, g)
    d = b.add_diffuse(color=(0.7, 0.3, 0.2), method=DIFFUSE_UNIT_SPHERE)
    m = b.add_metallic(color=(0.8, 0.8, 0.9), fuzz=0.3)
    b.add_sphere((-0.6, 0.15, -2.0), 0.4, d, velocity=(0.0, 0.25, 0.0))
    b.add_sphere((0.6, 0.15, -2.0), 0.4, m, velocity=(0.1, 0.0, 0.1))
    camera = rtt.make_camera(width=width, height=width, vfov=55.0,
                             focus_dist=1.0, look_from=(0, 0, 0),
                             look_at=(0, 0, -1), device=device)
    return b.build(device=device), camera


SCENES: Dict[str, Callable] = dict(rtt.scenes.SCENES,
                                   checker_two_ior=checker_two_ior,
                                   moving=moving_scene)


def _megakernel(scene, camera, seed, cfg, **kw):
    return rtt.render_megakernel(scene, camera, seed, cfg, **kw), 0


def _wavefront(scene, camera, seed, cfg, **kw):
    return rtt.render_wavefront(scene, camera, seed, cfg, **kw), 0


def _recorded(scene, camera, seed, cfg, stream: Optional[int] = None):
    with forced_stream(stream) if stream else contextlib.nullcontext():
        return rtt.render_diff(scene, camera, seed, cfg), 0


def _recorded_pp(scene, camera, seed, cfg):
    # spp * depth: the budget that completes every sample in one pass
    # (tpu_check.py:124-129); leftover must come back 0
    img, left = rtt.render_diff_pp(scene, camera, seed, cfg,
                                   iters=cfg.spp * cfg.max_depth,
                                   return_leftover=True)
    return img, int(left)


#: engine -> render(scene, camera, seed, config, **keywords) -> (image,
#: leftover)
RENDER = {"megakernel": _megakernel, "wavefront": _wavefront,
          "recorded": _recorded, "recorded-pp": _recorded_pp}
#: engine -> whether it takes the scene at these keywords (a refusal is a
#: SKIP)
SUPPORTS = {
    "megakernel": lambda scene, kw: supports_scene(scene),
    "wavefront": lambda scene, kw: supports_wavefront(scene),
    "recorded": lambda scene, kw: dk.supports_diff(scene) and (
        not kw.get("stream") or fits(scene, "record", stream=kw["stream"])),
    "recorded-pp": lambda scene, kw: pr.supports_pp(scene),
}


def _host(img: torch.Tensor) -> np.ndarray:
    return img.detach().float().cpu().numpy()


def _mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a - b)))


def _grads(loss, params: dict) -> dict:
    """Autograd of ``loss(params)`` in every field of ``params``."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    g = torch.autograd.grad(loss(leaves), list(leaves.values()))
    return dict(zip(leaves, g))


class Checks:
    """The checks at one image width and spp on one device. Each check
    prints its line through ``out`` and returns whether it passed. Scenes
    and the dense oracle's renders are made once per (scene, width) and
    (scene, depth, spp) and shared by the engines checked against them."""

    def __init__(self, width: int = 128, spp: int = 256, device="cuda",
                 out: Optional[Callable[[str], None]] = None):
        self.width, self.spp = width, spp
        self.out = out or (lambda line: print(line, flush=True))
        self.dev = resolve(device)
        self._scenes: dict = {}
        self._oracles: dict = {}

    def scene(self, name: str, width: int):
        key = (name, width)
        if key not in self._scenes:
            self._scenes[key] = SCENES[name](width=width, device=self.dev)
        return self._scenes[key]

    def oracle(self, name: str, depth: int, spp: int):
        """The dense render of scene ``name`` at ORACLE_SEED and its noise
        floor: the mean absolute error of the dense render at FLOOR_SEED
        against it."""
        key = (name, depth, spp)
        if key not in self._oracles:
            scene, camera = self.scene(name, self.width)
            cfg = rtt.RenderConfig(spp=spp, max_depth=depth, t_min=T_MIN,
                                   chunk_size=ORACLE_CHUNK)
            with torch.no_grad():
                ref = _host(rtt.render(scene, camera, ORACLE_SEED, cfg))
                other = _host(rtt.render(scene, camera, FLOOR_SEED, cfg))
            self._oracles[key] = ref, _mae(ref, other)
        return self._oracles[key]

    def parity(self, engine: str, name: str, depth: int, kw: dict,
               spp: int, tol: float) -> bool:
        """``engine`` at ENGINE_SEED against the dense oracle: the mean
        absolute error under ``tol``, the image finite, the oracle's floor
        under ``tol``, and no sample left unfinished."""
        label = engine + "".join(f"[{k}={v}]" for k, v in kw.items())
        label = f"{label}/{name}"
        scene, camera = self.scene(name, self.width)
        if not SUPPORTS[engine](scene, kw):
            self.out(f"SKIP {label}: unsupported scene")
            return True
        cfg = rtt.RenderConfig(spp=spp, max_depth=depth, t_min=T_MIN)
        with torch.no_grad():
            img, left = RENDER[engine](scene, camera, ENGINE_SEED, cfg, **kw)
        img = _host(img)
        ref, floor = self.oracle(name, depth, spp)
        mae = _mae(img, ref)
        power = floor < tol
        ok = (mae < tol and bool(np.isfinite(img).all()) and power
              and left == 0)
        self.out(f"{'OK  ' if ok else 'FAIL'} {label:40s} mae={mae:.4f} "
                 f"floor={floor:.4f} tol={tol:.4f} spp={spp} d{depth}"
                 + (f" leftover={left}" if engine == "recorded-pp" else "")
                 + ("" if power else " NO POWER: floor >= tol"))
        return ok

    def _recording(self, scene, camera, *, spp: int, depth: int,
                   iters: int, seed: int):
        n = camera.width * camera.height
        pix = torch.arange(n, dtype=torch.int32, device=self.dev)
        idx, aux, left = pr.record_pp(scene, camera, seed, pix, spp=spp,
                                      max_depth=depth, t_min=T_MIN,
                                      jitter=True, iters=iters)
        return idx, aux, int(left.sum()) == 0

    def grad_fd(self, label: str, name: str, fields, width: int, *,
                spp: int = 2, depth: int = 8, iters: int = 24,
                eps: float = 1e-3, seed: int = GRAD_SEED,
                per_coord: int = 0) -> bool:
        """tpu_check.py:142-296: autograd through the fused replay
        (``replay_pp_fused``, the train step's backward) against a central
        finite difference of the same frozen recording, as a derivative in
        one random direction over ``fields``. The recording freezes every
        control decision, so the loss responds smoothly to the fields
        almost everywhere: this differentiates the estimator exactly, not
        in distribution. Its jumps (a HEMISPHERE diffuse bounce flipping
        its frozen direction as the normal turns, a checker's parity, a
        Schlick choice, a root select) have measure zero but are not
        excluded: a secant that straddles one fails.

        Two measures keep the float32 difference resolvable: the loss is
        summed in float64 (summed in float32, a loss of ~3,900 moves in
        steps of 2.4e-4, 9% of the Cornell box's difference at eps 3e-4),
        and the autograd side is taken along the step the float32
        parameters really took (at coordinates near 555, 3e-4 rounds by up
        to 20%). ``per_coord=k`` instead steps the k largest-gradient
        coordinates of each field one at a time and passes on a two-thirds
        majority (a secant straddling a jump fails only its coordinate; a
        wrong gradient fails them all)."""
        scene, camera = self.scene(name, width)
        idx, aux, complete = self._recording(scene, camera, spp=spp,
                                             depth=depth, iters=iters,
                                             seed=seed)
        n = camera.width * camera.height
        params = {f: getattr(scene, f).detach() for f in fields}

        def loss(p):
            rad = pr.replay_pp_fused(rtt.inject_params(scene, p), idx, aux,
                                     t_min=T_MIN)
            return torch.sum(rad[:n].double() ** 2)

        def value(p):
            with torch.no_grad():
                return float(loss(p))

        grads = _grads(loss, params)
        finite = all(bool(torch.isfinite(grads[f]).all()) for f in fields)
        if per_coord:
            pairs, n_ok = [], 0
            for f in fields:
                g = grads[f].cpu().numpy().ravel()
                base = params[f]
                for k in np.argsort(-np.abs(g))[:per_coord]:
                    plus, minus = base.clone(), base.clone()
                    plus.view(-1)[int(k)] += eps
                    minus.view(-1)[int(k)] -= eps
                    step = float(plus.view(-1)[int(k)]
                                 - minus.view(-1)[int(k)])
                    fd = (value({**params, f: plus})
                          - value({**params, f: minus})) / step
                    rel = abs(fd - g[k]) / max(1.0, abs(fd), abs(g[k]))
                    n_ok += rel < GRAD_TOL
                    pairs.append((f, int(k), fd, float(g[k])))
            ok = n_ok >= -(-2 * len(pairs) // 3) and finite and complete
            detail = " ".join(f"{f}[{k}]:fd={fd:.4g}/ad={ad:.4g}"
                              for f, k, fd, ad in pairs[:3])
            self.out(f"{'OK  ' if ok else 'FAIL'} grad/{label:14s} "
                     f"per-coord {n_ok}/{len(pairs)} within tol={GRAD_TOL} "
                     f"complete={complete} {detail}")
            return ok
        rng = np.random.default_rng(DIRECTION_SEED)
        vs = {f: torch.from_numpy(rng.standard_normal(
            tuple(params[f].shape)).astype(np.float32)).to(self.dev)
            for f in fields}
        plus = {f: params[f] + eps * vs[f] for f in fields}
        minus = {f: params[f] - eps * vs[f] for f in fields}
        # the derivative along the step the f32 parameters really took
        gdotv = sum(float(torch.sum(grads[f].double() * (
            plus[f].double() - minus[f].double()))) for f in fields) / (
                2 * eps)
        fd = (value(plus) - value(minus)) / (2 * eps)
        rel = abs(fd - gdotv) / max(1.0, abs(fd), abs(gdotv))
        ok = rel < GRAD_TOL and finite and complete
        self.out(f"{'OK  ' if ok else 'FAIL'} grad/{label:14s} "
                 f"ad.v={gdotv:.5g} fd={fd:.5g} rel={rel:.4f} "
                 f"tol={GRAD_TOL} finite={finite} complete={complete}")
        return ok

    def grad_velocity(self, width: int) -> bool:
        """tpu_check.py:298-352: the fused replay's gradients in the sphere
        velocities and centres against the eager replay's (``replay_pp``,
        plain autograd, an independent implementation) on the same frozen
        recording of :func:`moving_scene`. A finite difference is the wrong
        tool here: near a silhouette the recorded root's kink makes an f32
        secant measure curvature."""
        scene, camera = self.scene("moving", width)
        idx, aux, complete = self._recording(scene, camera, spp=2, depth=8,
                                             iters=16, seed=GRAD_SEED)
        n = camera.width * camera.height
        fields = ("sphere_velocity", "sphere_center")
        params = {f: getattr(scene, f).detach() for f in fields}

        def loss(replay):
            return lambda p: torch.sum(replay(rtt.inject_params(scene, p),
                                              idx, aux, t_min=T_MIN)[:n] ** 2)

        g_f = _grads(loss(pr.replay_pp_fused), params)
        g_e = _grads(loss(pr.replay_pp), params)
        worst, finite = 0.0, True
        for f in fields:
            a, b = g_e[f], g_f[f]
            finite &= bool(torch.isfinite(b).all())
            scale = max(1.0, float(a.abs().max()))
            worst = max(worst, float((a - b).abs().max()) / scale)
        nz = float(g_f["sphere_velocity"].abs().sum())
        ok = worst < VELOCITY_TOL and finite and complete and nz > 0
        self.out(f"{'OK  ' if ok else 'FAIL'} grad/velocity       "
                 f"fused-vs-eager rel={worst:.2e} tol={VELOCITY_TOL} "
                 f"|g_vel|={nz:.4g} complete={complete}")
        return ok

    def run(self) -> bool:
        """Every check of the lists above, in order; True if all pass."""
        ok = True
        tol = forward_tol(self.spp)
        for engine, name, depth, kw in FORWARD:
            ok &= self.parity(engine, name, depth, kw, self.spp, tol)
        spp, tol = min(self.spp, 64), recorded_tol(self.spp)
        for engine, name, depth, kw in RECORDED:
            ok &= self.parity(engine, name, depth, kw, spp, tol)
        gw = min(self.width, 64)
        for label, (name, fields, kw) in FD_LINES.items():
            ok &= self.grad_fd(label, name, fields, gw, **kw)
        ok &= self.grad_velocity(gw)
        return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    checks = Checks(args.width, args.spp, args.device)
    print(f"# gpu_check width={args.width} spp={args.spp} "
          f"engine_seed={ENGINE_SEED} oracle_seed={ORACLE_SEED} "
          f"floor_seed={FLOOR_SEED} grad_seed={GRAD_SEED} "
          f"device={card(checks.dev)} torch={torch.__version__}",
          flush=True)
    return 0 if checks.run() else 1


if __name__ == "__main__":
    raise SystemExit(main())
