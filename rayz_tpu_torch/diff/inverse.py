"""Inverse rendering: recover scene parameters by gradient descent on pixels.

PyTorch counterpart of :mod:`rayz_tpu.diff.inverse` for its two recorded
engines: :func:`pixel_loss` (inverse.py:147), :func:`make_train_step`
(:188) without a mesh, and :func:`fit` (:312), with ``torch.optim.Adam`` in
place of optax. Parameters are a dict of leaf tensors keyed by scene field
(:data:`DEFAULT_TRAINABLE`); autograd reaches them through
:func:`rayz_tpu_torch.ops.pathrec.render_diff_pp` (``"recorded-pp"``, the
persistent-path estimator) or :func:`rayz_tpu_torch.ops.diffkernel.render_diff`
(``"recorded"``, the bounce-indexed one, whose recorder streams scenes
beyond one block's shared memory).

Not ported yet, and raising ``NotImplementedError`` rather than degrading:
the ``"dense"`` engine (ROADMAP queue 1 item 4), the mesh path (item 9) and
checkpoints (item 10). The render under ``"recorded-pp"`` replays a float32
scene through the fused replay kernels and a float64 scene through the
eager replay, as the JAX package does (the ``fused=None`` default of
:func:`rayz_tpu_torch.ops.pathrec.render_diff_pp_flat`); ``"recorded"``
replays eagerly in the scene's dtype, as the JAX package replays in XLA.

Seeds are ints; :func:`fit` draws each step's seed from an explicit
``torch.Generator``.

The JAX module's geometry-gradient caveat holds here too: the HEMISPHERE
diffuse scatter is piecewise constant in the surface normal, so positions
lit only through it get zero gradient almost everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.diffkernel import RECORD_STREAM_CHUNK, render_diff, supports_diff
from ..ops.integrator import RenderConfig
from ..ops.pathrec import render_diff_pp
from ..ops.tables import SHARED_LIMIT, fits_record_stream, fits_shared

__all__ = [
    "DEFAULT_TRAINABLE",
    "extract_params",
    "inject_params",
    "params_from_numpy",
    "pixel_loss",
    "make_train_step",
    "fit",
]

# Differentiable scene leaves: geometry, albedo, roughness, IOR (the JAX
# package's list, inverse.py:65).
DEFAULT_TRAINABLE = (
    "sphere_center",
    "sphere_radius",
    "tri_v0",
    "tri_v1",
    "tri_v2",
    "tex_color",
    "mat_fuzz",
    "mat_ior",
)

_ENGINES = ("dense", "recorded", "recorded-pp")
_NOT_PORTED = {"dense": "the dense engine is ROADMAP queue 1 item 4"}


def extract_params(scene: Scene,
                   fields: Sequence[str] = DEFAULT_TRAINABLE
                   ) -> Dict[str, torch.Tensor]:
    """The scene's trainable tensors, keyed by field name."""
    return {f: getattr(scene, f) for f in fields}


def inject_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    """The scene with ``params`` in place of its fields."""
    return dataclasses.replace(scene, **params)


def params_from_numpy(arrays: dict) -> Dict[str, torch.Tensor]:
    """Parameters from numpy arrays keyed by field name (for example the
    JAX ``extract_params(scene)``, ``np.asarray`` each), dtypes kept; the
    parameter-dict counterpart of ``scene_from_numpy``."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in arrays.items()}


def _check_engine(engine: str) -> None:
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[engine])


def _check_recordable(scene: Scene, engine: str) -> None:
    """Gate of the recorded engines (inverse.py:97): RAISES unless the
    engine's recorder can run ``scene``. ``"recorded"`` takes every scene
    :func:`supports_diff` covers whose tables fit one block's shared memory
    or whose chunk bounds do (:func:`fits_record_stream`: streamed);
    ``"recorded-pp"`` only the first. The JAX package's one-hot replay
    budget has no counterpart (the port gathers rows), and its
    ``allow_dense=True`` degrade to the dense integrator none until that
    engine is ported (ROADMAP queue 1 item 4)."""
    _check_engine(engine)
    if not supports_diff(scene):
        why = ("the scene is empty or nests checker textures, which the "
               "record/replay estimator does not shade exactly")
    elif fits_shared(scene):
        return
    elif engine == "recorded":
        if fits_record_stream(scene, RECORD_STREAM_CHUNK):
            return
        why = (f"the bounds of its chunks of {RECORD_STREAM_CHUNK} columns "
               f"exceed one block's {SHARED_LIMIT} bytes of shared memory")
    else:
        why = (f"its tables exceed one block's {SHARED_LIMIT} bytes of "
               "shared memory on an H100, and the persistent-path recorder "
               "keeps them there (it cannot stream); use engine='recorded', "
               "whose recorder streams")
    raise ValueError(f"engine={engine!r} cannot record this scene: {why}")


def pixel_loss(params: Dict[str, torch.Tensor], scene: Scene,
               camera: Camera, seed: int, target: torch.Tensor,
               config: RenderConfig, engine: str = "dense",
               iters: Optional[int] = None, return_leftover: bool = False):
    """Mean squared pixel error of a fresh stochastic render against
    ``target``, differentiable in ``params``.

    ``engine="recorded"`` renders by bounce-indexed record/replay
    (:func:`render_diff`), which never truncates: its leftover is 0.
    ``engine="recorded-pp"`` renders by persistent-path record/replay; its
    default budget completes every sample through straggler compaction,
    ``iters`` overrides the recording budget, and ``return_leftover=True``
    returns ``(loss, leftover)``: a nonzero leftover counts truncated
    samples, so loss AND gradients are biased low (:func:`fit` raises on
    it). A scene the engine's recorder cannot run raises (see
    :func:`_check_recordable`)."""
    _check_recordable(scene, engine)
    fitted = inject_params(scene, params)
    if engine == "recorded":
        img = render_diff(fitted, camera, seed, config)
        leftover = torch.zeros((), dtype=torch.int64, device=img.device)
    else:
        img, leftover = render_diff_pp(fitted, camera, seed, config,
                                       iters=iters, return_leftover=True)
    loss = torch.mean((img - target.reshape(img.shape)) ** 2)
    if return_leftover:
        return loss, leftover
    return loss


def make_train_step(optimizer: torch.optim.Optimizer, config: RenderConfig,
                    mesh=None, engine: str = "dense",
                    iters: Optional[int] = None, strict: bool = False,
                    with_leftover: bool = False):
    """Build a training step over the parameters ``optimizer`` updates:
    ``step(params, scene, camera, seed, target) -> (params, loss)``, or
    ``(params, loss, leftover)`` with ``with_leftover=True``. The step
    zeroes the gradients, differentiates :func:`pixel_loss` and applies
    one optimizer update to ``params`` in place (the JAX step returns new
    params and optimizer state; here the optimizer holds its state).
    ``iters`` overrides the ``"recorded-pp"`` recording budget;
    ``strict=True`` forces the exhaustive single-pass ``spp * max_depth``,
    which never truncates. ``mesh`` (pixel-sharded data parallelism) is
    ROADMAP queue 1 item 9."""
    _check_engine(engine)
    if mesh is not None:
        raise NotImplementedError("the mesh path of make_train_step is "
                                  "ROADMAP queue 1 item 9")
    if strict:
        if iters is not None:
            raise ValueError("pass either iters or strict=True, not both")
        iters = config.spp * config.max_depth

    def step(params, scene, camera, seed, target):
        optimizer.zero_grad(set_to_none=True)
        loss, leftover = pixel_loss(params, scene, camera, seed, target,
                                    config, engine, iters, True)
        loss.backward()
        optimizer.step()
        if with_leftover:
            return params, loss.detach(), leftover
        return params, loss.detach()

    return step


def fit(scene: Scene, camera: Camera, target: torch.Tensor, *,
        config: RenderConfig, steps: int = 200, learning_rate: float = 1e-2,
        fields: Sequence[str] = DEFAULT_TRAINABLE, mesh=None,
        seed: int = 0, callback=None, engine: str = "dense",
        iters: Optional[int] = None, strict: bool = False,
        checkpoint_dir: Optional[str] = None) -> Tuple[Scene, list]:
    """Run Adam on pixel L2 against ``target``; returns (fitted scene, loss
    history). Step seeds are drawn from a ``torch.Generator`` seeded with
    ``seed``. With ``engine="recorded-pp"`` every step's leftover is
    checked on the host: a nonzero value (samples truncated even after
    straggler compaction, so loss and gradients would be biased) raises
    ``RuntimeError``; raise ``iters`` or pass ``strict=True`` to proceed.
    ``checkpoint_dir`` (resume) is ROADMAP queue 1 item 10."""
    if checkpoint_dir is not None:
        raise NotImplementedError("fit checkpoints are ROADMAP queue 1 item "
                                  "10")
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)
    check_left = engine == "recorded-pp"
    step_fn = make_train_step(optimizer, config, mesh, engine=engine,
                              iters=iters, strict=strict, with_leftover=True)
    gen = torch.Generator().manual_seed(int(seed))
    history = []
    for i in range(steps):
        sub = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        params, loss, leftover = step_fn(params, scene, camera, sub, target)
        if check_left and int(leftover):
            raise RuntimeError(
                f"fit step {i}: recording budget truncated {int(leftover)} "
                f"of {camera.height * camera.width * config.spp} samples "
                "even after straggler compaction; loss/gradients would be "
                "biased. Raise iters= (recording budget) or pass "
                "strict=True for the exhaustive single-pass budget.")
        history.append(float(loss))
        if callback is not None:
            callback(i, float(loss), params)
    return inject_params(scene, {k: v.detach() for k, v in params.items()}
                         ), history
