"""Inverse rendering: recover scene parameters by gradient descent on pixels.

PyTorch counterpart of :mod:`rayz_tpu.diff.inverse`: :func:`pixel_loss`
(inverse.py:147), :func:`make_train_step` (:188) without a mesh, and
:func:`fit` (:312), with ``torch.optim.Adam`` in place of optax.
Parameters are a dict of leaf tensors keyed by scene field
(:data:`DEFAULT_TRAINABLE`); autograd reaches them through one of three
engines:

* ``"dense"`` (the default): :func:`rayz_tpu_torch.ops.integrator.render`,
  the dense integrator differentiated end to end (any scene; O(R N) work a
  bounce, its backward memory bounded by per-bounce and per-chunk
  checkpoints, ``RenderConfig.remat`` and ``chunk_size``);
* ``"recorded-pp"``: :func:`rayz_tpu_torch.ops.pathrec.render_diff_pp`, the
  persistent-path record/replay estimator, the fastest backward;
* ``"recorded"``: :func:`rayz_tpu_torch.ops.diffkernel.render_diff`, the
  bounce-indexed one, whose recorder streams scenes beyond one block's
  shared memory.

A recorded engine RAISES on a scene its recorder cannot run, unless the
caller passes ``allow_dense=True``: then it renders through the dense
integrator with a ``RuntimeWarning``, never silently (inverse.py:97).
Not ported yet, and raising ``NotImplementedError``: the mesh path (ROADMAP
queue 1 item 9) and checkpoints (item 10). The render under
``"recorded-pp"`` replays a float32 scene through the fused replay kernels
and a float64 scene through the eager replay, as the JAX package does (the
``fused=None`` default of
:func:`rayz_tpu_torch.ops.pathrec.render_diff_pp_flat`); ``"recorded"``
replays eagerly in the scene's dtype, as the JAX package replays in XLA.

Seeds are ints; :func:`fit` draws each step's seed from an explicit
``torch.Generator``.

The JAX module's geometry-gradient caveat holds here too: the HEMISPHERE
diffuse scatter is piecewise constant in the surface normal, so positions
lit only through it get zero gradient almost everywhere (build such scenes
with ``method=DIFFUSE_UNIT_SPHERE``, metal or glass).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.diffkernel import RECORD_STREAM_CHUNK, render_diff, supports_diff
from ..ops.integrator import RenderConfig, render
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


def _check_recordable(scene: Scene, engine: str,
                      allow_dense: bool = False) -> bool:
    """Gate of the recorded engines (inverse.py:97): True when the engine's
    recorder can run ``scene``, False for ``"dense"``. Otherwise it RAISES,
    unless ``allow_dense=True``: then it warns (``RuntimeWarning``) and
    returns False, and the caller renders densely. The degrade trades an
    O(R) backward for an O(R N) one, so it is never silent.

    ``"recorded"`` takes every scene :func:`supports_diff` covers whose
    tables fit one block's shared memory or whose chunk bounds do
    (:func:`fits_record_stream`: streamed); ``"recorded-pp"`` only the
    first. The JAX package's one-hot replay budget has no counterpart (the
    port gathers rows)."""
    _check_engine(engine)
    if engine == "dense":
        return False
    if not supports_diff(scene):
        why = ("the scene is empty or nests checker textures, which the "
               "record/replay estimator does not shade exactly")
    elif fits_shared(scene):
        return True
    elif engine == "recorded":
        if fits_record_stream(scene, RECORD_STREAM_CHUNK):
            return True
        why = (f"the bounds of its chunks of {RECORD_STREAM_CHUNK} columns "
               f"exceed one block's {SHARED_LIMIT} bytes of shared memory")
    else:
        why = (f"its tables exceed one block's {SHARED_LIMIT} bytes of "
               "shared memory on an H100, and the persistent-path recorder "
               "keeps them there (it cannot stream); use engine='recorded', "
               "whose recorder streams")
    msg = f"engine={engine!r} cannot record this scene: {why}. "
    if not allow_dense:
        raise ValueError(
            msg + "Pass allow_dense=True to fall back to the dense "
            "differentiable integrator (an O(R*N) backward, far slower), or "
            "use engine='dense' explicitly.")
    warnings.warn(msg + "Falling back to the dense O(R*N) integrator "
                  "(allow_dense=True): expect a large slowdown.",
                  RuntimeWarning, stacklevel=3)
    return False


def pixel_loss(params: Dict[str, torch.Tensor], scene: Scene,
               camera: Camera, seed: int, target: torch.Tensor,
               config: RenderConfig, engine: str = "dense",
               iters: Optional[int] = None, return_leftover: bool = False,
               allow_dense: bool = False):
    """Mean squared pixel error of a fresh stochastic render against
    ``target``, differentiable in ``params``.

    ``engine="dense"`` differentiates through the dense integrator
    (:func:`render`; any scene). ``engine="recorded"`` renders by
    bounce-indexed record/replay (:func:`render_diff`), which never
    truncates: its leftover is 0. ``engine="recorded-pp"`` renders by
    persistent-path record/replay; its default budget completes every
    sample through straggler compaction, ``iters`` overrides the recording
    budget, and ``return_leftover=True`` returns ``(loss, leftover)``: a
    nonzero leftover counts truncated samples, so loss AND gradients are
    biased low (:func:`fit` raises on it). A scene the engine's recorder
    cannot run raises, or with ``allow_dense=True`` renders densely with a
    ``RuntimeWarning`` (see :func:`_check_recordable`)."""
    recordable = _check_recordable(scene, engine, allow_dense)
    fitted = inject_params(scene, params)
    leftover = None
    if engine == "recorded-pp" and recordable:
        img, leftover = render_diff_pp(fitted, camera, seed, config,
                                       iters=iters, return_leftover=True)
    elif engine == "recorded" and recordable:
        img = render_diff(fitted, camera, seed, config)
    else:
        img = render(fitted, camera, seed, config)
    if leftover is None:
        leftover = torch.zeros((), dtype=torch.int64, device=img.device)
    loss = torch.mean((img - target.reshape(img.shape)) ** 2)
    if return_leftover:
        return loss, leftover
    return loss


def make_train_step(optimizer: torch.optim.Optimizer, config: RenderConfig,
                    mesh=None, engine: str = "dense",
                    iters: Optional[int] = None, strict: bool = False,
                    with_leftover: bool = False, allow_dense: bool = False):
    """Build a training step over the parameters ``optimizer`` updates:
    ``step(params, scene, camera, seed, target) -> (params, loss)``, or
    ``(params, loss, leftover)`` with ``with_leftover=True``. The step
    zeroes the gradients, differentiates :func:`pixel_loss` and applies
    one optimizer update to ``params`` in place (the JAX step returns new
    params and optimizer state; here the optimizer holds its state).
    ``iters`` overrides the ``"recorded-pp"`` recording budget;
    ``strict=True`` forces the exhaustive single-pass ``spp * max_depth``,
    which never truncates; ``allow_dense`` as in :func:`pixel_loss`.
    ``mesh`` (pixel-sharded data parallelism) is ROADMAP queue 1 item 9."""
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
                                    config, engine, iters, True,
                                    allow_dense)
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
        allow_dense: bool = False,
        checkpoint_dir: Optional[str] = None) -> Tuple[Scene, list]:
    """Run Adam on pixel L2 against ``target``; returns (fitted scene, loss
    history). Step seeds are drawn from a ``torch.Generator`` seeded with
    ``seed``. With ``engine="recorded-pp"`` every step's leftover is
    checked on the host: a nonzero value (samples truncated even after
    straggler compaction, so loss and gradients would be biased) raises
    ``RuntimeError``; raise ``iters`` or pass ``strict=True`` to proceed.
    ``engine`` and ``allow_dense`` as in :func:`pixel_loss`: with the
    defaults it trains through the dense integrator. ``checkpoint_dir``
    (resume) is ROADMAP queue 1 item 10."""
    if checkpoint_dir is not None:
        raise NotImplementedError("fit checkpoints are ROADMAP queue 1 item "
                                  "10")
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)
    check_left = engine == "recorded-pp"
    step_fn = make_train_step(optimizer, config, mesh, engine=engine,
                              iters=iters, strict=strict, with_leftover=True,
                              allow_dense=allow_dense)
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
