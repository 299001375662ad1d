"""Inverse rendering: recover scene parameters by gradient descent on pixels.

PyTorch counterpart of :mod:`rayz_tpu.diff.inverse`: :func:`pixel_loss`
(inverse.py:147), :func:`make_train_step` (:188) on one device or over a
pixel-sharded mesh, and :func:`fit` (:312) with its checkpoints, with
``torch.optim.Adam`` in place of optax.
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
The render under
``"recorded-pp"`` replays a float32 scene through the fused replay kernels
and a float64 scene through the eager replay, as the JAX package does (the
``fused=None`` default of
:func:`rayz_tpu_torch.ops.pathrec.render_diff_pp_flat`); ``"recorded"``
replays eagerly in the scene's dtype, as the JAX package replays in XLA.

Seeds are ints; :func:`fit` draws each step's seed from an explicit
``torch.Generator``, whose state its checkpoints keep.

On a mesh (:func:`rayz_tpu_torch.parallel.make_mesh`) each rank renders
its own pixels (the draws keyed by the global pixel ids) and the
gradients are all-reduced; the step then equals the single-device one up
to the order of the sums.

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
from ..ops.diffkernel import render_diff, render_diff_flat, supports_diff
from ..ops.integrator import RenderConfig, render, render_pixels
from ..ops.pathrec import render_diff_pp, render_diff_pp_flat
from ..ops.tables import RECORD_STREAM_CHUNK, SHARED_LIMIT, fits

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
    (streamed); ``"recorded-pp"`` only the first, as
    :func:`~rayz_tpu_torch.ops.tables.resolve` lays out their recorders.
    The JAX package's one-hot replay budget has no counterpart (the port
    gathers rows)."""
    _check_engine(engine)
    if engine == "dense":
        return False
    if not supports_diff(scene):
        why = ("the scene is empty or nests checker textures, which the "
               "record/replay estimator does not shade exactly")
    elif fits(scene, "record" if engine == "recorded" else "record_pp"):
        return True
    elif engine == "recorded":
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

    With a 1-D ``mesh`` (:func:`rayz_tpu_torch.parallel.make_mesh`) the
    step is data-parallel over pixels (inverse.py:230-309); call it on
    every rank with the same arguments. Rank ``s`` of ``D`` takes the
    pixels s, s + D, s + 2D, ... (round-robin, where the renders take
    contiguous ranges: each rank's pixels then sample the whole image, so
    the ranks' work and their shares of ``"recorded-pp"``'s straggling
    samples follow the image's, and its compaction schedule, sized for a
    share of the slots, holds on every rank; contiguous halves of the
    flagship left 632 samples unfinished on the rank holding the ground).
    It renders them through the engine's pixel-list render, keyed by the
    global pixel ids, and differentiates the SUM of their squared errors.
    The loss, every parameter gradient and the leftover are all-reduced
    (SUM) over the mesh, and the loss and gradients divided by
    ``H * W * 3``, so the learning rate means what it means off the mesh.
    No pixel is padded: a rank beyond the pixels renders none."""
    _check_engine(engine)
    if strict:
        if iters is not None:
            raise ValueError("pass either iters or strict=True, not both")
        iters = config.spp * config.max_depth
    if mesh is not None:
        return _mesh_step(optimizer, config, mesh, engine, iters,
                          with_leftover, allow_dense)

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


def _shard_loss(params, scene: Scene, camera: Camera, seed: int,
                target: torch.Tensor, config: RenderConfig, engine: str,
                iters: Optional[int], allow_dense: bool, pix: torch.Tensor):
    """One rank's summed squared error over the global pixel ids ``pix``
    (int32 [n], n > 0) and its leftover (0 but for a truncated
    ``"recorded-pp"`` recording): JAX's ``_loss_grad_shard`` body. Each
    engine renders the pixel list keyed by the global ids:
    ``render_pixels`` (dense), ``render_diff_pp_flat`` or
    ``render_diff_flat``."""
    recordable = _check_recordable(scene, engine, allow_dense)
    fitted = inject_params(scene, params)
    tgt = target.reshape(-1, 3)[pix.long()]
    left = torch.zeros((), dtype=torch.int64, device=camera.device)
    kw = dict(spp=config.spp, max_depth=config.max_depth, t_min=config.t_min,
              jitter=config.jitter)
    px, py = pix % camera.width, pix // camera.width
    if engine == "recorded-pp" and recordable:
        img, left = render_diff_pp_flat(fitted, camera, seed, px, py,
                                        iters=iters, return_leftover=True,
                                        **kw)
    elif engine == "recorded" and recordable:
        img = render_diff_flat(fitted, camera, seed, px, py, **kw)
    else:
        img = render_pixels(fitted, camera, seed, pix, config)
    return torch.sum((img - tgt.to(img.dtype)) ** 2), left


def _mesh_step(optimizer, config, mesh, engine, iters, with_leftover,
               allow_dense):
    """The mesh path of :func:`make_train_step`."""
    import torch.distributed as dist

    group = mesh.get_group()

    def step(params, scene, camera, seed, target):
        optimizer.zero_grad(set_to_none=True)
        n_px = camera.height * camera.width
        pix = torch.arange(mesh.get_local_rank(), n_px, mesh.size(),
                           dtype=torch.int32, device=camera.device)
        leaves = list(params.values())
        if pix.numel():
            loss, left = _shard_loss(params, scene, camera, seed, target,
                                     config, engine, iters, allow_dense, pix)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            loss = loss.detach()
        else:  # more ranks than pixels: this rank adds nothing, but
            # raises where the others raise instead of waiting for them
            _check_recordable(scene, engine, allow_dense)
            loss = torch.zeros((), dtype=camera.dtype, device=camera.device)
            left = torch.zeros((), dtype=torch.int64, device=camera.device)
            grads = [None] * len(leaves)
        # the recorded engines' gradients can be strided views of one
        # table; a collective reduces a dense tensor
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(leaves, grads)]
        for t in (loss, left, *grads):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        denom = n_px * 3
        for p, g in zip(leaves, grads):
            p.grad = g / denom
        optimizer.step()
        loss = loss / denom
        if with_leftover:
            return params, loss, left
        return params, loss

    return step


def fit(scene: Scene, camera: Camera, target: torch.Tensor, *,
        config: RenderConfig, steps: int = 200, learning_rate: float = 1e-2,
        fields: Sequence[str] = DEFAULT_TRAINABLE, mesh=None,
        seed: int = 0, callback=None, engine: str = "dense",
        iters: Optional[int] = None, strict: bool = False,
        allow_dense: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50) -> Tuple[Scene, list]:
    """Run Adam on pixel L2 against ``target``; returns (fitted scene, loss
    history). Step seeds are drawn from a ``torch.Generator`` seeded with
    ``seed``. With ``engine="recorded-pp"`` every step's leftover is
    checked on the host: a nonzero value (samples truncated even after
    straggler compaction, so loss and gradients would be biased) raises
    ``RuntimeError``; raise ``iters`` or pass ``strict=True`` to proceed.
    ``engine`` and ``allow_dense`` as in :func:`pixel_loss`: with the
    defaults it trains through the dense integrator. ``mesh`` trains
    pixel-sharded (:func:`make_train_step`); every rank runs ``fit`` with
    the same arguments, and a truncated recording raises on each.

    With ``checkpoint_dir`` the parameters, the Adam ``state_dict``, the
    step number and the generator's state are saved
    (:mod:`rayz_tpu_torch.diff.checkpoint`) every ``checkpoint_every``
    steps and after the last; a directory that holds a checkpoint already
    RESUMES from its latest step, onto the trajectory an uninterrupted run
    takes, bit for bit. ``steps`` counts the resumed steps too; the
    history covers only the steps this call runs (inverse.py:312-390). On
    a mesh rank 0 writes and every rank reads."""
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)
    gen = torch.Generator().manual_seed(int(seed))
    start = 0
    if checkpoint_dir is not None:
        from . import checkpoint as ckpt

        last = ckpt.latest_step(checkpoint_dir)
        if last is not None:
            st = ckpt.restore_checkpoint(checkpoint_dir, last,
                                         map_location=camera.device)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(st["params"][k])
            optimizer.load_state_dict(st["optimizer"])
            gen.set_state(st["generator"].cpu())
            start = int(st["step"])
    check_left = engine == "recorded-pp"
    step_fn = make_train_step(optimizer, config, mesh, engine=engine,
                              iters=iters, strict=strict, with_leftover=True,
                              allow_dense=allow_dense)
    history = []
    for i in range(start, steps):
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
        if checkpoint_dir is not None and (
                (i + 1) % checkpoint_every == 0 or i + 1 == steps):
            _save(checkpoint_dir, i + 1, params, optimizer, gen, mesh)
    return inject_params(scene, {k: v.detach() for k, v in params.items()}
                         ), history


def _save(directory: str, step: int, params, optimizer, gen, mesh) -> None:
    """Checkpoint a fit after ``step`` steps; on a mesh rank 0 writes and
    the ranks wait for it, so none reads a checkpoint not yet written."""
    from . import checkpoint as ckpt

    rank0 = mesh is None or mesh.get_rank() == 0
    if rank0:
        ckpt.save_checkpoint(directory, step, {
            "params": {k: v.detach() for k, v in params.items()},
            "optimizer": optimizer.state_dict(),
            "generator": gen.get_state(), "step": step})
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.get_group())
