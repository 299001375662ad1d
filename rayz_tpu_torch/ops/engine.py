"""Render-engine dispatch.

PyTorch counterpart of :mod:`rayz_tpu.ops.engine`, three engines:

* ``"megakernel"`` — :func:`rayz_tpu_torch.ops.megakernel.render_megakernel`,
  the persistent path-tracing kernel (the JAX package's ``"pallas"``
  engine): tables in shared memory, or streamed from device memory;
* ``"wavefront"`` — :func:`rayz_tpu_torch.ops.wavefront.render_wavefront`,
  the bounce-synchronous engine with sorted rays, for large scenes;
* ``"xla"`` — :func:`rayz_tpu_torch.ops.integrator.render`, the dense
  integrator (plain torch; the name is the JAX package's): every scene,
  nested checker textures and any size included.

``"auto"`` follows the JAX rule with the H100's limits, each asked of
:func:`~rayz_tpu_torch.ops.tables.resolve`: nested checker textures (the
kernels resolve one level) and scenes with no primitive go to ``"xla"``;
then the megakernel for scenes whose tables fit one block's shared memory,
the wavefront for the rest that its streamed launch takes, the streamed
megakernel for the few larger scenes whose chunk bounds still fit, and
``"xla"`` beyond.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .integrator import RenderConfig, render_jit
from .megakernel import render_megakernel
from .tables import DEFAULT_STREAM_CHUNK, fits, fits_shared, supports_scene
from .wavefront import render_wavefront

__all__ = ["render_fast", "pick_engine", "ENGINES"]

ENGINES = ("auto", "megakernel", "wavefront", "xla")

# render_fast keywords the wavefront takes; the megakernel's others
# (budget, passes) do not apply to it and are dropped, as in JAX
_WAVEFRONT_KW = ("culling", "block_size", "stream", "sort")


def pick_engine(scene, engine: str = "auto") -> str:
    """Resolve an engine name; ``"auto"`` -> ``"megakernel"``,
    ``"wavefront"`` or ``"xla"``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "auto":
        return engine
    if not supports_scene(scene):  # nested checkers, or nothing but sky
        return "xla"
    if fits_shared(scene):
        return "megakernel"
    if fits(scene, "wavefront", stream=DEFAULT_STREAM_CHUNK):
        return "wavefront"
    if fits(scene, "megakernel"):  # streamed
        return "megakernel"
    return "xla"


def render_fast(scene, camera, seed: int,
                config: RenderConfig = RenderConfig(), engine: str = "auto",
                **engine_kw):
    """Render [H, W, 3] with the fastest applicable engine (forward only),
    on the device the scene and camera live on. Keywords go to the engine;
    the wavefront takes ``culling``, ``block_size``, ``stream`` and
    ``sort`` and ignores the rest, the dense integrator ignores them all
    (it reads ``config.chunk_size``)."""
    with span("dispatch"):
        eng = pick_engine(scene, engine)
    if eng == "xla":
        with torch.no_grad():
            return render_jit(scene, camera, seed, config)
    if eng == "wavefront":
        kw = {k: v for k, v in engine_kw.items()
              if k in _WAVEFRONT_KW and v is not None}
        return render_wavefront(scene, camera, seed, config, **kw)
    return render_megakernel(scene, camera, seed, config, **engine_kw)
