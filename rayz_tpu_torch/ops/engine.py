"""Render-engine dispatch.

PyTorch counterpart of :mod:`rayz_tpu.ops.engine`. Two engines are ported:

* ``"megakernel"`` — :func:`rayz_tpu_torch.ops.megakernel.render_megakernel`,
  the persistent path-tracing kernel (the JAX package's ``"pallas"``
  engine): tables in shared memory, or streamed from device memory;
* ``"wavefront"`` — :func:`rayz_tpu_torch.ops.wavefront.render_wavefront`,
  the bounce-synchronous engine with sorted rays, for large scenes.

``"auto"`` follows the JAX rule with the H100's limits: the megakernel for
scenes whose tables fit one block's shared memory (:func:`fits_shared`),
the wavefront for the rest that its streamed launch takes
(:func:`fits_wavefront`), and the streamed megakernel for the few larger
scenes whose chunk bounds still fit (:func:`fits_stream`). Engines and
scenes that are not ported yet raise ``NotImplementedError`` naming their
ROADMAP item; nothing falls back quietly.
"""

from __future__ import annotations

from .integrator import RenderConfig
from .megakernel import render_megakernel
from .tables import fits_shared, fits_stream, fits_wavefront, supports_scene
from .wavefront import render_wavefront

__all__ = ["render_fast", "pick_engine", "ENGINES"]

ENGINES = ("auto", "megakernel", "wavefront", "xla")

_NOT_PORTED = {
    "xla": "the dense integrator (engine 'xla') is ROADMAP queue 1 item 4",
}

# render_fast keywords the wavefront takes; the megakernel's others
# (budget, passes) do not apply to it and are dropped, as in JAX
_WAVEFRONT_KW = ("culling", "block_size", "stream", "sort")


def pick_engine(scene, engine: str = "auto") -> str:
    """Resolve an engine name; ``"auto"`` -> ``"megakernel"`` or
    ``"wavefront"``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[engine])
    if engine != "auto":
        return engine
    if scene.deep_checker:
        raise NotImplementedError(
            "nested checker textures need the dense integrator, ROADMAP "
            "queue 1 item 4")
    if not supports_scene(scene):
        raise ValueError("nothing to render: the scene has no spheres and no "
                         "triangles")
    if fits_shared(scene):
        return "megakernel"
    if fits_wavefront(scene):
        return "wavefront"
    if fits_stream(scene):
        return "megakernel"
    raise NotImplementedError(
        "scene too large even for the streamed tables' chunk bounds in shared "
        "memory; the JAX package renders it with the dense integrator, ROADMAP "
        "queue 1 item 4")


def render_fast(scene, camera, seed: int,
                config: RenderConfig = RenderConfig(), engine: str = "auto",
                **engine_kw):
    """Render [H, W, 3] with the fastest applicable engine (forward only),
    on the device the scene and camera live on. Keywords go to the engine;
    the wavefront takes ``culling``, ``block_size``, ``stream`` and
    ``sort`` and ignores the rest."""
    if pick_engine(scene, engine) == "wavefront":
        kw = {k: v for k, v in engine_kw.items()
              if k in _WAVEFRONT_KW and v is not None}
        return render_wavefront(scene, camera, seed, config, **kw)
    return render_megakernel(scene, camera, seed, config, **engine_kw)
