"""Render-engine dispatch.

PyTorch counterpart of :mod:`rayz_tpu.ops.engine`. The port has one engine
so far:

* ``"megakernel"`` — :func:`rayz_tpu_torch.ops.megakernel.render_megakernel`,
  the persistent path-tracing kernel with the scene tables in shared memory
  (the JAX package's ``"pallas"`` engine).

``"auto"`` resolves to it for every scene it supports whose tables fit one
block's shared memory. Engines and scenes that are not ported yet raise
``NotImplementedError`` naming their ROADMAP item; nothing falls back
quietly.
"""

from __future__ import annotations

from .integrator import RenderConfig
from .megakernel import render_megakernel
from .tables import fits_shared, supports_scene

__all__ = ["render_fast", "pick_engine", "ENGINES"]

ENGINES = ("auto", "megakernel", "wavefront", "xla")

_NOT_PORTED = {
    "xla": "the dense integrator (engine 'xla') is ROADMAP queue 1 item 4",
    "wavefront": "the wavefront engine is ROADMAP queue 1 item 8",
}


def pick_engine(scene, engine: str = "auto") -> str:
    """Resolve an engine name; ``"auto"`` -> ``"megakernel"``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[engine])
    if engine == "auto":
        if scene.deep_checker:
            raise NotImplementedError(
                "nested checker textures need the dense integrator, ROADMAP "
                "queue 1 item 4")
        if not supports_scene(scene):
            raise ValueError("nothing to render: the scene has no spheres "
                             "and no triangles")
        if not fits_shared(scene):
            raise NotImplementedError(
                "scene tables exceed one block's shared memory; streamed "
                "tables and the wavefront engine are ROADMAP queue 1 item 8")
    return "megakernel"


def render_fast(scene, camera, seed: int,
                config: RenderConfig = RenderConfig(), engine: str = "auto",
                **megakernel_kw):
    """Render [H, W, 3] with the fastest applicable engine (forward only),
    on the device the scene and camera live on."""
    pick_engine(scene, engine)
    return render_megakernel(scene, camera, seed, config, **megakernel_kw)
