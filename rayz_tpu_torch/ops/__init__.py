from .engine import pick_engine, render_fast
from .integrator import RenderConfig
from .megakernel import render_megakernel
from .tables import fits_shared, scene_tables, supports_scene, tri_tables

__all__ = [
    "RenderConfig",
    "render_fast",
    "render_megakernel",
    "pick_engine",
    "fits_shared",
    "scene_tables",
    "tri_tables",
    "supports_scene",
]
