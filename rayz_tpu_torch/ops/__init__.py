from .engine import pick_engine, render_fast
from .integrator import (RenderConfig, render, render_jit, render_pixels,
                         trace_rays)
from .intersect import (HitRecord, aabb_hit, intersect, intersect_spheres,
                        intersect_triangles)
from .shade import scatter, schlick_reflectance, sky_color, texture_value
from .megakernel import render_megakernel, render_megakernel_sharded
from .pathrec import (default_iters, default_k1, gather_rows, gather_rows_T,
                      record_pp, render_diff_pp, render_diff_pp_flat,
                      replay_pp, supports_pp)
from .diffkernel import record_paths, render_diff, replay_paths, supports_diff
from .tables import (fits_shared, fits_stream, scene_tables, supports_scene,
                     tri_tables)
from .wavefront import render_wavefront, supports_wavefront

__all__ = [
    "RenderConfig",
    "render",
    "render_jit",
    "render_pixels",
    "trace_rays",
    "intersect",
    "intersect_spheres",
    "intersect_triangles",
    "HitRecord",
    "aabb_hit",
    "scatter",
    "schlick_reflectance",
    "sky_color",
    "texture_value",
    "render_fast",
    "render_megakernel",
    "render_megakernel_sharded",
    "render_wavefront",
    "supports_wavefront",
    "pick_engine",
    "render_diff_pp",
    "render_diff_pp_flat",
    "render_diff",
    "record_paths",
    "replay_paths",
    "record_pp",
    "replay_pp",
    "gather_rows",
    "gather_rows_T",
    "default_iters",
    "default_k1",
    "supports_pp",
    "supports_diff",
    "fits_shared",
    "fits_stream",
    "scene_tables",
    "tri_tables",
    "supports_scene",
]
