"""A configuration file made into the scene both sides are handed.

:func:`inputs` reads the configuration's textures, materials, spheres and
quads (each quad cut into ``tessellation`` x ``tessellation`` cells of two
triangles) into numpy arrays, every number rounded to the configuration's
``dtype``: these are the inputs, and the reference reads them as they are.
:func:`program_scene` hands the same numbers to the program through its
public ``SceneBuilder`` and ``make_camera``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .reference.tracer import DIFFUSE_METHODS, MAT_KINDS, TEX_KINDS

_DTYPES = {"float32": np.float32, "float64": np.float64}


def inputs(cfg: dict) -> Dict[str, np.ndarray]:
    """The scene's arrays, each float rounded to ``cfg["dtype"]`` and held
    as float64."""
    rnd = _DTYPES[cfg["dtype"]]

    def fl(a, shape):
        return np.asarray(a, np.float64).reshape(shape).astype(rnd).astype(
            np.float64)

    tex, mat = cfg["textures"], cfg["materials"]
    sph = np.asarray(cfg["spheres"], np.float64).reshape(-1, 8)
    tris, tri_m = [], []
    for q in cfg["quads"]:
        n = int(q["tessellation"])
        c = np.asarray(q["corner"], np.float64)
        u = np.asarray(q["u"], np.float64) / n
        v = np.asarray(q["v"], np.float64) / n
        for i in range(n):
            for j in range(n):
                p = c + i * u + j * v
                tris += [(p, p + u, p + v), (p + u, p + u + v, p + v)]
                tri_m += [q["material"]] * 2
    tri = np.asarray(tris, np.float64).reshape(-1, 3, 3)
    return {
        "sph_c": fl(sph[:, 0:3], (-1, 3)), "sph_r": fl(sph[:, 3], (-1,)),
        "sph_v": fl(sph[:, 4:7], (-1, 3)),
        "sph_m": sph[:, 7].astype(np.int64),
        "tri_v0": fl(tri[:, 0], (-1, 3)), "tri_v1": fl(tri[:, 1], (-1, 3)),
        "tri_v2": fl(tri[:, 2], (-1, 3)),
        "tri_m": np.asarray(tri_m, np.int64),
        "mat_kind": np.asarray([MAT_KINDS[m["kind"]] for m in mat]),
        "mat_tex": np.asarray([m.get("texture", 0) for m in mat]),
        "mat_method": np.asarray([DIFFUSE_METHODS[m.get("method",
                                                        "hemisphere")]
                                  for m in mat]),
        "mat_fuzz": fl([m.get("fuzz", 0.0) for m in mat], (-1,)),
        "mat_ior": fl([m.get("ior", 1.0) for m in mat], (-1,)),
        "tex_kind": np.asarray([TEX_KINDS[t["kind"]] for t in tex]),
        "tex_color": fl([t.get("color", [0.0] * 3) for t in tex], (-1, 3)),
        "tex_scale": fl([t.get("scale", 1.0) for t in tex], (-1,)),
        "tex_even": np.asarray([t.get("even", 0) for t in tex]),
        "tex_odd": np.asarray([t.get("odd", 0) for t in tex]),
    }


def program_scene(arrays: Dict[str, np.ndarray], cfg: dict, device,
                  params: Optional[Dict[str, np.ndarray]] = None):
    """(Scene, Camera) of the program, built from ``arrays`` (with the
    trainable arrays of ``params``, keyed as in :func:`inputs`, in their
    place) through the program's public builder, on ``device``."""
    import torch
    import rayz_tpu_torch as rtt
    from rayz_tpu_torch.models import scene as sm

    a = dict(arrays, **(params or {}))
    methods = {DIFFUSE_METHODS["unit_sphere"]: sm.DIFFUSE_UNIT_SPHERE,
               DIFFUSE_METHODS["unit_sphere_surface"]:
                   sm.DIFFUSE_UNIT_SPHERE_SURFACE,
               DIFFUSE_METHODS["hemisphere"]: sm.DIFFUSE_HEMISPHERE}
    b = rtt.SceneBuilder()
    for i, kind in enumerate(a["tex_kind"]):
        if kind == TEX_KINDS["solid"]:
            b.add_solid_texture(tuple(a["tex_color"][i]))
        else:
            b.add_checker_texture(float(a["tex_scale"][i]),
                                  int(a["tex_even"][i]), int(a["tex_odd"][i]))
    for i, kind in enumerate(a["mat_kind"]):
        if kind == MAT_KINDS["diffuse"]:
            b.add_diffuse(texture=int(a["mat_tex"][i]),
                          method=methods[int(a["mat_method"][i])])
        elif kind == MAT_KINDS["metal"]:
            b.add_metallic(texture=int(a["mat_tex"][i]),
                           fuzz=float(a["mat_fuzz"][i]))
        else:
            b.add_dielectric(float(a["mat_ior"][i]), share=False)
    for c, r, v, m in zip(a["sph_c"], a["sph_r"], a["sph_v"], a["sph_m"]):
        b.add_sphere(tuple(c), float(r), int(m),
                     velocity=tuple(v) if np.any(v != 0.0) else None)
    for v0, v1, v2, m in zip(a["tri_v0"], a["tri_v1"], a["tri_v2"],
                             a["tri_m"]):
        b.add_triangle(tuple(v0), tuple(v1), tuple(v2), int(m))
    dtype = getattr(torch, cfg["dtype"])
    cam = cfg["camera"]
    width, height = (int(x) for x in cfg["resolution"])
    camera = rtt.make_camera(
        width=width, height=height, vfov=cam["vfov"],
        focus_dist=cam["focus_dist"], defocus_angle=cam["defocus_angle"],
        look_from=tuple(cam["look_from"]), look_at=tuple(cam["look_at"]),
        vup=tuple(cam["vup"]), dtype=dtype, device=device)
    scene = b.build(dtype=dtype, pad_multiple=int(cfg["pad_multiple"]),
                    device=device)
    return scene, camera
