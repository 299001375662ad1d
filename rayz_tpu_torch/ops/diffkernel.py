"""The differentiable parameter table of the record/replay estimators.

PyTorch counterpart of the part of :mod:`rayz_tpu.ops.diffkernel` that the
persistent-path estimator (:mod:`rayz_tpu_torch.ops.pathrec`) needs:
``supports_diff`` (diffkernel.py:100), ``_diff_material_cols`` (:607) and
``_diff_tables`` (:633). The bounce-indexed recorder, ``record_paths``,
``replay_paths`` and ``render_diff`` join in a later slice (ROADMAP queue 1
item 7).

The residency rule of the JAX module, ``fits_smem_record`` (:111), is sized
for the 1 MiB SMEM of a TPU v5e. The port's recorder keeps the same tables
as the megakernel in one block's shared memory, so its rule is
:func:`rayz_tpu_torch.ops.tables.fits_shared`.
"""

from __future__ import annotations

import torch

from ..models.scene import TEX_SOLID, Scene

__all__ = ["supports_diff"]


def supports_diff(scene: Scene) -> bool:
    """Record/replay covers any non-empty sphere/triangle scene whose
    checker textures nest one level at most: the replay resolves one
    checker level, like the megakernel, and would shade a deeper nest
    differently, so such scenes are refused rather than degraded."""
    return ((scene.n_spheres > 0 or scene.n_triangles > 0)
            and not scene.deep_checker)


def _diff_material_cols(scene: Scene, mat: torch.Tensor) -> torch.Tensor:
    """Differentiable per-primitive material columns [P, 11]: kind, method,
    fuzz, ior, checker scale, even rgb, odd rgb (checker children resolved
    one level, like the megakernel; a solid texture gets even == odd ==
    its color and scale 1)."""
    dt = scene.sphere_center.dtype
    mat = mat.long()
    kind = scene.mat_kind[mat].to(dt)
    method = scene.mat_method[mat].to(dt)
    fuzz = scene.mat_fuzz[mat]
    ior = scene.mat_ior[mat]

    tex = scene.mat_texture[mat].long()
    solid = scene.tex_kind[tex] == TEX_SOLID
    base = scene.tex_color[tex]
    even = scene.tex_color[scene.tex_even[tex].long()]
    odd = scene.tex_color[scene.tex_odd[tex].long()]
    ev = torch.where(solid[:, None], base, even)
    od = torch.where(solid[:, None], base, odd)
    scale = scene.tex_scale[tex]
    scale = torch.where(solid, torch.ones_like(scale), scale)
    return torch.cat([kind[:, None], method[:, None], fuzz[:, None],
                      ior[:, None], scale[:, None], ev, od], dim=1)


def _diff_tables(scene: Scene) -> torch.Tensor:
    """Per-primitive [N_pad + M_pad, 20] parameter table, built from the
    scene's leaf tensors so autograd reaches them (the differentiable twin
    of :func:`rayz_tpu_torch.ops.tables.scene_tables` / ``tri_tables``).

    Geometry (columns 0:9): a sphere is [center(3), velocity(3), radius, 0,
    0]; a triangle (rows N_pad..) is [v0(3), v1(3), v2(3)], so the replay
    derives its plane from the raw vertices. Material (columns 9:20): see
    :func:`_diff_material_cols`. An absent class contributes no rows, so a
    triangle's row is the sphere count (0 without spheres) plus its
    column, the index the recorder writes."""
    parts = []
    if scene.n_spheres > 0:
        zeros = torch.zeros_like(scene.sphere_radius[:, None])
        parts.append(torch.cat([
            scene.sphere_center, scene.sphere_velocity,
            scene.sphere_radius[:, None], zeros, zeros,
            _diff_material_cols(scene, scene.sphere_material)], dim=1))
    if scene.n_triangles > 0:
        parts.append(torch.cat([
            scene.tri_v0, scene.tri_v1, scene.tri_v2,
            _diff_material_cols(scene, scene.tri_material)], dim=1))
    return torch.cat(parts, dim=0)
