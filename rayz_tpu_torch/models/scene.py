"""Scene representation: flat SoA tensors + an imperative builder.

PyTorch counterpart of :mod:`rayz_tpu.models.scene`. The scene is a frozen
dataclass of flat tensors: vectorized intersection tests every primitive
against every ray, and material/texture "dispatch" is a select on integer
kind codes. Handles are plain integer indices into the SoA tensors.

Primitive counts are padded (``valid`` masks) so kernel tables stay aligned.
Field names, padding and the static analysis match the JAX package, so both
packages compute on identical inputs (see :func:`scene_from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "MAT_DIFFUSE",
    "MAT_METALLIC",
    "MAT_DIELECTRIC",
    "TEX_SOLID",
    "TEX_CHECKER",
    "DIFFUSE_UNIT_SPHERE",
    "DIFFUSE_UNIT_SPHERE_SURFACE",
    "DIFFUSE_HEMISPHERE",
    "Scene",
    "SceneBuilder",
    "scene_from_numpy",
    "resolve_device",
]

# Material kinds (the reference's Material tagged union as integer codes).
MAT_DIFFUSE = 0
MAT_METALLIC = 1
MAT_DIELECTRIC = 2

# Texture kinds.
TEX_SOLID = 0
TEX_CHECKER = 1

# Diffuse scatter methods. HEMISPHERE is the reference default.
DIFFUSE_UNIT_SPHERE = 0
DIFFUSE_UNIT_SPHERE_SURFACE = 1
DIFFUSE_HEMISPHERE = 2

_STATIC = ("n_spheres", "n_triangles", "has_motion", "deep_checker",
           "tex_depth", "uniq_checker_tex", "uniq_dielectric_mat")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if m > 0 else n


def resolve_device(device) -> torch.device:
    """The device a constructor builds on. Scenes and cameras default to
    the card (``"cuda"``), where the kernels run; without one that default
    raises instead of quietly building for the CPU, whose plain versions are
    hundreds of times slower: pass ``device="cpu"`` to ask for them."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch sees no CUDA device; pass "
            "device=\"cpu\" to build on the CPU (the kernels' plain "
            "versions render there)")
    return dev


@dataclasses.dataclass(frozen=True)
class Scene:
    """Flat SoA scene. Tensor fields mirror the JAX ``Scene`` leaves; the
    ``n_*`` counts, ``has_motion`` and the structural hints are plain Python
    values. Sphere centers are stored as start + velocity (center at time t
    = center + t * velocity)."""

    # Spheres
    sphere_center: torch.Tensor  # [N, 3] center at t=0
    sphere_velocity: torch.Tensor  # [N, 3] center motion over t in [0,1]
    sphere_radius: torch.Tensor  # [N]
    sphere_material: torch.Tensor  # [N] int32 index into material tensors
    sphere_valid: torch.Tensor  # [N] bool (False = padding)

    # Triangles
    tri_v0: torch.Tensor  # [M, 3]
    tri_v1: torch.Tensor  # [M, 3]
    tri_v2: torch.Tensor  # [M, 3]
    tri_material: torch.Tensor  # [M] int32
    tri_valid: torch.Tensor  # [M] bool

    # Materials
    mat_kind: torch.Tensor  # [K] int32: MAT_*
    mat_texture: torch.Tensor  # [K] int32 texture index
    mat_fuzz: torch.Tensor  # [K] metallic fuzz
    mat_ior: torch.Tensor  # [K] dielectric refractive index
    mat_method: torch.Tensor  # [K] int32 DIFFUSE_* scatter method

    # Textures
    tex_kind: torch.Tensor  # [T] int32: TEX_*
    tex_color: torch.Tensor  # [T, 3] solid color
    tex_scale: torch.Tensor  # [T] checker scale
    tex_even: torch.Tensor  # [T] int32 child handle (checker)
    tex_odd: torch.Tensor  # [T] int32 child handle (checker)

    # Static metadata (same meaning as in the JAX Scene)
    n_spheres: int = 0
    n_triangles: int = 0
    has_motion: bool = False
    # A checker texture with a checker child: the megakernel resolves one
    # level of checker nesting, so such scenes are rejected, not degraded.
    deep_checker: bool = False
    # Maximum texture-indirection depth (0 = unknown).
    tex_depth: int = 0
    # Index of the sole checker texture / sole dielectric material: -1 =
    # none, -2 = more than one (or unknown).
    uniq_checker_tex: int = -2
    uniq_dielectric_mat: int = -2

    @property
    def dtype(self) -> torch.dtype:
        return self.sphere_center.dtype

    @property
    def device(self) -> torch.device:
        return self.sphere_center.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Scene":
        """A copy with every tensor field on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name not in _STATIC})


def scene_from_numpy(arrays: dict, **statics) -> Scene:
    """Build a :class:`Scene` from numpy arrays keyed by field name (for
    example the JAX ``Scene``'s leaves, ``np.asarray`` each) plus the static
    fields as keywords. Dtypes are kept, so both packages compute on
    identical inputs."""
    tensors = {k: torch.from_numpy(np.array(v, copy=True))
               for k, v in arrays.items()}
    return Scene(**tensors, **statics)


class SceneBuilder:
    """Imperative scene construction: add textures/materials and get integer
    handles back, then add primitives referencing those handles. ``build()``
    freezes everything into a :class:`Scene` of tensors."""

    def __init__(self):
        self._sph_center: list = []
        self._sph_vel: list = []
        self._sph_radius: list = []
        self._sph_mat: list = []
        self._tri_v: list = []  # (v0, v1, v2)
        self._tri_mat: list = []
        self._mat: list = []  # (kind, tex, fuzz, ior, method)
        self._tex: list = []  # (kind, color3, scale, even, odd)

    # -- textures --

    def add_solid_texture(self, color) -> int:
        self._tex.append((TEX_SOLID, tuple(color), 1.0, 0, 0))
        return len(self._tex) - 1

    def add_checker_texture(self, scale: float, even: int, odd: int) -> int:
        """3-D spatial checker selecting child handles by floor-parity."""
        self._tex.append((TEX_CHECKER, (0.0, 0.0, 0.0), float(scale), even, odd))
        return len(self._tex) - 1

    # -- materials --

    def _coerce_texture(self, texture, color) -> int:
        if texture is None:
            if color is None:
                raise ValueError("provide texture handle or color")
            return self.add_solid_texture(color)
        return int(texture)

    def add_diffuse(self, texture: Optional[int] = None, color=None,
                    method: int = DIFFUSE_HEMISPHERE) -> int:
        tex = self._coerce_texture(texture, color)
        self._mat.append((MAT_DIFFUSE, tex, 0.0, 1.0, method))
        return len(self._mat) - 1

    def add_metallic(self, texture: Optional[int] = None, color=None,
                     fuzz: float = 0.0) -> int:
        tex = self._coerce_texture(texture, color)
        self._mat.append((MAT_METALLIC, tex, float(fuzz), 1.0, 0))
        return len(self._mat) - 1

    def add_dielectric(self, refractive_index: float = 1.0,
                       share: bool = True) -> int:
        """Dielectric material. With ``share=True`` dielectrics of equal IOR
        are deduplicated to one material (renders are identical; the scene's
        dielectric count stays structurally small)."""
        entry = (MAT_DIELECTRIC, 0, 0.0, float(refractive_index), 0)
        if share:
            for i, m in enumerate(self._mat):
                if m == entry:
                    return i
        self._mat.append(entry)
        return len(self._mat) - 1

    # -- primitives --

    def add_sphere(self, center, radius: float, material: int,
                   velocity=None) -> int:
        self._sph_center.append(tuple(center))
        self._sph_vel.append((0.0, 0.0, 0.0) if velocity is None else tuple(velocity))
        self._sph_radius.append(float(radius))
        self._sph_mat.append(int(material))
        return len(self._sph_radius) - 1

    def add_triangle(self, v0, v1, v2, material: int) -> int:
        self._tri_v.append((tuple(v0), tuple(v1), tuple(v2)))
        self._tri_mat.append(int(material))
        return len(self._tri_mat) - 1

    def add_quad(self, corner, edge_u, edge_v, material: int) -> None:
        """Parallelogram as two triangles."""
        c = np.asarray(corner, dtype=np.float64)
        u = np.asarray(edge_u, dtype=np.float64)
        v = np.asarray(edge_v, dtype=np.float64)
        self.add_triangle(c, c + u, c + v, material)
        self.add_triangle(c + u, c + u + v, c + v, material)

    def add_mesh(self, vertices, faces, material: int) -> None:
        """Triangle soup from [V,3] vertices and [F,3] integer faces."""
        vertices = np.asarray(vertices, dtype=np.float64)
        for f in np.asarray(faces, dtype=np.int64):
            self.add_triangle(vertices[f[0]], vertices[f[1]], vertices[f[2]], material)

    # -- freeze --

    def build(self, dtype=torch.float32, pad_multiple: int = 8,
              device="cuda") -> Scene:
        """Freeze into a :class:`Scene` on ``device`` (the card unless
        ``device="cpu"``; see :func:`resolve_device`)."""
        device = resolve_device(device)
        ns = len(self._sph_radius)
        nt = len(self._tri_mat)
        npad = max(_round_up(max(ns, 1), pad_multiple), pad_multiple)
        mpad = max(_round_up(nt, pad_multiple), pad_multiple) if nt else 0

        def tensor(a, dt):
            return torch.from_numpy(a).to(device=device, dtype=dt)

        def farr(data, shape, fill=0.0):
            a = np.full(shape, fill, dtype=np.float64)
            if len(data):
                a[: len(data)] = np.asarray(data, dtype=np.float64)
            return tensor(a, dtype)

        def iarr(data, n, fill=0):
            a = np.full((n,), fill, dtype=np.int32)
            if len(data):
                a[: len(data)] = np.asarray(data, dtype=np.int32)
            return tensor(a, torch.int32)

        def mask(n_real, n_total):
            m = np.zeros((n_total,), dtype=bool)
            m[:n_real] = True
            return tensor(m, torch.bool)

        if not self._mat:
            self._mat.append((MAT_DIFFUSE, 0, 0.0, 1.0, DIFFUSE_HEMISPHERE))
        if not self._tex:
            self._tex.append((TEX_SOLID, (0.5, 0.5, 0.5), 1.0, 0, 0))

        mk, mt, mf, mi, mm = zip(*self._mat)
        tk, tc, tsc, te, to = zip(*self._tex)

        vel = np.asarray(self._sph_vel, dtype=np.float64) if ns else np.zeros((0, 3))
        has_motion = bool(ns and np.any(vel != 0.0))

        tri_v = np.asarray(self._tri_v, dtype=np.float64) if nt else np.zeros((0, 3, 3))

        def uniq(indices):
            indices = list(indices)
            if not indices:
                return -1
            return indices[0] if len(indices) == 1 else -2

        uniq_checker = uniq(i for i, t in enumerate(tk) if t == TEX_CHECKER)
        uniq_diel = uniq(i for i, k in enumerate(mk) if k == MAT_DIELECTRIC)
        deep_checker = any(
            t == TEX_CHECKER and (tk[te[i]] == TEX_CHECKER
                                  or tk[to[i]] == TEX_CHECKER)
            for i, t in enumerate(tk))

        depth_memo = {}

        def _tex_depth(i):
            if i not in depth_memo:
                depth_memo[i] = 1 if tk[i] != TEX_CHECKER else 1 + max(
                    _tex_depth(te[i]), _tex_depth(to[i]))
            return depth_memo[i]

        tex_depth = max((_tex_depth(i) for i in range(len(tk))), default=1)

        def ints(v):
            return tensor(np.asarray(v, dtype=np.int32), torch.int32)

        def floats(v):
            return tensor(np.asarray(v, dtype=np.float64), dtype)

        return Scene(
            sphere_center=farr(self._sph_center, (npad, 3)),
            sphere_velocity=farr(self._sph_vel, (npad, 3)),
            sphere_radius=farr(self._sph_radius, (npad,)),
            sphere_material=iarr(self._sph_mat, npad),
            sphere_valid=mask(ns, npad),
            tri_v0=farr(tri_v[:, 0] if nt else [], (mpad, 3)),
            tri_v1=farr(tri_v[:, 1] if nt else [], (mpad, 3)),
            tri_v2=farr(tri_v[:, 2] if nt else [], (mpad, 3)),
            tri_material=iarr(self._tri_mat, mpad),
            tri_valid=mask(nt, mpad),
            mat_kind=ints(mk),
            mat_texture=ints(mt),
            mat_fuzz=floats(mf),
            mat_ior=floats(mi),
            mat_method=ints(mm),
            tex_kind=ints(tk),
            tex_color=floats(tc),
            tex_scale=floats(tsc),
            tex_even=ints(te),
            tex_odd=ints(to),
            n_spheres=ns,
            n_triangles=nt,
            has_motion=has_motion,
            uniq_checker_tex=uniq_checker,
            uniq_dielectric_mat=uniq_diel,
            deep_checker=deep_checker,
            tex_depth=tex_depth,
        )
