"""Thin-lens camera frame.

PyTorch counterpart of :mod:`rayz_tpu.models.camera`. The basis/viewport
precompute is done in float64 numpy on the host, term for term as in the JAX
package, and cast to the render dtype, so both packages hold identical
camera vectors. The kernels spawn their camera rays themselves (jitter,
defocus and time); :func:`generate_rays`, the dense integrator's batched
form, computes the same rays from the same draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .scene import resolve_device

__all__ = ["Camera", "make_camera", "camera_from_numpy", "generate_rays"]

_DEG_TO_RAD = math.pi / 180.0
_VECTORS = ("look_from", "px_du", "px_dv", "px_origin", "defocus_u",
            "defocus_v")


@dataclasses.dataclass(frozen=True)
class Camera:
    """Precomputed camera frame. All tensor fields are [3] of the render
    dtype; ``height``/``width`` are the image size."""

    look_from: torch.Tensor
    px_du: torch.Tensor
    px_dv: torch.Tensor
    px_origin: torch.Tensor
    defocus_u: torch.Tensor
    defocus_v: torch.Tensor
    height: int = 0
    width: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return self.look_from.dtype

    @property
    def device(self) -> torch.device:
        return self.look_from.device

    def to(self, device) -> "Camera":
        """A copy with every tensor field on ``device``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in _VECTORS})


def camera_from_numpy(arrays: dict, *, height: int, width: int) -> Camera:
    """Build a :class:`Camera` from numpy arrays keyed by field name (for
    example the JAX ``Camera``'s leaves)."""
    return Camera(**{k: torch.from_numpy(np.array(arrays[k], copy=True))
                     for k in _VECTORS}, height=int(height), width=int(width))


def make_camera(
    *,
    width: int,
    height: int | None = None,
    vfov: float = 20.0,
    focus_dist: float = 10.0,
    defocus_angle: float = 0.0,
    look_from=(13.0, 2.0, 3.0),
    look_at=(0.0, 0.0, 0.0),
    vup=(0.0, 1.0, 0.0),
    dtype=torch.float32,
    device="cuda",
) -> Camera:
    """Build the camera frame on ``device`` (the card unless
    ``device="cpu"``; see :func:`rayz_tpu_torch.models.scene.resolve_device`).
    ``height=None`` derives height from the reference's fixed 16:9 aspect
    (height = floor(width / (16/9)))."""
    device = resolve_device(device)
    if height is None:
        height = int(width / (16.0 / 9.0))

    look_from = np.asarray(look_from, dtype=np.float64)
    look_at = np.asarray(look_at, dtype=np.float64)
    vup = np.asarray(vup, dtype=np.float64)

    vp_height = 2.0 * math.tan(vfov * _DEG_TO_RAD / 2.0) * focus_dist
    vp_width = vp_height * float(width) / float(height)

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    vp_u = u * vp_width
    vp_v = v * (-vp_height)
    px_du = vp_u / float(width)
    px_dv = vp_v / float(height)
    # defocus radius: tan(angle/2) * focus_dist; angle <= 0 disables defocus,
    # encoded as zero vectors.
    defocus_radius = math.tan(defocus_angle * _DEG_TO_RAD / 2.0) * focus_dist
    if defocus_angle <= 0.0:
        defocus_radius = 0.0

    px_origin = (
        look_from - w * focus_dist - vp_u / 2.0 - vp_v / 2.0
        + (px_du + px_dv) * 0.5
    )

    def as_dt(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=dtype)

    return Camera(
        look_from=as_dt(look_from),
        px_du=as_dt(px_du),
        px_dv=as_dt(px_dv),
        px_origin=as_dt(px_origin),
        defocus_u=as_dt(u * defocus_radius),
        defocus_v=as_dt(v * defocus_radius),
        height=int(height),
        width=int(width),
    )


def generate_rays(camera: Camera, px_x, px_y, seed=None, sample: int = 0):
    """Batched Camera.getRay (camera.zig:59-77) for integer pixel
    coordinates ``px_x``/``px_y`` of any one shape [...]: returns (origins
    [..., 3], directions [..., 3], times [...]) in the camera's dtype.

    ``seed=None`` is the reference's deterministic path (no jitter, origin
    at look_from, time 0). With a seed, the ray is sample ``sample`` (from
    0) of that render as the megakernel spawns it: jitter, defocus disk and
    time from the draws keyed by (seed, pixel, sample), through
    :func:`rayz_tpu_torch.ops.common._camera_rays`. (The JAX function
    takes a ``jax.random`` key instead.)"""
    from ..ops.common import _camera_rays

    x = torch.as_tensor(px_x, device=camera.device)
    y = torch.as_tensor(px_y, device=camera.device)
    shape = torch.broadcast_shapes(x.shape, y.shape)
    pix = (y.long() * camera.width + x.long()).expand(shape).reshape(-1)
    o, d, tm = _camera_rays(camera, 0 if seed is None else int(seed),
                            pix.to(torch.int32), sample, seed is not None)
    return o.reshape(*shape, 3), d.reshape(*shape, 3), tm.reshape(shape)
