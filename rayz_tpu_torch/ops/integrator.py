"""The dense path-tracing integrator, and the render settings shared by
the engines.

PyTorch counterpart of :mod:`rayz_tpu.ops.integrator`: every ray tests
every primitive each bounce (:func:`rayz_tpu_torch.ops.intersect.intersect`)
and scatters (:func:`rayz_tpu_torch.ops.shade.scatter`), a loop over the
bounce depth carrying the per-ray state. Plain torch on whatever device the
scene lives on (the JAX package computes it in XLA, outside any Pallas
kernel); autograd through it is the ``"dense"`` training engine, and in
float64 it is the package's own oracle. It renders every scene, nested
checker textures and scenes of any size included.

Random draws are the megakernel's, keyed by (seed, pixel, sample, bounce,
draw number) (:mod:`rayz_tpu_torch.ops.rng`): each sample's camera ray
from ``common._camera_rays`` and each bounce's scatter numbers from
``common._make_rand``. So for one seed :func:`render` traces the
megakernel's paths, apart from near ties where their arithmetic rounds
differently, and matches JAX's ``render`` in distribution.

Semantics (renderer.zig:103-126): a ray that exhausts the depth is black;
an absorbed ray (metal below the horizon) is black; a miss adds the sky
weighted by the throughput and ends the ray; a scatter multiplies the
throughput by the attenuation and moves the origin to the hit point,
keeping the time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.camera import Camera
from ..models.scene import Scene
from .common import _camera_rays, _make_rand
from .intersect import intersect
from .shade import scatter, sky_color

__all__ = ["RenderConfig", "trace_rays", "render", "render_jit",
           "render_pixels"]


class RenderConfig(NamedTuple):
    """Static render settings, the JAX fields in the JAX order. Defaults
    mirror the reference Tracer fields (max_bounces=50,
    samples_per_px=10). The reference's t_min is 1e-10 in f64; in f32 that
    invites shadow acne, so the default is 1e-3.

    ``chunk_size`` and ``remat`` act on the dense integrator only:
    ``chunk_size`` rays per chunk (None: every pixel at once) bounds its
    [chunk, primitives] intermediates; ``remat`` recomputes each bounce,
    and each (sample pass, chunk), in the backward instead of keeping
    their states (no effect on a forward-only render)."""

    spp: int = 10
    max_depth: int = 50
    t_min: float = 1e-3
    chunk_size: Optional[int] = None
    jitter: bool = True
    remat: bool = True


def _bounce(scene: Scene, t_min: float, o, d, tm, thr, rad, act, draws):
    """One bounce of every ray (the scan body of integrator.py:80-94):
    returns the new (origin, direction, throughput, radiance, active)."""
    hit = intersect(scene, o, d, tm, t_min)
    # a miss adds the sky weighted by the throughput; the ray ends
    miss_now = act & ~hit.hit
    rad = rad + torch.where(miss_now[..., None], thr * sky_color(d), 0.0)
    new_dir, att, scattered = scatter(scene, d, hit, draws.unbind(0))
    cont = act & hit.hit & scattered
    c3 = cont[..., None]
    return (torch.where(c3, hit.point, o), torch.where(c3, new_dir, d),
            torch.where(c3, thr * att, thr), rad, cont)


def trace_rays(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
               time: torch.Tensor, rand: torch.Tensor, *, max_depth: int,
               t_min: float, remat: bool = True) -> torch.Tensor:
    """Trace rays [R] to radiance [R, 3]: the batched bounceRay. ``rand``
    holds each bounce's scatter draws, [max_depth, 5, R] (a unit vector,
    the ball radius u^(1/3) and the Schlick uniform; ``_make_rand`` gives
    the megakernel's). ``remat`` runs each bounce under
    ``torch.utils.checkpoint``: the backward keeps only the O(R) ray state
    per bounce and recomputes the bounce."""
    thr = torch.ones_like(origin)
    rad = torch.zeros_like(origin)
    act = torch.ones(time.shape, dtype=torch.bool, device=origin.device)
    o, d = origin, direction
    for b in range(max_depth):
        args = (o, d, time, thr, rad, act, rand[b])
        if remat and torch.is_grad_enabled():
            o, d, thr, rad, act = checkpoint(
                _bounce, scene, t_min, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            o, d, thr, rad, act = _bounce(scene, t_min, *args)
    return rad


def render_pixels(scene: Scene, camera: Camera, seed: int,
                  pix: torch.Tensor,
                  config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Render the flat pixel ids ``pix`` (an integer tensor [n], ids
    ``y * W + x`` of the full image) to radiance [n, 3], averaged over
    ``config.spp``: the pixel-subset render that :func:`render` runs over
    every pixel and a pixel shard of
    :func:`rayz_tpu_torch.parallel.render_sharded` over its own.

    The rays are the (sample, pixel) items over ``pix`` in sample-major
    order, traced in chunks of ``config.chunk_size`` (None: one sample pass
    of ``pix`` at a time, as in JAX; a larger chunk takes several passes at
    once), each chunk's camera rays and bounce draws made from its items'
    keys, which hold the global pixel id. So a pixel's radiance does not
    depend on which other pixels are rendered with it, and any subset
    equals the matching rows of :func:`render` bit for bit.

    Each chunk's radiance is added into one [n, 3] accumulator as soon as
    it is traced, in pass order (a chunk that spans a pass boundary is
    split there): memory holds the accumulator and one chunk whatever the
    spp, and the sum is the one pass after another gives. The additions
    save no inputs, so under autograd with ``config.remat`` each chunk is
    checkpointed and the backward keeps only the accumulator and the
    chunks' ranges, tracing each chunk again (its rays and draws are
    counter-keyed and come out the same). The radiance has the camera's
    dtype; the scene, the camera and ``pix`` share a device."""
    if camera.device != scene.device:
        raise ValueError(f"camera is on {camera.device}, scene on "
                         f"{scene.device}")
    if pix.dim() != 1 or pix.dtype.is_floating_point:
        raise ValueError(f"pix must be a 1-D integer tensor, got "
                         f"{pix.dtype} {tuple(pix.shape)}")
    pix = pix.to(device=camera.device, dtype=torch.int32)
    n = pix.shape[0]
    items = n * config.spp
    if items == 0:
        return torch.zeros((n, 3), dtype=camera.dtype, device=camera.device)
    chunk = min(config.chunk_size or n, items)

    def trace_chunk(i0: int, i1: int):
        item = torch.arange(i0, i1, dtype=torch.int64, device=camera.device)
        p = pix[item % n]
        sample = item // n
        o, d, tm = _camera_rays(camera, seed, p, sample, config.jitter)
        rand = _make_rand(seed, p, sample, config.max_depth).to(o.dtype)
        return trace_rays(scene, o, d, tm, rand, max_depth=config.max_depth,
                          t_min=config.t_min, remat=config.remat)

    acc = None
    for i0 in range(0, items, chunk):
        i1 = min(i0 + chunk, items)
        if config.remat and torch.is_grad_enabled():
            rad = checkpoint(trace_chunk, i0, i1, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            rad = trace_chunk(i0, i1)
        if acc is None:
            acc = rad.new_empty((n, 3))
        j = i0
        while j < i1:  # the chunk's piece of each pass it spans
            s, a = divmod(j, n)
            e = min(i1, (s + 1) * n)
            piece = rad[j - i0:e - i0]
            if s == 0:
                acc[a:a + e - j] = piece
            else:
                acc[a:a + e - j] += piece
            j = e
    return acc.to(camera.dtype) / config.spp


def render(scene: Scene, camera: Camera, seed: int,
           config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Full render to a [H, W, 3] linear-RGB image (integrator.py:103),
    differentiable in the scene's float tensors: :func:`render_pixels`
    over every pixel. The passes' radiance is summed in pass order and
    divided by ``spp``, so the image does not depend on the chunking
    (``config.chunk_size``) or on ``config.remat``, and memory does not
    grow with the spp. The image has the camera's dtype; the scene and
    the camera must share a device."""
    if camera.device != scene.device:
        raise ValueError(f"camera is on {camera.device}, scene on "
                         f"{scene.device}")
    h, w = camera.height, camera.width
    pix = torch.arange(h * w, dtype=torch.int32, device=camera.device)
    return render_pixels(scene, camera, seed, pix, config).reshape(h, w, 3)


def render_jit(scene: Scene, camera: Camera, seed: int,
               config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """:func:`render` under the JAX package's name (integrator.py:153):
    PyTorch runs eagerly, so there is nothing to compile."""
    return render(scene, camera, seed, config)


def _pixel_grid(camera):
    """Flat int32 pixel coordinates [H*W] in the reference's layout
    (integrator.py:95): x = column i, y = row j, index j*W + i."""
    xs = torch.arange(camera.width, dtype=torch.int32, device=camera.device)
    ys = torch.arange(camera.height, dtype=torch.int32, device=camera.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    return gx.reshape(-1), gy.reshape(-1)
