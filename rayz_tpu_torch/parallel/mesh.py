"""Pixel-sharded rendering over a 1-D device mesh.

PyTorch counterpart of :mod:`rayz_tpu.parallel.mesh`. Rendering is
embarrassingly parallel over pixels: the flat pixel array [H*W] is split
over the ranks of a 1-D ``torch.distributed`` device mesh, every rank holds
the whole scene, traces its own pixels with no communication, and the image
is put together by one all-gather in shard order. Gradients of scene
parameters are all-reduced by the mesh path of
:func:`rayz_tpu_torch.diff.make_train_step`, which deals the pixels
round-robin instead (its reasons are there).

The mesh is PyTorch's own :class:`~torch.distributed.device_mesh.DeviceMesh`
with one dimension named :data:`AXIS`: ``"cuda"`` on the card (NCCL), or
``"cpu"`` over gloo. One process per device, started by ``torchrun`` (or
any launcher) and joined by :func:`rayz_tpu_torch.parallel.initialize`.

Shard ``s`` of ``D`` owns the pixels [s*ceil(n/D), min((s+1)*ceil(n/D), n)):
the last shard is short (or empty) instead of padded, since a rank renders
any subset of pixels (:func:`rayz_tpu_torch.ops.integrator.render_pixels`).
Draws are keyed by (seed, global pixel id, sample, bounce), so a sharded
render equals the single-device image bit for bit, whatever ``D`` is (JAX
folds the key with the device index instead, so its shards draw other
numbers than one device would).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.integrator import RenderConfig, render_pixels

__all__ = ["make_mesh", "render_sharded", "render_sharded_jit", "AXIS"]

AXIS = "devices"

#: The backend of ranks on cards: NCCL for CUDA tensors, gloo beside it for
#: host tensors (the image assembly gathers on the host).
CUDA_BACKEND = "cpu:gloo,cuda:nccl"


def make_mesh(device_type: Optional[str] = None,
              axis_name: str = AXIS) -> DeviceMesh:
    """1-D mesh over every rank of the default process group, one device
    each (``device_type`` ``"cuda"`` or ``"cpu"``; default ``"cuda"`` when
    torch sees a card). A flat axis is the right shape: no pixel talks to
    another, so there is nothing for a second axis to keep local.

    A process that joined no group (no launcher, no
    :func:`~rayz_tpu_torch.parallel.initialize`) gets a world of one, its
    store in memory: NCCL for ``"cuda"`` (gloo beside it for host
    tensors), gloo for ``"cpu"``."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        dist.init_process_group(
            CUDA_BACKEND if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    if device_type == "cuda":
        # the rank's card is chosen before the mesh is made (initialize
        # selects it); DeviceMesh then leaves the choice alone
        torch.cuda.init()
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def shard_range(n: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """The pixels [p0, p1) of the flat [n] array that this rank owns."""
    d = mesh.size()
    per = -(-n // d)
    p0 = min(mesh.get_local_rank() * per, n)
    return p0, min(p0 + per, n)


def gather_shards(local: torch.Tensor, n: int,
                  mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's rows [p1 - p0, ...] of a flat [n, ...] array, put
    together in shard order on every rank (on ``local``'s device). Each
    rank sends ceil(n/D) rows, its own zero-padded; the pads are dropped.
    Gloo gathers tensors in host memory only, so over gloo the rows go
    through the host (two ranks sharing one card use gloo: NCCL takes one
    rank per device)."""
    group = mesh.get_group()
    d = mesh.size()
    per = -(-n // d)
    send = local.new_zeros((per, *local.shape[1:]))
    send[:local.shape[0]] = local
    if dist.get_backend(group) == "gloo":
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(d)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts)[:n].to(local.device)


def _render_shard(scene: Scene, camera: Camera, seed: int, p0: int, p1: int,
                  config: RenderConfig) -> torch.Tensor:
    """One rank's body: the spp-averaged radiance [p1 - p0, 3] of the
    global pixels [p0, p1) through the dense integrator."""
    pix = torch.arange(p0, p1, dtype=torch.int32, device=camera.device)
    return render_pixels(scene, camera, seed, pix, config)


def render_sharded(scene: Scene, camera: Camera, seed: int,
                   config: RenderConfig, mesh: DeviceMesh) -> torch.Tensor:
    """Render with the pixels sharded over ``mesh``; returns the full
    [H, W, 3] image on every rank. Each rank renders its pixels through the
    dense integrator (:func:`_render_shard`), then the shards are gathered
    in order (:func:`gather_shards`). Call it on every rank of the mesh."""
    h, w = camera.height, camera.width
    p0, p1 = shard_range(h * w, mesh)
    with torch.no_grad():
        local = _render_shard(scene, camera, seed, p0, p1, config)
    return gather_shards(local, h * w, mesh).reshape(h, w, 3)


def render_sharded_jit(scene: Scene, camera: Camera, seed: int,
                       config: RenderConfig,
                       mesh: DeviceMesh) -> torch.Tensor:
    """:func:`render_sharded` under the JAX package's name: PyTorch runs
    eagerly, so there is nothing to compile."""
    return render_sharded(scene, camera, seed, config, mesh)
