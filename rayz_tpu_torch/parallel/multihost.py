"""Joining a multi-process job, and putting the image together on rank 0.

PyTorch counterpart of :mod:`rayz_tpu.parallel.multihost`. One process
runs per device (``torchrun --nproc-per-node N``, or any launcher that sets
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``/``LOCAL_RANK``):
:func:`initialize` joins them into the default process group, the global
1-D mesh spans every rank, the same
:func:`~rayz_tpu_torch.parallel.render_sharded` and mesh train step run on
each, and :func:`assemble_global_image` gives the whole image to rank 0
for writing.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import CUDA_BACKEND, make_mesh

__all__ = ["initialize", "is_primary_host", "global_mesh",
           "assemble_global_image", "rank_device"]

# torchrun's environment, which the no-argument form reads
_LAUNCHER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def rank_device(kind: Optional[str] = None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` (so ranks
    beyond the host's cards share them), or the CPU. ``kind`` ``"cuda"`` or
    ``"cpu"``; default the card when torch sees one."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank device was asked for, but torch sees "
                           "no CUDA device")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               device: Optional[str] = None) -> None:
    """Join the job's default process group; call it first on every rank.

    With no arguments it reads the launcher's environment (``torchrun``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); where
    there is none, the process runs alone, JAX's "no cluster" case, and
    the group is left unmade. Explicit ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` join through
    ``tcp://host:port``, and their errors are raised, never swallowed. A
    second call, or a call after the launcher made the group, does
    nothing.

    The backend is NCCL when the rank's device (``device``: ``"cuda"`` or
    ``"cpu"``, default the card when torch sees one) is CUDA, with gloo
    beside it for host tensors (``"cpu:gloo,cuda:nccl"``: the image
    assembly gathers on the host), and gloo otherwise; ``backend=``
    overrides it (two ranks that share one card need ``"gloo"``: NCCL
    takes one rank per device). On the card the rank's device
    (:func:`rank_device`) is made current."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None
    if not explicit and not all(k in os.environ for k in _LAUNCHER_ENV):
        return  # no cluster: a single process
    dev = rank_device(device)
    if backend is None:
        backend = CUDA_BACKEND if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend)
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(**kw)


def is_primary_host() -> bool:
    """True on rank 0, and in a process that joined no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(device_type: Optional[str] = None):
    """The 1-D mesh over every rank of the job (:func:`make_mesh`)."""
    return make_mesh(device_type)


def assemble_global_image(img: torch.Tensor) -> Optional[np.ndarray]:
    """Every rank's rows of the image, put together in rank order on rank
    0 as one numpy array; ``None`` on the other ranks (JAX's contract).
    ``img`` is this rank's part along the first axis: the pixels it owns
    ([p1 - p0, 3], see :func:`~rayz_tpu_torch.parallel.mesh.shard_range`),
    which JAX's ``process_allgather(tiled=True)`` concatenates the same
    way. The rows go to the host before the gather: the result is a host
    array, and gloo gathers host tensors only. Alone (no group, or a world
    of one) it returns ``img`` itself. :func:`render_sharded` gives every
    rank the whole image already; its rank 0 writes its own copy."""
    host = img.detach().cpu()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return host.numpy()
    rank = dist.get_rank()
    parts = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(host, parts, dst=0)
    if rank != 0:
        return None
    return torch.cat(parts).numpy()
