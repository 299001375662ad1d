"""Entry points of the port, the twins of the repository's
``__graft_entry__.py`` (which drives the JAX package).

``entry()``              the forward render step on the flagship scene
                         (``random_bouncing``), its function and arguments.
``dryrun_multichip(n)``  a pixel-sharded render and a data-parallel train
                         step (render, pixel L2 gradient, all-reduce, Adam)
                         over ``n`` processes joined by gloo, at 16x16.

Both run on the card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import math
import socket
from typing import Optional

import torch


def _device(device: Optional[str]) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return device


def entry(device: Optional[str] = None):
    """``(forward, (scene, camera, seed))``: ``forward`` renders the
    flagship scene at 128 wide, 2 spp, depth 8 through the dense
    integrator, as ``__graft_entry__.entry`` does with JAX's."""
    import rayz_tpu_torch as rtt

    scene, camera = rtt.scenes.random_bouncing(width=128,
                                               device=_device(device))
    config = rtt.RenderConfig(spp=2, max_depth=8)

    def forward(scene, camera, seed):
        return rtt.render(scene, camera, seed, config)

    return forward, (scene, camera, 0)


def _dryrun_rank(rank: int, n: int, port: int, device: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    import rayz_tpu_torch as rtt
    from rayz_tpu_torch.parallel import (initialize, make_mesh,
                                         render_sharded)

    initialize(f"127.0.0.1:{port}", n, rank, backend="gloo", device=device)
    try:
        mesh = make_mesh(device)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device("cpu"))
        scene, camera = rtt.scenes.two_sphere(width=16, height=16,
                                              device=dev)
        config = rtt.RenderConfig(spp=1, max_depth=3)
        img = render_sharded(scene, camera, 0, config, mesh)
        if img.shape != (16, 16, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"rank {rank}: sharded render "
                                 f"{tuple(img.shape)} not finite")
        target = torch.zeros((16, 16, 3), dtype=camera.dtype, device=dev)
        for engine in ("dense", "recorded-pp"):
            params = rtt.extract_params(scene)
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in params.items()}
            opt = torch.optim.Adam(list(params.values()), lr=1e-2)
            step = rtt.make_train_step(opt, config, mesh, engine=engine)
            _, loss = step(params, scene, camera, 0, target)
            if not math.isfinite(float(loss)):
                raise AssertionError(f"rank {rank}: {engine} step loss "
                                     f"{float(loss)}")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """Spawn ``n_devices`` processes joined over gloo (two or more may
    share one card); each renders its pixel shard of a 16x16 image and
    takes one mesh train step through ``"dense"`` and one through
    ``"recorded-pp"``. Raises if any rank fails or a loss is not
    finite."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dryrun_rank, args=(n_devices, port,
                                           _device(device)),
                       nprocs=n_devices, join=True, start_method="spawn")
