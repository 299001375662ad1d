"""One rank of the port's sharded paths, for tests/test_torch_parallel.py.

Joins a gloo process group on the CPU through
``rayz_tpu_torch.parallel.initialize`` (an explicit loopback coordinator),
makes the 1-D mesh, and runs on a small stochastic scene: the dense sharded
render, the megakernel's (its plain version), the image assembly on rank 0,
one mesh train step through each engine, and a checkpointed mesh fit that
is interrupted and resumed; then, on the deterministic fuzz-0 metal scene
of tests/test_multihost.py, the sharded render and one dense mesh step,
for the comparison with the JAX package. Rank 0 writes everything to
``<out>/world<N>.npz``. Imports the port only (torch, numpy,
rayz_tpu_torch), never JAX.

Usage: python torch_parallel_worker.py <rank> <world> <port> <out_dir>
"""

import os
import sys

import numpy as np
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.ops import megakernel as mk
from rayz_tpu_torch.parallel import (assemble_global_image, initialize,
                                     is_primary_host, make_mesh,
                                     render_sharded)
from rayz_tpu_torch.parallel.mesh import shard_range

FIELDS = ("sphere_center", "sphere_radius", "tex_color")
ENGINES = ("dense", "recorded-pp", "recorded")


def small_scene():
    """Ground, a diffuse (UNIT_SPHERE) ball, a fuzzy metal ball, a glass
    ball and a triangle; 17x11 pixels, a count that neither 2 nor 3
    divides."""
    b = rtt.SceneBuilder()
    m = rtt.models.DIFFUSE_UNIT_SPHERE
    b.add_sphere((0, -100.5, -1), 100.0,
                 b.add_diffuse(color=(0.5, 0.5, 0.5), method=m))
    b.add_sphere((0, 0, -1.2), 0.5, b.add_diffuse(color=(0.7, 0.3, 0.2),
                                                  method=m))
    b.add_sphere((-1.0, 0, -1.3), 0.45, b.add_metallic(color=(0.8, 0.8, 0.9),
                                                       fuzz=0.2))
    b.add_sphere((1.0, 0, -1.3), 0.45, b.add_dielectric(1.5))
    b.add_triangle((-0.4, -0.3, -0.9), (0.3, -0.3, -1.0), (0.0, 0.4, -1.1),
                   b.add_diffuse(color=(0.2, 0.8, 0.3), method=m))
    cam = rtt.make_camera(width=17, height=11, vfov=70.0, focus_dist=1.0,
                          look_from=(0, 0.1, 0.4), look_at=(0, 0, -1),
                          device="cpu")
    return b.build(device="cpu"), cam


CONFIG = rtt.RenderConfig(spp=2, max_depth=4)


def metal_scene():
    """tests/test_multihost.py's scene: fuzz-0 metals, jitter off."""
    b = rtt.SceneBuilder()
    m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    cam = rtt.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          device="cpu")
    return b.build(device="cpu"), cam


METAL_CONFIG = rtt.RenderConfig(spp=1, max_depth=4, jitter=False)


def leaves(scene, fields):
    return {f: getattr(scene, f).detach().clone().requires_grad_(True)
            for f in fields}


def mesh_step(mesh, scene, cam, target, cfg, engine, fields):
    """One mesh step; returns (loss, leftover, the all-reduced gradients
    the optimizer was given)."""
    params = leaves(scene, fields)
    opt = torch.optim.SGD(list(params.values()), lr=0.0)
    step = rtt.make_train_step(opt, cfg, mesh, engine=engine,
                               with_leftover=True)
    _, loss, left = step(params, scene, cam, 7, target)
    return (float(loss), int(left),
            {k: p.grad.numpy().copy() for k, p in params.items()})


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
               device="cpu")
    mesh = make_mesh("cpu")
    assert mesh.size() == world and mesh.get_local_rank() == rank
    out = {}

    scene, cam = small_scene()
    n = cam.height * cam.width
    out["dense"] = render_sharded(scene, cam, 3, CONFIG, mesh).numpy()
    out["megakernel"] = mk.render_megakernel_sharded(scene, cam, 3, CONFIG,
                                                     mesh).numpy()
    out["megakernel_culled"] = mk.render_megakernel_sharded(
        scene, cam, 3, CONFIG, mesh, culling=True).numpy()
    p0, p1 = shard_range(n, mesh)
    rows = rtt.ops.render_pixels(scene, cam, 3,
                                 torch.arange(p0, p1, dtype=torch.int32),
                                 CONFIG)
    full = assemble_global_image(rows)
    assert (full is None) == (rank != 0), (rank, full is None)
    if full is not None:
        out["assembled"] = full

    target = torch.full((cam.height, cam.width, 3), 0.3)
    for engine in ENGINES:
        loss, left, grads = mesh_step(mesh, scene, cam, target, CONFIG,
                                      engine, FIELDS)
        out[f"loss_{engine}"] = loss
        out[f"left_{engine}"] = left
        for k, g in grads.items():
            out[f"grad_{engine}_{k}"] = g

    # a checkpointed fit interrupted after 2 of 3 steps and resumed, against
    # the uninterrupted one; rank 0 writes, every rank reads
    ckpt = os.path.join(out_dir, f"ckpt{world}")
    kw = dict(config=CONFIG, learning_rate=5e-2, fields=("tex_color",),
              mesh=mesh, seed=1)
    ref, hist_ref = rtt.fit(scene, cam, target, steps=3, **kw)
    _, hist_a = rtt.fit(scene, cam, target, steps=2, checkpoint_dir=ckpt,
                        checkpoint_every=1, **kw)
    res, hist_b = rtt.fit(scene, cam, target, steps=3, checkpoint_dir=ckpt,
                          checkpoint_every=1, **kw)
    out["hist_ref"] = np.asarray(hist_ref)
    out["hist_resumed"] = np.asarray(hist_a + hist_b)
    out["fit_equal"] = bool(torch.equal(res.tex_color, ref.tex_color))

    mscene, mcam = metal_scene()
    out["metal_img"] = render_sharded(mscene, mcam, 0, METAL_CONFIG,
                                      mesh).numpy()
    loss, _, grads = mesh_step(mesh, mscene, mcam,
                               torch.zeros((16, 16, 3)), METAL_CONFIG,
                               "dense", ("tex_color", "sphere_center"))
    out["metal_loss"] = loss
    for k, g in grads.items():
        out[f"metal_grad_{k}"] = g

    if is_primary_host():
        np.savez(os.path.join(out_dir, f"world{world}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
