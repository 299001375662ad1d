"""The port's pixel-sharded paths (rayz_tpu_torch/parallel, the megakernel's
pixel offset, render_megakernel_sharded, the mesh train step) on the CPU.

Real gloo process groups: tests/torch_parallel_worker.py runs as 2 and as 3
processes (17x11 = 187 pixels, which neither divides, so the last shard is
short), importing the port only. Against them:

* the sharded renders (dense, and the megakernel's plain version, resident
  and culled) and the image assembled on rank 0 equal the single-device
  image bit for bit: draws are keyed by the global pixel id;
* each engine's mesh step ("dense", "recorded-pp" with leftover 0,
  "recorded") gives the single-device pixel_loss and its gradients within
  rtol 1e-5: the loss relative to itself, each gradient field relative to
  its largest entry (the shards sum their pixels in another order);
* a checkpointed mesh fit, interrupted and resumed, reproduces the
  uninterrupted loss history bit for bit;
* against the JAX package on its deterministic fuzz-0 metal scene (jitter
  off, tests/test_multihost.py's), with JAX on conftest's 8-device CPU
  mesh: the sharded image within tests/test_torch_dense.py's float32
  bound (5e-5, and 1e-5 on all but 0.1% of channels), one dense mesh
  step's loss within 1e-5 relative of JAX's mesh step and its gradients
  within 1e-4 of each field's largest entry of ``jax.grad`` of JAX's
  single-device pixel_loss (tests/test_torch_inverse.py's tolerances).
  JAX's dense mesh step itself returns the device count times those
  gradients (its shard_map already sums the gradient of a replicated
  input over the devices, then psums it again; Adam, its tests' optimizer,
  is blind to the scale); the test states that too, as a witness.

In this process: the offset queue's plain version, render_pixels' world of
one, initialize's cases (mirroring tests/test_multihost.py:31-68) and the
port's dryrun_multichip.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.diff import extract_params as jextract
from rayz_tpu.diff import make_train_step as jmake_train_step
from rayz_tpu.diff import pixel_loss as jpixel_loss
from rayz_tpu.parallel import make_mesh as jmake_mesh
from rayz_tpu.parallel import render_sharded_jit as jrender_sharded_jit
from rayz_tpu_torch import entry, parallel
from rayz_tpu_torch.ops import megakernel as mk, tables
from rayz_tpu_torch.parallel import multihost

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' workers, started together; rank 0's results by world."""
    out = tmp_path_factory.mktemp("parallel")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "torch_parallel_worker.py"),
             str(rank), str(world), str(port), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
        assert "WORKER_OK" in log
    return {w: dict(np.load(out / f"world{w}.npz")) for w in WORLDS}


@pytest.fixture(scope="module")
def small():
    scene, cam = worker.small_scene()
    return scene, cam, torch.full((cam.height, cam.width, 3), 0.3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_renders_equal_single_device(runs, small, world):
    scene, cam, _ = small
    got = runs[world]
    dense = rtt.render(scene, cam, 3, worker.CONFIG).numpy()
    np.testing.assert_array_equal(got["dense"], dense)
    np.testing.assert_array_equal(
        got["megakernel"],
        rtt.render_megakernel(scene, cam, 3, worker.CONFIG).numpy())
    np.testing.assert_array_equal(
        got["megakernel_culled"],
        rtt.render_megakernel(scene, cam, 3, worker.CONFIG,
                              culling=True).numpy())
    # rank 0 assembled every rank's rows (the worker asserts None elsewhere)
    np.testing.assert_array_equal(got["assembled"].reshape(dense.shape),
                                  dense)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", worker.ENGINES)
def test_mesh_step_matches_pixel_loss(runs, small, world, engine):
    scene, cam, target = small
    got = runs[world]
    params = worker.leaves(scene, worker.FIELDS)
    loss = rtt.pixel_loss(params, scene, cam, 7, target, worker.CONFIG,
                          engine)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(float(got[f"loss_{engine}"]) - loss.item()) <= \
        1e-5 * abs(loss.item())
    assert int(got[f"left_{engine}"]) == 0
    for k, g in zip(worker.FIELDS, grads):
        assert float(g.abs().max()) > 0
        assert _rel(got[f"grad_{engine}_{k}"], g.numpy()) <= 1e-5, k


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_fit_resumes_bit_for_bit(runs, world):
    got = runs[world]
    assert len(got["hist_ref"]) == 3
    np.testing.assert_array_equal(got["hist_resumed"], got["hist_ref"])
    assert bool(got["fit_equal"])


@pytest.fixture(scope="module")
def jax_metal():
    """JAX's sharded render and one dense mesh step of the metal scene on
    the 8-device CPU mesh (the step's gradients read from an optax
    transformation that keeps them as its state), and jax.grad of the
    single-device pixel_loss."""
    b = rt.SceneBuilder()
    m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    scene = b.build(dtype=jnp.float32)
    cam = rt.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1),
                         dtype=jnp.float32)
    cfg = rt.RenderConfig(spp=1, max_depth=4, jitter=False)
    mesh = jmake_mesh()
    img = np.asarray(jrender_sharded_jit(scene, cam, jax.random.PRNGKey(0),
                                         cfg, mesh))
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    params = jextract(scene, ("tex_color", "sphere_center"))
    target = jnp.zeros((16, 16, 3), jnp.float32)
    step = jmake_train_step(keep, cfg, mesh, engine="dense")
    _, mesh_grads, loss = step(params, keep.init(params), scene, cam,
                               jax.random.PRNGKey(1), target)
    grads = jax.grad(jpixel_loss)(params, scene, cam, jax.random.PRNGKey(1),
                                  target, cfg, "dense")
    return (img, float(loss), {k: np.asarray(v) for k, v in grads.items()},
            {k: np.asarray(v) / mesh.size for k, v in mesh_grads.items()})


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax(runs, jax_metal, world):
    img, loss, grads, mesh_grads = jax_metal
    got = runs[world]
    d = np.abs(got["metal_img"] - img)
    assert d.max() <= 5e-5 and (d > 1e-5).mean() < 1e-3
    assert abs(float(got["metal_loss"]) - loss) <= 1e-5 * abs(loss)
    for k, g in grads.items():
        assert np.abs(g).max() > 0
        assert _rel(got[f"metal_grad_{k}"], g) <= 1e-4, k
        assert _rel(mesh_grads[k], g) <= 1e-5, k  # JAX's: devices x grads


@pytest.mark.parametrize("mode", [{}, dict(culling=True)],
                         ids=["resident", "culled"])
def test_offset_queue_plain_version(mode):
    """_queue (plain) at p0 > 0 equals the rows of the p0 = 0 launch, and
    two halves folded are the one-launch render."""
    scene, cam = worker.small_scene()
    layout = tables.resolve(scene, "megakernel", **mode)
    args, kw = mk._launch_args(scene, cam, 5, layout, spp=2, max_depth=4,
                               t_min=1e-3, jitter=True)
    del kw["spp"]
    n = cam.width * cam.height
    whole = mk._queue(*args, n, 0, 2, **kw)
    for p0 in (1, 100, n - 1):
        part = mk._queue(*args, n - p0, 0, 2, p0=p0, **kw)
        assert torch.equal(part, whole[:, :, p0:])
    flat = mk._trace_shard_queue(scene, cam, 5, n, layout, spp=2,
                                 max_depth=4, t_min=1e-3, jitter=True)
    halves = torch.cat([mk._trace_shard_queue(
        scene, cam, 5, p1 - p0, layout, spp=2, max_depth=4, t_min=1e-3,
        jitter=True, p0=p0) for p0, p1 in ((0, 90), (90, n))])
    assert torch.equal(halves, flat)
    with pytest.raises(ValueError, match="nothing to trace"):
        mk._queue(*args, n, 0, 2, p0=-1, **kw)


def test_render_pixels_world_of_one(small):
    """In one process make_mesh makes a world of one (gloo, store in
    memory); the sharded paths then render the whole image."""
    scene, cam, _ = small
    assert not dist.is_initialized()
    try:
        mesh = parallel.make_mesh("cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == (parallel.AXIS,)
        assert multihost.is_primary_host()
        np.testing.assert_array_equal(
            parallel.render_sharded_jit(scene, cam, 3, worker.CONFIG, mesh),
            rtt.render(scene, cam, 3, worker.CONFIG))
        img = torch.arange(12.0).reshape(2, 2, 3)
        out = multihost.assemble_global_image(img)
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, img.numpy())
        assert parallel.global_mesh("cpu").size() == 1
    finally:
        dist.destroy_process_group()


class _Recorder:
    def __init__(self, exc=None):
        self.calls = []
        self.exc = exc

    def __call__(self, **kw):
        self.calls.append(kw)
        if self.exc is not None:
            raise self.exc


LAUNCHER = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER:
        monkeypatch.delenv(k, raising=False)
    rec = _Recorder()
    monkeypatch.setattr(dist, "init_process_group", rec)
    return rec


def test_initialize_no_cluster_stays_single_process(no_launcher):
    multihost.initialize(device="cpu")
    assert no_launcher.calls == []
    assert multihost.is_primary_host()


def test_initialize_reads_the_launcher_environment(no_launcher,
                                                   monkeypatch):
    for k, v in zip(LAUNCHER, ("127.0.0.1", "29500", "1", "2", "1")):
        monkeypatch.setenv(k, v)
    multihost.initialize(device="cpu")
    assert len(no_launcher.calls) == 1
    call = no_launcher.calls[0]
    assert call["backend"] == "gloo" and "init_method" not in call


def test_initialize_explicit_coordinator_forwards_and_raises(monkeypatch):
    rec = _Recorder(exc=ValueError("boom"))
    monkeypatch.setattr(dist, "init_process_group", rec)
    with pytest.raises(ValueError, match="boom"):
        multihost.initialize("10.0.0.1:1234", num_processes=2, process_id=0,
                             device="cpu")
    (call,) = rec.calls
    assert call["init_method"] == "tcp://10.0.0.1:1234"
    assert (call["world_size"], call["rank"], call["backend"]) == \
        (2, 0, "gloo")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("10.0.0.1:1234", device="cpu")
    rec.exc = None
    multihost.initialize("10.0.0.1:1234", 2, 1, backend="nccl",
                         device="cpu")
    assert rec.calls[-1]["backend"] == "nccl"


def test_initialize_idempotent_when_already_up(no_launcher, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    multihost.initialize()
    multihost.initialize("10.0.0.1:1234", 2, 0)
    assert no_launcher.calls == []


def test_sharded_megakernel_refuses_streamed_scenes():
    big, cam = rtt.scenes.sphere_field(n=14_000, width=8, device="cpu")
    with pytest.raises(ValueError, match="no sharded streamed path"):
        mk.render_megakernel_sharded(big, cam, 0, worker.CONFIG, mesh=None)


def test_dryrun_multichip_entrypoint():
    """The port's twins of __graft_entry__: entry() renders, and two gloo
    processes take the sharded render and both mesh steps."""
    fn, args = entry.entry(device="cpu")
    img = fn(*args)
    assert img.shape == (72, 128, 3) and bool(torch.isfinite(img).all())
    entry.dryrun_multichip(2, device="cpu")
