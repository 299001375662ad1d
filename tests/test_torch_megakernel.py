"""The port's megakernel path (rayz_tpu_torch/ops/megakernel.py) against the
JAX package. On the CPU the wrapper runs the kernel's plain torch version,
which is what the CUDA kernel is held against on the card (chip_smoke.py).

Tolerances:
* golden: the allowance tests/test_golden.py gives the JAX engines (+-1 u8
  step on < 0.5% of channels);
* zero random bits vs JAX ``render_pallas(interpret=True)`` (whose
  interpreter draws zero bits): atol 1e-5 on all but 0.1% of channels and
  5e-5 on every channel. The port rounds every operation on its own; the
  JAX kernel on the CPU does not: XLA contracts multiply-adds into FMAs
  and its rsqrt is not 1/sqrt in the last bit (each changes about a
  quarter to a third of float32 results by an ulp), and a curved mirror
  at a grazing angle magnifies such ulps (measured: at most 2.1e-5, on 10
  of the golden scene's 18,432 channels);
* sample groups vs one group, ``budget``/``passes`` vs none: atol 0 (draws
  are keyed by (pixel, sample, bounce), and the fold adds in sample order);
* real bits vs JAX ``rt.render``: distribution only (different generators),
  with the bounds of tests/test_render.py.
"""

import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.ops.megakernel import render_pallas
from rayz_tpu_torch.io.image import read_ppm, write_ppm
from rayz_tpu_torch.ops import engine, megakernel as mk, tables

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_deterministic.ppm")


def _golden_scene(m, **dt):
    """tests/test_golden.py's scene, built by either package ``m``."""
    b = m.SceneBuilder()
    e = b.add_solid_texture((0.2, 0.3, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.5, e, o)
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_metallic(texture=checker, fuzz=0.0))
    b.add_sphere((0, 0, -2), 0.5, b.add_metallic(color=(0.9, 0.6, 0.3),
                                                 fuzz=0.0))
    b.add_sphere((-1.1, 0, -2.4), 0.45, b.add_metallic(color=(0.6, 0.8, 0.9),
                                                       fuzz=0.0))
    b.add_triangle((0.6, -0.2, -1.6), (1.4, -0.2, -1.9), (1.0, 0.7, -1.8),
                   b.add_metallic(color=(0.8, 0.8, 0.8), fuzz=0.0))
    cam = m.make_camera(width=96, height=64, vfov=55.0, focus_dist=1.0,
                        defocus_angle=0.0, look_from=(0, 0.2, 0.6),
                        look_at=(0, 0, -2), **dt)
    return b.build(**dt), cam, dict(spp=1, max_depth=8, jitter=False)


def _compact_scene(m, **dt):
    """tests/test_megakernel.py's compact-respawn scene: glass, diffuse,
    metal and a triangle."""
    b = m.SceneBuilder()
    mt = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, mt)
    b.add_sphere((0, 0, -2), 0.5, mt)
    b.add_sphere((1.1, 0, -2.5), 0.5, b.add_dielectric(1.5))
    b.add_triangle((-1.6, 0.0, -2.5), (-0.8, 0.0, -2.5), (-1.2, 0.9, -2.5),
                   b.add_diffuse(color=(0.7, 0.2, 0.2)))
    cam = m.make_camera(width=64, height=32, vfov=55.0, focus_dist=1.0,
                        look_from=(0, 0, 0), look_at=(0, 0, -1), **dt)
    return b.build(**dt), cam, dict(spp=2, max_depth=6, jitter=False)


def _full_table_scene(m, **dt):
    """Two dielectric IORs and a fuzzy metal: the JAX kernel runs its
    full-table mode here (no global-material fast path), the port's only
    mode. Its diffuse surfaces scatter by UNIT_SPHERE (n + s): with zero
    random bits the HEMISPHERE sample shrinks to ~1e-8 and its direction
    is rounding noise of the hit point, which no two implementations
    share."""
    b = m.SceneBuilder()
    e = b.add_solid_texture((0.1, 0.4, 0.2))
    o = b.add_solid_texture((0.8, 0.8, 0.7))
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_diffuse(texture=b.add_checker_texture(0.4, e, o),
                               method=m.models.DIFFUSE_UNIT_SPHERE))
    b.add_sphere((-0.9, 0, -2.2), 0.5, b.add_dielectric(1.5))
    b.add_sphere((0.2, 0, -2.6), 0.5, b.add_dielectric(1.3))
    b.add_sphere((1.2, 0, -2.2), 0.45, b.add_metallic(color=(0.7, 0.7, 0.9),
                                                      fuzz=0.3))
    b.add_triangle((-0.4, -0.3, -1.6), (0.3, -0.3, -1.7), (0.0, 0.4, -1.8),
                   b.add_diffuse(color=(0.8, 0.3, 0.2),
                                 method=m.models.DIFFUSE_UNIT_SPHERE))
    cam = m.make_camera(width=48, height=32, vfov=55.0, focus_dist=1.0,
                        look_from=(0, 0.2, 0.5), look_at=(0, 0, -2), **dt)
    return b.build(**dt), cam, dict(spp=2, max_depth=6, jitter=False)


@pytest.fixture
def cuda_device():
    """Decided per test (never at import): the kernel needs the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernel on "
                    "the card")
    return torch.device("cuda", 0)


def _port(recipe):
    scene, cam, cfg = recipe(rtt, device="cpu")
    return scene, cam, rtt.RenderConfig(**cfg)


def _zero_bits(key, n):
    return torch.zeros_like(key)


def _golden_allowance(img):
    buf = io.BytesIO()
    write_ppm(img, buf)
    u8 = read_ppm(io.BytesIO(buf.getvalue())).astype(np.int32)
    diff = np.abs(u8 - read_ppm(GOLDEN).astype(np.int32))
    return diff.max(), (diff > 0).mean()


@pytest.mark.parametrize("schedule", [{}, dict(budget=2, passes=3)],
                         ids=["default", "budget_passes_ignored"])
def test_golden_plain_version(schedule):
    scene, cam, cfg = _port(_golden_scene)
    before = mk.LAUNCHES
    img = rtt.render_megakernel(scene, cam, 0, cfg, **schedule)
    assert mk.LAUNCHES == before  # CPU tensors never launch the kernel
    step, frac = _golden_allowance(img)
    assert step <= 1 and frac < 0.005, (step, frac)


@pytest.mark.parametrize("recipe, mode", [
    (_golden_scene, {}), (_compact_scene, {}), (_full_table_scene, {}),
    (_compact_scene, dict(culling=True)), (_compact_scene, dict(stream=128))],
    ids=["golden", "compact_scene", "full_table", "culled", "streamed"])
def test_zero_bits_matches_jax_interpreter(recipe, mode, monkeypatch):
    """The resident mode on three scenes, and the culled (Morton-sorted
    blocks) and streamed (chunks of 128) modes on the scene with every
    material and a triangle, each against ``render_pallas`` in the same
    mode, interpreted."""
    jscene, jcam, cfg = recipe(rt, dtype=jnp.float32)
    if recipe is _full_table_scene:
        assert jscene.uniq_dielectric_mat == -2  # JAX full-table mode
    want = np.asarray(render_pallas(jscene, jcam, 0, rt.RenderConfig(**cfg),
                                    interpret=True, **mode))
    monkeypatch.setattr(mk, "_queue", functools.partial(
        mk._queue_reference, bits=_zero_bits))
    scene, cam, tcfg = _port(recipe)
    got = rtt.render_megakernel(scene, cam, 0, tcfg, **mode).numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff > 1e-5).mean() < 1e-3, (diff > 1e-5).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("mode", [dict(culling=True), dict(stream=128)],
                         ids=["culled", "streamed"])
def test_sample_groups_equal_one_group(mode, monkeypatch):
    """Real random bits, jitter, defocus, motion blur, glass: samples run
    in groups (a small QUEUE_BYTES: one queue launch and one fold per
    group) render what one group renders, bit for bit, and so do JAX's
    ``budget``/``passes`` keywords, which the queue ignores; every draw is
    keyed by (pixel, sample, bounce) and the fold adds in sample order."""
    scene, cam = rtt.scenes.random_bouncing(width=24, height=14, seed=1,
                                            device="cpu")
    cfg = rtt.RenderConfig(spp=6, max_depth=6)
    groups = []
    real = mk._queue

    def spy(*args, **kw):
        groups.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(mk, "_queue", spy)
    ref = rtt.render_megakernel(scene, cam, 5, cfg, **mode)
    assert groups == [6] and float(ref.std()) > 0.01
    monkeypatch.setattr(mk, "QUEUE_BYTES", 4 * 12 * 24 * 14)
    groups.clear()
    img = rtt.render_megakernel(scene, cam, 5, cfg, **mode)
    assert groups == [4, 2] and torch.equal(img, ref)
    for budget, passes in ((3, 4), (1, 7)):
        assert torch.equal(rtt.render_megakernel(
            scene, cam, 5, cfg, budget=budget, passes=passes, **mode), ref)


def test_plain_version_matches_xla_render_in_distribution():
    W, H, spp = 32, 16, 32
    jscene, jcam = rt.scenes.random_bouncing(width=W, height=H,
                                             dtype=jnp.float32)
    cfg = rt.RenderConfig(spp=spp, max_depth=8)
    want = np.asarray(rt.render(jscene, jcam, jax.random.PRNGKey(0), cfg))
    scene, cam = rtt.scenes.random_bouncing(width=W, height=H, device="cpu")
    got = rtt.render_fast(scene, cam, 0, rtt.RenderConfig(spp=spp,
                                                         max_depth=8))
    got = got.numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    assert np.abs(got.mean(axis=(0, 1)) - want.mean(axis=(0, 1))).max() < 0.015
    bg = got.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    bw = want.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    assert np.abs(bg - bw).max() < 0.05


@pytest.mark.parametrize("mode", [dict(culling=True), dict(stream=128)],
                         ids=["culled", "streamed"])
def test_last_pixel_of_a_partial_run(mode):
    """20x12 = 240 pixels, not a multiple of the queue's run of 64 items:
    the last pixel of the culled and streamed renders is lit and equals the
    resident render's (only an exact tie could part them)."""
    b = rtt.SceneBuilder()
    m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    scene = b.build(device="cpu")
    cam = rtt.make_camera(width=20, height=12, vfov=55.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          device="cpu")
    cfg = rtt.RenderConfig(spp=2, max_depth=4, jitter=False)
    assert (20 * 12) % mk.QUEUE_RUN
    ref = rtt.render_megakernel(scene, cam, 0, cfg)
    img = rtt.render_megakernel(scene, cam, 0, cfg, **mode)
    assert float(ref[-1, -1].min()) > 0.0
    assert torch.equal(img, ref)


def test_unsupported_scenes_raise():
    b = rtt.SceneBuilder()
    e = b.add_solid_texture((0.1, 0.1, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    inner = b.add_checker_texture(0.3, e, o)
    outer = b.add_checker_texture(1.1, inner, o)
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(texture=outer))
    nested = b.build(device="cpu")
    cam = rtt.make_camera(width=8, height=8, vfov=60.0, focus_dist=1.0,
                          device="cpu")
    cfg = rtt.RenderConfig(spp=1, max_depth=2)
    assert nested.deep_checker
    # auto sends nested checkers to the dense integrator (they raised here
    # until it was ported); the megakernel itself still refuses them
    assert torch.equal(rtt.render_fast(nested, cam, 0, cfg),
                       rtt.render(nested, cam, 0, cfg))
    with pytest.raises(ValueError, match="checker"):
        rtt.render_megakernel(nested, cam, 0, cfg)

    big, cam = rtt.scenes.sphere_field(n=14_000, width=8, device="cpu")
    assert engine.pick_engine(big, "auto") == "wavefront"
    with pytest.raises(ValueError, match="shared memory"):
        rtt.render_megakernel(big, cam, 0, cfg, stream=0)
    assert engine.pick_engine(big, "xla") == "xla"
    with pytest.raises(ValueError):
        engine.pick_engine(big, "pallas")


def test_wrapper_validates_inputs():
    """The queue's wrapper checks a culled or streamed launch's bounds,
    packed records and hits, and refuses a device with no kernel instead of
    falling back."""
    scene, cam, cfg = _port(_golden_scene)
    launch = dict(spp=1, max_depth=2, t_min=1e-3, jitter=False)
    culled = tables.resolve(scene, "megakernel", culling=True)
    args, kw = mk._launch_args(scene, cam, 0, culled, **launch)
    del kw["spp"]
    hits = torch.full((2, 64), -2, dtype=torch.int32)
    out = mk._queue(*args, 64, 0, 1, hits=hits, **kw)
    assert out.shape == (1, 3, 64) and bool((hits[0] >= -1).all())
    with pytest.raises(ValueError, match="hits"):
        mk._queue(*args, 64, 0, 1, hits=hits.long(), **kw)
    rargs, rkw = mk._launch_args(scene, cam, 0,
                                 tables.resolve(scene, "megakernel"),
                                 **launch)
    del rkw["spp"]
    with pytest.raises(ValueError, match="hits"):
        mk._queue(*rargs, 64, 0, 1, hits=hits, **rkw)
    with pytest.raises(ValueError, match="not those of"):
        mk._queue(*rargs, 64, 0, 1, **dict(rkw, layout=culled))
    with pytest.raises(ValueError, match="8k"):
        mk._queue(args[0], args[1][:, :5].contiguous(), args[2], 64, 0, 1,
                  **kw)
    b = kw["bounds"]
    with pytest.raises(ValueError, match="bound rows"):
        mk._queue(*args, 64, 0, 1, **dict(kw, bounds=b._replace(
            sblk=b.sblk.double())))
    meta = dict(kw, bounds=b._replace(sblk=b.sblk.to("meta"),
                                      tblk=b.tblk.to("meta")))
    with pytest.raises(ValueError, match="no megakernel"):
        mk._queue(*(a.to("meta") for a in args), 64, 0, 1, **meta)
    args, kw = mk._launch_args(
        scene, cam, 0, tables.resolve(scene, "megakernel", stream=128),
        **launch)
    del kw["spp"]
    assert mk._queue(*args, 64, 0, 1, **kw).shape == (1, 3, 64)
    with pytest.raises(ValueError, match="packed records"):
        mk._queue(*args, 64, 0, 1, **dict(kw, records=None))
    recs, brecs = kw["records"]
    with pytest.raises(ValueError, match="packed records"):
        mk._queue(*args, 64, 0, 1, **dict(kw, records=(recs[:-4], brecs)))


MODES = [dict(culling=True), dict(culling=True, budget=2, passes=3),
         dict(stream=128), dict(stream=128, culling=False)]
MODE_IDS = ["culled", "culled_budget_passes", "streamed",
            "streamed_unculled"]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_culled_and_streamed_modes_golden(mode):
    """The culled and streamed table modes (Morton-sorted tables; the plain
    version sweeps them in full, as the kernel's conservative bound tests
    leave the same winners up to near ties) pass the golden."""
    scene, cam, cfg = _port(_golden_scene)
    before = mk.LAUNCHES
    img = rtt.render_megakernel(scene, cam, 0, cfg, **mode)
    assert mk.LAUNCHES == before
    step, frac = _golden_allowance(img)
    assert step <= 1 and frac < 0.005, (step, frac)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_culled_and_streamed_modes_match_full_table(mode):
    """Real random bits (jitter, defocus, motion, glass) and triangles: the
    culled and streamed renders equal the full-table render for the same
    seed on at least 99.9% of pixels (only an exact tie between two columns
    may resolve otherwise in the sorted tables)."""
    scene, cam = rtt.scenes.random_bouncing(width=24, height=14, seed=1,
                                            device="cpu")
    b = rtt.SceneBuilder()
    _mixed_primitives(b)
    mixed = b.build(device="cpu")
    for sc, cfg in ((scene, rtt.RenderConfig(spp=3, max_depth=6)),
                    (mixed, rtt.RenderConfig(spp=2, max_depth=5))):
        ref = rtt.render_megakernel(sc, cam, 7, cfg)
        img = rtt.render_megakernel(sc, cam, 7, cfg, **mode)
        same = float((img == ref).all(dim=-1).double().mean())
        print(f"{mode}: {same:.4%} of pixels identical")
        assert same >= 0.999, same


def _mixed_primitives(b):
    """Spheres and more triangles than spheres (triangle-dominant unroll),
    a glass sphere and a metal quad, around the origin."""
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(color=(0.5, 0.5, 0.5)))
    b.add_sphere((0.4, 0.2, -0.5), 0.3, b.add_dielectric(1.5))
    m = b.add_metallic(color=(0.7, 0.8, 0.9), fuzz=0.2)
    for k in range(12):
        x = -1.2 + 0.2 * k
        b.add_quad((x, -0.4, -1.2), (0.15, 0.0, 0.1), (0.0, 0.6, 0.0), m)


def test_render_megakernel_resolves_modes(monkeypatch):
    """Every mode takes the queue, one group of all samples at this size:
    resident scenes stay unculled by default, ``culling=True`` culls them in
    shared memory, ``stream`` streams them (blocks of STREAM_BLOCK, packed
    records), a scene beyond shared memory streams, and ``budget``/
    ``passes`` change nothing."""
    seen = []
    real = mk._trace_queue

    def spy(*args, **kw):
        layout = kw["layout"]
        seen.append((args[3], kw["spp"], layout.mode, layout.blk,
                     kw["records"] is not None))
        return real(*args, **kw)

    monkeypatch.setattr(mk, "_trace_queue", spy)
    scene, cam = rtt.scenes.random_bouncing(width=8, height=4, device="cpu")
    cfg = rtt.RenderConfig(spp=16, max_depth=2)
    rtt.render_megakernel(scene, cam, 0, cfg)
    rtt.render_megakernel(scene, cam, 0, cfg, budget=4, passes=10)
    rtt.render_megakernel(scene, cam, 0, cfg, culling=True)
    rtt.render_megakernel(scene, cam, 0, cfg, stream=256)
    assert seen == [(32, 16, 0, 0, False)] * 2 + [
        (32, 16, 1, mk.DEFAULT_BLOCK, False),
        (32, 16, 2, tables.STREAM_BLOCK, True)]
    seen.clear()
    big, bcam = rtt.scenes.sphere_field(n=3_500, width=8, height=4,
                                        device="cpu")
    rtt.render_megakernel(big, bcam, 0, rtt.RenderConfig(spp=1, max_depth=1))
    assert seen == [(32, 1, 2, tables.STREAM_BLOCK, True)]


@pytest.mark.cuda
def test_kernel_golden_on_card(cuda_device):
    """The CUDA kernels themselves (chip_smoke.py runs this and more on the
    card): golden through the queue and its fold in every table mode,
    whatever ``budget``/``passes`` ask."""
    scene, cam, cfg = _port(_golden_scene)
    scene, cam = scene.to(cuda_device), cam.to(cuda_device)
    for mode in ({}, dict(budget=2, passes=3), dict(culling=True),
                 dict(stream=128)):
        before = mk.LAUNCHES
        img = rtt.render_megakernel(scene, cam, 0, cfg, **mode)
        torch.cuda.synchronize()
        assert mk.LAUNCHES - before == 2
        step, frac = _golden_allowance(img)
        assert step <= 1 and frac < 0.005, (step, frac)


@pytest.mark.cuda
def test_wide_resident_build_on_card(cuda_device):
    """A scene whose resident tables take the wide build (the Cornell box,
    122,960 bytes: one block an SM) launches 1,024 threads a block, no more
    than the card's SMs hold at once, and renders what ``_queue_reference``
    renders on at least 99.9% of its items (64x64, 4 spp, depth 8); a
    flagship-sized sphere scene keeps 128 threads."""
    scene, cam = rtt.scenes.cornell_box(width=64, device=cuda_device)
    args, kw = mk._launch_args(scene, cam, 3,
                               tables.resolve(scene, "megakernel"), spp=4,
                               max_depth=8, t_min=1e-3, jitter=True)
    del kw["spp"]
    n = cam.width * cam.height
    got = mk._queue(*args, n, 0, 4, **kw)
    torch.cuda.synchronize()
    assert mk.QUEUE_BLOCK == 1024
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert mk.QUEUE_GRID * mk.QUEUE_BLOCK <= sms * 2048
    want = mk._queue_reference(*args, n, 0, 4, **kw)
    same = float((got == want).all(dim=1).double().mean())
    assert same >= 0.999, same
    scene, cam = rtt.scenes.random_bouncing(width=64, height=64,
                                            device=cuda_device)
    rtt.render_megakernel(scene, cam, 0, rtt.RenderConfig(spp=1, max_depth=4))
    assert mk.QUEUE_BLOCK == 128


@pytest.mark.cuda
def test_resident_drain_on_card(cuda_device):
    """The resident queue's drain: a warp with few live lanes sweeps their
    spheres a column per lane. The flagship scene at 128x128, 1 spp, depth
    32 takes it (its counter, stats slot 8, above 0 and at most the
    segments) and renders what ``_queue_reference`` renders on at least
    99.9% of its items, as the per-lane sweep does; the Cornell box, which
    has no spheres, never takes it."""
    def launch(scene, cam, depth):
        args, kw = mk._launch_args(scene, cam, 3,
                                   tables.resolve(scene, "megakernel"),
                                   spp=1, max_depth=depth, t_min=1e-3,
                                   jitter=True)
        del kw["spp"]
        n = cam.width * cam.height
        stats = torch.zeros(mk.QUEUE_STATS, dtype=torch.int64,
                            device=cuda_device)
        got = mk._queue(*args, n, 0, 1, stats=stats, **kw)
        torch.cuda.synchronize()
        return got, [int(x) for x in stats.tolist()], args, kw, n

    scene, cam = rtt.scenes.random_bouncing(width=128, height=128,
                                            device=cuda_device)
    got, st, args, kw, n = launch(scene, cam, 32)
    assert 0 < st[8] <= st[0], st
    want = mk._queue_reference(*args, n, 0, 1, **kw)
    same = float((got == want).all(dim=1).double().mean())
    assert same >= 0.999, same
    box, bcam = rtt.scenes.cornell_box(width=64, device=cuda_device)
    _, st, *_ = launch(box, bcam, 8)
    assert st[0] > 0 and st[8] == 0, st
