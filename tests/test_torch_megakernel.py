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
* compact vs single launch: atol 0 (draws are keyed by slot state);
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
from rayz_tpu_torch.ops import engine, megakernel as mk

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


@pytest.mark.parametrize("schedule", [dict(passes=0),
                                      dict(budget=2, passes=3)],
                         ids=["single", "compact"])
def test_golden_plain_version(schedule):
    scene, cam, cfg = _port(_golden_scene)
    before = mk.LAUNCHES
    img = rtt.render_megakernel(scene, cam, 0, cfg, **schedule)
    assert mk.LAUNCHES == before  # CPU tensors never launch the kernel
    step, frac = _golden_allowance(img)
    assert step <= 1 and frac < 0.005, (step, frac)


@pytest.mark.parametrize("recipe", [_golden_scene, _compact_scene,
                                    _full_table_scene],
                         ids=["golden", "compact_scene", "full_table"])
def test_zero_bits_matches_jax_interpreter(recipe, monkeypatch):
    jscene, jcam, cfg = recipe(rt, dtype=jnp.float32)
    if recipe is _full_table_scene:
        assert jscene.uniq_dielectric_mat == -2  # JAX full-table mode
    want = np.asarray(render_pallas(jscene, jcam, 0, rt.RenderConfig(**cfg),
                                    interpret=True))
    monkeypatch.setattr(mk, "_queue", functools.partial(
        mk._queue_reference, bits=_zero_bits))
    scene, cam, tcfg = _port(recipe)
    got = rtt.render_megakernel(scene, cam, 0, tcfg).numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff > 1e-5).mean() < 1e-3, (diff > 1e-5).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_compact_equals_single_launch_stochastic():
    """Real random bits, jitter, defocus, motion blur, glass: budgeted
    passes with compaction in between (the culled mode's schedule)
    reproduce the single launch bit for bit, because every draw is keyed by
    the slot's own state."""
    scene, cam = rtt.scenes.random_bouncing(width=24, height=14, seed=1,
                                            device="cpu")
    cfg = rtt.RenderConfig(spp=6, max_depth=6)
    ref = rtt.render_megakernel(scene, cam, 5, cfg, culling=True, passes=0)
    assert float(ref.std()) > 0.01
    for budget, passes in ((3, 4), (1, 7)):
        img = rtt.render_megakernel(scene, cam, 5, cfg, culling=True,
                                    budget=budget, passes=passes)
        assert torch.equal(img, ref), (budget, passes)
    # the culled default at spp >= 16 is the compact one
    cfg16 = rtt.RenderConfig(spp=16, max_depth=3)
    assert torch.equal(
        rtt.render_megakernel(scene, cam, 2, cfg16, culling=True),
        rtt.render_megakernel(scene, cam, 2, cfg16, culling=True, passes=0))


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


def test_retired_slots_do_not_overwrite_last_pixel():
    """20x12 = 240 pixels in 256 slots: the 16 retired (-1) slots must not
    land on pixel 239 through the final scatter (torch indexing wraps -1
    as JAX's does)."""
    b = rtt.SceneBuilder()
    m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    scene = b.build(device="cpu")
    cam = rtt.make_camera(width=20, height=12, vfov=55.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          device="cpu")
    cfg = rtt.RenderConfig(spp=2, max_depth=4, jitter=False)
    assert mk._slot_table(240, "cpu").tolist()[-17:] == [239] + [-1] * 16
    ref = rtt.render_megakernel(scene, cam, 0, cfg, culling=True, passes=0)
    img = rtt.render_megakernel(scene, cam, 0, cfg, culling=True, budget=1,
                                passes=4)
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
    with pytest.raises(NotImplementedError, match="item 4"):
        rtt.render_fast(nested, cam, 0, cfg)
    with pytest.raises(ValueError, match="checker"):
        rtt.render_megakernel(nested, cam, 0, cfg)

    big, cam = rtt.scenes.sphere_field(n=14_000, width=8, device="cpu")
    assert engine.pick_engine(big, "auto") == "wavefront"
    with pytest.raises(ValueError, match="shared memory"):
        rtt.render_megakernel(big, cam, 0, cfg, stream=0)
    with pytest.raises(NotImplementedError, match="item 4"):
        engine.pick_engine(big, "xla")
    with pytest.raises(ValueError):
        engine.pick_engine(big, "pallas")


def test_wrapper_validates_inputs():
    scene, cam, cfg = _port(_golden_scene)
    args, kw = mk._launch_args(scene, cam, 0, spp=1, max_depth=2,
                               t_min=1e-3, jitter=False, unroll=8,
                               blk=mk.DEFAULT_BLOCK)
    pix = mk._slot_table(64, "cpu")
    rgb, st = mk._trace_slots(*args, pix, save_state=True, **kw)
    assert rgb.shape == (3, 128) and st.shape == (mk.STATE_PLANES, 128)
    with pytest.raises(ValueError, match="int32"):
        mk._trace_slots(*args, pix.long(), **kw)
    with pytest.raises(ValueError, match="8k"):
        mk._trace_slots(args[0], args[1][:, :5].contiguous(), args[2], pix,
                        **kw)
    with pytest.raises(ValueError, match="resume"):
        mk._trace_slots(*args, pix, resume=st[:, :64], **kw)
    b = kw["bounds"]
    meta = dict(kw, bounds=b._replace(sblk=b.sblk.to("meta"),
                                      tblk=b.tblk.to("meta")))
    with pytest.raises(ValueError, match="no megakernel"):
        mk._trace_slots(*(a.to("meta") for a in args), pix.to("meta"),
                        **meta)
    with pytest.raises(ValueError, match="queue"):
        mk._trace_slots(*args, pix, **dict(kw, bounds=None))


MODES = [dict(culling=True), dict(culling=True, budget=2, passes=3),
         dict(stream=128), dict(stream=128, culling=False)]
MODE_IDS = ["culled", "culled_compact", "streamed", "streamed_unculled"]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_culled_and_streamed_modes_golden(mode):
    """The culled and streamed table modes (Morton-sorted tables; the plain
    version sweeps them in full, as the kernel's conservative bound tests
    leave the same winners) pass the golden."""
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
        ref = rtt.render_megakernel(sc, cam, 7, cfg, passes=0)
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
    """Resident scenes stay unculled by default, take the queue whatever
    ``passes`` asks, and stream only when asked; culled renders compact at
    spp >= 16; a scene beyond shared memory streams; streamed renders take
    one launch and no compaction."""
    seen, queued = [], []
    real, real_queue = mk._trace_slots, mk._trace_queue

    def spy(*args, **kw):
        seen.append((mk._mode(kw.get("bounds")), kw.get("budget", 0)))
        return real(*args, **kw)

    def spy_queue(*args, **kw):
        queued.append((args[3], kw["spp"]))
        return real_queue(*args, **kw)

    monkeypatch.setattr(mk, "_trace_slots", spy)
    monkeypatch.setattr(mk, "_trace_queue", spy_queue)
    scene, cam = rtt.scenes.random_bouncing(width=8, height=4, device="cpu")
    cfg = rtt.RenderConfig(spp=16, max_depth=2)
    rtt.render_megakernel(scene, cam, 0, cfg)
    assert seen == [] and queued == [(32, 16)]
    rtt.render_megakernel(scene, cam, 0, cfg, passes=10)
    assert seen == [] and len(queued) == 2
    rtt.render_megakernel(scene, cam, 0, cfg, culling=True)
    assert seen == [(1, 16)] * 9 + [(1, 0)] and len(queued) == 2
    seen.clear()
    rtt.render_megakernel(scene, cam, 0, cfg, culling=True, passes=0)
    rtt.render_megakernel(scene, cam, 0, cfg, stream=256)
    assert seen == [(1, 0), (2, 0)]
    seen.clear()
    big, bcam = rtt.scenes.sphere_field(n=3_500, width=8, height=4,
                                        device="cpu")
    rtt.render_megakernel(big, bcam, 0, rtt.RenderConfig(spp=1, max_depth=1))
    assert seen == [(2, 0)]


@pytest.mark.cuda
def test_kernel_golden_on_card(cuda_device):
    """The CUDA kernels themselves (chip_smoke.py runs this and more on the
    card): golden through the queue and its fold, whatever ``passes``
    asks."""
    scene, cam, cfg = _port(_golden_scene)
    scene, cam = scene.to(cuda_device), cam.to(cuda_device)
    for schedule in (dict(passes=0), dict(budget=2, passes=3)):
        before = mk.LAUNCHES
        img = rtt.render_megakernel(scene, cam, 0, cfg, **schedule)
        torch.cuda.synchronize()
        assert mk.LAUNCHES - before == 2
        step, frac = _golden_allowance(img)
        assert step <= 1 and frac < 0.005, (step, frac)
