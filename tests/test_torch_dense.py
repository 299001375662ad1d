"""The port's dense integrator (rayz_tpu_torch/ops/integrator.py: render,
trace_rays) and the "dense" training engine against the JAX package, the
committed golden image and the NumPy oracle (tests/oracle.py), on the CPU.

Tolerances and why:
* deterministic configs (jitter off, fuzz-0 metals: no draw changes a
  path): images within 1e-12 of JAX ``render`` in float64 (measured
  6.7e-14), in float32 within 5e-5 and within 1e-5 on all but 0.1% of
  channels (measured 2.1e-5, 0.06%: XLA contracts multiply-adds and a
  curved mirror magnifies an ulp, as tests/test_torch_megakernel.py
  states); float64
  gradients within 1e-7 of ``jax.grad`` of JAX's dense ``pixel_loss``,
  relative to each field's largest entry (the two round the intersection
  sums differently, ~1e-16, and a curved mirror magnifies it); the golden
  at tests/test_golden.py's allowance (+-1 u8 step on < 0.5% of channels);
* stochastic configs: the draws are the megakernel's, not jax.random's, so
  against JAX ``render`` and the oracle only in distribution, with
  tests/test_render.py's bounds; against the megakernel's plain version at
  the same seed, the same paths apart from near ties: >= 95% of channels
  within 1e-4 (measured 98.6% at 32x18, 2 spp, depth 6);
* chunking and remat change no bit of an image, and gradients only by the
  order of their sums (1e-12 relative);
* finite differences as tests/test_grad.py (albedo 1e-4 relative, centre
  and radius 5e-3 relative).
"""

import dataclasses
import io
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.diff import pixel_loss as jpixel_loss
from rayz_tpu_torch.diff import inverse
from rayz_tpu_torch.io.image import read_ppm, write_ppm
from rayz_tpu_torch.ops import engine

sys.path.insert(0, os.path.dirname(__file__))
from oracle import OracleCamera, render_oracle  # noqa: E402

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_deterministic.ppm")
STATICS = ("n_spheres", "n_triangles", "has_motion", "deep_checker",
           "tex_depth", "uniq_checker_tex", "uniq_dielectric_mat")
GEOMETRY = ("sphere_center", "sphere_radius", "tri_v0", "tri_v1", "tri_v2",
            "tex_color")


def port_scene(jscene):
    leaves = {f.name: np.asarray(getattr(jscene, f.name))
              for f in dataclasses.fields(jscene) if f.name not in STATICS}
    return rtt.scene_from_numpy(leaves,
                                **{k: getattr(jscene, k) for k in STATICS})


def port_camera(jcam):
    return rtt.camera_from_numpy(
        {f.name: np.asarray(getattr(jcam, f.name))
         for f in dataclasses.fields(jcam)
         if f.name not in ("height", "width")},
        height=jcam.height, width=jcam.width)


def golden_scene(m, **dt):
    """tests/test_golden.py's scene: fuzz-0 metals, a checker, a triangle."""
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
    return b.build(**dt), cam


DET = dict(spp=1, max_depth=8, jitter=False)


def test_golden():
    scene, cam = golden_scene(rtt, device="cpu")
    img = rtt.render(scene, cam, 0, rtt.RenderConfig(**DET))
    buf = io.BytesIO()
    write_ppm(img, buf)
    u8 = read_ppm(io.BytesIO(buf.getvalue())).astype(np.int32)
    diff = np.abs(u8 - read_ppm(GOLDEN).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_deterministic_render_matches_jax(dt):
    jdt = {"f64": jnp.float64, "f32": jnp.float32}[dt]
    jscene, jcam = golden_scene(rt, dtype=jdt)
    want = np.asarray(rt.render(jscene, jcam, jax.random.PRNGKey(0),
                                rt.RenderConfig(**DET)))
    got = rtt.render(port_scene(jscene), port_camera(jcam), 0,
                     rtt.RenderConfig(**DET)).numpy()
    assert got.dtype == want.dtype
    d = np.abs(got - want)
    if dt == "f64":
        assert d.max() <= 1e-12
    else:
        assert d.max() <= 5e-5 and (d > 1e-5).mean() < 1e-3


def _two_sphere(W, H):
    scene, cam = rtt.scenes.two_sphere(width=W, height=H,
                                       dtype=torch.float64, device="cpu")
    ocam = OracleCamera(width=W, height=H, vfov=90.0, focus_dist=1.0,
                        defocus_angle=0.0, look_from=(0, 0, 0),
                        look_at=(0, 0, -1))
    return scene, cam, ocam, dict(spp=96, max_depth=8), 0.01, 0.035


def _six_deep(W, H):
    b = rtt.SceneBuilder()
    cur = b.add_solid_texture((0.9, 0.1, 0.1))
    other = b.add_solid_texture((0.1, 0.1, 0.9))
    for lvl in range(5):
        cur = b.add_checker_texture(1.6 / (2 ** lvl), cur, other)
    b.add_sphere((0, -100.5, -2), 100.0, b.add_diffuse(texture=cur))
    b.add_sphere((0, 0, -2), 0.5, b.add_diffuse(texture=cur))
    scene = b.build(dtype=torch.float64, device="cpu")
    assert scene.tex_depth == 6 and scene.deep_checker
    cam = rtt.make_camera(width=W, height=H, vfov=55.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          dtype=torch.float64, device="cpu")
    ocam = OracleCamera(width=W, height=H, vfov=55.0, focus_dist=1.0,
                        defocus_angle=0.0, look_from=(0, 0, 0),
                        look_at=(0, 0, -1))
    return scene, cam, ocam, dict(spp=64, max_depth=4), 0.015, 0.05


@pytest.mark.parametrize("recipe,size", [(_two_sphere, 48), (_six_deep, 32)],
                         ids=["two_sphere", "six_deep_checker"])
def test_render_matches_oracle(recipe, size):
    """tests/test_render.py:36 and :94 through the port: block means
    within Monte-Carlo noise of the independent NumPy oracle."""
    scene, cam, ocam, kw, mean_tol, block_tol = recipe(size, size)
    cfg = rtt.RenderConfig(t_min=1e-3, chunk_size=1 << 16, **kw)
    img = rtt.render(scene, cam, 7, cfg).numpy()
    oimg = render_oracle(scene, ocam, t_min=1e-3, seed=3, **kw)
    assert np.abs(img.mean((0, 1)) - oimg.mean((0, 1))).max() < mean_tol
    n = size // 8
    bi = img.reshape(n, 8, n, 8, 3).mean((1, 3))
    bo = oimg.reshape(n, 8, n, 8, 3).mean((1, 3))
    assert np.abs(bi - bo).max() < block_tol


def test_stochastic_mean_matches_jax():
    """Real draws against JAX's render: distribution only, with the bounds
    of tests/test_render.py."""
    W, H, spp = 32, 16, 32
    jscene, jcam = rt.scenes.random_bouncing(width=W, height=H,
                                             dtype=jnp.float32)
    want = np.asarray(rt.render(jscene, jcam, jax.random.PRNGKey(0),
                                rt.RenderConfig(spp=spp, max_depth=8)))
    got = rtt.render(port_scene(jscene), port_camera(jcam), 0,
                     rtt.RenderConfig(spp=spp, max_depth=8,
                                      chunk_size=1 << 16)).numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    assert np.abs(got.mean((0, 1)) - want.mean((0, 1))).max() < 0.015
    bg = got.reshape(H // 8, 8, W // 8, 8, 3).mean((1, 3))
    bw = want.reshape(H // 8, 8, W // 8, 8, 3).mean((1, 3))
    assert np.abs(bg - bw).max() < 0.05


def test_same_paths_as_the_megakernel():
    """One seed, the megakernel's draws: the same paths but where the two
    arithmetics round a near tie apart."""
    scene, cam = rtt.scenes.random_bouncing(width=32, height=18,
                                            device="cpu")
    cfg = rtt.RenderConfig(spp=2, max_depth=6)
    img = rtt.render(scene, cam, 0, cfg)
    ref = rtt.render_megakernel(scene, cam, 0, cfg)
    assert float(((img - ref).abs() <= 1e-4).double().mean()) >= 0.95


def _unit_scene(dtype=torch.float64):
    """tests/test_grad.py's two diffuse spheres, scattering by UNIT_SPHERE
    (smooth in the normal, so geometry gradients are nonzero)."""
    b = rtt.SceneBuilder()
    m = rtt.models.DIFFUSE_UNIT_SPHERE
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(color=(0.5, 0.5, 0.5),
                                                       method=m))
    b.add_sphere((0, 0, -1.2), 0.5, b.add_diffuse(color=(0.7, 0.3, 0.2),
                                                  method=m))
    cam = rtt.make_camera(width=12, height=12, vfov=60.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          dtype=dtype, device="cpu")
    return b.build(dtype=dtype, device="cpu"), cam


def _grads(scene, cam, cfg, fields, seed=5, target=None):
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}
    if target is None:
        target = torch.zeros((cam.height, cam.width, 3), dtype=cam.dtype)
    loss = rtt.pixel_loss(params, scene, cam, seed, target, cfg)
    return loss, dict(zip(fields, torch.autograd.grad(
        loss, list(params.values()))))


@pytest.mark.parametrize("change", [dict(chunk_size=50), dict(remat=False),
                                    dict(chunk_size=1 << 16, remat=False)],
                         ids=["chunked", "no_remat", "all_at_once"])
def test_chunk_and_remat_change_nothing(change):
    scene, cam = _unit_scene()
    cfg = rtt.RenderConfig(spp=3, max_depth=4)
    loss, grads = _grads(scene, cam, cfg, ("sphere_center", "tex_color"))
    other = cfg._replace(**change)
    assert torch.equal(rtt.render(scene, cam, 2, cfg),
                       rtt.render(scene, cam, 2, other))
    loss2, grads2 = _grads(scene, cam, other, ("sphere_center", "tex_color"))
    assert loss.item() == loss2.item()
    for k, g in grads.items():
        assert float(g.abs().max()) > 0
        torch.testing.assert_close(grads2[k], g, rtol=1e-12, atol=0)


def test_gradients_match_jax():
    """Deterministic config (golden scene, float64): jax.grad of JAX's
    dense pixel_loss against the port's autograd."""
    jscene, jcam = golden_scene(rt, dtype=jnp.float64)
    jscene = jscene.replace(tex_color=jscene.tex_color * 0.9)
    cfg = dict(spp=1, max_depth=6, jitter=False)
    target = np.full((jcam.height, jcam.width, 3), 0.25)
    jparams = {f: getattr(jscene, f) for f in GEOMETRY}
    jg = jax.grad(jpixel_loss)(jparams, jscene, jcam, jax.random.PRNGKey(0),
                               jnp.asarray(target), rt.RenderConfig(**cfg))
    scene, cam = port_scene(jscene), port_camera(jcam)
    loss, grads = _grads(scene, cam, rtt.RenderConfig(**cfg), GEOMETRY,
                         seed=0, target=torch.tensor(target))
    for f in GEOMETRY:
        want = np.asarray(jg[f])
        scale = np.abs(want).max()
        assert scale > 0, f
        np.testing.assert_allclose(grads[f].numpy(), want, rtol=0,
                                   atol=1e-7 * scale, err_msg=f)


def _fd(f, params, field, index, eps):
    plus = {k: v.clone() for k, v in params.items()}
    minus = {k: v.clone() for k, v in params.items()}
    plus[field].view(-1)[index] += eps
    minus[field].view(-1)[index] -= eps
    return (float(f(plus)) - float(f(minus))) / (2 * eps)


def _fd_setup(method):
    """tests/test_grad.py's _setup at 12x12: the target a render of the
    same scene at another seed."""
    b = rtt.SceneBuilder()
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(color=(0.5, 0.5, 0.5),
                                                       method=method))
    b.add_sphere((0, 0, -1.2), 0.5, b.add_diffuse(color=(0.7, 0.3, 0.2),
                                                  method=method))
    scene = b.build(dtype=torch.float64, device="cpu")
    cam = rtt.make_camera(width=12, height=12, vfov=60.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          dtype=torch.float64, device="cpu")
    cfg = rtt.RenderConfig(spp=2, max_depth=4)
    target = rtt.render(scene, cam, 99, cfg)
    return scene, cam, cfg, target


def test_albedo_grad_matches_fd():
    scene, cam, cfg, target = _fd_setup(rtt.models.DIFFUSE_HEMISPHERE)
    params = {"tex_color": scene.tex_color.clone()}

    def f(p):
        return rtt.pixel_loss(p, scene, cam, 5, target, cfg)
    leaf = {"tex_color": params["tex_color"].clone().requires_grad_(True)}
    g = torch.autograd.grad(f(leaf), leaf["tex_color"])[0].reshape(-1)
    with torch.no_grad():
        for idx in range(6):
            fd = _fd(f, params, "tex_color", idx, 1e-5)
            assert abs(float(g[idx]) - fd) <= 1e-6 + 1e-4 * abs(fd), idx


def test_center_and_radius_grad_match_fd():
    scene, cam, cfg, target = _fd_setup(rtt.models.DIFFUSE_UNIT_SPHERE)
    fields = ("sphere_center", "sphere_radius")
    params = {k: getattr(scene, k).clone() for k in fields}

    def f(p):
        return rtt.pixel_loss(p, scene, cam, 5, target, cfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    grads = dict(zip(fields, torch.autograd.grad(f(leaves),
                                                 list(leaves.values()))))
    assert float(grads["sphere_center"].abs().sum()) > 0
    assert float(grads["sphere_radius"].abs().sum()) > 0
    with torch.no_grad():
        for field, idx in (("sphere_center", 5), ("sphere_radius", 1)):
            fd = _fd(f, params, field, idx, 1e-6)
            ad = float(grads[field].reshape(-1)[idx])
            assert abs(ad - fd) <= 1e-5 + 5e-3 * abs(fd), (field, ad, fd)


def test_hemisphere_diffuse_geometry_grad_is_zero_ae():
    """The estimator property the JAX package documents: HEMISPHERE
    scatter is piecewise constant in the normal, so geometry gradients
    vanish under sky-only lighting."""
    scene, cam, cfg, target = _fd_setup(rtt.models.DIFFUSE_HEMISPHERE)
    _, grads = _grads(scene, cam, cfg, ("sphere_center", "sphere_radius"),
                      target=target)
    assert float(grads["sphere_center"].abs().sum()) == 0.0
    assert float(grads["sphere_radius"].abs().sum()) == 0.0


def _material_mix():
    b = rtt.SceneBuilder()
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(
        texture=b.add_checker_texture(0.5, even, odd)))
    b.add_sphere((-1, 0, -1.2), 0.5, b.add_metallic(color=(0.8, 0.8, 0.9),
                                                    fuzz=0.3))
    b.add_sphere((0, 0, -1.2), 0.5, b.add_dielectric(1.5))
    b.add_sphere((1, 0, -1.2), 0.5, b.add_diffuse(color=(0.7, 0.3, 0.2)),
                 velocity=(0, 0.3, 0))
    b.add_triangle((-0.4, 0.6, -1.4), (0.4, 0.6, -1.5), (0.0, 1.1, -1.5),
                   b.add_metallic(color=(0.7, 0.7, 0.7), fuzz=0.0))
    cam = rtt.make_camera(width=16, height=16, vfov=60.0, focus_dist=1.0,
                          look_from=(0, 0.3, 1), look_at=(0, 0, -1.2),
                          dtype=torch.float64, device="cpu")
    return b.build(dtype=torch.float64, device="cpu"), cam


@pytest.mark.parametrize("which", ["material_mix", "random_bouncing"])
def test_gradients_finite(which):
    """No NaN or inf through metal, glass, checkers, motion and triangles
    (tests/test_grad.py:98), nor on random_bouncing, whose grazing rays
    reach refract's square root at exactly 0."""
    if which == "material_mix":
        scene, cam = _material_mix()
        cfg = rtt.RenderConfig(spp=2, max_depth=5)
    else:
        scene, cam = rtt.scenes.random_bouncing(width=32, height=32,
                                                device="cpu")
        cfg = rtt.RenderConfig(spp=1, max_depth=6, chunk_size=1 << 16)
    fields = tuple(f for f in rtt.DEFAULT_TRAINABLE
                   if getattr(scene, f).numel())
    _, grads = _grads(scene, cam, cfg, fields, seed=3)
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
    assert float(grads["tex_color"].abs().sum()) > 0


def test_render_independent_of_matmul_precision():
    scene, cam = golden_scene(rtt, device="cpu")
    cfg = rtt.RenderConfig(**DET)
    ref = rtt.render(scene, cam, 0, cfg)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        assert torch.equal(rtt.render(scene, cam, 0, cfg), ref)
    finally:
        torch.set_float32_matmul_precision(prev)


def _nested():
    b = rtt.SceneBuilder()
    e = b.add_solid_texture((0.1, 0.1, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    outer = b.add_checker_texture(1.1, b.add_checker_texture(0.3, e, o), o)
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(texture=outer))
    cam = rtt.make_camera(width=8, height=8, vfov=60.0, focus_dist=1.0,
                          device="cpu")
    return b.build(device="cpu"), cam


def test_engine_dispatch(monkeypatch):
    """"xla" runs the dense integrator; auto takes it for nested checkers,
    for a scene with no primitive and beyond the streamed tables."""
    cfg = rtt.RenderConfig(spp=2, max_depth=3)
    nested, cam = _nested()
    assert engine.pick_engine(nested) == "xla"
    assert torch.equal(rtt.render_fast(nested, cam, 1, cfg),
                       rtt.render(nested, cam, 1, cfg))
    empty = rtt.SceneBuilder().build(device="cpu")
    assert engine.pick_engine(empty) == "xla"
    sky = rtt.render_fast(empty, cam, 1, cfg)
    assert bool((sky > 0).all())
    small, scam = rtt.scenes.random_bouncing(width=8, height=4, device="cpu")
    assert engine.pick_engine(small, "xla") == "xla"
    assert torch.equal(rtt.render_fast(small, scam, 1, cfg, engine="xla",
                                       budget=3),
                       rtt.render_jit(small, scam, 1, cfg))
    monkeypatch.setattr(engine, "fits_shared", lambda scene: False)
    monkeypatch.setattr(engine, "fits", lambda scene, eng, **kw: False)
    assert engine.pick_engine(small) == "xla"


@pytest.mark.parametrize("entry", ["pixel_loss", "make_train_step", "fit"])
def test_allow_dense(entry):
    """A recorded engine on a scene its recorder cannot run raises, and
    with allow_dense=True renders densely with a RuntimeWarning."""
    scene, cam = _nested()
    cfg = rtt.RenderConfig(spp=1, max_depth=3)
    target = torch.zeros((8, 8, 3))
    fields = ("tex_color",)

    def run(allow):
        params = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in fields}
        if entry == "pixel_loss":
            return float(rtt.pixel_loss(params, scene, cam, 4, target, cfg,
                                        "recorded", allow_dense=allow))
        if entry == "make_train_step":
            step = rtt.make_train_step(torch.optim.SGD(params.values(),
                                                       lr=0.0), cfg,
                                       engine="recorded-pp",
                                       allow_dense=allow)
            return float(step(params, scene, cam, 4, target)[1])
        return rtt.fit(scene, cam, target, config=cfg, steps=1, fields=fields,
                       engine="recorded", allow_dense=allow)[1][0]

    with pytest.raises(ValueError, match="allow_dense=True"):
        run(False)
    with pytest.warns(RuntimeWarning, match="dense"):
        got = run(True)
    params = {f: getattr(scene, f) for f in fields}
    if entry == "fit":  # fit draws its step seeds from its generator
        assert np.isfinite(got)
    else:
        assert got == float(rtt.pixel_loss(params, scene, cam, 4, target,
                                           cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not inverse._check_recordable(scene, "dense")


def test_fit_with_defaults():
    """fit(...) with its default arguments (engine "dense", every
    trainable field) takes its steps."""
    scene, cam = rtt.scenes.random_bouncing(width=16, height=8, device="cpu")
    cfg = rtt.RenderConfig(spp=1, max_depth=4)
    target = rtt.render_fast(scene, cam, 0, cfg)
    fitted, hist = rtt.fit(scene, cam, target, config=cfg, steps=2)
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert not torch.equal(fitted.tex_color, scene.tex_color)


def _render_stacked(scene, cam, seed, cfg):
    """The dense render before its memory repair: every chunk's radiance
    kept, stacked to [spp, H*W, 3] and summed pass by pass afterwards. The
    yardstick of the repaired accumulation's bits."""
    from rayz_tpu_torch.ops.diffkernel import _camera_rays, _make_rand

    n_px = cam.height * cam.width
    items = n_px * cfg.spp
    chunk = min(cfg.chunk_size or n_px, items)
    parts = []
    for i0 in range(0, items, chunk):
        item = torch.arange(i0, min(i0 + chunk, items), dtype=torch.int64)
        pix = (item % n_px).to(torch.int32)
        o, d, tm = _camera_rays(cam, seed, pix, item // n_px, cfg.jitter)
        rand = _make_rand(seed, pix, item // n_px, cfg.max_depth).to(o.dtype)
        parts.append(rtt.trace_rays(scene, o, d, tm, rand,
                                    max_depth=cfg.max_depth, t_min=cfg.t_min))
    rad = torch.cat(parts).reshape(cfg.spp, n_px, 3)
    acc = rad[0]
    for s in range(1, cfg.spp):
        acc = acc + rad[s]
    return (acc / cfg.spp).reshape(cam.height, cam.width, 3)


def _peak_bytes(fn) -> int:
    """Most bytes the CPU allocator held at once while ``fn`` ran, from the
    profiler's allocation and free events in time order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    cur = top = 0
    for e in events:
        cur += e.nbytes()
        top = max(top, cur)
    return top


@pytest.mark.parametrize("chunk", [None, 100, 700], ids=["pass", "chunk100",
                                                        "chunk700"])
def test_peak_memory_flat_in_spp(chunk):
    """The repaired accumulation: the peak does not grow with the spp (the
    stacked form's [spp, H*W, 3] grew it), and the image is the stacked
    form's bit for bit (a 700-ray chunk spans passes of 512 pixels)."""
    scene, cam = rtt.scenes.two_sphere(width=32, height=16, device="cpu")
    peaks = {}
    for spp in (2, 8):
        cfg = rtt.RenderConfig(spp=spp, max_depth=3, chunk_size=chunk)
        with torch.no_grad():
            img = rtt.render(scene, cam, 5, cfg)
            assert torch.equal(img, _render_stacked(scene, cam, 5, cfg))
            peaks[spp] = _peak_bytes(lambda: rtt.render(scene, cam, 5, cfg))
    assert peaks[8] <= 1.05 * peaks[2], peaks


def test_render_pixels_is_any_subset_of_render():
    """render_pixels over any subset of pixel ids, in any order and at any
    chunking, equals the matching rows of render bit for bit; the empty
    subset renders nothing."""
    scene, cam = _unit_scene()
    cfg = rtt.RenderConfig(spp=3, max_depth=4)
    full = rtt.render(scene, cam, 2, cfg).reshape(-1, 3)
    r = np.random.default_rng(0)
    for n, chunk in ((1, None), (37, None), (37, 10), (100, 250)):
        pix = torch.from_numpy(r.choice(full.shape[0], n, replace=False))
        got = rtt.ops.render_pixels(scene, cam, 2, pix,
                                    cfg._replace(chunk_size=chunk))
        assert torch.equal(got, full[pix])
    none = torch.zeros(0, dtype=torch.int64)
    assert rtt.ops.render_pixels(scene, cam, 2, none, cfg).shape == (0, 3)
    with pytest.raises(ValueError, match="integer"):
        rtt.ops.render_pixels(scene, cam, 2, torch.zeros(3), cfg)
