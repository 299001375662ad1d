"""The port's training API (rayz_tpu_torch/diff/inverse.py) against the JAX
package on a deterministic config, and its refusals. On the CPU the
recorder and the gathers run their plain torch versions.

The comparison scene is tests/test_pathrec.py's ``_metal_scene`` with
jitter off and fuzz-0 metal, so no random draw changes a path. The
recorded unit vector still enters the fuzz gradient (d dir / d fuzz), so
the port's recorder draws zero bits here, as the JAX interpreter does. The
JAX side runs its default f32 configuration (the fused replay,
interpreted); the port replays unfused (``fused=False``, the JAX oracle
configuration), so the two agree to float rounding.

Tolerances: loss within 1e-5 relative, gradients within 1e-4 relative to
each field's largest entry, images 1e-5 abs; loss histories of three Adam
steps within 1e-4 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.diff import extract_params as jextract, fit as jfit
from rayz_tpu.diff import pixel_loss as jpixel_loss
from rayz_tpu.ops.pathrec import render_diff_pp as jrender_diff_pp
from rayz_tpu_torch.diff import inverse
from rayz_tpu_torch.ops import _build, pathrec as tpr, tables

torch.set_num_threads(2)

STATICS = ("n_spheres", "n_triangles", "has_motion", "deep_checker",
           "tex_depth", "uniq_checker_tex", "uniq_dielectric_mat")


def _metal_scene(m, dtype):
    b = m.SceneBuilder()
    mt = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, mt)
    b.add_sphere((0, 0, -2), 0.5, b.add_metallic(color=(0.6, 0.8, 0.9),
                                                 fuzz=0.0))
    cam = m.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                        look_from=(0, 0, 0), look_at=(0, 0, -1), dtype=dtype)
    return b.build(dtype=dtype), cam


def _pair():
    jscene, jcam = _metal_scene(rt, jnp.float32)
    leaves = {f.name: np.asarray(getattr(jscene, f.name))
              for f in dataclasses.fields(jscene) if f.name not in STATICS}
    scene = rtt.scene_from_numpy(leaves,
                                 **{k: getattr(jscene, k) for k in STATICS})
    cam = rtt.camera_from_numpy(
        {f.name: np.asarray(getattr(jcam, f.name))
         for f in dataclasses.fields(jcam)
         if f.name not in ("height", "width")},
        height=jcam.height, width=jcam.width)
    return jscene, jcam, scene, cam


TARGET = np.full((16, 16, 3), 0.3, np.float32)


@pytest.fixture
def zero_bits(monkeypatch):
    """Route the port's recorder to its plain version with zero random
    bits, as the JAX interpreter draws."""
    monkeypatch.setattr(tpr, "_record_slots", functools.partial(
        tpr._record_slots_reference, bits=lambda key, n: torch.zeros_like(
            key)))


def _leaf_params(jscene):
    """The JAX extract_params carried across, as trainable leaves."""
    arrays = {k: np.array(v) for k, v in jextract(jscene).items()}
    params = rtt.params_from_numpy(arrays)
    for k, v in params.items():
        assert v.dtype == torch.from_numpy(arrays[k]).dtype, k
    return {k: v.requires_grad_(True) for k, v in params.items()}


def _assert_grads(got, want):
    for name, b in want.items():
        b = np.asarray(b)
        a = got[name]
        a = np.zeros_like(b) if a is None else a.numpy()
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_pixel_loss_and_grads_match_jax(zero_bits):
    jscene, jcam, scene, cam = _pair()
    cfg = dict(spp=1, max_depth=4, jitter=False)
    jl, jg = jax.value_and_grad(jpixel_loss)(
        jextract(jscene), jscene, jcam, 0, jnp.asarray(TARGET),
        rt.RenderConfig(**cfg), "recorded-pp")
    params = _leaf_params(jscene)
    loss, left = rtt.pixel_loss(params, scene, cam, 0,
                                torch.from_numpy(TARGET),
                                rtt.RenderConfig(**cfg), "recorded-pp",
                                return_leftover=True)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    assert int(left) == 0
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_grads(dict(zip(params, grads)), jg)
    assert float(grads[list(params).index("tex_color")].abs().sum()) > 0


def test_compacted_render_and_grads_match_jax(zero_bits):
    """A starved first pass (2 iterations) and a resumed pass finishing
    the exhaustive budget: the carry handoff and the scatter-back, in both
    packages, image and gradients."""
    jscene, jcam, scene, cam = _pair()
    cfg = dict(spp=2, max_depth=4, jitter=False)

    def jloss(p):
        img, left = jrender_diff_pp(rt.diff.inject_params(jscene, p), jcam,
                                    0, rt.RenderConfig(**cfg), iters=2,
                                    compact=True, return_leftover=True)
        return jnp.sum(img ** 2), (img, left)

    (_, (jimg, jleft)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jextract(jscene))
    params = _leaf_params(jscene)
    img, left = tpr.render_diff_pp(rtt.inject_params(scene, params), cam, 0,
                                   rtt.RenderConfig(**cfg), iters=2,
                                   compact=True, return_leftover=True)
    grads = torch.autograd.grad((img ** 2).sum(), list(params.values()),
                                allow_unused=True)
    assert int(left) == int(jleft) == 0
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=1e-5)
    _assert_grads(dict(zip(params, grads)), jg)


def test_fit_tracks_jax_loss_history(zero_bits):
    jscene, jcam, scene, cam = _pair()
    cfg = dict(spp=1, max_depth=4, jitter=False)
    _, want = jfit(jscene, jcam, jnp.asarray(TARGET),
                   config=rt.RenderConfig(**cfg), steps=3,
                   engine="recorded-pp", learning_rate=1e-2)
    fitted, got = rtt.fit(scene, cam, torch.from_numpy(TARGET),
                          config=rtt.RenderConfig(**cfg), steps=3,
                          engine="recorded-pp", learning_rate=1e-2)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(got)) == 3  # the parameters moved
    assert not fitted.tex_color.requires_grad
    assert not torch.equal(fitted.tex_color, scene.tex_color)


def test_make_train_step_updates_params():
    _, _, scene, cam = _pair()
    cfg = rtt.RenderConfig(spp=1, max_depth=4, jitter=False)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in rtt.extract_params(scene, ("tex_color",)).items()}
    before = params["tex_color"].detach().clone()
    step = rtt.make_train_step(torch.optim.Adam(params.values(), lr=1e-2),
                               cfg, engine="recorded-pp", with_leftover=True)
    out, loss, left = step(params, scene, cam, 0, torch.from_numpy(TARGET))
    assert out is params and int(left) == 0 and np.isfinite(float(loss))
    assert not torch.equal(params["tex_color"].detach(), before)
    strict = rtt.make_train_step(torch.optim.SGD(params.values(), lr=0.1),
                                 cfg, engine="recorded-pp", strict=True)
    assert len(strict(params, scene, cam, 1, torch.from_numpy(TARGET))) == 2


# ---- 9. refusals ----

def test_fit_raises_on_truncation():
    _, _, scene, cam = _pair()
    cfg = rtt.RenderConfig(spp=4, max_depth=6, jitter=False)
    target = torch.zeros((16, 16, 3))
    with pytest.raises(RuntimeError, match="truncated"):
        rtt.fit(scene, cam, target, config=cfg, steps=1,
                engine="recorded-pp", iters=2)
    _, hist = rtt.fit(scene, cam, target, config=cfg, steps=1,
                      engine="recorded-pp", strict=True)
    assert len(hist) == 1 and np.isfinite(hist[0])


def test_check_recordable_raises():
    b = rtt.SceneBuilder()
    e = b.add_solid_texture((0.1, 0.1, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    inner = b.add_checker_texture(0.3, e, o)
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(
        texture=b.add_checker_texture(1.1, inner, o)))
    nested = b.build(device="cpu")
    assert nested.deep_checker
    with pytest.raises(ValueError, match="checker"):
        inverse._check_recordable(nested, "recorded-pp")
    big, cam = rtt.scenes.sphere_field(n=14_000, width=8, device="cpu")
    assert not rtt.ops.fits_shared(big) and not tpr.supports_pp(big)
    with pytest.raises(ValueError, match="shared memory.*'recorded'"):
        inverse._check_recordable(big, "recorded-pp")
    with pytest.raises(ValueError, match="shared memory"):
        tpr.record_pp(big, cam, 0, torch.zeros(64, dtype=torch.int32),
                      spp=1, max_depth=2, t_min=1e-3, jitter=False, iters=1)
    cfg = rtt.RenderConfig(spp=1, max_depth=2)
    with pytest.raises(ValueError, match="checker"):
        tpr.render_diff_pp(nested, rtt.make_camera(width=8, height=8,
                                                    device="cpu"), 0,
                           cfg)


def test_unported_paths_raise(tmp_path):
    _, _, scene, cam = _pair()
    cfg = rtt.RenderConfig(spp=1, max_depth=2, jitter=False)
    params = rtt.extract_params(scene)
    target = torch.zeros((16, 16, 3))
    # the dense engine (ROADMAP queue 1 item 4) raised here until it was
    # ported; it is the default now
    loss = rtt.pixel_loss(params, scene, cam, 0, target, cfg, "dense")
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert callable(rtt.make_train_step(None, cfg, engine="dense"))
    with pytest.raises(ValueError, match="unknown engine"):
        rtt.make_train_step(None, cfg, engine="fused")
    # the mesh path and fit's checkpoints raised NotImplementedError here
    # until they were ported; now a mesh step runs (a world of one: every
    # pixel on this rank) and equals the single-device step, and a
    # checkpointed fit runs and saves
    from rayz_tpu_torch.parallel import make_mesh
    import torch.distributed as dist

    try:
        mesh = make_mesh("cpu")
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        opt = torch.optim.SGD(list(p.values()), lr=0.0)
        step = rtt.make_train_step(opt, cfg, mesh, engine="recorded-pp",
                                   with_leftover=True)
        _, mloss, left = step(p, scene, cam, 0, target)
    finally:
        dist.destroy_process_group()
    ploss = rtt.pixel_loss(params, scene, cam, 0, target, cfg, "recorded-pp")
    assert int(left) == 0
    assert abs(mloss.item() - ploss.item()) <= 1e-6 * ploss.item()
    ckpt = str(tmp_path / "ckpt")
    _, hist = rtt.fit(scene, cam, target, config=cfg, engine="recorded-pp",
                      steps=2, fields=("tex_color",), checkpoint_dir=ckpt)
    assert len(hist) == 2 and rtt.diff.latest_step(ckpt) == 2


def test_cuda_path_raises_without_card(monkeypatch):
    """Only CPU tensors take the plain versions: another device raises,
    and without the CUDA toolkit the kernels cannot be built."""
    _, _, scene, cam = _pair()
    tab = torch.zeros((4, 20), device="meta")
    idx = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no gather kernel"):
        tpr._gather_fwd(tab, idx, False)
    with pytest.raises(ValueError, match="no gather kernel"):
        tpr._gather_bwd(torch.zeros((8, 20), device="meta"), idx, 4, False)
    layout = tables.resolve(scene, "record_pp")
    stab = torch.zeros((17, layout.n_pad), device="meta")
    ttab = torch.zeros((20, layout.m_pad), device="meta")
    with pytest.raises(ValueError, match="no record kernel"):
        tpr._record_slots(torch.zeros(18, device="meta"), stab, ttab, idx,
                          width=4, spp=1, max_depth=2, t_min=1e-3,
                          jitter=False, has_motion=False, seed=0, iters=1,
                          layout=layout)
    k_it, r = 2, 4
    rows = torch.zeros((20, k_it * r), device="meta")
    aux = torch.zeros((k_it, 13, r), device="meta")
    ridx = torch.zeros((k_it, r), dtype=torch.int32, device="meta")
    st = torch.zeros((10, r), device="meta")
    cfg = tpr._replay_cfg(scene, 1e-3)
    with pytest.raises(ValueError, match="no replay kernel"):
        tpr._fused_fwd(rows, aux, ridx, st, cfg)
    with pytest.raises(ValueError, match="no replay kernel"):
        tpr._fused_bwd(rows, aux, ridx, torch.zeros((10, k_it, r),
                                                    device="meta"),
                       torch.zeros((3, r), device="meta"), st, cfg)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
