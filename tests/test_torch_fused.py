"""The port's fused replay (rayz_tpu_torch/ops/pathrec.py: _pp_step,
_fused_fwd_reference, _fused_bwd_reference, replay_pp_fused) against the
JAX package's (rayz_tpu/ops/pathrec.py: _pp_step_c, replay_pp_fused), and
against the port's eager replay. On the CPU the wrappers run the plain
versions, which chip_smoke.py holds the CUDA kernels against on the card.

The JAX fused kernels run interpreted (``interpret=True``), as
tests/test_pathrec.py runs them. Inputs are made from numpy seeds, or
recorded by the JAX package with its interpreter's zero random bits, and
carried across as numpy.

Tolerances:
* one step (``_pp_step`` vs ``_pp_step_c``) and its VJP, float32: values
  within 2e-5 * max(1, |x|), cotangents within 1e-4 of each component's
  largest |x| (at least 1): XLA:CPU contracts multiply-adds and its rsqrt
  is not 1/sqrt;
* the fused replay against JAX: radiance and final carry within 1e-5 abs
  (the carry also 1e-5 relative, its positions reach 100), gradients
  within 5e-4 * max(1, largest |ref|) per field, the bound of
  tests/test_pathrec.py's fused-vs-scan check;
* the port's fused replay against its eager replay: 1e-6 abs on values,
  1e-5 of each field's largest gradient (the same arithmetic in another
  formulation, both rounded by torch on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.diff import extract_params as jextract
from rayz_tpu.ops import diffkernel as jdk, pathrec as jpr
from rayz_tpu_torch.ops import pathrec as tpr
from test_torch_pathrec import _mixed_scene, _port, _replay_case

torch.set_num_threads(2)


# ---- (a) one step and its VJP against _pp_step_c / jax.vjp ----

def _step_scene():
    """Spheres (a moving fuzz-1.0 metal, glass, hemisphere and unit-sphere
    diffuse, a radius-100 ground) and triangles (diffuse, metal, glass)."""
    b = rt.SceneBuilder()
    unit = rt.models.scene.DIFFUSE_UNIT_SPHERE
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_diffuse(color=(0.5, 0.6, 0.5), method=unit))
    b.add_sphere((-0.7, 0, -2), 0.45,
                 b.add_metallic(color=(0.9, 0.8, 0.7), fuzz=1.0),
                 velocity=(0.1, 0.05, -0.02))
    b.add_sphere((0.7, 0, -2), 0.45, b.add_dielectric(1.5))
    b.add_sphere((0, 0.9, -2.2), 0.3, b.add_diffuse(color=(0.2, 0.3, 0.8)))
    b.add_triangle((-0.4, 0.8, -2.5), (0.4, 0.8, -2.5), (0, 1.5, -2.5),
                   b.add_diffuse(color=(0.8, 0.2, 0.2), method=unit))
    b.add_triangle((-1.5, -0.4, -3.0), (1.5, -0.4, -3.0), (0, 1.8, -3.2),
                   b.add_metallic(color=(0.7, 0.8, 0.9), fuzz=0.3))
    b.add_triangle((0.9, -0.3, -1.5), (1.4, -0.3, -1.6), (1.1, 0.4, -1.6),
                   b.add_dielectric(1.3))
    return b.build(dtype=jnp.float32)


def _tir_lane(tab, glass: int):
    """A ray inside the glass sphere, running nearly along its surface:
    the refraction is impossible (eta * sin > 1), so it reflects."""
    c, r = tab[glass, 0:3].astype(np.float64), float(tab[glass, 6])
    o = c + np.array([0.9 * r, 0.0, 0.0])
    d = np.array([0.0, 1.0, 0.0])
    disc = (d @ (c - o)) ** 2 - (o - c) @ (o - c) + r * r
    p = o + (d @ (c - o) + np.sqrt(disc)) * d
    cos_t = d @ ((p - c) / r)  # inside: the normal faces the ray
    assert float(tab[glass, 12]) * np.sqrt(1 - cos_t ** 2) > 1.0
    return o, d


def _lanes(tab, n_sph: int, cand, *, sph: bool, r: int, seed: int):
    """Carry, rows, aux and index of r lanes: rays aimed at primitives of
    ``cand`` (rows of ``tab``; as the carry, or as the recorded spawn ray
    on spawn lanes, whose carry is noise), recorded misses and idle lanes
    on all-zero rows, random flags; lane 0 is a TIR lane, lane 1 continues
    off the fuzz-1.0 metal (when spheres are in)."""
    g = np.random.default_rng(seed)
    prim = g.choice(cand, r)
    geo = tab[prim].astype(np.float64)
    is_s = prim < n_sph
    aim = np.where(is_s[:, None], geo[:, 0:3] + 0.3 * geo[:, 6:7]
                   * g.normal(size=(r, 3)),
                   (geo[:, 0:3] + geo[:, 3:6] + geo[:, 6:9]) / 3.0)
    ground = is_s & (prim == 0)
    aim[ground] = g.uniform(-2, 2, (int(ground.sum()), 3)) * [1, 0, 1] + [
        0, -0.5, -2]  # points on the ground's top
    o = aim + g.normal(size=(r, 3)) * [1.5, 0.5, 1.5] + [0, 1.0, 1.5]
    d = (aim - o) * g.uniform(0.5, 2.0, (r, 1))
    tau = g.uniform(0, 1, r)
    th = g.uniform(0.2, 1.0, (r, 3))
    flg = g.choice([0.0, 1.0, 2.0, 3.0], r, p=[0.2, 0.2, 0.4, 0.2])
    idx = prim.astype(np.int32)
    u = g.normal(size=(r, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    kind = g.uniform(size=r)
    idx[kind < 0.15] = -1                      # recorded misses
    flg[kind < 0.15] = np.where(flg[kind < 0.15] >= 2, 1.0, 0.0)
    idle = (kind >= 0.15) & (kind < 0.2)
    idx[idle], flg[idle] = -2, 0.0
    if sph:
        glass = int(np.flatnonzero(tab[:n_sph, 9] == 2.0)[0])
        metal = int(np.flatnonzero(tab[:n_sph, 11] == 1.0)[0])
        o[0], d[0] = _tir_lane(tab, glass)
        idx[0], flg[0] = glass, 2.0
        idx[1], flg[1] = metal, 2.0
        o[1], d[1] = [-0.7, 0.6, -0.8], [0.0, -0.5, -1.0]
    rows = np.where((idx >= 0)[:, None], tab[np.maximum(idx, 0)], 0.0)
    spawn = (flg == 1) | (flg == 3)
    st = np.concatenate([o.T, d.T, tau[None], th.T])
    aux = np.concatenate([u.T, g.uniform(0, 1, (1, r)) ** (1 / 3),
                          g.uniform(0, 1, (1, r)), o.T, d.T, tau[None],
                          flg[None]])
    aux[5:12, ~spawn] = 0.0
    st[:, spawn] = g.normal(size=(10, int(spawn.sum())))
    f32 = np.float32
    return st.astype(f32), rows.T.astype(f32), aux.astype(f32), idx


@pytest.mark.parametrize("case", ["spheres", "triangles", "mixed_motion"])
def test_step_and_vjp_match_jax(case):
    jscene = _step_scene()
    tab = np.asarray(jdk._diff_tables(jscene))
    n_sph = int(jscene.sphere_radius.shape[0])  # padded
    sph, tri = case != "triangles", case != "spheres"
    if not sph:  # a triangle-only table starts at row 0
        tab, n_sph = tab[n_sph:], 0
    cand = (list(range(jscene.n_spheres)) if sph else []) + (
        list(range(n_sph, n_sph + jscene.n_triangles)) if tri else [])
    st, rows, aux, idx = _lanes(tab, n_sph, cand, sph=sph, r=512,
                                seed=len(case))
    kw = dict(has_motion=case == "mixed_motion", with_sph=sph, with_tri=tri,
              t_min=1e-3)
    g = np.random.default_rng(7)
    d_st = g.standard_normal((10, 512)).astype(np.float32)
    d_out = g.standard_normal((3, 512)).astype(np.float32)

    masks = (idx >= 0, idx == -1, idx >= n_sph)
    jaux = tuple(jnp.asarray(a) for a in aux)
    jmasks = tuple(jnp.asarray(m) for m in masks)
    (jst, jout), vjp = jax.vjp(
        lambda s, w: jpr._pp_step_c(s, w, jaux, *jmasks, **kw),
        tuple(jnp.asarray(a) for a in st), tuple(jnp.asarray(a) for a in rows))
    want_dst, want_drow = vjp((tuple(jnp.asarray(a) for a in d_st),
                               tuple(jnp.asarray(a) for a in d_out)))

    tst = torch.from_numpy(st).requires_grad_(True)
    trow = torch.from_numpy(rows).requires_grad_(True)
    new, out = tpr._pp_step(
        tuple(tst.unbind()), tuple(trow.unbind()),
        tuple(torch.from_numpy(aux).unbind()),
        *(torch.from_numpy(m) for m in masks), **kw)
    got_dst, got_drow = torch.autograd.grad(
        new + out, (tst, trow),
        grad_outputs=tuple(torch.from_numpy(d_st)) + tuple(
            torch.from_numpy(d_out)))

    for name, a, b in (("carry", torch.stack(new), jst),
                       ("radiance", torch.stack(out), jout)):
        a, b = a.detach().numpy(), np.stack(b)
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=name)
    for name, a, b in (("d carry", got_dst, want_dst),
                       ("d rows", got_drow, want_drow)):
        a, b = a.numpy(), np.stack(b)
        assert np.isfinite(a).all(), name
        err = np.abs(a - b) / np.maximum(np.abs(b).max(axis=1,
                                                     keepdims=True), 1.0)
        worst = np.unravel_index(err.argmax(), err.shape)
        assert err.max() <= 1e-4, (name, float(err.max()), worst)
    # the lanes exercise what they should
    cont = aux[12] >= 2
    assert (cont & (idx >= 0)).sum() > 100 and (idx == -1).sum() > 20
    if sph:
        assert got_drow[11, 1] != 0  # the fuzz-1.0 metal's tie gradient
    if sph and tri:
        assert ((idx >= n_sph) & cont).sum() > 20 and (
            (idx >= 0) & (idx < n_sph) & cont).sum() > 20


# ---- (b) replay_pp_fused against the JAX fused replay ----

def _fused_jax(jscene, idx, aux, carry, rs):
    def f(p, ic):
        s = rt.diff.inject_params(jscene, p)
        out, fin = jpr.replay_pp_fused(s, jnp.asarray(idx), jnp.asarray(aux),
                                       t_min=1e-3, tile_sublanes=rs,
                                       interpret=True, init_carry=ic,
                                       return_final=True)
        return jnp.sum(out ** 2) + jnp.sum(fin[7:10] ** 2), (out, fin)

    (_, (out, fin)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(
        jextract(jscene), jnp.asarray(carry, jnp.float32))
    return (np.asarray(out), np.asarray(fin),
            {k: np.asarray(v) for k, v in grads[0].items()},
            np.asarray(grads[1]))


def _fused_port(scene, idx, aux, carry, replay):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in rtt.extract_params(scene).items()}
    ic = torch.tensor(carry, dtype=torch.float32, requires_grad=True)
    out, fin = replay(rtt.inject_params(scene, params),
                      torch.from_numpy(idx), torch.from_numpy(aux),
                      t_min=1e-3, init_carry=ic, return_final=True)
    loss = (out ** 2).sum() + (fin[7:10] ** 2).sum()
    grads = torch.autograd.grad(loss, list(params.values()) + [ic],
                                allow_unused=True)
    g = {k: (torch.zeros_like(v) if d is None else d).numpy()
         for (k, v), d in zip(params.items(), grads)}
    return out.detach().numpy(), fin.detach().numpy(), g, grads[-1].numpy()


@functools.lru_cache(maxsize=1)
def _case():
    jscene, scene, idx, aux, carry = _replay_case(jnp.float32)
    carry = carry.astype(np.float32)
    return jscene, scene, idx, aux, carry


def test_replay_pp_fused_matches_jax_fused():
    jscene, scene, idx, aux, carry = _case()
    rs = idx.shape[1] // 128
    want = _fused_jax(jscene, idx, aux, carry, rs)
    got = _fused_port(scene, idx, aux, carry, tpr.replay_pp_fused)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5,
                               err_msg="radiance")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5,
                               err_msg="final carry")
    assert got[0].std() > 0.01  # the recording is not trivial
    for name in list(want[2]) + ["init_carry"]:
        a = got[3] if name == "init_carry" else got[2][name]
        b = want[3] if name == "init_carry" else want[2][name]
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(
            a, b, rtol=0, atol=5e-4 * max(1.0, float(np.abs(b).max())),
            err_msg=name)
    assert np.abs(got[3]).max() > 0  # the initial carry reaches the loss


# ---- (c) the port's fused replay against its eager replay ----

def test_fused_matches_eager_replay():
    _, scene, idx, aux, carry = _case()
    fused = _fused_port(scene, idx, aux, carry, tpr.replay_pp_fused)
    steps = tpr.REPLAY_STEPS
    eager = _fused_port(scene, idx, aux, carry, tpr.replay_pp)
    assert tpr.REPLAY_STEPS > steps
    np.testing.assert_allclose(fused[0], eager[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(fused[1], eager[1], rtol=1e-6, atol=1e-6)
    for name in list(eager[2]) + ["init_carry"]:
        a = fused[3] if name == "init_carry" else fused[2][name]
        b = eager[3] if name == "init_carry" else eager[2][name]
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


# ---- (d) which replay render_diff_pp_flat takes ----

@pytest.mark.parametrize("dtype,fused,takes", [
    (torch.float32, None, "fused"), (torch.float64, None, "eager"),
    (torch.float32, True, "fused"), (torch.float32, False, "eager")],
    ids=["f32_default", "f64_default", "f32_fused", "f32_unfused"])
def test_fused_default_follows_dtype(monkeypatch, dtype, fused, takes):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    scene, cam = _port(*_mixed_scene(rt, jdtype))
    calls = []
    real = tpr.replay_pp_fused

    def spy(*a, **k):
        calls.append("fused")
        return real(*a, **k)

    monkeypatch.setattr(tpr, "replay_pp_fused", spy)
    px, py = tpr._pixel_grid(cam)
    steps = tpr.REPLAY_STEPS
    img, left = tpr.render_diff_pp_flat(scene, cam, 1, px, py, spp=1,
                                        max_depth=3, t_min=1e-3,
                                        jitter=True, fused=fused,
                                        return_leftover=True)
    assert int(left) == 0 and img.dtype == dtype
    assert bool(torch.isfinite(img).all()) and float(img.std()) > 0
    if takes == "fused":
        assert calls and tpr.REPLAY_STEPS == steps
    else:
        assert not calls and tpr.REPLAY_STEPS > steps


# ---- (e) the kernels on the card ----

@pytest.fixture
def cuda_device():
    """Decided per test (never at import): the kernels need the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replay_kernels_match_plain_on_card(cuda_device):
    scene, cam = rtt.scenes.three_sphere(width=32, height=18,
                                         device=cuda_device)
    pix = torch.arange(640, dtype=torch.int32, device=cuda_device)
    pix = torch.where(pix < 576, pix, -1)
    idx, aux, _ = tpr.record_pp(scene, cam, 1, pix, spp=4, max_depth=8,
                                t_min=1e-3, jitter=True, iters=32)
    cfg = tpr._replay_cfg(scene, 1e-3)
    rows = tpr.gather_rows_T(tpr._diff_tables(scene).detach().float(),
                             idx.reshape(-1))
    st0 = tpr._default_carry(640, device=cuda_device)
    before = dict(tpr.LAUNCHES)
    k = tpr._fused_fwd(rows, aux, idx, st0, cfg)
    p = tpr._fused_fwd_reference(rows, aux, idx, st0, cfg)
    g = torch.Generator().manual_seed(0)
    g_out = torch.randn(3, 640, generator=g).to(cuda_device)
    g_fin = torch.randn(10, 640, generator=g).to(cuda_device)
    dk = tpr._fused_bwd(rows, aux, idx, k[2], g_out, g_fin, cfg)
    dp = tpr._fused_bwd_reference(rows, aux, idx, p[2], g_out, g_fin, cfg)
    assert tpr.LAUNCHES["replay_fwd"] == before["replay_fwd"] + 1
    assert tpr.LAUNCHES["replay_bwd"] == before["replay_bwd"] + 1
    live = idx >= -1
    torch.testing.assert_close(k[0], p[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k[1], p[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k[2][:, live], p[2][:, live], rtol=1e-4,
                               atol=1e-4)
    for a, b in ((dk[0], dp[0]), (dk[1], dp[1])):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * scale)
