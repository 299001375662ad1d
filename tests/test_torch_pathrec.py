"""The port's persistent-path record/replay (rayz_tpu_torch/ops/pathrec.py)
against the JAX package, and the port's own invariants. On the CPU the
recorder and the gathers run their plain torch versions, which is what the
CUDA kernels are held against on the card (chip_smoke.py).

The JAX kernels run as tests/test_pathrec.py runs them (interpret mode),
where the recorder's PRNG returns zero bits; the port's recorder takes a
zero-bits hook for those comparisons. Inputs are built by the JAX package
and carried across as numpy (``scene_from_numpy``/``params_from_numpy``).

Tolerances:
* recorder: winner indices identical on the metal, golden and
  triangle-offset scenes, on >= 99.9% of active lane-iterations of the
  mixed scene; aux rows within 1e-5 where a slot is active (the JAX
  recorder writes computed randoms on the idle lanes of a working tile,
  the port zeros), flags everywhere. XLA:CPU contracts multiply-adds and
  takes a Newton reciprocal in the triangle test, the port rounds every
  operation, so values agree to float rounding, not bit for bit;
* gathers: forward within 2^-23 relative (JAX's three-term bf16 split
  carries f32 rounding), table cotangent within 1e-5 of the sum of |g|
  over each row's rays;
* replay on one recording: f32 radiance within 1e-5 abs (the final carry
  also 1e-5 relative, its positions reach 100), gradients within 1e-4
  relative to each field's largest entry; f64 within 1e-10 relative;
* saved recorder state: 1e-3 relative (rays after a few bounces off
  curved mirrors, which magnify rounding);
* compaction vs one exhaustive pass: 1e-6 abs per channel (the same paths,
  summed in another order);
* recorded forward vs the megakernel, real draws: the chip_smoke.py
  thresholds (< 1% of channels off by > 1e-4, 8x8 block means within
  0.01);
* finite differences (f64): the bound of tests/test_pathrec.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.diff import extract_params as jextract
from rayz_tpu.ops import diffkernel as jdk, pathrec as jpr
from rayz_tpu.ops.integrator import _pixel_grid as jpixel_grid
from rayz_tpu_torch.ops import diffkernel as tdk, pathrec as tpr, tables

torch.set_num_threads(2)

STATICS = ("n_spheres", "n_triangles", "has_motion", "deep_checker",
           "tex_depth", "uniq_checker_tex", "uniq_dielectric_mat")
# Under 8 iterations the JAX recorder runs one iteration per grid step,
# which its interpreter traces ~8x faster.
SPP, DEPTH, ITERS = 2, 4, 7


# ---- scenes (built by either package ``m``) ----

def _metal_scene(m, dtype):
    b = m.SceneBuilder()
    mt = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, mt)
    b.add_sphere((0, 0, -2), 0.5, mt)
    cam = m.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                        look_from=(0, 0, 0), look_at=(0, 0, -1), dtype=dtype)
    return b.build(dtype=dtype), cam


def _golden_scene(m, dtype):
    """tests/test_golden.py's scene at a smaller camera."""
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
    cam = m.make_camera(width=24, height=16, vfov=55.0, focus_dist=1.0,
                        look_from=(0, 0.2, 0.6), look_at=(0, 0, -2),
                        dtype=dtype)
    return b.build(dtype=dtype), cam


def _mixed_scene(m, dtype, fuzz: float = 0.0):
    """tests/test_pathrec.py's all-branches scene; the triangle's diffuse
    is UNIT_SPHERE: with zero random bits the HEMISPHERE sample is rounding
    noise of the hit point, which no two implementations share. ``fuzz``
    is the metal's (1.0: the tie of min(fuzz, 1), as in three_sphere)."""
    b = m.SceneBuilder()
    unit = m.models.scene.DIFFUSE_UNIT_SPHERE
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_diffuse(color=(0.5, 0.5, 0.5), method=unit))
    b.add_sphere((-0.7, 0, -2), 0.45,
                 b.add_metallic(color=(0.9, 0.8, 0.7), fuzz=fuzz))
    b.add_sphere((0.7, 0, -2), 0.45, b.add_dielectric(1.5))
    b.add_triangle((-0.4, 0.8, -2.5), (0.4, 0.8, -2.5), (0, 1.5, -2.5),
                   b.add_diffuse(color=(0.8, 0.2, 0.2), method=unit))
    cam = m.make_camera(width=12, height=12, vfov=60.0, focus_dist=1.0,
                        look_from=(0, 0, 0), look_at=(0, 0, -1), dtype=dtype)
    return b.build(dtype=dtype), cam


def _tri_heavy_scene(m, dtype):
    """More triangles than spheres: the megakernel's tables pad spheres to
    16 columns here, the recorded indices must offset triangles by the
    raw 8 (the trap of ops/pathrec.record_pp's docstring)."""
    b = m.SceneBuilder()
    mt = b.add_metallic(color=(0.8, 0.8, 0.8), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, mt)
    b.add_sphere((0.9, 0, -2.2), 0.4, b.add_metallic(color=(0.9, 0.6, 0.3)))
    wall = b.add_metallic(color=(0.7, 0.8, 0.9), fuzz=0.0)
    for i in range(3):
        for j in range(3):
            b.add_quad((-1.2 + 0.4 * i, -0.3 + 0.4 * j, -2.6), (0.4, 0, 0),
                       (0, 0.4, 0.05), wall)
    cam = m.make_camera(width=16, height=12, vfov=60.0, focus_dist=1.0,
                        look_from=(0, 0.1, 0), look_at=(0, 0, -2),
                        dtype=dtype)
    return b.build(dtype=dtype), cam


# ---- carrying the JAX package's inputs across ----

def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.name not in STATICS + ("height", "width")}


def _port(jscene, jcam):
    scene = rtt.scene_from_numpy(_leaves(jscene),
                                 **{k: getattr(jscene, k) for k in STATICS})
    cam = rtt.camera_from_numpy(_leaves(jcam), height=jcam.height,
                                width=jcam.width)
    return scene, cam


def _zero_bits(key, n):
    return torch.zeros_like(key)


def _slots(jcam):
    """JAX padded pixel coordinates and the port's slot table (one tile of
    rs*128 slots, -1 past the image)."""
    px, py = jpixel_grid(jcam)
    n = px.shape[0]
    rs = max(1, -(-n // 128))
    pad = rs * 128 - n
    pxp = jnp.concatenate([px, jnp.zeros((pad,), px.dtype)])
    pyp = jnp.concatenate([py, jnp.zeros((pad,), py.dtype)])
    pix = torch.full((rs * 128,), -1, dtype=torch.int32)
    pix[:n] = torch.arange(n, dtype=torch.int32)
    return (pxp.astype(jnp.float32), pyp.astype(jnp.float32), n, rs), pix


def _jax_record(jscene, jcam, iters, init_state=None, want_state=False,
                **kw):
    (pxp, pyp, n, rs), _ = _slots(jcam)
    out = jpr.record_pp(jscene, jcam, 0, pxp, pyp, n, spp=SPP,
                        max_depth=DEPTH, t_min=1e-3, jitter=False,
                        iters=iters, tile_sublanes=rs,
                        interpret=pltpu.InterpretParams(),
                        init_state=init_state, want_state=want_state, **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_record(scene, cam, pix, iters, **kw):
    return tpr.record_pp(scene, cam, 0, pix, spp=SPP, max_depth=DEPTH,
                         t_min=1e-3, jitter=False, iters=iters, **kw)


@pytest.fixture
def zero_bits(monkeypatch):
    """Route the port's recorder to its plain version with zero random
    bits, as the JAX interpreter draws."""
    monkeypatch.setattr(tpr, "_record_slots", functools.partial(
        tpr._record_slots_reference, bits=_zero_bits))


# ---- 1. policies ----

@pytest.mark.parametrize("spp,depth", [(1, 32), (8, 32), (32, 32), (64, 8),
                                       (3, 5), (4, 6), (2, 12)])
def test_policies_match_jax(spp, depth):
    assert tpr.default_iters(spp, depth) == jpr.default_iters(spp, depth)
    assert tpr.default_k1(spp, depth) == jpr.default_k1(spp, depth)
    for r_pad, block in ((262144, 2048), (4096, 2048), (2048, 2048),
                         (256, 256), (640, 640)):
        assert (tpr.default_schedule(spp, depth, r_pad, block)
                == jpr.default_schedule(spp, depth, r_pad, block))


def test_flagship_micro_batch_schedule():
    assert tpr.default_schedule(32, 32, 262144, 2048) == [
        (112, 262144), (112, 131072), (800, 16384)]
    st0 = tpr._default_carry(256)
    np.testing.assert_array_equal(
        st0.numpy(), np.asarray(jpr._default_carry(2)).reshape(10, 256))


# ---- 2. the differentiable table ----

@pytest.mark.parametrize("recipe,dtype", [
    (_mixed_scene, jnp.float32), (_mixed_scene, jnp.float64),
    ("cornell_box", jnp.float32)], ids=["mixed", "mixed_f64", "cornell"])
def test_diff_tables_match_jax(recipe, dtype):
    if recipe == "cornell_box":
        jscene, jcam = rt.scenes.SCENES[recipe](dtype=dtype, width=16,
                                                tessellation=2)
    else:
        jscene, jcam = recipe(rt, dtype)
    scene, _ = _port(jscene, jcam)
    got = tdk._diff_tables(scene)
    want = np.asarray(jdk._diff_tables(jscene))
    assert got.dtype == scene.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert tdk.supports_diff(scene) == jdk.supports_diff(jscene)


@pytest.mark.parametrize("name", ["cornell_box", "tri_heavy"])
def test_recorded_indices_land_on_their_rows(name):
    """Every winner the recorder writes (real draws) names the
    ``_diff_tables`` row of the primitive the camera ray hits: on the
    Cornell box (no spheres, so triangles start at row 0) and on a scene
    whose megakernel tables pad spheres past the raw count."""
    if name == "cornell_box":
        scene, cam = rtt.scenes.cornell_box(width=16, tessellation=2,
                                              device="cpu")
    else:
        scene, cam = _port(*_tri_heavy_scene(rt, jnp.float32))
    n = cam.width * cam.height
    pix = torch.arange(-(-n // 128) * 128, dtype=torch.int32)
    pix = torch.where(pix < n, pix, -1)
    idx, aux, _ = tpr.record_pp(scene, cam, 1, pix, spp=1, max_depth=2,
                                t_min=1e-3, jitter=True, iters=1)
    hit = idx[0] >= 0
    row = tdk._diff_tables(scene).double()[idx[0][hit].long()]
    o = aux[0, tpr._AUX_OX:tpr._AUX_OZ + 1, hit].T.double()
    d = aux[0, tpr._AUX_DX:tpr._AUX_DZ + 1, hit].T.double()
    n_sph = int(scene.sphere_radius.shape[0]) if scene.n_spheres else 0
    tri = idx[0][hit] >= n_sph
    assert int(tri.sum()) > 0
    v0 = row[:, 0:3]
    e1, e2 = row[:, 3:6] - v0, row[:, 6:9] - v0
    pn = torch.linalg.cross(e1, e2, dim=-1)
    t = (pn * (v0 - o)).sum(-1) / (pn * d).sum(-1)
    q = o + t[:, None] * d - v0  # hit point in the triangle's frame
    d11, d12, d22 = (e1 * e1).sum(-1), (e1 * e2).sum(-1), (e2 * e2).sum(-1)
    q1, q2 = (q * e1).sum(-1), (q * e2).sum(-1)
    den = d11 * d22 - d12 * d12
    u, v = (d22 * q1 - d12 * q2) / den, (d11 * q2 - d12 * q1) / den
    inside = (t > 0) & (u >= -1e-4) & (v >= -1e-4) & (u + v <= 1 + 1e-4)
    assert bool(inside[tri].all())
    if n_sph:
        c, rad = row[:, 0:3], row[:, 6]
        oc = o - c
        b = (d * oc).sum(-1)
        disc = b * b - (d * d).sum(-1) * ((oc * oc).sum(-1) - rad * rad)
        assert bool((disc[~tri] >= 0).all())  # the ray meets that sphere


# ---- 3. the recorder against JAX record_pp ----

@pytest.mark.parametrize("recipe", [_metal_scene, _golden_scene,
                                    _mixed_scene, _tri_heavy_scene],
                         ids=["metal", "golden", "mixed", "tri_offset"])
def test_recorder_matches_jax(recipe, zero_bits):
    jscene, jcam = recipe(rt, jnp.float32)
    scene, cam = _port(jscene, jcam)
    _, pix = _slots(jcam)
    want_idx, want_aux, want_left = _jax_record(jscene, jcam, ITERS)
    got_idx, got_aux, got_left = (t.numpy() for t in
                                  _port_record(scene, cam, pix, ITERS))
    assert got_idx.shape == want_idx.shape
    assert got_aux.shape == want_aux.shape
    active = want_idx >= -1
    if recipe is _mixed_scene:
        act = active | (got_idx >= -1)
        assert (got_idx == want_idx)[act].mean() >= 0.999
    else:
        np.testing.assert_array_equal(got_idx, want_idx)
    same = (got_idx == want_idx) & active
    flg = tpr._AUX_FLG
    np.testing.assert_array_equal(got_aux[:, flg], want_aux[:, flg])
    for row in range(tpr._AUX_ROWS):
        np.testing.assert_allclose(got_aux[:, row][same],
                                   want_aux[:, row][same], atol=1e-5,
                                   err_msg=f"aux row {row}")
    np.testing.assert_array_equal(got_left, want_left)
    if recipe is _tri_heavy_scene:
        n_sph = int(scene.sphere_radius.shape[0])
        padded = tables._smem_scene_inputs(scene,
                                           tables._resolve_tiling(scene))[2]
        assert (n_sph, padded) == (8, 16)  # the offset trap is live here
        assert (got_idx >= n_sph).sum() > 0


def test_recorder_resume_matches_jax(zero_bits):
    """A 4-iteration recording's saved state, resumed for 4 more, in both
    packages: the same resumed recording and leftover."""
    jscene, jcam = _metal_scene(rt, jnp.float32)
    scene, cam = _port(jscene, jcam)
    _, pix = _slots(jcam)
    j1 = _jax_record(jscene, jcam, 4, want_state=True)
    t1 = _port_record(scene, cam, pix, 4, want_state=True)
    np.testing.assert_array_equal(t1[3][1].numpy(), j1[3][1])
    # rays after a few bounces off curved mirrors: the mirrors magnify
    # the rounding differences (no FMA, 1/sqrt for rsqrt)
    np.testing.assert_allclose(t1[3][0].numpy(), j1[3][0], rtol=1e-3,
                               atol=1e-5)
    j2 = _jax_record(jscene, jcam, 4, init_state=j1[3])
    t2 = _port_record(scene, cam, pix, 4, init_state=t1[3])
    np.testing.assert_array_equal(t2[0].numpy(), j2[0])
    np.testing.assert_array_equal(t2[2].numpy(), j2[2])
    # and the port's resumed recording continues its one-pass recording
    full = _port_record(scene, cam, pix, 8)
    np.testing.assert_array_equal(
        torch.cat([t1[0], t2[0]]).numpy(), full[0].numpy())


# ---- 4. the gathers against JAX gather_rows / gather_rows_T ----

@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "rows_T"])
def test_gathers_match_jax(transposed):
    g = np.random.default_rng(0)
    p, c, r = 37, 20, 300
    tab = g.standard_normal((p, c)).astype(np.float32)
    idx = g.integers(-2, p, r).astype(np.int32)  # negatives: no row
    cot = g.standard_normal((c, r) if transposed else (r, c)
                            ).astype(np.float32)
    jt, ji, jg = jnp.asarray(tab), jnp.asarray(idx), jnp.asarray(cot)
    if transposed:
        def jfn(t):
            return jpr.gather_rows_T(t, ji, True)[:, :r]
        tfn = tpr.gather_rows_T
    else:
        def jfn(t):
            return jpr.gather_rows(t, ji, True)
        tfn = tpr.gather_rows
    want = np.asarray(jfn(jt))
    want_d = np.asarray(jax.grad(lambda t: jnp.sum(jfn(t) * jg))(jt))

    tt = torch.from_numpy(tab).requires_grad_(True)
    got = tfn(tt, torch.from_numpy(idx))
    (got_d,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), tt)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               rtol=2.0 ** -23, atol=0)
    rows = cot.T if transposed else cot
    miss = idx < 0
    out = got.detach().numpy()
    assert not (out.T if transposed else out)[miss].any()
    mag = np.zeros((p, c))
    np.add.at(mag, idx[~miss], np.abs(rows[~miss]))
    assert (np.abs(got_d.numpy() - want_d) <= 1e-5 * mag + 1e-12).all()
    # no cotangent from a negative index
    only_miss = np.where(miss[:, None], rows, 0.0)
    (d_miss,) = torch.autograd.grad(
        (tfn(tt, torch.from_numpy(idx))
         * torch.from_numpy(only_miss.T.copy() if transposed
                            else only_miss).float()).sum(), tt)
    assert not d_miss.numpy().any()


def _bwd_indices(case: str, p: int, r: int, g) -> np.ndarray:
    if case == "out_of_range":  # -3..-1 and P..P+2: no row, no cotangent
        return g.integers(-3, p + 3, r)
    if case == "empty_row":     # row 5 gets no ray
        idx = g.integers(0, p, r)
        return np.where(idx == 5, 6, idx)
    return np.where(g.random(r) < 0.6, 2, g.integers(-1, p, r))  # hot row


@pytest.mark.parametrize("case", ["out_of_range", "empty_row", "hot_row"])
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "rows_T"])
def test_gather_backward_cases_match_jax(case, transposed):
    """The table cotangent against the f64 sum and JAX's VJP of gather_rows
    / gather_rows_T, within 1e-5 of each row's sum of |g| (the module
    docstring's bound): indices outside [0, P) add nothing, an empty row
    gets zeros, and a row holding more than half the rays sums them all."""
    g = np.random.default_rng(1)
    p, c, r = 41, 20, 400
    tab = g.standard_normal((p, c)).astype(np.float32)
    idx = _bwd_indices(case, p, r, g).astype(np.int32)
    cot = g.standard_normal((c, r) if transposed else (r, c)).astype(
        np.float32)
    rows = cot.T if transposed else cot
    ok = (idx >= 0) & (idx < p)
    want, mag = np.zeros((p, c)), np.zeros((p, c))
    np.add.at(want, idx[ok], rows[ok].astype(np.float64))
    np.add.at(mag, idx[ok], np.abs(rows[ok]))
    jfn = ((lambda t: jpr.gather_rows_T(t, jnp.asarray(idx), True)[:, :r])
           if transposed else
           (lambda t: jpr.gather_rows(t, jnp.asarray(idx), True)))
    want_j = np.asarray(jax.grad(lambda t: jnp.sum(jfn(t) * cot))(
        jnp.asarray(tab)))
    tt = torch.from_numpy(tab).requires_grad_(True)
    fn = tpr.gather_rows_T if transposed else tpr.gather_rows
    (got,) = torch.autograd.grad(
        (fn(tt, torch.from_numpy(idx)) * torch.from_numpy(cot)).sum(), tt)
    got = got.numpy()
    for ref in (want, want_j):
        assert (np.abs(got - ref) <= 1e-5 * mag + 1e-12).all()
    if case == "empty_row":
        assert not got[5].any() and not (idx == 5).any()
    if case == "hot_row":
        assert (idx == 2).mean() > 0.5 and np.abs(got[2]).sum() > 0
    if case == "out_of_range":
        assert (~ok).sum() > 20


def test_gather_backward_plan_covers_the_rays():
    """The backward kernel's launch plan on a table of one row block: tiles
    of a multiple of one block's 256 lanes that cover the rays, no empty
    tile, and no warp's share of a tile past the rays per warp; a replay
    pass's K*R rows take many tiles."""
    cap = tpr._BWD_WARP_RAYS
    for r in (1, 255, 256, 257, 4097, 147_456, 262_144, 29_360_128):
        for c in (1, 20):
            tiles, span = tpr._bwd_plan(r, c, 132)
            assert tiles >= 1 and span % 256 == 0
            assert (tiles - 1) * span < r <= tiles * span
            assert span // tpr._BWD_WARPS <= cap + 32
    assert tpr._bwd_plan(29_360_128, 20, 132)[0] > 100


def test_gather_rows_f64_takes_plain_indexing():
    tab = torch.randn(9, 20, dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([0, 3, 3, 8], dtype=torch.int32)
    before = dict(tpr.LAUNCHES)
    rows = tpr.gather_rows(tab, idx)
    assert rows.grad_fn is not None and "Index" in type(rows.grad_fn).__name__
    torch.testing.assert_close(rows, tab[idx.long()])
    assert tpr.LAUNCHES == before  # CPU tensors never launch a kernel


# ---- 5. the replay on one recording ----

def _replay_case(dtype, fuzz: float = 0.0):
    jscene, jcam = _mixed_scene(rt, dtype, fuzz)
    scene, _ = _port(jscene, jcam)
    (pxp, pyp, n, rs), _ = _slots(jcam)
    idx, aux, _ = jpr.record_pp(jscene, jcam, 3, pxp, pyp, n, spp=3,
                                max_depth=5, t_min=1e-3, jitter=True,
                                iters=7, tile_sublanes=rs,
                                interpret=pltpu.InterpretParams())
    g = np.random.default_rng(1)
    r = idx.shape[1]
    carry = np.concatenate([g.normal(0, 0.1, (3, r)),
                            g.normal(0, 1, (3, r)) + [[0], [0], [-1]],
                            np.zeros((1, r)), g.uniform(0.5, 1, (3, r))])
    return jscene, scene, np.asarray(idx), np.asarray(aux), carry


def _jax_replay(jscene, idx, aux, carry, dtype):
    params = jextract(jscene)

    def f(p, ic):
        s = rt.diff.inject_params(jscene, p)
        out, fin = jpr.replay_pp(s, jnp.asarray(idx), jnp.asarray(aux),
                                 t_min=1e-3, interpret=True,
                                 init_carry=ic, return_final=True)
        return jnp.sum(out ** 2) + jnp.sum(fin[7:10] ** 2), (out, fin)

    (_, (out, fin)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(
        params, jnp.asarray(carry, dtype))
    return (np.asarray(out), np.asarray(fin),
            {k: np.asarray(v) for k, v in grads[0].items()},
            np.asarray(grads[1]))


def _port_replay(scene, idx, aux, carry, replay=tpr.replay_pp):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in rtt.extract_params(scene).items()}
    ic = torch.tensor(carry, dtype=scene.dtype, requires_grad=True)
    out, fin = replay(rtt.inject_params(scene, params),
                      torch.from_numpy(idx), torch.from_numpy(aux),
                      t_min=1e-3, init_carry=ic, return_final=True)
    loss = (out ** 2).sum() + (fin[7:10] ** 2).sum()
    grads = torch.autograd.grad(loss, list(params.values()) + [ic],
                                allow_unused=True)
    g = {k: (torch.zeros_like(v) if d is None else d).numpy()
         for (k, v), d in zip(params.items(), grads)}
    return out.detach().numpy(), fin.detach().numpy(), g, grads[-1].numpy()


@pytest.mark.parametrize("dtype,fuzz", [(jnp.float32, 0.0),
                                        (jnp.float64, 0.0),
                                        (jnp.float32, 1.0)],
                         ids=["f32", "f64", "f32_fuzz1"])
def test_replay_matches_jax_on_one_recording(dtype, fuzz):
    jscene, scene, idx, aux, carry = _replay_case(dtype, fuzz)
    want = _jax_replay(jscene, idx, aux, carry, dtype)
    got = _port_replay(scene, idx, aux, carry)
    f32 = dtype == jnp.float32
    for name, a, b in (("radiance", got[0], want[0]),
                       ("final carry", got[1], want[1])):
        if f32:
            # the final carry's positions reach 100 (ground sphere)
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name,
                                       rtol=1e-5 if name != "radiance" else 0)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                       err_msg=name)
    assert got[0].std() > 0.01  # the recording is not trivial
    for name in list(want[2]) + ["init_carry"]:
        a = got[3] if name == "init_carry" else got[2][name]
        b = want[3] if name == "init_carry" else want[2][name]
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max()), 1e-3)
        tol = 1e-4 if f32 else 1e-10
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=name)
    if fuzz == 1.0:
        # at fuzz == 1 exactly, d min(fuzz, 1) / d fuzz is 1/2 in JAX; the
        # fused replay (plain versions here) must give the same
        metal = int(np.flatnonzero(np.asarray(jscene.mat_fuzz) == 1.0)[0])
        want_fuzz = want[2]["mat_fuzz"]
        assert want_fuzz[metal] != 0
        fused = _port_replay(scene, idx, aux, carry, tpr.replay_pp_fused)
        scale = max(float(np.abs(want_fuzz).max()), 1e-3)
        for got_fuzz in (got[2]["mat_fuzz"], fused[2]["mat_fuzz"]):
            np.testing.assert_allclose(got_fuzz, want_fuzz, rtol=0,
                                       atol=1e-4 * scale)


# ---- 7. the port on its own, real random draws ----

def _bouncing():
    scene, cam = rtt.scenes.random_bouncing(width=32, height=18, seed=2,
                                            device="cpu")
    return scene, cam, rtt.RenderConfig(spp=4, max_depth=8)


def test_recorded_forward_matches_megakernel():
    """The recorder draws the megakernel's numbers, so the recorded paths
    are the megakernel's; the replay re-derives their values (and decides
    a glass reflect-or-refract again), so agreement is close, not
    bitwise."""
    scene, cam, cfg = _bouncing()
    img, left = tpr.render_diff_pp(scene, cam, 9, cfg, return_leftover=True)
    ref = rtt.render_megakernel(scene, cam, 9, cfg)
    assert int(left) == 0 and float(ref.std()) > 0.01
    d = (img - ref).abs()
    assert float((d > 1e-4).double().mean()) < 0.01
    blk = (img - ref)[:16].reshape(2, 8, 4, 8, 3).mean((1, 3))
    assert float(blk.abs().max()) < 0.01


def test_compaction_equals_exhaustive_single_pass():
    scene, cam, cfg = _bouncing()
    steps = tpr.REPLAY_STEPS
    img_c, left_c = tpr.render_diff_pp(scene, cam, 4, cfg,
                                       return_leftover=True)
    assert tpr.REPLAY_STEPS == steps  # f32: the fused replay, no eager step
    img_x, left_x = tpr.render_diff_pp(scene, cam, 4, cfg,
                                       iters=cfg.spp * cfg.max_depth,
                                       return_leftover=True)
    assert int(left_c) == 0 and int(left_x) == 0
    torch.testing.assert_close(img_c, img_x, rtol=0, atol=1e-6)
    # a starved budget truncates, and reports it
    _, left_s = tpr.render_diff_pp(scene, cam, 4, cfg, iters=2,
                                   return_leftover=True)
    assert int(left_s) > 0


# ---- 8. gradients against central finite differences (f64) ----

def _fd_check(loss, params, fields, picks, eps):
    grads = torch.autograd.grad(loss(params), [params[f] for f in fields])
    for field, g in zip(fields, grads):
        assert torch.isfinite(g).all(), field
        flat = params[field].detach().clone().reshape(-1)
        for k in picks(g):
            def at(delta):
                v = flat.clone()
                v[k] += delta
                return float(loss({**params,
                                   field: v.reshape(g.shape)}))
            fd = (at(eps) - at(-eps)) / (2 * eps)
            ad = float(g.reshape(-1)[k])
            assert abs(fd - ad) <= 1e-4 * max(1.0, abs(fd), abs(ad)), (
                field, k, fd, ad)


def test_grad_matches_fd_albedo_and_center():
    jscene, jcam = _mixed_scene(rt, jnp.float64)
    scene, cam = _port(jscene, jcam)
    _, pix = _slots(jcam)
    idx, aux, left = tpr.record_pp(scene, cam, 5, pix, spp=1, max_depth=4,
                                   t_min=1e-3, jitter=True, iters=8)
    assert int(left.sum()) == 0
    fields = ("tex_color", "sphere_center", "sphere_radius", "tri_v0")
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}

    def loss(p):
        return (tpr.replay_pp(rtt.inject_params(scene, p), idx, aux,
                              t_min=1e-3) ** 2).sum()

    rng = np.random.RandomState(0)
    _fd_check(loss, params, fields,
              lambda g: rng.choice(g.numel(), size=min(3, g.numel()),
                                   replace=False), 1e-5)


def test_velocity_grad_matches_fd_f64():
    b = rtt.SceneBuilder()
    m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, m)
    b.add_sphere((0, 0, -2), 0.5, m, velocity=(0.15, 0.1, -0.05))
    scene = b.build(dtype=torch.float64, device="cpu")
    cam = rtt.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          dtype=torch.float64, device="cpu")
    pix = torch.arange(256, dtype=torch.int32)
    idx, aux, left = tpr.record_pp(scene, cam, 2, pix, spp=1, max_depth=4,
                                   t_min=1e-3, jitter=True, iters=8)
    assert int(left.sum()) == 0
    assert float(aux[:, tpr._AUX_TAU].abs().sum()) > 0  # real times
    fields = ("sphere_velocity", "sphere_center")
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}

    def loss(p):
        return (tpr.replay_pp(rtt.inject_params(scene, p), idx, aux,
                              t_min=1e-3) ** 2).sum()

    g = torch.autograd.grad(loss(params), params["sphere_velocity"])[0]
    assert float(g.abs().sum()) > 0
    _fd_check(loss, params, fields,
              lambda g: torch.argsort(-g.abs().reshape(-1))[:3].tolist(),
              1e-6)


# ---- 10. the kernels on the card ----

@pytest.fixture
def cuda_device():
    """Decided per test (never at import): the kernels need the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_record_kernel_matches_plain_on_card(cuda_device):
    scene, cam, cfg = _bouncing()
    scene, cam = scene.to(cuda_device), cam.to(cuda_device)
    pix = torch.arange(640, dtype=torch.int32, device=cuda_device)
    pix = torch.where(pix < 576, pix, -1)
    kw = dict(spp=cfg.spp, max_depth=cfg.max_depth, t_min=1e-3, jitter=True,
              iters=16, want_state=True)
    before = tpr.LAUNCHES["record_pp"]
    k = tpr.record_pp(scene, cam, 1, pix, **kw)
    assert tpr.LAUNCHES["record_pp"] == before + 1
    cpu = tpr.record_pp(scene.to("cpu"), cam.to("cpu"), 1, pix.cpu(), **kw)
    assert torch.equal(k[0].cpu(), cpu[0])
    torch.testing.assert_close(k[1].cpu(), cpu[1], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [512, 5000])  # one row block; a counting sort
def test_gather_kernels_match_plain_on_card(cuda_device, p):
    g = torch.Generator().manual_seed(0)
    tab = torch.randn(p, 20, generator=g)
    idx = torch.randint(-1, p + 2, (8192,), generator=g, dtype=torch.int32)
    idx[:3000] = 7  # a row most rays hit
    cot = torch.randn(8192, 20, generator=g)
    tc, ic, cc = (t.to(cuda_device) for t in (tab, idx, cot))
    assert torch.equal(tpr._gather_fwd(tc, ic, False).cpu(),
                       tpr._gather_fwd_reference(tab, idx, False))
    for transposed in (False, True):
        cg = cc.T.contiguous() if transposed else cc
        d1 = tpr._gather_bwd(cg, ic, p, transposed)
        assert torch.equal(d1, tpr._gather_bwd(cg, ic, p, transposed))
        torch.testing.assert_close(d1.cpu(), tpr._gather_bwd_reference(
            cot, idx, p, False), rtol=0, atol=1e-4)
