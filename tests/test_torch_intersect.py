"""The dense integrator's building blocks in the port
(rayz_tpu_torch/ops/intersect.py, ops/shade.py, utils/vec.py,
utils/sampling.py, models/camera.generate_rays) against the JAX package's,
on the same inputs made from a numpy seed.

Tolerances: float64 1e-12 absolute on distances, points, normals and
directions (the port writes the inner products out as multiply-adds where
XLA contracts a dot, so the two round differently in the last bits), and
float32 2e-5 relative on distances, 1e-4 absolute on the rest; integer and
boolean outputs (winners, hit flags, faces, materials, scattered) equal,
apart from winners tied within that rounding (none on these rays).
Textures and the deterministic camera rays are exact in float64 (the same
operations in the same order); the sky and Schlick within 1e-15 relative
(XLA may fuse a division or a power differently). The AABB helpers are
exact in both dtypes, zero-direction divisions (IEEE infinities and NaN)
included.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.models.camera import generate_rays as jgenerate_rays
from rayz_tpu.ops import intersect as jintersect
from rayz_tpu.ops import intersect_spheres as jintersect_spheres
from rayz_tpu.ops import scatter as jscatter
from rayz_tpu.ops import schlick_reflectance as jschlick
from rayz_tpu.ops import sky_color as jsky
from rayz_tpu.ops import texture_value as jtexture
from rayz_tpu.utils import sampling as jsampling
from rayz_tpu_torch.models.scene import (DIFFUSE_HEMISPHERE,
                                         DIFFUSE_UNIT_SPHERE,
                                         DIFFUSE_UNIT_SPHERE_SURFACE)
from rayz_tpu_torch.utils import sampling, vec

torch.set_num_threads(2)

shade = sys.modules["rayz_tpu_torch.ops.shade"]
ti = sys.modules["rayz_tpu_torch.ops.intersect"]

STATICS = ("n_spheres", "n_triangles", "has_motion", "deep_checker",
           "tex_depth", "uniq_checker_tex", "uniq_dielectric_mat")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32,
                                                       torch.float32)}


def port_scene(jscene):
    """The JAX scene's arrays carried across unchanged."""
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


def mixed_scene(m, dtype):
    """Spheres (one moving, one a bubble of negative radius), triangles,
    padding (pad_multiple 8 leaves invalid columns) and every material."""
    b = m.SceneBuilder()
    e = b.add_solid_texture((0.2, 0.3, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_diffuse(texture=b.add_checker_texture(0.5, e, o)))
    b.add_sphere((0, 0, -2), 0.5, b.add_metallic(color=(0.9, 0.6, 0.3),
                                                 fuzz=0.0))
    b.add_sphere((-1.1, 0, -2.4), 0.45, b.add_dielectric(1.5),
                 velocity=(0.0, 0.3, 0.1))
    b.add_sphere((1.1, 0.1, -2.2), -0.4, b.add_dielectric(1.5))
    b.add_triangle((0.6, -0.2, -1.6), (1.4, -0.2, -1.9), (1.0, 0.7, -1.8),
                   b.add_diffuse(color=(0.8, 0.3, 0.2)))
    b.add_triangle((-0.8, 0.4, -1.5), (-0.2, 0.5, -1.7), (-0.5, 1.0, -1.6),
                   b.add_metallic(color=(0.8, 0.8, 0.8), fuzz=0.0))
    return b.build(dtype=dtype)


def ray_batch(n: int, seed: int):
    """Rays from near the camera and from inside the spheres (back faces),
    directions random, times in [0, 1)."""
    g = np.random.default_rng(seed)
    o = np.concatenate([g.uniform(-0.3, 0.3, (n // 2, 3)) + [0, 0.2, 0.5],
                        g.normal(0.0, 0.1, (n - n // 2, 3)) + [0, 0, -2]])
    d = g.normal(size=(n, 3))
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 0.5  # toward the scene
    return o, d, g.uniform(0.0, 1.0, n)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_intersect_matches_jax(dt):
    jdt, tdt = DTYPES[dt]
    jscene = mixed_scene(rt, jdt)
    scene = port_scene(jscene)
    o, d, tm = ray_batch(4096, 0)
    want = jintersect(jscene, *(jnp.asarray(x, jdt) for x in (o, d, tm)),
                      1e-3)
    got = rtt.ops.intersect(scene, *(torch.tensor(x, dtype=tdt)
                                     for x in (o, d, tm)), 1e-3)
    hit = np.asarray(want.hit)
    assert 0.3 < hit.mean() < 0.95
    assert (got.hit.numpy() == hit).all()
    for name in ("front_face", "material"):
        assert (getattr(got, name).numpy()
                == np.asarray(getattr(want, name))).all(), name
    assert (~np.asarray(want.front_face[hit])).any()  # back faces too
    t = np.asarray(want.t)
    if dt == "f64":
        np.testing.assert_allclose(got.t.numpy()[hit], t[hit], rtol=0,
                                   atol=1e-12)
        atol = 1e-12
    else:
        np.testing.assert_allclose(got.t.numpy()[hit], t[hit], rtol=2e-5)
        atol = 1e-4
    assert np.isinf(got.t.numpy()[~hit]).all()
    for name in ("point", "normal"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=atol, err_msg=name)


def test_sphere_winners_match_jax():
    jscene = mixed_scene(rt, jnp.float64)
    scene = port_scene(jscene)
    o, d, tm = ray_batch(2048, 1)
    jt, ji = jintersect_spheres(jscene, *(jnp.asarray(x) for x in (o, d, tm)),
                                1e-3, jnp.inf)
    t, i = rtt.ops.intersect_spheres(scene, *(torch.tensor(x)
                                              for x in (o, d, tm)), 1e-3)
    hit = np.isfinite(np.asarray(jt))
    assert (i.numpy()[hit] == np.asarray(ji)[hit]).all()
    assert (i.numpy()[~hit] == 0).all()  # the first minimum: column 0


def single_sphere(center=(0, 0, -2), radius=1.0, velocity=None,
                  pad_multiple=8):
    b = rtt.SceneBuilder()
    b.add_sphere(center, radius, b.add_diffuse(color=(0.5, 0.5, 0.5)),
                 velocity=velocity)
    return b.build(dtype=torch.float64, pad_multiple=pad_multiple,
                   device="cpu")


def rays(os, ds, times=None):
    o = torch.tensor(os, dtype=torch.float64)
    d = torch.tensor(ds, dtype=torch.float64)
    t = (torch.zeros(o.shape[0], dtype=torch.float64) if times is None
         else torch.tensor(times, dtype=torch.float64))
    return o, d, t


def test_sphere_hit_t_values():
    """tests/test_intersect.py's analytic cases, through the port."""
    scene = single_sphere()
    t, _ = rtt.ops.intersect_spheres(scene, *rays(
        [[0, 0, 0]] * 3, [[0, 0, -1], [0, 0, 1], [0, 1, 0]]), 1e-10)
    assert float(t[0]) == 1.0
    assert not torch.isfinite(t[1:]).any()
    # origin inside: the far root; a window that holds only the far root
    inside = single_sphere(center=(0, 0, 0))
    t, _ = rtt.ops.intersect_spheres(inside, *rays([[0, 0, 0]],
                                                   [[0, 0, -1]]), 1e-10)
    assert float(t[0]) == 1.0
    t, _ = rtt.ops.intersect_spheres(scene, *rays([[0, 0, 0]], [[0, 0, -1]]),
                                     1e-10, 0.5)
    assert not bool(torch.isfinite(t[0]))
    t, _ = rtt.ops.intersect_spheres(scene, *rays([[0, 0, 0]], [[0, 0, -1]]),
                                     2.0, 10.0)
    assert float(t[0]) == 3.0


def test_moving_sphere_and_faces():
    scene = single_sphere(velocity=(0, 1, 0))
    rec = rtt.ops.intersect(scene, *rays([[0, 0, 0], [0, 0, 0]],
                                         [[0, 0, -1], [0, 1, -2]],
                                         [0.0, 1.0]), 1e-10)
    assert bool(rec.hit.all())
    p = rec.point[1].numpy()
    assert abs(np.linalg.norm(p - np.array([0, 1, -2])) - 1.0) < 1e-9
    scene = single_sphere()
    rec = rtt.ops.intersect(scene, *rays([[0, 0, 0]], [[0, 0, -1]]), 1e-10)
    np.testing.assert_allclose(rec.normal[0].numpy(), [0, 0, 1], atol=1e-12)
    assert bool(rec.front_face[0])
    rec = rtt.ops.intersect(scene, *rays([[0, 0, -2]], [[0, 0, -1]]), 1e-10)
    np.testing.assert_allclose(rec.normal[0].numpy(), [0, 0, 1], atol=1e-12)
    assert not bool(rec.front_face[0])


def test_nearest_hit_and_padding():
    b = rtt.SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -5), 1.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    scene = b.build(dtype=torch.float64, device="cpu")
    rec = rtt.ops.intersect(scene, *rays([[0, 0, 0]], [[0, 0, -1]]), 1e-10)
    assert float(rec.t[0]) == 1.5
    padded = single_sphere(pad_multiple=64)
    assert padded.sphere_radius.shape[0] == 64
    rec = rtt.ops.intersect(padded, *rays([[5, 5, 5]], [[-1, -1, -1]]), 1e-10)
    assert not bool(rec.hit[0])


def test_triangle_hit():
    b = rtt.SceneBuilder()
    b.add_triangle((0, 0, -2), (1, 0, -2), (0, 1, -2),
                   b.add_diffuse(color=(0.5, 0.5, 0.5)))
    scene = b.build(dtype=torch.float64, device="cpu")
    rec = rtt.ops.intersect(scene, *rays(
        [[0.2, 0.2, 0], [0.9, 0.9, 0], [-0.1, 0.2, 0], [0.2, 0.2, 0]],
        [[0, 0, -1], [0, 0, -1], [0, 0, -1], [0, 0, 1]]), 1e-10)
    assert rec.hit.tolist() == [True, False, False, False]
    assert float(rec.t[0]) == 2.0


def test_independent_of_matmul_precision():
    """The inner products are written-out multiply-adds: no float32 matmul
    setting changes a bit (JAX pins its matmuls to HIGHEST for the same
    reason: reduced precision rings surfaces with self-intersections)."""
    scene = port_scene(mixed_scene(rt, jnp.float32))
    o, d, tm = (torch.tensor(x, dtype=torch.float32)
                for x in ray_batch(1024, 2))
    ref = rtt.ops.intersect(scene, o, d, tm, 1e-3)
    prev = torch.get_float32_matmul_precision()
    try:
        for prec in ("medium", "high"):
            torch.set_float32_matmul_precision(prec)
            got = rtt.ops.intersect(scene, o, d, tm, 1e-3)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
    finally:
        torch.set_float32_matmul_precision(prev)


def deep_checker_scene(m, dtype):
    """tests/test_render.py's six-deep nested checker."""
    b = m.SceneBuilder()
    cur = b.add_solid_texture((0.9, 0.1, 0.1))
    other = b.add_solid_texture((0.1, 0.1, 0.9))
    for lvl in range(5):
        cur = b.add_checker_texture(1.6 / (2 ** lvl), cur, other)
    b.add_sphere((0, -100.5, -2), 100.0, b.add_diffuse(texture=cur))
    b.add_sphere((0, 0, -2), 0.5, b.add_diffuse(texture=cur))
    return b.build(dtype=dtype), cur


def test_texture_six_deep_checker_matches_jax():
    jscene, top = deep_checker_scene(rt, jnp.float64)
    scene = port_scene(jscene)
    assert scene.tex_depth == 6 and scene.deep_checker
    g = np.random.default_rng(3)
    pts = g.uniform(-3.0, 3.0, (4096, 3))
    idx = np.full(4096, top, np.int32)
    want = np.asarray(jtexture(jscene, jnp.asarray(idx), jnp.asarray(pts)))
    got = shade.texture_value(scene, torch.tensor(idx), torch.tensor(pts))
    assert (got.numpy() == want).all()
    assert len(np.unique(want, axis=0)) == 2


def test_sky_and_schlick_match_jax():
    g = np.random.default_rng(4)
    d = g.normal(size=(2048, 3))
    np.testing.assert_allclose(shade.sky_color(torch.tensor(d)).numpy(),
                               np.asarray(jsky(jnp.asarray(d))), rtol=1e-15)
    cos = g.uniform(-1.0, 1.0, 2048)
    eta = g.uniform(0.5, 2.0, 2048)
    np.testing.assert_allclose(
        shade.schlick_reflectance(torch.tensor(cos), torch.tensor(eta)),
        np.asarray(jschlick(jnp.asarray(cos), jnp.asarray(eta))), rtol=1e-15)
    assert float(shade.schlick_reflectance(torch.tensor(1.0),
                                           1.5)) == pytest.approx(0.04)


def _scatter_scene(kind):
    b = rt.SceneBuilder()
    mat = {"metal": lambda: b.add_metallic(color=(0.7, 0.6, 0.5), fuzz=0.0),
           "metal_fuzz": lambda: b.add_metallic(color=(0.7, 0.6, 0.5),
                                                fuzz=0.4),
           "glass": lambda: b.add_dielectric(1.5),
           "unit_sphere": lambda: b.add_diffuse(
               color=(0.2, 0.6, 0.4), method=DIFFUSE_UNIT_SPHERE),
           "unit_surface": lambda: b.add_diffuse(
               color=(0.2, 0.6, 0.4), method=DIFFUSE_UNIT_SPHERE_SURFACE),
           "hemisphere": lambda: b.add_diffuse(
               color=(0.2, 0.6, 0.4), method=DIFFUSE_HEMISPHERE)}[kind]()
    b.add_sphere((0, 0, -2), 1.0, mat)
    return b.build(dtype=jnp.float64)


@pytest.mark.parametrize("kind", ["metal", "metal_fuzz", "glass",
                                  "unit_sphere", "unit_surface",
                                  "hemisphere"])
def test_scatter_matches_jax(kind):
    """JAX's scatter against the port's fed the same numbers: the sample
    JAX draws from its key for this material (its unit vector, ball or
    hemisphere sample, fuzz vector and Schlick coin), split into the unit
    vector, radius and coin the port takes. Rays from outside and inside
    the sphere (both faces)."""
    jscene = _scatter_scene(kind)
    scene = port_scene(jscene)
    g = np.random.default_rng(5)
    n = 1024
    o = np.where(np.arange(n)[:, None] < n // 2, [0.0, 0.0, 0.0],
                 [0.0, 0.0, -2.0]) + g.normal(0, 0.1, (n, 3))
    d = g.normal(0, 0.3, (n, 3)) + [0.0, 0.0, -1.0]
    tm = np.zeros(n)
    jrec = jintersect(jscene, *(jnp.asarray(x) for x in (o, d, tm)), 1e-6)
    hit = np.asarray(jrec.hit)  # misses scatter nothing the caller uses
    assert hit.mean() > 0.5 and not np.asarray(jrec.front_face)[hit].all()
    key = jax.random.PRNGKey(9)
    want = jscatter(key, jscene, jnp.asarray(d), jnp.asarray(tm), jrec)
    k_sph, k_unit, k_hemi, k_fuzz, k_coin = jax.random.split(key, 5)
    shape, f64 = (n,), jnp.float64
    vec3 = {"metal": lambda: jsampling.random_unit_vector(k_fuzz, shape, f64),
            "metal_fuzz": lambda: jsampling.random_unit_vector(k_fuzz, shape,
                                                               f64),
            "glass": lambda: jsampling.random_unit_vector(k_fuzz, shape, f64),
            "unit_sphere": lambda: jsampling.random_in_unit_sphere(
                k_sph, shape, f64),
            "unit_surface": lambda: jsampling.random_unit_vector(
                k_unit, shape, f64),
            "hemisphere": lambda: jsampling.random_in_unit_sphere(
                k_hemi, shape, f64)}[kind]()
    v = np.asarray(vec3)
    radius = np.linalg.norm(v, axis=1)
    unit = v / radius[:, None]
    coin = np.asarray(jax.random.uniform(k_coin, shape, dtype=f64))
    rec = rtt.ops.intersect(scene, *(torch.tensor(x) for x in (o, d, tm)),
                            1e-6)
    draws = [torch.tensor(x) for x in (*unit.T, radius, coin)]
    got = shade.scatter(scene, torch.tensor(d), rec, draws)
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy()[hit], np.asarray(want[1])[hit],
                               rtol=0, atol=1e-15)
    assert (got[2].numpy()[hit] == np.asarray(want[2])[hit]).all()
    if kind == "glass":  # both branches taken: reflected rays turn back
        back = ((np.asarray(want[0]) * np.asarray(jrec.normal)).sum(1) > 0)
        assert 0 < back[hit].sum() < hit.sum()


def test_sampling_distributions():
    g = np.random.default_rng(6)
    u = [torch.tensor(g.random(20_000)) for _ in range(3)]
    s = sampling.random_unit_vector(u[0], u[1])
    np.testing.assert_allclose(vec.norm(s).numpy(), 1.0, atol=1e-12)
    assert (s.mean(0).abs() < 0.02).all()
    ball = sampling.random_in_unit_sphere(*u)
    r = vec.norm(ball).numpy()
    assert r.max() <= 1.0 and abs((r ** 3).mean() - 0.5) < 0.01
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64).expand(20_000, 3)
    assert (vec.dot(sampling.random_in_hemisphere(ball, n), n) >= 0).all()
    disk = sampling.random_in_unit_disk(u[0], u[1]).numpy()
    rr = np.linalg.norm(disk, axis=1)
    assert rr.max() <= 1.0 and abs((rr ** 2).mean() - 0.5) < 0.01
    assert torch.allclose(sampling.cube_root(u[2]), u[2] ** (1 / 3),
                          rtol=1e-12, atol=0)


def test_vec_matches_jax():
    g = np.random.default_rng(7)
    a, b = g.normal(size=(2, 512, 3))
    eta = g.uniform(0.6, 1.6, 512)
    unit = a / np.linalg.norm(a, axis=1, keepdims=True)
    nrm = b / np.linalg.norm(b, axis=1, keepdims=True)
    jv = rt.utils.vec
    ta, tb, tu, tn = (torch.tensor(x) for x in (a, b, unit, nrm))
    for got, want in (
            (vec.cross(ta, tb), jv.cross(a, b)),
            (vec.reflect(ta, tn), jv.reflect(a, nrm)),
            (vec.refract(tu, tn, torch.tensor(eta)),
             jv.refract(unit, nrm, jnp.asarray(eta))),
            (vec.normalize(ta, eps=1e-20), jv.normalize(a, eps=1e-20)),
            (vec.ray_at(ta, tb, torch.tensor(eta)),
             jv.ray_at(a, b, jnp.asarray(eta)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-14)
    z = torch.tensor([[1e-9, -1e-9, 0.0], [1e-7, 0.0, 0.0]])
    assert vec.near_zero(z).tolist() == [True, False]


def test_deterministic_camera_rays_match_jax():
    """With no seed, generate_rays is JAX's generate_rays(key=None) bit for
    bit in float64; with one, it is the megakernel's spawn."""
    jcam = rt.make_camera(width=24, height=16, vfov=40.0, focus_dist=3.0,
                          defocus_angle=2.0, look_from=(1, 2, 3),
                          look_at=(0, 0, -1), dtype=jnp.float64)
    cam = port_camera(jcam)
    gx, gy = np.meshgrid(np.arange(24), np.arange(16))
    want = jgenerate_rays(jcam, jnp.asarray(gx), jnp.asarray(gy), key=None)
    got = rtt.generate_rays(cam, torch.tensor(gx), torch.tensor(gy))
    for a, b in zip(got, want):
        assert a.shape == b.shape and (a.numpy() == np.asarray(b)).all()
    o, d, tm = rtt.generate_rays(cam, torch.tensor(gx), torch.tensor(gy),
                                 seed=4, sample=2)
    dk = sys.modules["rayz_tpu_torch.ops.diffkernel"]
    pix = torch.arange(24 * 16, dtype=torch.int32)
    ro, rd, rtm = dk._camera_rays(cam, 4, pix, 2, True)
    assert torch.equal(o.reshape(-1, 3), ro) and torch.equal(tm.reshape(-1),
                                                             rtm)
    assert not torch.equal(o.reshape(-1, 3), got[0].reshape(-1, 3))


def _boxes_and_rays(r, n):
    """Random boxes and rays, with zero direction components and origins on
    a slab's plane (IEEE infinities and 0/0 = NaN in the slab test)."""
    a, b = r.uniform(-2, 2, (n, 3)), r.uniform(-2, 2, (n, 3))
    low, high = np.minimum(a, b), np.maximum(a, b)
    o = r.uniform(-4, 4, (n, 3))
    d = r.normal(size=(n, 3))
    d[r.random((n, 3)) < 0.2] = 0.0
    on_plane = r.random(n) < 0.1
    o[on_plane, 0] = low[on_plane, 0]
    return low, high, o, d


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_aabb_helpers_match_jax(dt):
    """aabb_hit, aabb_enclose, aabb_longest_axis and sphere_aabb against
    rayz_tpu/ops/intersect.py:234-272 on random inputs, bit for bit (the
    same IEEE operations)."""
    jint = sys.modules["rayz_tpu.ops.intersect"]
    jdt = DTYPES[dt][0]
    r = np.random.default_rng(11)
    low, high, o, d = (x.astype(np.dtype(jdt)) for x in
                       _boxes_and_rays(r, 4000))
    with np.errstate(divide="ignore", invalid="ignore"):
        assert np.isnan((low - o) / d).any()
    for t_min, t_max in ((0.0, 10.0), (1e-3, 2.5)):
        want = np.asarray(jint.aabb_hit(low, high, o, d, t_min, t_max))
        got = ti.aabb_hit(*(torch.from_numpy(x) for x in (low, high, o, d)),
                          t_min, t_max)
        assert got.dtype == torch.bool and 0 < want.mean() < 1
        np.testing.assert_array_equal(got.numpy(), want)
    lo2, hi2 = low[::-1].copy(), high[::-1].copy()
    for w, g in zip(jint.aabb_enclose(low, high, lo2, hi2),
                    ti.aabb_enclose(*(torch.from_numpy(x) for x in
                                      (low, high, lo2, hi2)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = np.asarray(jint.aabb_longest_axis(low, high))
    got = ti.aabb_longest_axis(torch.from_numpy(low), torch.from_numpy(high))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rad = r.uniform(0.1, 1, 4000).astype(np.dtype(jdt))
    for w, g in zip(jint.sphere_aabb(o, d, rad),
                    ti.sphere_aabb(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(rad))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert rtt.ops.aabb_hit is ti.aabb_hit


def test_aabb_golden():
    """The reference's hit.zig and geom.zig cases, as
    tests/test_intersect.py:105-135 holds JAX's helpers to them."""
    t = torch.tensor
    low, high = t([0.0, 0, 0]), t([1.0, 1, 1])
    o = t([[-1.0, -1, -1]] * 3)
    d = t([[1.0, 1, 1], [-1, -1, -1], [0.5, 0.5, 0.5]])
    assert ti.aabb_hit(low, high, o, d, 0.0, 10.0).tolist() == [True, False,
                                                                True]
    assert bool(ti.aabb_hit(t([-1000.0, -2000, -1000]), t([1000.0, 2, 1000]),
                            t([[13.0, 2, 3]]), t([[-9.6, -1.5, -2.3]]),
                            0.0, 10.0)[0])
    lo, hi = ti.aabb_enclose(t([-1.0, -1, -1]), t([1.0, 1, 1]),
                             t([0.0, 0, 0]), t([2.0, 2, 2]))
    assert lo.tolist() == [-1, -1, -1] and hi.tolist() == [2, 2, 2]
    assert int(ti.aabb_longest_axis(t([0.0, 0, 0]), t([1.0, 3, 2]))) == 1
    lo, hi = ti.sphere_aabb(torch.zeros(1, 3), torch.zeros(1, 3),
                            torch.ones(1))
    assert lo[0].tolist() == [-1, -1, -1] and hi[0].tolist() == [1, 1, 1]
    lo, hi = ti.sphere_aabb(torch.zeros(1, 3), torch.ones(1, 3),
                            torch.ones(1))
    assert lo[0].tolist() == [-1, -1, -1] and hi[0].tolist() == [2, 2, 2]
