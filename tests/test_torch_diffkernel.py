"""The port's bounce-indexed record/replay (rayz_tpu_torch/ops/diffkernel.py,
the ``"recorded"`` engine) against the JAX package, and the port's own
invariants. On the CPU the recorder and the gathers run their plain torch
versions, which is what the CUDA kernels are held against on the card
(chip_smoke.py).

The JAX recorder takes its randoms as inputs, so with the same numpy rays
and randoms its interpreter (interpret mode, as tests/test_diffkernel.py
runs it) is an exact stochastic reference. Inputs cross as numpy
(``scene_from_numpy``/``params_from_numpy``).

Tolerances:
* recorder: every ray that differs is decided by rounding: a 1e-6
  relative perturbation of its camera ray changes the port's own recording
  at or before the first differing bounce, or at that bounce one package
  re-hits the flat triangle the ray has just left, which no ray does in
  exact arithmetic (XLA:CPU contracts multiply-adds and JAX takes an
  approximate reciprocal in the triangle test; the port rounds every
  operation, as the kernel does). >= 99.9% of the [depth, R] indices
  equal on the mixed scene, on random_bouncing at t_min = 0.01 and on the
  Cornell box at 0.05. At the default t_min = 1e-3 the f32 rounding of a
  plane or sphere distance at these two scenes' scales (~10 and 555 units)
  is itself of the order of t_min, so whether a bounce re-hits the surface
  it leaves is decided by rounding in both packages: there >= 99% of the
  indices equal on random_bouncing and >= 95% on the Cornell box (99.29%
  and 95.65% seen; 12 of the box's 72 differing rays are JAX re-hitting
  the wall triangle they leave);
* replay on one recording: f64 radiance and gradients within 1e-9 of each
  field's largest entry; f32 radiance within 1e-5 abs, gradients within
  1e-3 of each field's largest entry (a sum over 1,024 rays of 5 bounces
  each, rounded with and without contracted multiply-adds: 2.6e-4 seen on
  the radius of the sphere the most rays hit);
* the forward against the megakernel, same seed: < 1% of channels off by
  more than 1e-4 and 8x8 block means within 0.01 (the replay re-derives
  each hit from the quadratic, so a glass or grazing bounce may resolve
  differently; the recorded-pp estimator shows the same channels); the
  image equals render_diff_pp's within 1e-6;
* distribution against JAX's render_diff at 16 spp: the bounds of
  tests/test_diffkernel.py:195-197 (independent random streams);
* pixel_loss against JAX on a deterministic f64 config (JAX's randoms fed
  to the port): loss and gradients within 1e-9 relative;
* finite differences (f64): the bound of tests/test_diffkernel.py.
"""

import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.diff import extract_params as jextract
from rayz_tpu.diff import pixel_loss as jpixel_loss
from rayz_tpu.ops import diffkernel as jdk
from rayz_tpu_torch.diff import inverse
from rayz_tpu_torch.io.image import read_ppm, write_ppm
from rayz_tpu_torch.ops import diffkernel as tdk, pathrec as tpr, tables
from rayz_tpu_torch.ops import sweep as sw

torch.set_num_threads(2)

STATICS = ("n_spheres", "n_triangles", "has_motion", "deep_checker",
           "tex_depth", "uniq_checker_tex", "uniq_dielectric_mat")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_deterministic.ppm")
T_MIN = 1e-3


# ---- scenes (built by either package ``m``) ----

def _mixed_scene(m, dtype, fuzz: float = 0.3):
    """Spheres and triangles in one table, a moving metal (``fuzz``; 1.0 is
    the tie of min(fuzz, 1)), glass, a diffuse triangle and a mirror
    quad."""
    b = m.SceneBuilder()
    b.add_sphere((0, -100.5, -2), 100.0, b.add_diffuse(color=(0.5, 0.5, 0.5)))
    b.add_sphere((-0.7, 0, -2), 0.45,
                 b.add_metallic(color=(0.9, 0.8, 0.7), fuzz=fuzz),
                 velocity=(0.1, 0.05, 0.0))
    b.add_sphere((0.7, 0, -2), 0.45, b.add_dielectric(1.5))
    b.add_triangle((-0.4, 0.8, -2.5), (0.4, 0.8, -2.5), (0, 1.5, -2.5),
                   b.add_diffuse(color=(0.8, 0.2, 0.2)))
    b.add_quad((-1.5, -0.5, -3), (3, 0, 0), (0, 2.5, 0),
               b.add_metallic(color=(0.7, 0.8, 0.9), fuzz=0.0))
    cam = m.make_camera(width=32, height=32, vfov=60.0, focus_dist=1.0,
                        look_from=(0, 0, 0), look_at=(0, 0, -1), dtype=dtype)
    return b.build(dtype=dtype), cam


def _metal_scene(m, dtype):
    """Fuzz-0 metals only: with jitter off no random number changes a
    path."""
    b = m.SceneBuilder()
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0))
    b.add_sphere((0, 0, -2), 0.5, b.add_metallic(color=(0.6, 0.8, 0.9),
                                                 fuzz=0.0))
    cam = m.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                        look_from=(0, 0, 0), look_at=(0, 0, -1), dtype=dtype)
    return b.build(dtype=dtype), cam


def _jax_scene(name, dtype=jnp.float32):
    if name == "mixed":
        return _mixed_scene(rt, dtype)
    if name == "random_bouncing":
        return rt.scenes.random_bouncing(width=32, height=32, dtype=dtype)
    return rt.scenes.cornell_box(width=32, tessellation=2, dtype=dtype)


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


def _rand(r: int, depth: int, seed: int = 0) -> np.ndarray:
    """[depth, 5, R] f32: unit vectors, u^(1/3), Schlick uniforms."""
    g = np.random.default_rng(seed)
    u = g.standard_normal((depth, 3, r))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return np.concatenate([u, g.random((depth, 1, r)) ** (1.0 / 3.0),
                           g.random((depth, 1, r))], axis=1).astype(np.float32)


def _rays(cam, n: int, seed: int = 3, jitter: bool = True):
    """The port's camera rays of the first n pixels (sample 0)."""
    pix = torch.arange(n, dtype=torch.int32)
    return tdk._camera_rays(cam, seed, pix, 0, jitter)


def _jax_record(jscene, o, d, tm, rand, depth, t_min, stream):
    return np.asarray(jdk.record_paths(
        jscene, *(jnp.asarray(np.asarray(x)) for x in (o, d, tm, rand)),
        max_depth=depth, t_min=t_min, tile_sublanes=o.shape[0] // 128,
        interpret=True, stream=stream))


def _sensitive(scene, o, d, tm, rand, got, want, t_min, k: int = 16):
    """Per ray that differs from JAX: whether a 1e-6 relative perturbation
    of its ray changes the port's recording at or before the first bounce
    where the two packages differ."""
    g = np.random.default_rng(7)
    out = []
    for r in np.flatnonzero((got != want).any(axis=0)):
        first = int(np.argmax(got[:, r] != want[:, r]))
        sel = torch.full((k,), int(r))
        jig = [1.0 + 1e-6 * torch.from_numpy(
            g.standard_normal((k, 3))).float() for _ in range(2)]
        alt = tdk.record_paths(
            scene, o[sel] * jig[0], d[sel] * jig[1], tm[sel],
            torch.from_numpy(rand[:, :, [r] * k]), max_depth=rand.shape[0],
            t_min=t_min).numpy()
        out.append(bool((alt[:first + 1] != got[:first + 1, [r]]).any()))
    return np.array(out, dtype=bool)


def _flat_self_hit(scene, got, want):
    """Per ray that differs from JAX: whether at the first differing bounce
    one package records the triangle the ray has just left (a flat
    primitive no ray leaving it can hit again but by rounding)."""
    tri_base = tables._padded_counts(scene, 1)[0]
    out = []
    for r in np.flatnonzero((got != want).any(axis=0)):
        f = int(np.argmax(got[:, r] != want[:, r]))
        left = got[f - 1, r] if f else -1
        out.append(bool(left >= tri_base and left in (got[f, r], want[f, r])))
    return np.array(out, dtype=bool)


# ---- 1. the recorder against JAX record_paths ----

#: least share of equal indices, per scene and t_min (module docstring)
RECORD_SHARE = {("random_bouncing", 1e-2): 0.999, ("cornell_box", 0.05): 0.999,
                ("mixed", T_MIN): 0.999, ("random_bouncing", T_MIN): 0.99,
                ("cornell_box", T_MIN): 0.95}


#: resident and streamed in chunks of 128; at the default t_min the two
#: single-scene cases record resident only (streamed = resident is test 3)
RECORD_CASES = [pytest.param(name, t_min, stream, id=f"{name}-{t_min}-{sid}")
                for name, t_min in RECORD_SHARE
                for stream, sid in ((0, "resident"), (128, "stream128"))
                if not stream or name == "mixed" or t_min != T_MIN]


@pytest.mark.parametrize("name,t_min,stream", RECORD_CASES)
def test_recorder_matches_jax(name, t_min, stream):
    jscene, jcam = _jax_scene(name)
    scene, cam = _port(jscene, jcam)
    depth, r = 4, 1024
    o, d, tm = _rays(cam, r)
    rand = _rand(r, depth)
    want = _jax_record(jscene, o, d, tm, rand, depth, t_min, stream)
    before = dict(tdk.LAUNCHES)
    got = tdk.record_paths(scene, o, d, tm, torch.from_numpy(rand),
                           max_depth=depth, t_min=t_min,
                           stream=stream).numpy()
    assert tdk.LAUNCHES == before  # CPU tensors never launch the kernel
    assert got.shape == want.shape and got.dtype == np.int32
    share = float((got == want).mean())
    print(f"{name} stream={stream}: {share:.4%} of indices equal")
    assert share >= RECORD_SHARE[name, t_min]
    assert (_sensitive(scene, o, d, tm, rand, got, want, t_min)
            | _flat_self_hit(scene, got, want)).all()
    assert (got >= 0).mean() > 0.3  # the recording is not trivial
    if scene.n_triangles:
        n_sph = int(scene.sphere_radius.shape[0]) if scene.n_spheres else 0
        assert (got >= n_sph).any()  # triangle winners at N_pad + j


# ---- 2. the replay on one recording ----

def _replay_case(dtype, fuzz):
    jscene, jcam = _mixed_scene(rt, dtype, fuzz)
    scene, cam = _port(jscene, jcam)
    depth, r = 5, 1024
    o, d, tm = (x.numpy().astype(np.dtype(dtype)) for x in _rays(cam, r))
    rand = _rand(r, depth, seed=1).astype(np.dtype(dtype))
    idx = _jax_record(jscene, o, d, tm, rand, depth, T_MIN, 0)
    return jscene, scene, (o, d, tm, rand, idx)


def _jax_replay(jscene, inputs):
    args = [jnp.asarray(x) for x in inputs]

    def f(p):
        out = jdk.replay_paths(rt.diff.inject_params(jscene, p), *args,
                               t_min=T_MIN)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(jextract(jscene))
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _port_replay(scene, inputs, **kw):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in rtt.extract_params(scene).items()}
    out = tdk.replay_paths(rtt.inject_params(scene, params),
                           *(torch.from_numpy(x) for x in inputs),
                           t_min=T_MIN, **kw)
    grads = torch.autograd.grad((out ** 2).sum(), list(params.values()),
                                allow_unused=True)
    return out.detach().numpy(), {
        k: (torch.zeros_like(v) if g is None else g).numpy()
        for (k, v), g in zip(params.items(), grads)}


@pytest.mark.parametrize("dtype,fuzz", [(jnp.float32, 0.3),
                                        (jnp.float64, 0.3),
                                        (jnp.float32, 1.0)],
                         ids=["f32", "f64", "f32_fuzz1"])
def test_replay_matches_jax_on_one_recording(dtype, fuzz):
    jscene, scene, inputs = _replay_case(dtype, fuzz)
    want_out, want_g = _jax_replay(jscene, inputs)
    got_out, got_g = _port_replay(scene, inputs)
    f32 = dtype == jnp.float32
    assert got_out.dtype == np.dtype(dtype) and got_out.std() > 0.01
    if f32:
        np.testing.assert_allclose(got_out, want_out, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got_out, want_out, rtol=0,
                                   atol=1e-9 * np.abs(want_out).max())
    for name, b in want_g.items():
        a = got_g[name]
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-6)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=(1e-3 if f32 else 1e-9) * scale,
                                   err_msg=name)
    assert np.abs(got_g["tri_v0"]).sum() > 0
    if fuzz == 1.0:
        # at fuzz == 1 exactly, d min(fuzz, 1) / d fuzz is 1/2 in JAX
        metal = int(np.flatnonzero(np.asarray(jscene.mat_fuzz) == 1.0)[0])
        assert want_g["mat_fuzz"][metal] != 0
    # remat changes what is stored, never the values
    out2, g2 = _port_replay(scene, inputs, remat=False)
    np.testing.assert_array_equal(out2, got_out)
    for name in got_g:
        np.testing.assert_array_equal(g2[name], got_g[name])


# ---- 3. streamed = resident ----

def test_streamed_equals_resident_mixed():
    scene, cam = _port(*_mixed_scene(rt, jnp.float32))
    o, d, tm = _rays(cam, 1024)
    rand = torch.from_numpy(_rand(1024, 4))
    kw = dict(max_depth=4, t_min=T_MIN)
    ref = tdk.record_paths(scene, o, d, tm, rand, stream=0, **kw)
    for stream in (128, tables.RECORD_STREAM_CHUNK):
        b = tdk._record_tables(
            scene, tables.resolve(scene, "record", stream=stream), o[0])
        assert b.stab.shape[1] % stream == 0 and b.scb.shape == (4, 1)
        got = tdk.record_paths(scene, o, d, tm, rand, stream=stream, **kw)
        assert torch.equal(got, ref)
    assert int((ref >= int(scene.sphere_radius.shape[0])).sum()) > 0


def _raw_record(scene, o, d, tm, rand, t_min):
    """The plain recorder over the tables in the scene's own order."""
    raw = tdk._record_tables(scene, tables.resolve(scene, "record", stream=0))
    stab, ttab = raw.stab, raw.ttab
    rays = torch.cat([o.T, d.T, tm[None]]).float().contiguous()
    return rays, tdk._record_reference(
        stab, ttab, rays, rand, depth=rand.shape[0], t_min=t_min,
        has_motion=scene.has_motion, tri_base=tables._padded_counts(scene, 1)[0])


@pytest.mark.parametrize("name,stream", [("mixed", 128), ("field", 128),
                                         ("field", 512)])
def test_sorted_recorder_parts_only_at_ties(name, stream):
    """The streamed recorder's Morton-sorted, near-to-far layout against
    the scene-order plain recorder and, on the field at chunk 128, JAX
    record_paths (original order; the mixed scene's streamed recording
    meets JAX in test_recorder_matches_jax): every ray that differs from
    the scene order parts from it at an exact f32 tie, and every ray that
    differs from JAX differs from it in the scene order too or parts there
    at such a tie. Then a replay
    of the sorted recording equals the scene order's on every ray whose
    indices agree (the indices name _diff_tables rows)."""
    if name == "mixed":
        jscene, jcam = _mixed_scene(rt, jnp.float32)
        t_min = T_MIN
    else:
        jscene, jcam = rt.scenes.sphere_field(n=600, width=16, height=16)
        t_min = 1e-2
    r = 256
    scene, cam = _port(jscene, jcam)
    depth = 4
    o, d, tm = _rays(cam, r)
    rand = torch.from_numpy(_rand(r, depth))
    got = tdk.record_paths(scene, o, d, tm, rand, max_depth=depth,
                           t_min=t_min, stream=stream)
    b = tdk._record_tables(
        scene, tables.resolve(scene, "record", stream=stream), o[0])
    if name == "field":  # the sort moved the columns
        assert not torch.equal(b.sperm, torch.arange(b.stab.shape[1],
                                                     dtype=torch.int32))
    rays, want = _raw_record(scene, o, d, tm, rand, t_min)
    tie = tdk._exact_ties(scene, rays, rand, got, want, depth=depth,
                          t_min=t_min)
    print(f"{name} stream={stream}: {tie.numel()} rays differ from the "
          "scene order")
    assert tie.all()
    assert (got[0] >= 0).float().mean() > 0.3
    if name == "field" and stream == 128:
        jax_idx = _jax_record(jscene, o, d, tm, rand.numpy(), depth, t_min,
                              128)
        off = (got.numpy() != jax_idx).any(axis=0)
        off_raw = (want.numpy() != jax_idx).any(axis=0)
        parted = (got != want).any(dim=0).numpy()
        assert not (off & ~off_raw & ~parted).any()
        assert float((got.numpy() == jax_idx).mean()) >= 0.99

    same = ~(got != want).any(dim=0)
    a = tdk.replay_paths(scene, o, d, tm, rand, got, t_min=t_min)
    b = tdk.replay_paths(scene, o, d, tm, rand, want, t_min=t_min)
    assert torch.equal(a[same], b[same]) and float(a.std()) > 0.01


def test_exact_ties_tells_a_tie_from_a_fault():
    """The tie witness on a made-up split: a scene with one sphere twice
    (two columns at the same f32 distance from any ray) recorded once; a
    copy that names the twin at the first bounce parts at an exact tie, a
    copy that names another sphere there does not."""
    b = rtt.SceneBuilder()
    b.add_sphere((0, -100.5, -2), 100.0, b.add_diffuse(color=(0.5, 0.5, 0.5)))
    m = b.add_diffuse(color=(0.8, 0.3, 0.2))
    for _ in range(2):
        b.add_sphere((0, 0, -2), 0.5, m)
    b.add_sphere((1.2, 0, -2), 0.5, m)
    scene = b.build(device="cpu")
    cam = rtt.make_camera(width=16, height=16, vfov=60.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          device="cpu")
    o, d, tm = _rays(cam, 256)
    rand = torch.from_numpy(_rand(256, 3))
    rays, want = _raw_record(scene, o, d, tm, rand, T_MIN)
    hit = want[0] == 1  # the first twin wins its ties
    assert hit.sum() > 10 and not (want == 2).any()
    twin, other = want.clone(), want.clone()
    twin[0, hit], other[0, hit] = 2, 3
    kw = dict(depth=3, t_min=T_MIN)
    assert tdk._exact_ties(scene, rays, rand, twin, want, **kw).all()
    assert not tdk._exact_ties(scene, rays, rand, other, want, **kw).any()


def test_streamed_beyond_shared_memory():
    """A sphere_field past the resident rule records streamed by default
    (original order, chunk-global indices); its indices equal a plain
    recording over the raw resident tables, and so do the replay's
    gradients (tests/test_diffkernel.py:333-397)."""
    scene, cam = rtt.scenes.sphere_field(n=4000, width=16, height=16,
                                         device="cpu")
    assert not tables.fits_shared(scene)
    layout = tables.resolve(scene, "record")
    assert layout.mode == tables.STREAMED
    assert layout.stream == tables.RECORD_STREAM_CHUNK
    assert tables.fits(scene, "record")
    o, d, tm = _rays(cam, 256)
    rand = torch.from_numpy(_rand(256, 4))
    idx_s = tdk.record_paths(scene, o, d, tm, rand, max_depth=4, t_min=T_MIN)
    resident = tables.resolve(scene, "record", stream=0)
    assert resident.mode == tables.RESIDENT
    raw = tdk._record_tables(scene, resident)
    stab, ttab = raw.stab, raw.ttab
    rays = torch.cat([o.T, d.T, tm[None]]).contiguous()
    idx_r = tdk._record_reference(stab, ttab, rays, rand, depth=4,
                                  t_min=T_MIN, has_motion=scene.has_motion,
                                  tri_base=stab.shape[1])
    assert torch.equal(idx_s, idx_r)
    assert (idx_s >= 1).any()  # hits beyond the ground

    def grads(idx):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in
             rtt.extract_params(scene, ("tex_color", "sphere_center")).items()}
        out = tdk.replay_paths(rtt.inject_params(scene, p), o, d, tm, rand,
                               idx, t_min=T_MIN)
        return torch.autograd.grad(((out - 0.25) ** 2).mean(),
                                   list(p.values()))

    for a, b in zip(grads(idx_s), grads(idx_r)):
        assert torch.equal(a, b)
    assert float(grads(idx_s)[0].abs().sum()) > 0


def test_fits_record_stream_boundary():
    """The streamed recorder's shared memory is 16 bytes per chunk of both
    classes: 14,528 chunks fit one H100 block (232,448 bytes)."""
    scene, _ = rtt.scenes.two_sphere(width=8, device="cpu")

    def with_spheres(n):
        z = torch.zeros((n, 3))
        return dataclasses.replace(
            scene, sphere_center=z, sphere_velocity=z,
            sphere_radius=torch.ones(n), sphere_valid=torch.ones(n, dtype=bool),
            sphere_material=torch.zeros(n, dtype=torch.int32), n_spheres=n)

    assert tables.fits(with_spheres(14528), "record", stream=1)
    assert not tables.fits(with_spheres(14529), "record", stream=1)
    assert tables.fits(with_spheres(14528 * 512), "record", stream=512)


# ---- 4. golden ----

def _force_stream(monkeypatch, chunk: int):
    """Have the recorder stream every scene in chunks of ``chunk``, as it
    does the scenes beyond one block's shared memory: its layout is
    resolved with that chunk wherever the rule would pick one."""
    resolve = tdk.resolve

    def forced(scene, engine, **kw):
        if engine == "record" and kw.get("stream") is None:
            kw["stream"] = chunk
        return resolve(scene, engine, **kw)
    monkeypatch.setattr(tdk, "resolve", forced)


@pytest.mark.parametrize("stream", [None, 128], ids=["resident", "stream128"])
def test_golden(stream, monkeypatch):
    """The golden image through render_diff, resident and (the chunk rule
    forced) streamed in chunks of 128."""
    modes = []
    record_tables = tdk._record_tables
    monkeypatch.setattr(tdk, "_record_tables",
                        lambda sc, layout, o: modes.append(layout.stream)
                        or record_tables(sc, layout, o))
    if stream:
        _force_stream(monkeypatch, stream)
    b = rtt.SceneBuilder()
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
    cam = rtt.make_camera(width=96, height=64, vfov=55.0, focus_dist=1.0,
                          defocus_angle=0.0, look_from=(0, 0.2, 0.6),
                          look_at=(0, 0, -2), device="cpu")
    cfg = rtt.RenderConfig(spp=1, max_depth=8, jitter=False)
    img = rtt.render_diff(b.build(device="cpu"), cam, 0, cfg)
    assert modes == [stream or 0]
    buf = io.BytesIO()
    write_ppm(img, buf)
    u8 = read_ppm(io.BytesIO(buf.getvalue())).astype(np.int32)
    diff = np.abs(u8 - read_ppm(GOLDEN).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


# ---- 5. the same paths as the megakernel ----

@pytest.mark.parametrize("name", ["random_bouncing", "cornell_box"])
def test_same_paths_as_megakernel(name):
    if name == "random_bouncing":
        scene, cam = rtt.scenes.random_bouncing(width=32, height=18, seed=2,
                                                device="cpu")
    else:
        scene, cam = rtt.scenes.cornell_box(width=16, tessellation=2,
                                            device="cpu")
    cfg = rtt.RenderConfig(spp=4, max_depth=8)
    img = rtt.render_diff(scene, cam, 9, cfg)
    ref = rtt.render_megakernel(scene, cam, 9, cfg)
    assert float(ref.std()) > 0.01
    d = (img - ref).abs()
    share = float((d <= 1e-4).double().mean())
    print(f"{name}: {share:.4%} of channels within 1e-4 of the megakernel")
    assert share > 0.99
    h8, w8 = (img.shape[0] // 8) * 8, (img.shape[1] // 8) * 8
    blk = (img - ref)[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8, 3)
    assert float(blk.mean((1, 3)).abs().max()) < 0.01
    torch.testing.assert_close(img, tpr.render_diff_pp(scene, cam, 9, cfg),
                               rtol=0, atol=1e-6)


# ---- 6. the distribution of JAX's render_diff ----

def test_distribution_matches_jax():
    def build(m, **kw):
        b = m.SceneBuilder()
        b.add_sphere((0, -100.5, -2), 100.0,
                     b.add_diffuse(color=(0.5, 0.5, 0.5)))
        b.add_sphere((0, 0, -2), 0.5, b.add_diffuse(color=(0.7, 0.3, 0.2)))
        cam = m.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                            look_from=(0, 0, 0), look_at=(0, 0, -1), **kw)
        return b.build(**kw), cam

    js, jc = build(rt)
    scene, cam = build(rtt, device="cpu")
    cfg = dict(spp=16, max_depth=6)
    want = np.asarray(jdk.render_diff(js, jc, 7, rt.RenderConfig(**cfg),
                                      interpret=True))
    got = rtt.render_diff(scene, cam, 7, rtt.RenderConfig(**cfg)).numpy()
    assert np.mean(np.abs(got - want)) < 0.025
    np.testing.assert_allclose(got, want, atol=0.3)


# ---- 7. gradients ----

def test_pixel_loss_matches_jax(monkeypatch):
    """Deterministic f64 config (fuzz-0 metals, jitter off): JAX's randoms
    are fed to the port, whose camera rays then equal JAX's bit for bit,
    so loss and every gradient (the fuzz one reads the unit vectors) agree
    to float64 rounding."""
    jscene, jcam = _metal_scene(rt, jnp.float64)
    scene, cam = _port(jscene, jcam)
    spp, depth, n = 2, 4, 256
    rands = []
    for k in jax.random.split(jax.random.PRNGKey(0), spp):
        _, k_mat = jax.random.split(k)
        rands.append(np.asarray(jdk._make_rand(k_mat, depth, n,
                                               jnp.float64)))
    monkeypatch.setattr(tdk, "_make_rand",
                        lambda seed, pix, s, d: torch.from_numpy(rands[s]))
    target = np.full((16, 16, 3), 0.3)
    cfg = dict(spp=spp, max_depth=depth, jitter=False)
    jl, jg = jax.value_and_grad(jpixel_loss)(
        jextract(jscene), jscene, jcam, 0, jnp.asarray(target),
        rt.RenderConfig(**cfg), "recorded")
    params = rtt.params_from_numpy({k: np.asarray(v) for k, v in
                                    jextract(jscene).items()})
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    loss, left = rtt.pixel_loss(params, scene, cam, 0,
                                torch.from_numpy(target),
                                rtt.RenderConfig(**cfg), "recorded",
                                return_leftover=True)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    assert int(left) == 0 and loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-9)
    for (name, v), g in zip(params.items(), grads):
        b = np.asarray(jg[name])
        a = np.zeros_like(b) if g is None else g.numpy()
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-12)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * scale,
                                   err_msg=name)
    assert float(np.abs(np.asarray(jg["mat_fuzz"])).sum()) > 0


def test_grad_matches_fd_vertices_and_centers():
    """The replay's derivative in triangle vertices and sphere centres
    against central finite differences, f64, on a fixed recording
    (tests/test_diffkernel.py:200-239); padding triangles never win, so
    they get zero gradient."""
    unit = rtt.models.DIFFUSE_UNIT_SPHERE
    b = rtt.SceneBuilder()
    tm_ = b.add_diffuse(color=(0.6, 0.4, 0.3), method=unit)
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_diffuse(color=(0.5, 0.5, 0.5), method=unit))
    b.add_sphere((0.9, 0.0, -2.2), 0.4,
                 b.add_metallic(color=(0.8, 0.8, 0.9), fuzz=0.0))
    b.add_triangle((-1.4, -0.5, -2.0), (0.2, -0.5, -2.0), (-0.6, 0.9, -2.0),
                   tm_)
    b.add_triangle((-1.4, -0.5, -2.4), (-0.6, 0.9, -2.4), (0.2, -0.5, -2.4),
                   tm_)
    scene = b.build(dtype=torch.float64, device="cpu")
    cam = rtt.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          dtype=torch.float64, device="cpu")
    depth = 4
    o, d, tm = _rays(cam, 256, jitter=False)
    rand = tdk._make_rand(5, torch.arange(256, dtype=torch.int32), 0, depth)
    idx = tdk.record_paths(scene, o, d, tm, rand, max_depth=depth,
                           t_min=T_MIN)
    n_sph = int(scene.sphere_radius.shape[0])
    assert (idx >= n_sph).any(), "no triangle hits recorded"

    def loss(v, c):
        s = dataclasses.replace(scene, tri_v0=v[0], tri_v1=v[1],
                                tri_v2=v[2], sphere_center=c)
        return (tdk.replay_paths(s, o, d, tm, rand, idx, t_min=T_MIN)
                ** 2).mean()

    v = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2])
    c = scene.sphere_center.clone()
    gv, gc = torch.autograd.grad(loss(v.requires_grad_(True),
                                      c.requires_grad_(True)), (v, c))
    v, c = v.detach(), c.detach()
    eps = 1e-6
    checks = [(gv, (vi, ti, ci)) for vi in range(3) for ti in range(2)
              for ci in range(3)] + [(gc, (1, ci)) for ci in range(3)]
    for g, at in checks:
        dv, dc = torch.zeros_like(v), torch.zeros_like(c)
        (dv if g is gv else dc)[at] = eps
        fd = float((loss(v + dv, c + dc) - loss(v - dv, c - dc)) / (2 * eps))
        assert abs(float(g[at]) - fd) <= 1e-7 + 1e-4 * abs(fd), (at, fd)
    assert float(gv[:, :2].abs().sum()) > 0 and float(gc.abs().sum()) > 0
    assert float(gv[:, 2:].abs().sum()) == 0.0  # padding triangles


# ---- 8. entry points and refusals ----

def test_make_train_step_and_fit():
    jscene, jcam = _metal_scene(rt, jnp.float32)
    scene, cam = _port(jscene, jcam)
    cfg = rtt.RenderConfig(spp=2, max_depth=4)
    target = torch.full((16, 16, 3), 0.3)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in rtt.extract_params(scene, ("tex_color",)).items()}
    before = params["tex_color"].detach().clone()
    step = rtt.make_train_step(torch.optim.Adam(params.values(), lr=1e-2),
                               cfg, engine="recorded", with_leftover=True)
    out, loss, left = step(params, scene, cam, 0, target)
    assert out is params and int(left) == 0 and np.isfinite(float(loss))
    assert not torch.equal(params["tex_color"].detach(), before)
    fitted, hist = rtt.fit(scene, cam, target, config=cfg, steps=2,
                           engine="recorded", fields=("tex_color",))
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert not torch.equal(fitted.tex_color, scene.tex_color)


def test_recordable_gates():
    big, cam = rtt.scenes.sphere_field(n=14_000, width=8, device="cpu")
    assert not tables.fits_shared(big)
    inverse._check_recordable(big, "recorded")  # streamed: accepted
    with pytest.raises(ValueError, match="shared memory.*'recorded'"):
        inverse._check_recordable(big, "recorded-pp")
    b = rtt.SceneBuilder()
    e = b.add_solid_texture((0.1, 0.1, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    inner = b.add_checker_texture(0.3, e, o)
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(
        texture=b.add_checker_texture(1.1, inner, o)))
    nested = b.build(device="cpu")
    cfg = rtt.RenderConfig(spp=1, max_depth=2)
    for engine in ("recorded", "recorded-pp"):
        with pytest.raises(ValueError, match="checker"):
            inverse._check_recordable(nested, engine)
    with pytest.raises(ValueError, match="checker"):
        rtt.render_diff(nested, rtt.make_camera(width=8, height=8,
                                                device="cpu"), 0, cfg)
    # forced resident, the packed sphere records (16 bytes a column without
    # motion) of 20,000 spheres exceed one block's shared memory
    bigger, cam = rtt.scenes.sphere_field(n=20_000, width=8, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        tdk.record_paths(bigger, *_rays(cam, 8), torch.zeros((2, 5, 8)),
                         max_depth=2, t_min=T_MIN, stream=0)


def test_resident_record_outputs_start_dead():
    """The resident kernel (the ray queue) writes winners only: its wrapper
    hands it idx filled with -1 and the queue's zeroed counter [2] (rays
    claimed, the last claim's clock); the streamed kernel writes every
    index and takes no counter."""
    idx, counter = tdk._record_outputs(4, 10, "cpu", True)
    assert idx.shape == (4, 10) and idx.dtype == torch.int32
    assert bool((idx == -1).all())
    assert counter.dtype == torch.int64 and counter.tolist() == [0, 0]
    idx, counter = tdk._record_outputs(4, 10, "cpu", False)
    assert idx.shape == (4, 10) and counter is None


def _spy_record(monkeypatch):
    """Record every call of the record wrapper: (rays, the sphere table's
    storage, the indices it returned)."""
    calls = []
    record = tdk._record

    def spy(stab, ttab, rays, rand, **kw):
        idx = record(stab, ttab, rays, rand, **kw)
        calls.append((rays.shape[1], stab.data_ptr(), idx))
        return idx

    monkeypatch.setattr(tdk, "_record", spy)
    return calls


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["resident", "streamed"])
def test_one_record_launch_per_group(monkeypatch, streamed):
    """render_diff records the resident sample passes RECORD_GROUP at a
    time, one call of the record wrapper (one launch on the card, counted
    in LAUNCHES there) over their rays side by side, and the streamed ones
    one pass per call; the tables are built once."""
    if streamed:
        _force_stream(monkeypatch, 128)
    calls = _spy_record(monkeypatch)
    scene, cam = rtt.scenes.random_bouncing(width=8, height=6, device="cpu")
    spp = tdk.RECORD_GROUP + 2
    rtt.render_diff(scene, cam, 0, rtt.RenderConfig(spp=spp, max_depth=3))
    want = [48] * spp if streamed else [48 * tdk.RECORD_GROUP, 96]
    assert [c[0] for c in calls] == want
    assert len({c[1] for c in calls}) == 1


def test_grouped_recording_changes_nothing(monkeypatch):
    """Passes recorded three at a time give each pass the indices it gets
    alone, and pixel_loss(engine="recorded") the same value and gradient
    bit for bit (each pass's rays and randoms in the group are the ones its
    replay regenerates)."""
    scene, cam = rtt.scenes.random_bouncing(width=8, height=6, device="cpu")
    cfg = rtt.RenderConfig(spp=5, max_depth=4)
    target = torch.full((cam.height, cam.width, 3), 0.25)
    out = {}
    for group in (1, 3):
        monkeypatch.setattr(tdk, "RECORD_GROUP", group)
        calls = _spy_record(monkeypatch)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in rtt.extract_params(scene).items()}
        loss = rtt.pixel_loss(params, scene, cam, 3, target, cfg, "recorded")
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        out[group] = (torch.cat([c[2] for c in calls], dim=1), loss, grads)
        monkeypatch.undo()
    (i1, l1, g1), (i3, l3, g3) = out[1], out[3]
    assert i3.shape == i1.shape == (4, 5 * 48) and torch.equal(i1, i3)
    assert torch.equal(l1, l3)
    assert any(g is not None for g in g1)
    for a, b in zip(g1, g3):
        assert (a is None and b is None) or torch.equal(a, b)


def test_record_kernel_raises_off_cpu():
    dev = "meta"
    scene, _ = rtt.scenes.two_sphere(width=8, device="cpu")
    layout = tables.resolve(scene, "record")
    n = layout.n_pad
    with pytest.raises(ValueError, match="no record kernel"):
        tdk._record(torch.zeros((17, n), device=dev),
                    torch.zeros((20, 0), device=dev),
                    torch.zeros((7, 4), device=dev),
                    torch.zeros((2, 5, 4), device=dev), depth=2, t_min=T_MIN,
                    has_motion=False, tri_base=n, layout=layout)


# ---- 9. the kernel on the card ----

@pytest.fixture
def cuda_device():
    """Decided per test (never at import): the kernel needs the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernel on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [0, 128], ids=["resident", "stream128"])
def test_record_kernel_matches_plain_on_card(cuda_device, stream):
    jscene, jcam = _jax_scene("mixed")
    scene, cam = _port(jscene, jcam)
    o, d, tm = _rays(cam, 1000)
    rand = torch.from_numpy(_rand(1000, 6))
    kw = dict(max_depth=6, t_min=T_MIN, stream=stream)
    want = tdk.record_paths(scene, o, d, tm, rand, **kw)
    key = "streamed" if stream else "resident"
    before = tdk.LAUNCHES[key]
    got = tdk.record_paths(scene.to(cuda_device),
                           *(x.to(cuda_device) for x in (o, d, tm, rand)),
                           **kw)
    assert tdk.LAUNCHES[key] == before + 1
    got = got.cpu()
    if stream:
        assert torch.equal(got, want)
    else:  # the packed sweep: equal, or parted at a near tie by the rule
        rays = torch.cat([o.T, d.T, tm[None]]).float().contiguous()
        ok = sw.explain_paths(scene, rays, rand.float(), got, want,
                              t_min=T_MIN)
        assert ok is None or bool(ok.all())
        assert float((got == want).double().mean()) >= 0.999
