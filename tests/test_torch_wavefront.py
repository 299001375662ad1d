"""The port's wavefront engine (rayz_tpu_torch/ops/wavefront.py) against the
JAX package and against the port's megakernel. On the CPU the wrapper runs
the kernel's plain version, which is what the CUDA kernel is held against on
the card (chip_smoke.py).

Tolerances:
* golden: the allowance tests/test_golden.py gives the JAX engines (+-1 u8
  step on < 0.5% of channels);
* zero random bits vs JAX ``render_wavefront(interpret=True)`` (whose
  interpreter draws zero bits): atol 1e-5 on all but 0.1% of channels and
  5e-5 on every channel, the megakernel's bound (tests/test_torch_megakernel
  .py): XLA contracts multiply-adds and approximates the triangle's
  reciprocal with a Newton step, the port rounds every operation;
* against the port's megakernel, same seed: at least 99.9% of pixels
  identical (one ray follows the same path in both engines; only an exact
  tie between two columns, met in another order, may resolve otherwise).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.ops.wavefront import render_wavefront as jax_wavefront
from rayz_tpu_torch.ops import engine, tables, wavefront as wf
from test_torch_megakernel import (_full_table_scene, _golden_allowance,
                                   _golden_scene, _mixed_primitives, _port,
                                   _zero_bits)

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    """Decided per test (never at import): the kernel needs the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernel on "
                    "the card")
    return torch.device("cuda", 0)


def _same(a, b) -> float:
    return float((a == b).all(dim=-1).double().mean())


@pytest.mark.parametrize("mode", [{}, dict(stream=128)],
                         ids=["resident", "streamed"])
def test_golden_plain_version(mode):
    scene, cam, cfg = _port(_golden_scene)
    before = wf.LAUNCHES
    img = wf.render_wavefront(scene, cam, 0, cfg, **mode)
    assert wf.LAUNCHES == before  # CPU tensors never launch the kernel
    step, frac = _golden_allowance(img)
    assert step <= 1 and frac < 0.005, (step, frac)


@pytest.mark.parametrize("mode", [{}, dict(culling=True), dict(stream=128)],
                         ids=["resident", "culled", "streamed"])
def test_zero_bits_matches_jax_interpreter(mode, monkeypatch):
    """Two dielectric IORs (JAX keeps its full tables), a fuzzy metal, a
    triangle and UNIT_SPHERE diffuse surfaces, jitter off: with zero random
    bits on both sides every path is fixed. Resident at depth 4 (three
    synchronous launches and the tail); the culled and streamed modes at
    depth 3, three synchronous launches (the tail runs the same sweep and
    shading; the JAX interpreter takes ~10 s per launch kind and mode)."""
    jscene, _, cfg = _full_table_scene(rt, dtype=jnp.float32)
    cfg = dict(cfg, spp=1, max_depth=3 if mode else 4)
    view = dict(width=16, height=16, vfov=55.0, focus_dist=1.0,
                look_from=(0, 0.2, 0.5), look_at=(0, 0, -2))
    jcam = rt.make_camera(dtype=jnp.float32, **view)
    want = np.asarray(jax_wavefront(jscene, jcam, 0, rt.RenderConfig(**cfg),
                                    interpret=True, **mode))
    monkeypatch.setattr(wf, "_wf_bounce", functools.partial(
        wf._wf_bounce_reference, bits=_zero_bits))
    scene, _, _ = _port(_full_table_scene)
    cam = rtt.make_camera(device="cpu", **view)
    got = wf.render_wavefront(scene, cam, 0, rtt.RenderConfig(**cfg),
                              **mode).numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    print(f"{mode}: max abs {diff.max():.3g}, {(diff > 1e-5).sum()} "
          "channels above 1e-5")
    assert (diff > 1e-5).mean() < 1e-3, (diff > 1e-5).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def _triangle_scene():
    b = rtt.SceneBuilder()
    _mixed_primitives(b)
    cam = rtt.make_camera(width=24, height=14, look_from=(0, 0.5, 1.5),
                          look_at=(0, 0, -1), defocus_angle=1.0,
                          focus_dist=2.0, device="cpu")
    return b.build(device="cpu"), cam


@pytest.mark.parametrize("name", ["random_bouncing", "triangles"])
@pytest.mark.parametrize("mode", [{}, dict(culling=True), dict(stream=128)],
                         ids=["resident", "culled", "streamed"])
def test_matches_megakernel_same_seed(name, mode):
    """Real random bits, jitter and defocus (motion and glass in
    random_bouncing; a triangle-dominant scene otherwise)."""
    if name == "random_bouncing":
        scene, cam = rtt.scenes.random_bouncing(width=24, height=14, seed=1,
                                                device="cpu")
    else:
        scene, cam = _triangle_scene()
    cfg = rtt.RenderConfig(spp=3, max_depth=6)
    ref = rtt.render_megakernel(scene, cam, 4, cfg, passes=0)
    img = wf.render_wavefront(scene, cam, 4, cfg, **mode)
    share = _same(img, ref)
    print(f"{name} {mode}: {share:.4%} of pixels identical")
    assert float(ref.std()) > 0.01
    assert share >= 0.999, share


def test_padding_rays_never_reach_the_image():
    """20x12 pixels at 3 spp: 720 rays in 768 slots (6 tiles), no patch
    order. Pixel 0, which a padding ray's id would wrap onto, and every
    other pixel equal the megakernel's."""
    scene, cam = rtt.scenes.random_bouncing(width=20, height=12, seed=2,
                                            device="cpu")
    cfg = rtt.RenderConfig(spp=3, max_depth=5)
    ref = rtt.render_megakernel(scene, cam, 9, cfg, passes=0)
    img = wf.render_wavefront(scene, cam, 9, cfg)
    assert not tables.use_patch_order(20, 12)
    assert torch.equal(img[0, 0], ref[0, 0])
    assert torch.equal(img, ref)


def test_sort_options_change_only_the_order():
    scene, cam, cfg = _port(_golden_scene)
    ref = wf.render_wavefront(scene, cam, 0, cfg)
    for kw in (dict(sort=False), dict(resort=True)):
        assert torch.equal(wf.render_wavefront(scene, cam, 0, cfg, **kw), ref)


def test_dispatch(monkeypatch):
    small, cam = rtt.scenes.random_bouncing(width=8, height=4, device="cpu")
    big, bcam = rtt.scenes.sphere_field(n=3_500, width=8, height=4,
                                        device="cpu")
    assert engine.pick_engine(small) == "megakernel"
    assert engine.pick_engine(big) == "wavefront"
    assert wf.supports_wavefront(big)
    assert engine.pick_engine(small, "wavefront") == "wavefront"

    seen = []
    real = wf.render_wavefront

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(engine, "render_wavefront", spy)
    cfg = rtt.RenderConfig(spp=1, max_depth=2)
    img = engine.render_fast(big, bcam, 0, cfg, passes=3, budget=2,
                             stream=256, sort=False)
    assert seen == [dict(stream=256, sort=False)]
    assert torch.equal(img, rtt.render_megakernel(big, bcam, 0, cfg))

    b = rtt.SceneBuilder()
    e = b.add_solid_texture((0.1, 0.1, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    outer = b.add_checker_texture(1.1, b.add_checker_texture(0.3, e, o), o)
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(texture=outer))
    # nested checkers and scenes beyond the streamed tables go to the dense
    # integrator (both raised until it was ported)
    assert engine.pick_engine(b.build(device="cpu")) == "xla"
    # beyond the wavefront's shared memory, the streamed megakernel
    fits = engine.fits
    monkeypatch.setattr(engine, "fits", lambda scene, eng, **kw: (
        eng == "megakernel" and fits(scene, eng, **kw)))
    assert engine.pick_engine(big) == "megakernel"
    monkeypatch.setattr(engine, "fits", lambda scene, eng, **kw: False)
    assert engine.pick_engine(big) == "xla"


def test_wrapper_validates_inputs():
    scene, cam, cfg = _port(_golden_scene)
    layout = tables.resolve(scene, "wavefront")
    tabs, _ = tables.layout_tables(scene, layout, cam.look_from, memo=False)
    rays = wf._Rays(tables._camera_vector(cam).contiguous(),
                    wf._slot_pixels(cam), 96 * 64, 96)
    rid = torch.arange(6144, dtype=torch.int32)
    kw = dict(bounce=0, loop_bounces=1, t_min=1e-3, jitter=False,
              has_motion=False, seed=0, layout=layout)
    st, alive, rad = wf._wf_bounce(tabs, rays, None, None, rid, **kw)
    assert st.shape == (wf.ST, 6144) and alive.dtype == torch.int32
    assert rad.shape == (3, 6144)
    with pytest.raises(ValueError, match="multiple"):
        wf._wf_bounce(tabs, rays, None, None, rid[:100], **kw)
    with pytest.raises(ValueError, match="int32"):
        wf._wf_bounce(tabs, rays, st, alive.long(), rid, **kw)
    meta = tabs._replace(stab=tabs.stab.to("meta"), ttab=tabs.ttab.to("meta"))
    mrays = wf._Rays(rays.cam.to("meta"), rays.slot_pix.to("meta"), 6144, 96)
    with pytest.raises(ValueError, match="no wavefront kernel"):
        wf._wf_bounce(meta, mrays, None, None, rid.to("meta"), **kw)
    streamed = tables.resolve(scene, "wavefront", stream=128)
    with pytest.raises(ValueError, match="not those of"):
        wf._wf_bounce(tabs, rays, None, None, rid,
                      **dict(kw, layout=streamed))


@pytest.mark.parametrize("bad", [dict(loop_bounces=0), dict(bounce=-1),
                                 dict(stats=torch.zeros(8,
                                                        dtype=torch.int32)),
                                 dict(stats=torch.zeros(9,
                                                        dtype=torch.int64))],
                         ids=["no_bounce", "negative_bounce", "stats_int32",
                              "stats_9"])
def test_wrapper_refuses_launch_arguments(bad):
    """A launch's bounces and counters are checked before any device is
    chosen, so the plain version refuses them as the kernel would."""
    scene, cam, _ = _port(_golden_scene)
    layout = tables.resolve(scene, "wavefront")
    tabs, _ = tables.layout_tables(scene, layout, cam.look_from, memo=False)
    rays = wf._Rays(tables._camera_vector(cam).contiguous(),
                    wf._slot_pixels(cam), 96 * 64, 96)
    rid = torch.arange(6144, dtype=torch.int32)
    kw = dict(bounce=0, loop_bounces=1, t_min=1e-3, jitter=False,
              has_motion=False, seed=0, layout=layout)
    with pytest.raises(ValueError, match="bounce|stats"):
        wf._wf_bounce(tabs, rays, None, None, rid, **{**kw, **bad})


@pytest.mark.parametrize("loop_bounces", [1, 2, 37])
def test_tail_counter(loop_bounces):
    """Only a launch of more than one bounce (the tail) gets the slot
    counter that makes the kernel a ray queue: a zeroed int64 [1] on the
    launch's device, made anew each launch."""
    c = wf._tail_counter(loop_bounces, torch.device("cpu"))
    if loop_bounces == 1:
        assert c is None
    else:
        assert c.dtype == torch.int64 and c.shape == (1,) and int(c) == 0
        assert c is not wf._tail_counter(loop_bounces, torch.device("cpu"))


@pytest.mark.parametrize("name", ["field", "box"])
def test_streamed_launch_shared_memory(name):
    """A streamed launch's shared memory as the wrapper accounts it: the
    camera and 8 work counters per warp tile, then for each of the block's
    WF_BLOCK // 32 warp tiles the staging of 32 columns of the largest
    record its sweeps read (a triangle's 12 sweep rows; a sphere's 9 with
    motion) and of its 32 rays (12 words each), each thread's parked
    throughput and radiance, then the chunk and supercluster bound rows of
    both classes."""
    scene, cam = (rtt.scenes.sphere_field(n=3000, width=16, device="cpu")
                  if name == "field"
                  else rtt.scenes.cornell_box(width=16, device="cpu"))
    layout = tables.resolve(scene, "wavefront", stream=128)
    tabs, _ = tables.layout_tables(scene, layout, cam.look_from, memo=False)
    rows = sum(4 * (n // 128 + (n // (128 * tabs.sc_group)
                                if tables._sc_enabled(n, 128, tabs.sc_group)
                                else 0))
               for n in (tabs.n_pad, tabs.m_pad))
    warps = wf.WF_BLOCK // 32
    assert tables.WF_HEAD_WORDS == 20 + 8 * warps
    assert tables.WF_STAGE_WORDS == warps * (32 * 12 + 32 * 12)
    assert tables.WF_PARK_WORDS == wf.WF_BLOCK * 6
    assert layout.smem == 4 * (
        tables.WF_HEAD_WORDS + tables.WF_STAGE_WORDS + tables.WF_PARK_WORDS
        + rows)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """The CUDA kernel itself (chip_smoke.py runs this and more on the
    card): every launch of a streamed render against the plain version on
    the same inputs, and the golden."""
    scene, cam, cfg = _port(_golden_scene)
    scene, cam = scene.to(cuda_device), cam.to(cuda_device)
    kernel = wf._wf_bounce
    launches = []

    def both(*args, **kw):
        k = kernel(*args, **kw)
        p = wf._wf_bounce_reference(*args, **kw)
        launches.append(all(torch.equal(a, b) for a, b in zip(k, p)))
        return k

    wf._wf_bounce = both
    try:
        img = wf.render_wavefront(scene, cam, 0, cfg, stream=128)
    finally:
        wf._wf_bounce = kernel
    torch.cuda.synchronize()
    assert launches == [True] * 4
    step, frac = _golden_allowance(img.cpu())
    assert step <= 1 and frac < 0.005, (step, frac)


def _tail_case(name, dev):
    """A small scene and its table layout's keyword arguments, with more
    live rays at 16 spp than an H100 holds lanes at once (132 SMs x 7
    blocks x 128 = 118,272), so lanes take second rays: the Cornell box
    (paths alive to depth 32) resident and streamed, the flagship's moving
    spheres resident, the 3,000-sphere field culled."""
    if name == "box":
        return rtt.scenes.cornell_box(width=128, device=dev), {}
    if name == "box_streamed":
        return (rtt.scenes.cornell_box(width=128, device=dev),
                dict(stream=128))
    if name == "motion":
        return rtt.scenes.random_bouncing(width=256, device=dev), {}
    return rtt.scenes.sphere_field(n=3000, width=256, device=dev), {}


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["partitioned", "unpartitioned",
                                   "spawned"])
@pytest.mark.parametrize("name", ["box", "box_streamed", "motion",
                                  "field_culled"])
def test_tail_queue_matches_plain_on_card(cuda_device, name, order):
    """The tail launch's ray queue against the plain version on every slot
    (state, alive flag, radiance): after a bounce launch, its rays
    partitioned dead-last as the render does, or left in ray order, or a
    queue launch that spawns the camera rays itself; 16 spp, depth 16. Its
    counters show lanes that took a ray after their first, and as many
    segments as its warps' trips allow."""
    (scene, cam), layout_kw = _tail_case(name, cuda_device)
    layout = tables.resolve(scene, "wavefront", **layout_kw)
    tabs, _ = tables.layout_tables(scene, layout, cam.look_from, memo=False)
    spp, depth = 16, 16
    n = cam.width * cam.height * spp
    rays = wf._Rays(tables._camera_vector(cam).contiguous(),
                    wf._slot_pixels(cam), n, cam.width)
    r_pad = -(-n // wf.WF_BLOCK) * wf.WF_BLOCK
    rid = torch.arange(r_pad, dtype=torch.int32, device=cuda_device)
    kw = dict(t_min=1e-3, jitter=True, has_motion=scene.has_motion, seed=7,
              layout=layout)
    st = alive = None
    first = 0
    if order != "spawned":
        st, alive, _ = wf._wf_bounce(tabs, rays, None, None, rid, bounce=0,
                                     loop_bounces=1, **kw)
        first = 1
        if order == "partitioned":
            perm = wf._dead_last(alive)
            st, alive, rid = (t[..., perm].contiguous()
                              for t in (st, alive, rid))
    stats = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    args = (tabs, rays, st, alive, rid)
    tail = dict(bounce=first, loop_bounces=depth - first, **kw)
    k = wf._wf_bounce(*args, stats=stats, **tail)
    p = wf._wf_bounce_reference(*args, **tail)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b), (name, order)
    seg, trips, again = (int(stats[i]) for i in (0, 5, 7))
    assert again > 0 and 0 < seg <= 32 * trips, (seg, trips, again)
