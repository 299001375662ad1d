"""The port's culling table prep (rayz_tpu_torch/ops/tables.py) against the
JAX package's: Morton order, block bound rows, near-to-far order, the
culled resident layout and the streamed layout with superclusters, on a
moving-sphere scene, a triangle scene and a mixed one. Then the memo of a
render's tables on the three paths that look them up (the megakernel
resident and streamed, the wavefront streamed): hits, misses, bypasses and
eviction, every image bit for bit a cold render's.

Tolerance: permutations equal; tables and bound rows within 1 ulp (both
build from the same float32 values in the same order; the rows agree bit
for bit today)."""

import dataclasses
import functools
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.ops import megakernel as jmk
from rayz_tpu.ops import wavefront as jwf
from rayz_tpu_torch.ops import tables, wavefront as twf

torch.set_num_threads(2)


def _mixed(m, **dt):
    """Spheres (one moving) and triangles in one scene. The triangles' vertices
    lie on a 1/16 grid, so the products of the triangle table are exact in
    float32 (XLA contracts the cross product into multiply-adds, which
    rounds otherwise than separate operations)."""
    b = m.SceneBuilder()
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(color=(0.5, 0.5, 0.5)))
    b.add_sphere((0.4, 0.2, -0.5), 0.3, b.add_dielectric(1.5),
                 velocity=(0.0, 0.2, 0.0))
    mt = b.add_metallic(color=(0.7, 0.8, 0.9), fuzz=0.2)
    g = np.random.default_rng(4)
    for _ in range(150):
        c = g.integers(-32, 32, 3) / 16
        b.add_triangle(c, c + g.integers(-5, 6, 3) / 16,
                       c + g.integers(-5, 6, 3) / 16, mt)
        b.add_sphere(g.uniform(-2, 2, 3), g.uniform(0.05, 0.2), mt)
    cam = m.make_camera(width=16, height=16, look_from=(0, 1, 3),
                        look_at=(0, 0, 0), **dt)
    return b.build(**dt), cam


def _pair(name):
    if name == "mixed":
        return _mixed(rt, dtype=jnp.float32), _mixed(rtt, device="cpu")
    kw = dict(random_bouncing=dict(width=16, seed=3),
              cornell_box=dict(width=16, tessellation=6))[name]
    return (rt.scenes.SCENES[name](dtype=jnp.float32, **kw),
            rtt.scenes.SCENES[name](device="cpu", **kw))


SCENES = ["random_bouncing", "cornell_box", "mixed"]


def _ulp1(got, want, what):
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(want, np.float32), maxulp=1)
    assert got.shape == want.shape, what


def _classes(js, ts):
    """(JAX aabbs, port aabbs, valid masks) per present class."""
    out = []
    if js.n_spheres:
        out.append((jmk._sphere_aabbs(js), tables._sphere_aabbs(ts),
                    js.sphere_valid, ts.sphere_valid))
    if js.n_triangles:
        out.append((jmk._tri_aabbs(js), tables._tri_aabbs(ts),
                    js.tri_valid, ts.tri_valid))
    return out


@pytest.mark.parametrize("name", SCENES)
def test_morton_blocks_and_near_to_far_match_jax(name):
    (js, jc), (ts, tc) = _pair(name)
    origin_j = jmk._cam_origin(jc)
    origin_t = tc.look_from.to(torch.float32)
    for (jlo, jhi), (tlo, thi), jv, tv in _classes(js, ts):
        _ulp1(tlo.numpy(), np.asarray(jlo), "aabb lo")
        _ulp1(thi.numpy(), np.asarray(jhi), "aabb hi")
        jp = np.asarray(jmk._morton_perm(jlo, jhi, jv))
        tp = tables._morton_perm(tlo, thi, tv).numpy()
        np.testing.assert_array_equal(tp, jp)
        n = (tp.shape[0] // 64) * 64
        jlo, jhi, jv = (x[jp][:n] for x in (jlo, jhi, jv))
        tlo, thi, tv = (x[torch.from_numpy(tp)][:n] for x in (tlo, thi, tv))
        for blk in (16, 64):
            _ulp1(tables._block_rows(tlo, thi, tv, blk).numpy(),
                  np.asarray(jmk._block_rows(jlo, jhi, jv, blk)), "rows")
        tab_j = jnp.arange(n, dtype=jnp.float32)[None, :]
        tab_t = torch.arange(n, dtype=torch.float32)[None, :]
        for group, within in ((32, 0), (16, 64), (64, 0)):
            jr = jmk._near_to_far(tab_j, jlo, jhi, jv, group, origin_j,
                                  within=within)
            tr = tables._near_to_far(tab_t, tlo, thi, tv, group, origin_t,
                                     within=within)
            np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
            np.testing.assert_array_equal(tr[3].numpy(), np.asarray(jr[3]))


def _counts(js):
    return (int(js.sphere_radius.shape[0]) if js.n_spheres else 0,
            int(js.tri_material.shape[0]) if js.n_triangles else 0)


@pytest.mark.parametrize("name", SCENES)
def test_culled_resident_layout_matches_jax(name):
    (js, _), (ts, _) = _pair(name)
    unroll = tables._resolve_tiling(ts)
    tabs, brows, n_pad, m_pad = jmk._smem_scene_inputs(
        js, False, 64, unroll, *_counts(js))
    got = tables._smem_scene_inputs(ts, unroll, 64)
    assert (got.n_pad, got.m_pad, got.blk) == (n_pad, m_pad, 64)
    port_tabs = [t for t in (got.stab, got.ttab) if t.shape[1]]
    port_rows = [t for t in (got.sblk, got.tblk) if t.shape[1]]
    assert len(port_tabs) == len(tabs) and len(port_rows) == len(brows)
    for a, b in zip(port_tabs + port_rows, list(tabs) + list(brows)):
        _ulp1(a.numpy(), np.asarray(b), "resident")


@pytest.mark.parametrize("stream,blk", [(128, 16), (256, 32)])
@pytest.mark.parametrize("name", SCENES)
def test_streamed_layout_matches_jax(name, stream, blk):
    (js, jc), (ts, tc) = _pair(name)
    lay = tables.resolve(ts, "wavefront", stream=stream)
    n_r, m_r, g = lay.n_pad, lay.m_pad, lay.sc_group
    jn_r = -(-_counts(js)[0] // stream) * stream
    jm_r = -(-_counts(js)[1] // stream) * stream
    assert (n_r, m_r, g) == (jn_r, jm_r,
                             jmk._pick_sc_group(max(jn_r, jm_r) // stream))
    (tabs, _, cbnds, scbnds, blk_hbm, n_pad,
     m_pad) = jmk._stream_scene_inputs(js, False, stream, blk,
                                       jmk._cam_origin(jc), *_counts(js), g)
    got = tables._stream_scene_inputs(ts, stream, blk,
                                      tc.look_from.to(torch.float32), g)
    assert (got.n_pad, got.m_pad, got.sc_group) == (n_pad, m_pad, g)
    present = [k for k, n in enumerate((n_pad, m_pad)) if n]
    for k, jt in zip(present, tabs):
        pt = (got.stab, got.ttab)[k]
        _ulp1(pt.numpy(), np.asarray(jt)[:pt.shape[0]], "table")
        _ulp1((got.scb, got.tcb)[k].numpy(), np.asarray(cbnds[present.index(k)]),
              "chunk bounds")
        _ulp1((got.sblk, got.tblk)[k].numpy(),
              np.asarray(blk_hbm[present.index(k)])[:4], "block rows")
    port_sc = [t for t in (got.ssc, got.tsc) if t.shape[1]]
    assert len(port_sc) == len(scbnds)
    for a, b in zip(port_sc, scbnds):
        _ulp1(a.numpy(), np.asarray(b), "supercluster bounds")
    if name != "mixed" and stream == 128:
        assert len(port_sc) == 1  # 4 chunks: superclusters exercised


def test_small_helpers_match_jax():
    for n in range(1, 40):
        assert tables._pick_sc_group(n) == jmk._pick_sc_group(n)
        for g in (0, 2, 5):
            assert (tables._sc_enabled(n * 128, 128, g)
                    == jmk._sc_enabled(n * 128, 128, g))
    for w, h in ((128, 64), (64, 32), (20, 12), (512, 288)):
        assert tables.use_patch_order(w, h) == jmk.use_patch_order(w, h)
        np.testing.assert_array_equal(tables._patch_inverse(w, h),
                                      jmk._patch_inverse(w, h))
    for name in SCENES:
        (js, _), (ts, _) = _pair(name)
        for culling in (None, True, False):
            assert (tables._resolve_blk(ts, culling, 64)
                    == jmk._resolve_blk(js, culling, 64))
        jlo, jspan = jwf._scene_bounds(js)
        tlo, tspan = tables._scene_bounds(ts)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(tspan.numpy(), np.asarray(jspan))


def test_sort_key_matches_jax():
    g = np.random.default_rng(0)
    o = g.uniform(-3, 3, (4096, 3)).astype(np.float32)
    d = g.standard_normal((4096, 3)).astype(np.float32)
    alive = (g.random(4096) < 0.7).astype(np.int32)
    lo = np.array([-2.5, -3.0, -1.0], np.float32)
    span = np.array([5.0, 6.5, 2.0], np.float32)
    want = np.asarray(jwf._sort_key(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(alive), jnp.asarray(lo),
                                    jnp.asarray(span)))
    st = torch.from_numpy(np.concatenate([o.T, d.T]))
    got = twf._sort_key(st, torch.from_numpy(alive), torch.from_numpy(lo),
                        torch.from_numpy(span))
    np.testing.assert_array_equal(got.numpy(), want)


def test_streamed_residency_rule():
    """The wavefront's streamed layout counts its launch's shared memory:
    the head (camera and the warps' counters), the warps' column and ray
    staging, the parked ray states and the chunk and supercluster bound
    rows. At the default chunk of 512 a 100k-sphere field (196 chunks in
    49 superclusters) needs 19,488 bytes; the rule gives out near 6.9 M
    columns. The streamed megakernel's counts the camera, its warps'
    staging of 4 words a record, 9 with motion, and the chunk bound rows,
    and gives out near 7.37 M columns (7.29 M with motion); fits_shared
    stops at n_pad 3,416."""
    chunk = tables.DEFAULT_STREAM_CHUNK
    assert chunk == 512
    field100k, _ = rtt.scenes.sphere_field(n=100_000, width=8, device="cpu")
    lay = tables.resolve(field100k, "wavefront")
    assert (lay.n_pad, lay.m_pad, lay.sc_group, lay.stream) == (
        100_352, 0, 4, chunk)
    assert lay.smem == 4 * (52 + 3072 + 768 + 4 * (196 + 49))
    wf_bytes = functools.partial(tables._launch_bytes, "wavefront",
                                 stream=chunk, sc_group=0)
    assert wf_bytes(13_500 * chunk, 0) <= tables.SHARED_LIMIT
    assert wf_bytes(13_600 * chunk, 0) > tables.SHARED_LIMIT
    mk_bytes = functools.partial(tables._launch_bytes, "megakernel",
                                 stream=chunk)
    assert mk_bytes(100_352, 0) == 4 * (20 + 4 * 32 * 4 + 4 * 196)
    assert mk_bytes(100_352, 0, motion=True) == 4 * (20 + 4 * 32 * 9
                                                     + 4 * 196)
    for motion, fits in ((False, 14_395), (True, 14_235)):
        assert mk_bytes(fits * chunk, 0, motion=motion) <= tables.SHARED_LIMIT
        assert mk_bytes((fits + 1) * chunk, 0,
                        motion=motion) > tables.SHARED_LIMIT
    field, _ = rtt.scenes.sphere_field(n=3500, width=8, device="cpu")
    assert tables.fits_stream(field) and not tables.fits_shared(field)
    assert tables.fits(field, "wavefront")
    assert tables.fits_shared(field, culling=False, block_size=64) is False


def _resident_bytes(scene):
    """The resident queue launch's shared memory for ``scene``'s tables."""
    lay = tables.resolve(scene, "megakernel")
    return tables._queue_bytes(lay.n_pad, lay.m_pad, scene.has_motion)


@pytest.mark.parametrize("scene, smem, threads", [
    ("random_bouncing", 18_512, 128), ("cornell_box", 122_960, 1024),
    (None, 0, 128), (None, 28_160, 128), (None, 28_176, 1024),
    (None, tables.SHARED_LIMIT, 1024), (None, tables.SHARED_LIMIT + 16, None)],
    ids=["flagship", "cornell_box", "tie", "narrow_last", "wide_first",
         "limit", "over_limit"])
def test_queue_width_rule(scene, smem, threads):
    """The resident queue kernel's block width from its launch's shared
    memory: the build with the most warps an SM, 128 threads on a tie. The
    flagship's 18,512 bytes (512 packed moving spheres) keep 8 blocks of
    128 (32 warps, as one block of 1,024); the Cornell box's 122,960 (1,536
    triangles) fit one block an SM, 4 warps narrow against 32 wide. 8
    narrow blocks fit up to 28,160 bytes (8 x 29,184 = 233,472 with the
    1,024 reserved a block), 16 bytes more leave 7 (28 warps). Past
    SHARED_LIMIT nothing launches."""
    if scene:
        scene, _ = getattr(rtt.scenes, scene)(width=8, device="cpu")
        assert _resident_bytes(scene) == smem
        assert tables.resolve(scene, "megakernel").threads == threads
    if threads is None:
        with pytest.raises(ValueError, match="exceed"):
            tables.queue_threads(smem)
    else:
        assert tables.queue_threads(smem) == threads


def _spheres(n: int):
    """A scene of ``n`` unit spheres at the origin, built without a
    builder (the columns count, not their contents)."""
    scene, _ = rtt.scenes.two_sphere(width=8, device="cpu")
    z = torch.zeros((n, 3))
    return dataclasses.replace(
        scene, sphere_center=z, sphere_velocity=z,
        sphere_radius=torch.ones(n), sphere_valid=torch.ones(n, dtype=bool),
        sphere_material=torch.zeros(n, dtype=torch.int32), n_spheres=n)


def _line(n: int):
    """``n`` small spheres in a row (n_pad = n where n is a multiple of 8)."""
    b = rtt.SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    for i in range(n):
        b.add_sphere((float(i), 0.0, 0.0), 0.1, m)
    return b.build(device="cpu")


@functools.lru_cache(maxsize=None)
def _layout_scene(name: str):
    kind, _, n = name.partition("_")
    if kind == "line":
        return _line(int(n))
    if kind == "spheres":
        return _spheres(int(n))
    if kind == "field":
        return rtt.scenes.sphere_field(n=int(n), width=8, device="cpu")[0]
    return getattr(rtt.scenes, {"flagship": "random_bouncing"}.get(
        name, name))(width=8, device="cpu")[0]


#: (scene, engine, resolve's keywords, the layout's (mode, unroll, blk,
#: stream, sc_group, cull, n_pad, m_pad, smem, threads) or the start of the
#: refusal). The values are those the per-engine resolvers this one
#: replaced gave: the megakernel's, the wavefront's, the bounce-indexed
#: recorder's (its launch's bytes as its wrapper counted them) and the
#: persistent-path recorder's rule. Boundaries: n_pad 3,416/3,417 (the
#: resident rule), 14,528/14,529 recorder columns at chunk 1, 14,395/14,396
#: chunks of the streamed megakernel, and the wavefront's 13,552 (grouped
#: into superclusters, over), 13,553 (no group, under) and 13,554 chunks.
LAYOUTS = [
    ("flagship", "megakernel", dict(),
     (0, 8, 0, 0, 0, True, 512, 0, 34896, 128)),
    ("flagship", "megakernel", dict(culling=True),
     (1, 8, 64, 0, 0, True, 512, 0, 35024, 128)),
    ("flagship", "megakernel", dict(stream=128),
     (2, 8, 32, 128, 0, True, 512, 0, 4752, 128)),
    ("flagship", "megakernel", dict(stream=128, culling=False),
     (2, 8, 0, 128, 0, False, 512, 0, 4752, 128)),
    ("flagship", "megakernel", dict(stream=100),
     "stream chunk must be a multiple of 16"),
    ("flagship", "wavefront", dict(),
     (0, 8, 0, 0, 0, True, 512, 0, 35024, 0)),
    ("flagship", "wavefront", dict(stream=128),
     (2, 8, 32, 128, 2, True, 512, 0, 15664, 0)),
    ("flagship", "record", dict(),
     (0, 1, 0, 0, 0, True, 512, 0, 18432, 0)),
    ("flagship", "record", dict(stream=128),
     (2, 1, 32, 128, 0, True, 512, 0, 64, 0)),
    ("flagship", "record_pp", dict(),
     (0, 1, 0, 0, 0, True, 512, 0, 34896, 0)),
    ("cornell_box", "megakernel", dict(),
     (0, 16, 0, 0, 0, True, 0, 1536, 122960, 1024)),
    ("cornell_box", "wavefront", dict(),
     (0, 16, 0, 0, 0, True, 0, 1536, 123088, 0)),
    ("cornell_box", "record", dict(),
     (0, 1, 0, 0, 0, True, 0, 1536, 122880, 0)),
    ("cornell_box", "record_pp", dict(),
     (0, 1, 0, 0, 0, True, 0, 1536, 122960, 0)),
    ("field_3000", "megakernel", dict(),
     (0, 8, 0, 0, 0, True, 3072, 0, 208976, 1024)),
    ("field_3000", "megakernel", dict(culling=True),
     (1, 8, 64, 0, 0, True, 3072, 0, 209744, 128)),
    ("field_3000", "wavefront", dict(),
     (1, 8, 64, 0, 0, True, 3072, 0, 209872, 0)),
    ("field_3000", "wavefront", dict(culling=False),
     (0, 8, 0, 0, 0, False, 3072, 0, 209104, 0)),
    ("field_3000", "record", dict(),
     (0, 1, 0, 0, 0, True, 3072, 0, 49152, 0)),
    ("field_100000", "megakernel", dict(),
     (2, 8, 32, 512, 0, True, 100352, 0, 5264, 128)),
    ("field_100000", "megakernel", dict(stream=0),
     "scene tables exceed one block's 232448 bytes"),
    ("field_100000", "wavefront", dict(),
     (2, 8, 32, 512, 4, True, 100352, 0, 19488, 0)),
    ("field_100000", "record", dict(),
     (2, 1, 32, 512, 0, True, 100352, 0, 3136, 0)),
    ("field_100000", "record_pp", dict(),
     "persistent-path recorder: scene tables exceed"),
    ("line_3416", "megakernel", dict(),
     (0, 8, 0, 0, 0, True, 3416, 0, 232368, 1024)),
    ("line_3416", "record", dict(),
     (0, 1, 0, 0, 0, True, 3416, 0, 54656, 0)),
    ("line_3416", "record_pp", dict(),
     (0, 1, 0, 0, 0, True, 3416, 0, 232368, 0)),
    ("line_3417", "megakernel", dict(),
     (2, 8, 32, 512, 0, True, 3584, 0, 2240, 128)),
    ("line_3417", "megakernel", dict(stream=0),
     "scene tables exceed one block's 232448 bytes"),
    ("line_3417", "record", dict(),
     (2, 1, 32, 512, 0, True, 3584, 0, 112, 0)),
    ("line_3417", "record_pp", dict(),
     "persistent-path recorder: scene tables exceed"),
    ("spheres_14528", "record", dict(stream=1),
     (2, 1, 1, 1, 0, True, 14528, 0, 232448, 0)),
    ("spheres_14529", "record", dict(stream=1),
     "streamed recorder: the chunk bounds of 14529 columns"),
    ("spheres_230320", "megakernel", dict(stream=16),
     (2, 8, 0, 16, 0, True, 230320, 0, 232448, 128)),
    ("spheres_230336", "megakernel", dict(stream=16),
     "streamed megakernel: 230336 columns"),
    ("spheres_216832", "wavefront", dict(stream=16),
     "wavefront: the chunk bounds of 216832 columns"),
    ("spheres_216848", "wavefront", dict(stream=16),
     (2, 8, 0, 16, 0, True, 216848, 0, 232416, 0)),
    ("spheres_216864", "wavefront", dict(stream=16),
     "wavefront: the chunk bounds of 216864 columns"),
]


@pytest.mark.parametrize(
    "name, engine, kw, want", LAYOUTS,
    ids=[f"{n}-{e}-" + ("-".join(f"{k}{v}" for k, v in kw.items()) or "auto")
         for n, e, kw, _ in LAYOUTS])
def test_resolve_pins_every_engines_layout(name, engine, kw, want):
    """resolve's layout, or its refusal, for each engine on the flagship,
    the Cornell box, sphere_field 3,000 and 100k and at each boundary; the
    queries agree with it (fits: a layout whose launch fits)."""
    scene = _layout_scene(name)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tables.resolve(scene, engine, **kw)
        assert not tables.fits(scene, engine, **kw)
        return
    layout = tables.resolve(scene, engine, **kw)
    assert layout.engine == engine
    assert tuple(layout)[1:] == want
    assert tables.fits(scene, engine, **kw) == (
        layout.smem <= tables.SHARED_LIMIT)
    if engine == "megakernel" and not kw:
        assert tables.fits_shared(scene) == (layout.mode == tables.RESIDENT)


def test_resolve_refuses_an_unknown_engine():
    scene = _layout_scene("flagship")
    for query in (tables.resolve, tables.fits):
        with pytest.raises(ValueError, match="unknown engine"):
            query(scene, "pallas")


@pytest.mark.parametrize("name", SCENES)
def test_streamed_permutations_invert_the_sort(name):
    """_stream_scene_inputs' column maps: each a permutation of the padded
    columns through which the scene-order table (padded with poisoned
    columns) reads as the sorted one; and the layout is still what the
    Morton sort and the two near-to-far passes give (_sorted_padded,
    _near_to_far, _block_rows)."""
    _, (ts, tc) = _pair(name)
    origin = tc.look_from.to(torch.float32)
    for stream, blk in ((128, 16), (256, 32)):
        got = tables._stream_scene_inputs(ts, stream, blk, origin)
        for tri, tab, perm, cb, bl in (
                (False, got.stab, got.sperm, got.scb, got.sblk),
                (True, got.ttab, got.tperm, got.tcb, got.tblk)):
            n = tab.shape[1]
            assert perm.dtype == torch.int32 and perm.shape == (n,)
            if not n:
                continue
            assert torch.equal(perm.sort().values,
                               torch.arange(n, dtype=torch.int32))
            raw, _, _, _, poison = tables._class_parts(ts, tri)
            raw = tables._pad_poison(raw, n, poison)
            assert torch.equal(tab, raw[:, perm.long()])
            t2, lo, hi, v, _ = tables._sorted_padded(ts, tri, stream)
            t2, lo, hi, v = tables._near_to_far(t2, lo, hi, v, stream, origin)
            t2, lo, hi, v = tables._near_to_far(t2, lo, hi, v, blk, origin,
                                                within=stream)
            assert torch.equal(tab, t2)
            assert torch.equal(cb, tables._block_rows(lo, hi, v, stream))
            assert torch.equal(bl, tables._block_rows(lo, hi, v, blk))


# --------------------------------------------------------------------------
# the memo of a render's tables (TABLE_MEMO, VIEW_MEMO)
# --------------------------------------------------------------------------

MEMO_CFG = rtt.RenderConfig(spp=1, max_depth=3)
#: The render paths that look their tables up: the megakernel resident, the
#: megakernel streamed and the wavefront streamed (both read the camera's
#: origin).
MEMO_PATHS = {"resident": dict(engine="megakernel"),
              "streamed": dict(engine="megakernel", stream=128),
              "wavefront": dict(engine="wavefront", stream=128)}


@pytest.fixture
def memo():
    tables.clear_memos()
    yield tables.TABLE_MEMO
    tables.clear_memos()


def _memo_scene():
    return rtt.scenes.random_bouncing(width=16, height=9, seed=3,
                                      device="cpu")


def _render_path(path, scene, cam):
    return rtt.render_fast(scene, cam, 5, MEMO_CFG, **MEMO_PATHS[path])


def _fresh(scene):
    """The same scene in new tensors."""
    return scene.replace(**{f: getattr(scene, f).clone()
                            for f in tables._SCENE_TENSORS})


def _cached_tensors():
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            for x in v:
                walk(x)
    for m in (tables.TABLE_MEMO, tables.VIEW_MEMO):
        for _, value in m._entries.values():
            walk(value)
    return out


@pytest.mark.parametrize("path", MEMO_PATHS)
def test_memo_second_render_hits_bit_for_bit(path, memo, monkeypatch):
    """A second render of an unchanged scene takes the first one's tables:
    no table builder runs, the image is the cold render's bit for bit and
    no cached tensor is written."""
    scene, cam = _memo_scene()
    cold = _render_path(path, scene, cam)
    assert memo.counts == dict(hits=0, builds=1, bypasses=0)
    versions = [(t, t._version) for t in _cached_tensors()]
    assert len(versions) >= 3

    def refuse(*args, **kw):
        raise AssertionError("a hit built tables")
    for mod, name in ((tables, "_smem_scene_inputs"),
                      (tables, "_stream_scene_inputs"),
                      (tables, "pack_records"), (tables, "_scene_bounds"),
                      (tables, "_camera_vector"), (tables, "scene_tables"),
                      (tables, "tri_tables"), (twf.np, "argsort")):
        monkeypatch.setattr(mod, name, refuse)
    warm = _render_path(path, scene, cam)
    assert memo.counts == dict(hits=1, builds=1, bypasses=0)
    assert torch.equal(warm, cold)
    assert all(t._version == v for t, v in versions)


@pytest.mark.parametrize("change", ["in_place", "replace"])
@pytest.mark.parametrize("path", MEMO_PATHS)
def test_memo_misses_on_a_changed_scene(path, change, memo):
    """An in-place write to a scene tensor (its ``_version``) or a new
    tensor through ``Scene.replace`` misses, and the render is a fresh
    scene's of the same values bit for bit."""
    scene, cam = _memo_scene()
    before = _render_path(path, scene, cam)
    if change == "in_place":
        scene.sphere_center.add_(torch.tensor([0.0, 0.05, 0.0]))
    else:
        scene = scene.replace(sphere_radius=scene.sphere_radius * 1.5)
    got = _render_path(path, scene, cam)
    assert memo.counts == dict(hits=0, builds=2, bypasses=0)
    assert not torch.equal(got, before)
    assert torch.equal(got, _render_path(path, _fresh(scene), cam))


@pytest.mark.parametrize("path", MEMO_PATHS)
def test_memo_keys_the_camera_where_the_layout_reads_it(path, memo):
    """A new camera origin misses on the streamed layouts (their chunks are
    ordered near to far from it) and hits on the resident one; the image
    is a cold render's with that camera bit for bit."""
    scene, cam = _memo_scene()
    _render_path(path, scene, cam)
    moved = dataclasses.replace(
        cam, look_from=cam.look_from + torch.tensor([0.5, 0.0, 0.0]))
    got = _render_path(path, scene, moved)
    streamed = path != "resident"
    assert memo.counts == dict(hits=int(not streamed), builds=1 + streamed,
                               bypasses=0)
    tables.clear_memos()
    assert torch.equal(got, _render_path(path, scene, moved))


@pytest.mark.parametrize("path", MEMO_PATHS)
def test_memo_is_bypassed_for_a_tensor_that_needs_grad(path, memo):
    """With grad mode on, a scene tensor that requires grad bypasses the
    memo (built as without it, nothing cached); under no_grad the tables
    are cached, and none of them requires grad."""
    scene, cam = _memo_scene()
    want = _render_path(path, scene, cam)
    trained = scene.replace(
        sphere_radius=scene.sphere_radius.clone().requires_grad_(True))
    got = _render_path(path, trained, cam)
    assert memo.counts == dict(hits=0, builds=1, bypasses=1)
    assert len(memo._entries) == 1
    assert torch.equal(got.detach(), want)
    with torch.no_grad():
        _render_path(path, trained, cam)
    assert memo.counts == dict(hits=0, builds=2, bypasses=1)
    assert not any(t.requires_grad for t in _cached_tensors())


@pytest.mark.parametrize("path", MEMO_PATHS)
def test_memo_drops_a_freed_scenes_entry(path, memo):
    scene, cam = _memo_scene()
    _render_path(path, scene, cam)
    other = _fresh(scene)
    _render_path(path, other, cam)
    assert len(memo._entries) == 2
    ref = weakref.ref(other.sphere_center)
    del other
    gc.collect()
    assert ref() is None
    _render_path(path, scene, cam)
    assert len(memo._entries) == 1
    assert memo.counts == dict(hits=1, builds=2, bypasses=0)


def test_memo_keeps_its_most_recent_entries():
    """At most ``size`` entries, the least recently used dropped first;
    the key holds the arguments as well as the tensors."""
    m = tables.Memo(size=2)
    ts = [torch.zeros(1) for _ in range(3)]
    built = []

    def get(t, arg=0):
        return m.get(t.device, (t,), (arg,),
                     lambda: built.append((t, arg)) or len(built))
    assert [get(ts[0]), get(ts[1]), get(ts[0])] == [1, 2, 1]
    get(ts[2])  # drops ts[1], the least recently used
    assert get(ts[0]) == 1 and get(ts[1]) == 4
    assert get(ts[1], arg=1) == 5
    assert m.counts == dict(hits=2, builds=5, bypasses=0)
    assert len(m._entries) == 2
    m.clear()
    assert m.counts == dict(hits=0, builds=0, bypasses=0)
    assert not m._entries


def test_memo_is_bypassed_in_inference_mode():
    m = tables.Memo()
    t = torch.zeros(1)
    with torch.inference_mode():
        assert m.get(t.device, (t,), (), lambda: 1) == 1
    assert m.counts == dict(hits=0, builds=0, bypasses=1)
    assert m.get(t.device, (t,), (), lambda: 2) == 2
    t[0] = 1.0  # bumps the version: a miss
    assert m.get(t.device, (t,), (), lambda: 3) == 3
    assert m.counts == dict(hits=0, builds=2, bypasses=1)
