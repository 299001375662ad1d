"""The resident kernels' coefficient-form sweep and queue schedule
(rayz_tpu_torch/ops/sweep.py, rayz_tpu_torch/ops/megakernel.py) on the CPU.
The CUDA kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there); these tests hold what surrounds them.

Tolerances:
* packing: ``half_b`` and ``c_term`` of the packed records and coefficient
  vectors against sweep_spheres' formula, both evaluated in float64 from the
  same float32 inputs, within 4 float32 roundings of the magnitudes summed
  (the coefficients tau*d and -2*tau*o are rounded once in float32, the
  formula's centre at the ray's time is not);
* fold order: 0 (bit for bit);
* near-tie rule: exact decisions on constructed rays.
"""

import numpy as np
import pytest
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.ops import common, diffkernel as dk, megakernel as mk
from rayz_tpu_torch.ops import pathrec as pr, sweep as sw, tables
from rayz_tpu_torch.ops.tables import _BIG, _pad_poison, _CCMR2

torch.set_num_threads(2)

U32 = 2.0 ** -24


def _random_spheres(g, n: int) -> torch.Tensor:
    """A [17, n + 8] sphere table of random centres, radii and velocities
    (the material rows unused), with 8 poisoned padding columns."""
    c = g.uniform(-20, 20, (n, 3))
    v = g.uniform(-1, 1, (n, 3))
    r = g.uniform(0.1, 3.0, n)
    tab = np.zeros((17, n))
    tab[0:3] = c.T
    tab[3] = (c * c).sum(1) - r * r
    tab[4:7] = v.T
    tab[7] = 2.0 * (c * v).sum(1)
    tab[8] = (v * v).sum(1)
    return _pad_poison(torch.from_numpy(tab).float(), n + 8, _CCMR2)


def _random_rays(g, r: int):
    o = tuple(torch.from_numpy(g.uniform(-25, 25, r)).float()
              for _ in range(3))
    d = tuple(torch.from_numpy(g.standard_normal(r)).float()
              for _ in range(3))
    return o, d, torch.from_numpy(g.random(r)).float()


def _slots(n: int) -> torch.Tensor:
    """Flat pixel ids of n pixels in whole blocks of 128 slots, -1 past
    the image (the one-thread-per-slot kernel's slot table)."""
    pix = torch.arange(-(-n // 128) * 128, dtype=torch.int32)
    return torch.where(pix < n, pix, -1)


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
def test_packed_records_reproduce_todays_terms(motion):
    """The records and coefficient vectors, built as the kernel builds
    them, give sweep_spheres' half_b and c_term (float64 evaluation of both
    from the same float32 inputs, within 4 float32 roundings of the summed
    magnitudes); the poisoned padding columns never have a real root, nor
    graze, in the kernel's float32 chains."""
    g = np.random.default_rng(3)
    stab = _random_spheres(g, 120)
    o, d, tau = _random_rays(g, 256)
    if not motion:
        tau = torch.zeros_like(tau)
    packed = sw.pack_spheres(stab, motion)
    assert packed[0].shape == (128, 4)
    assert (packed[1] is None) == (not motion)
    coef = sw.ray_coef(o, d, tau, 1e-3)
    hb, ct = sw.coef_terms(packed, coef)
    hb_t, ct_t = sw.today_terms(stab, o, d, tau, motion)
    f64 = torch.float64
    t = stab.to(f64)
    od = torch.stack(o, 1).to(f64)
    dd = torch.stack(d, 1).to(f64)
    ta = tau.to(f64)[:, None]
    span = [t[k][None, :].abs() + (ta * t[4 + k][None, :]).abs()
            for k in range(3)]
    mh = (sum(dd[:, k:k + 1].abs() * span[k] for k in range(3))
          + (dd * od).abs().sum(1, keepdim=True))
    mc = (t[3][None, :].abs() + (t[7][None, :] * ta).abs()
          + t[8][None, :] * ta * ta
          + 2.0 * sum(od[:, k:k + 1].abs() * span[k] for k in range(3))
          + (od * od).sum(1, keepdim=True))
    valid = stab[_CCMR2] < _BIG
    assert ((hb - hb_t).abs() <= 4 * U32 * mh)[:, valid].all()
    assert ((ct - ct_t).abs() <= 4 * U32 * mc)[:, valid].all()
    disc, _, grazing = sw.coef_disc(packed, coef)
    assert not (disc[:, ~valid] >= 0.0).any()
    assert not grazing[:, ~valid].any()
    assert not sw.coef_disc(packed, coef, wide=True)[2][:, ~valid].any()
    assert (disc[:, valid] >= 0.0).any()  # some rays do hit


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
def test_streamed_records_reproduce_todays_terms(motion):
    """The streamed megakernel's packed records, built once a render in
    device memory (tables.pack_records), are the resident kernels' staged
    records laid out flat (then the block bounds as records); its sweep
    reads them with sweep_spheres' expressions (rz::packed_at), which give
    the centre at the ray's time and |c|^2 - r^2 of the table bit for bit,
    so its winners are the plain version's."""
    g = np.random.default_rng(4)
    stab = _random_spheres(g, 120)
    sblk = torch.from_numpy(g.uniform(-5, 5, (4, 4))).float()
    recs, brecs = tables.pack_records(stab, sblk, motion)
    packed = sw.pack_spheres(stab, motion)
    n = stab.shape[1]
    assert recs.shape == ((9 if motion else 4) * n,)
    c = recs[:4 * n].view(n, 4)
    assert torch.equal(c, packed[0])
    if motion:
        assert torch.equal(recs[4 * n:8 * n].view(n, 4), packed[1])
        assert torch.equal(recs[8 * n:], packed[2])
    assert torch.equal(brecs, sblk.T) and brecs.is_contiguous()
    _, _, tau = _random_rays(g, 64)
    tau = tau[:, None]
    cx, cy, cz, ccmr2 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    if motion:
        v, vv = recs[4 * n:8 * n].view(n, 4), recs[8 * n:]
        cx, cy, cz = cx + tau * v[:, 0], cy + tau * v[:, 1], cz + tau * v[:, 2]
        ccmr2 = ccmr2 + v[:, 3] * tau + vv * (tau * tau)
    want = common._sphere_at(stab, slice(None), tau, tau * tau, motion)
    for got, ref in zip((cx, cy, cz, ccmr2), want):
        assert torch.equal(got.expand_as(ref), ref)


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
def test_range_sweep_matches_sequential_and_today(motion):
    """The column-range packed sweep (the culled kernel's blocks): ranges
    swept in turn carry the state to what one sweep over their union gives,
    which is what the sequential loop (a shrinking q_best, the runner-up,
    the last grazing column) keeps, column by column; and its winner is
    sweep_spheres' except where the near-tie rule accepts the difference."""
    g = np.random.default_rng(5)
    stab = _random_spheres(g, 120)
    o, d, tau = _random_rays(g, 512)
    if not motion:
        tau = torch.zeros_like(tau)
    packed = sw.pack_spheres(stab, motion)
    coef = sw.ray_coef(o, d, tau, 1e-3)
    n = stab.shape[1]
    one = sw.packed_sweep(packed, coef, 0, n)
    st = None
    for j0, j1 in ((0, 32), (32, 33), (33, 96), (96, n)):
        st = sw.packed_sweep(packed, coef, j0, j1, st)
    assert all(torch.equal(a, b) for a, b in zip(one, st))
    seq = None
    for j in range(n):
        seq = sw.packed_sweep(packed, coef, j, j + 1, seq)
    assert all(torch.equal(a, b) for a, b in zip(one, seq))
    assert bool((one.best >= 0).any()) and bool((one.second >= 0).any())
    a = coef.a
    qb, best, _ = common._sweep(stab, torch.zeros((20, 0)), o, d, tau, a,
                            -coef.ndo, coef.o2, coef.tmin_a, tau * tau,
                            motion)
    differ = one.best != best
    assert float(differ.double().mean()) < 0.01
    ok = sw.near_ties(stab, torch.zeros((20, 0)),
                      tuple(x[differ] for x in o), tuple(x[differ] for x in d),
                      tau[differ], one.best[differ], best[differ],
                      t_min=1e-3, has_motion=motion)
    assert bool(ok.all())


def _drain_rays(stab: torch.Tensor, g, motion: bool):
    """Rays for the lane-split sweep on the flagship's table ``stab``
    (column 1 the sphere of radius 1 at (0, 1, 0), copied into columns 4
    and 33): random rays through the scene, rays from above onto the
    copies (exact ties in q on two lanes and within one lane), rays
    tangent to them (grazing on two lanes) and rays into the sky."""
    r = 256
    o = g.uniform(-12, 12, (r, 3)) * [1, 0, 1] + [0, 3, 0]
    o[:, 1] += g.uniform(0, 4, r)
    d = g.standard_normal((r, 3))
    top = np.stack([g.uniform(-0.5, 0.5, r), np.full(r, 20.0),
                    g.uniform(-0.5, 0.5, r)], 1)
    down = np.stack([g.uniform(-0.02, 0.02, r), np.full(r, -1.0),
                     g.uniform(-0.02, 0.02, r)], 1)
    tan = np.stack([np.ones(r) + g.uniform(-1e-7, 1e-7, r),
                    np.full(r, 20.0), np.zeros(r)], 1)
    straight = np.tile([0.0, -1.0, 0.0], (r, 1))
    sky = np.tile([0.0, 5.0, 0.0], (r, 1))
    up = g.standard_normal((r, 3)) * [0.1, 0, 0.1] + [0, 1, 0]
    o = np.concatenate([o, top, tan, sky])
    d = np.concatenate([d, down, straight, up])
    tau = g.random(o.shape[0]) if motion else np.zeros(o.shape[0])
    # the copies of sphere 1 must not move, so that tau changes no tie
    assert float(stab[4:9, 1].abs().max()) == 0.0
    return (tuple(torch.from_numpy(o[:, k]).float() for k in range(3)),
            tuple(torch.from_numpy(d[:, k]).float() for k in range(3)),
            torch.from_numpy(tau).float())


@pytest.mark.parametrize("n", [512, 300], ids=["n512", "n300"])
@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
def test_lane_split_sweep_matches_sequential(motion, n):
    """The resident megakernel's drain (rz::sweep_packed_lanes): a warp
    sweeping one ray's table a column per lane and merging the lanes'
    states by (q, column) keeps the sequential packed sweep's state (qb,
    best, q2, second, graze; the resident narrow grazing band) bit for bit,
    over the flagship's packed table (and its first 300 columns, not a
    multiple of 32), with exact q ties on two lanes and within one lane,
    grazing columns on two lanes, and rays that some, all or no lanes
    accept."""
    scene, cam = rtt.scenes.random_bouncing(width=8, height=8, device="cpu")
    args, _ = mk._launch_args(scene, cam, 0,
                              tables.resolve(scene, "megakernel"), spp=1,
                              max_depth=2, t_min=1e-3, jitter=False)
    stab = args[1].clone()
    assert stab.shape[1] == 512 and scene.has_motion
    stab[:, 4] = stab[:, 1]
    stab[:, 33] = stab[:, 1]
    stab = stab[:, :n].contiguous()
    o, d, tau = _drain_rays(stab, np.random.default_rng(11), motion)
    packed = sw.pack_spheres(stab, motion)
    coef = sw.ray_coef(o, d, tau, 1e-3)
    seq = sw.packed_sweep(packed, coef, 0, n, wide=False)
    lanes = sw.packed_sweep_lanes(packed, coef, n)
    for a, b in zip(seq, lanes):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # what the cases cover
    assert bool(((seq.best == 1) & (seq.second == 4)).any())  # exact ties
    assert bool((seq.graze == 33).any())  # grazing on lanes 1 and 4
    disc, hb, _ = sw.coef_disc(packed, coef)
    rt = torch.sqrt(torch.clamp_min(disc, 0.0))
    tm = coef.tmin_a[:, None]
    q = torch.where(hb - rt >= tm, hb - rt, hb + rt)
    acc = (disc >= 0.0) & (q >= tm)
    per_lane = torch.stack([acc[:, k::32].any(1) for k in range(32)], 1)
    count = per_lane.sum(1)
    assert bool(((count > 0) & (count < 32)).any())
    assert bool((count == 0).any()) and bool((seq.best == -1).any())


@pytest.mark.parametrize("mode", [dict(culling=True), dict(stream=128)],
                         ids=["culled", "streamed"])
def test_explain_items(mode):
    """explain_items holds the culled and streamed queue's winners per
    bounce (``hits``) against the plain version's, over the mode's sorted
    tables: each differing item's ray re-derived at its first difference,
    a swap of the duplicated sphere's column accepted, a jump to the
    farther sphere refused, equal recordings None."""
    scene, cam = _tie_scene()
    layout = tables.resolve(scene, "megakernel", **mode)
    assert (layout.unroll, layout.blk) == (8, 32 if mode.get("stream")
                                           else 64)
    args, kw = mk._launch_args(scene, cam, 1, layout, spp=2, max_depth=3,
                               t_min=1e-3, jitter=False)
    del kw["spp"]
    stab = args[1]
    pair = torch.nonzero(stab[2] == -3.0).flatten().tolist()
    far = torch.nonzero(stab[2] == -6.0).flatten().tolist()
    assert len(pair) == 2 and len(far) == 1
    hits = torch.full((3, 32), -2, dtype=torch.int32)
    mk._queue(*args, 16, 0, 2, hits=hits, **kw)
    ekw = {k: kw[k] for k in ("width", "max_depth", "t_min", "jitter",
                              "has_motion", "seed")}
    assert sw.explain_items(*args, 16, 0, hits, hits, **ekw) is None
    b, i = (int(x) for x in torch.nonzero(hits == pair[0])[-1])
    for col, want in ((pair[1], True), (far[0], False), (-2, False)):
        got = hits.clone()
        got[b, i] = col
        assert sw.explain_items(*args, 16, 0, got, hits,
                                **ekw).tolist() == [want]


def test_queue_fold_matches_slot_sums():
    """The queue schedule's plain version, each (sample, pixel) item traced
    alone and the samples folded in order from 0.0, equals the
    one-thread-per-slot plain version's per-slot sums bit for bit
    (random_bouncing 8x8, 4 spp, depth 4, real random bits); so does the
    render, and the CPU launches no kernel."""
    scene, cam = rtt.scenes.random_bouncing(width=8, height=8, device="cpu")
    layout = tables.resolve(scene, "megakernel")
    assert layout.unroll == 8
    args, kw = mk._launch_args(scene, cam, 5, layout, spp=4, max_depth=4,
                               t_min=1e-3, jitter=True)
    del kw["layout"], kw["bounds"], kw["records"]
    want = mk._trace_slots_reference(*args, _slots(64), **kw)
    before = (mk.LAUNCHES, dict(mk.MODE_LAUNCHES))
    got = mk._trace_queue(*args, 64, layout=layout, **kw)
    assert (mk.LAUNCHES, mk.MODE_LAUNCHES) == before
    assert torch.equal(got, want[:, :64])
    assert (got > 0).any()
    # the fold's association: sample buffers added one by one from 0.0
    pix = torch.arange(64, dtype=torch.int32)
    items = [mk._trace_items_reference(
        *args, pix, torch.full_like(pix, s), width=8, max_depth=4,
        t_min=1e-3, jitter=True, has_motion=scene.has_motion, seed=5)
        for s in range(1, 5)]
    acc = torch.zeros((3, 64))
    for rad in items:
        acc = acc + rad
    assert torch.equal(acc, got)
    cfg = rtt.RenderConfig(spp=4, max_depth=4)
    args, kw = mk._launch_args(scene, cam, 5, layout, spp=4, max_depth=4,
                               t_min=1e-3, jitter=True)
    del kw["layout"], kw["bounds"], kw["records"]
    sums = mk._trace_slots_reference(*args, _slots(64), **kw)
    img = rtt.render_megakernel(scene, cam, 5, cfg)
    assert torch.equal(img, (sums[:, :64].T.reshape(8, 8, 3) / 4.0))


def test_queue_groups_keep_the_fold_order(monkeypatch):
    """Samples run in groups when their buffer would be too large; the
    fold carries each pixel's sum from group to group, so the sums do not
    change."""
    scene, cam = rtt.scenes.random_bouncing(width=6, height=4, device="cpu")
    args, kw = mk._launch_args(scene, cam, 9,
                               tables.resolve(scene, "megakernel"), spp=5,
                               max_depth=3, t_min=1e-3, jitter=True)
    whole = mk._trace_queue(*args, 24, **kw)
    monkeypatch.setattr(mk, "QUEUE_BYTES", 2 * 12 * 24)
    assert mk._queue_group(5, 24) == 2
    assert torch.equal(mk._trace_queue(*args, 24, **kw), whole)


def _tie_scene():
    """Two spheres at the same place (an exact tie), one behind them."""
    b = rtt.SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -3), 1.0, m)
    b.add_sphere((0, 0, -3), 1.0, m)
    b.add_sphere((0, 0, -6), 1.0, m)
    scene = b.build(device="cpu")
    cam = rtt.make_camera(width=4, height=4, look_from=(0, 0, 0),
                          look_at=(0, 0, -1), device="cpu")
    return scene, cam


def test_near_tie_rule():
    """The rule accepts a duplicated sphere (an exact tie), a grazing ray
    against a miss, and a farther column taken over a grazing nearer one;
    it refuses a farther sphere, a miss against a clear hit, a hit where
    the ray clearly misses, and a farther grazing column taken over a
    clear nearer hit (either way round)."""
    scene, cam = _tie_scene()
    _, stab, ttab = pr._scene_record_inputs(scene, cam)
    z = torch.zeros(8)
    # rays 0-2 head straight at the spheres, 3 and 7 graze the silhouettes
    # of both the first pair and the sphere behind (x = 1, tangent), 4
    # passes far to the side; 5 and 6 cross the first pair clearly (0.5
    # from its axis) and graze the sphere behind (d = (1/sqrt(35), 0, -1))
    k = 35.0 ** -0.5
    o = (torch.tensor([0.0, 0.0, 0.0, 1.0, 5.0, 0.0, 0.0, 1.0]), z, z)
    d = (torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, k, k, 0.0]), z,
         -torch.ones(8))
    got = torch.tensor([1, 2, -1, 0, 0, 2, 0, 2])
    want = torch.tensor([0, 0, 0, -1, -1, 0, 2, 0])
    c = sw.candidates(stab, ttab, torch.tensor([2, 2, 0, 0]),
                      (o[0][[5, 7, 5, 7]], z[:4], z[:4]),
                      (d[0][[5, 7, 5, 7]], z[:4], -torch.ones(4)), z[:4],
                      t_min=1e-3, has_motion=False)
    assert c.sensitive.tolist() == [True, True, False, True]
    ok = sw.near_ties(stab, ttab, o, d, z, got, want, t_min=1e-3,
                      has_motion=False)
    assert ok.tolist() == [True, False, False, True, False, False, False,
                           True]


def test_explain_recordings():
    """explain re-derives each differing slot's ray at its first
    difference: a swap of the duplicated sphere's column is accepted, a
    jump to the farther sphere refused, and equal recordings give None."""
    scene, cam = _tie_scene()
    pix = torch.arange(16, dtype=torch.int32)
    kw = dict(spp=2, max_depth=3, t_min=1e-3, jitter=False)
    idx, aux, _ = pr.record_pp(scene, cam, 1, pix, iters=8, **kw)
    assert sw.explain(scene, cam, 1, pix, idx, idx, aux, **kw) is None
    hits = torch.nonzero(idx == 0)
    k, s = (int(x) for x in hits[len(hits) // 2])
    assert k > 0  # a later bounce or sample: the ray is re-derived
    for col, want in ((1, True), (2, False)):
        got = idx.clone()
        got[k, s] = col
        assert sw.explain(scene, cam, 1, pix, got, idx, aux,
                          **kw).tolist() == [want]


def test_render_megakernel_queue_stats_refuse_on_cpu():
    """The queue's wrapper checks its inputs; a non-CPU, non-CUDA tensor
    raises instead of falling back."""
    scene, cam = rtt.scenes.random_bouncing(width=4, height=4, device="cpu")
    args, kw = mk._launch_args(scene, cam, 0,
                               tables.resolve(scene, "megakernel"), spp=1,
                               max_depth=2, t_min=1e-3, jitter=False)
    with pytest.raises(ValueError, match="nothing to trace"):
        mk._trace_queue(*args, 0, **kw)
    with pytest.raises(ValueError, match="8k"):
        mk._trace_queue(args[0], args[1][:, :5].contiguous(), args[2], 16,
                        **kw)
    with pytest.raises(ValueError, match="no megakernel"):
        mk._trace_queue(*(a.to("meta") for a in args), 16, **kw)


def test_states_carry_the_sphere_left():
    """The recorder's saved state carries the sphere column each ray
    leaves (-1 if none), which the kernel tests in the plain version's
    arithmetic: the winner of the last recorded iteration where the path
    continued off a sphere; a resumed pass continues the one-pass
    recording, and so does one resumed from an (st, cnt) pair, as earlier
    versions returned (no sphere left)."""
    scene, cam = rtt.scenes.random_bouncing(width=8, height=8, device="cpu")
    pix = torch.arange(64, dtype=torch.int32)
    kw = dict(spp=2, max_depth=8, t_min=1e-3, jitter=True)
    idx, aux, _, (st, cnt, frm) = pr.record_pp(scene, cam, 2, pix, iters=1,
                                               want_state=True, **kw)
    cont = torch.remainder(torch.floor(aux[-1, pr._AUX_FLG] / 2), 2) == 1
    n = int(scene.sphere_radius.shape[0])
    want = torch.where(cont & (idx[-1] < n), idx[-1], -1)
    assert torch.equal(frm, want) and bool((frm >= 0).any())
    more = pr.record_pp(scene, cam, 2, pix, iters=7, init_state=(st, cnt, frm),
                        **kw)
    full = pr.record_pp(scene, cam, 2, pix, iters=8, **kw)
    assert torch.equal(torch.cat([idx, more[0]]), full[0])
    pair = pr.record_pp(scene, cam, 2, pix, iters=7, init_state=(st, cnt),
                        want_state=True, **kw)
    assert torch.equal(pair[0], more[0]) and len(pair[3]) == 3
    with pytest.raises(ValueError, match="init_state"):
        pr._record_slots(*pr._scene_record_inputs(scene, cam), pix,
                         layout=tables.resolve(scene, "record_pp"),
                         width=cam.width, has_motion=scene.has_motion,
                         seed=2, iters=8, init_state=(st, cnt), **kw)


def test_explain_resumed_recordings():
    """explain on recordings resumed from a saved state re-derives each
    differing slot's ray from that state: at the first resumed iteration
    the rule sees the ray the state holds (not a fresh camera ray), so its
    decisions are near_ties' on those rays."""
    scene, cam = _tie_scene()
    _, stab, ttab = pr._scene_record_inputs(scene, cam)
    pix = torch.arange(16, dtype=torch.int32)
    kw = dict(spp=2, max_depth=3, t_min=1e-3, jitter=False)
    _, _, _, state = pr.record_pp(scene, cam, 1, pix, iters=1,
                                  want_state=True, **kw)
    idx, aux, _ = pr.record_pp(scene, cam, 1, pix, iters=8,
                               init_state=state, **kw)
    spawn = torch.remainder(aux[0, pr._AUX_FLG], 2.0) == 1.0
    assert not bool(spawn.any())  # every slot resumes mid-path
    st = state[0]
    for col in (0, 1, 2):
        got = idx.clone()
        got[0] = torch.where(idx[0] == col, (col + 1) % 3, col)
        want = sw.near_ties(stab, ttab, (st[0], st[1], st[2]),
                            (st[3], st[4], st[5]), st[6], got[0], idx[0],
                            t_min=1e-3, has_motion=False)
        ex = sw.explain(scene, cam, 1, pix, got, idx, aux,
                        init_state=state, **kw)
        assert torch.equal(ex, want), col


def _twin_ground_scene():
    """Three spheres on a ground sphere that is in the scene twice (columns
    0 and 1: every hit on it is an exact tie)."""
    b = rtt.SceneBuilder()
    g = b.add_diffuse(color=(0.5, 0.5, 0.5))
    for _ in range(2):
        b.add_sphere((0, -100.5, -2), 100.0, g)
    m = b.add_diffuse(color=(0.8, 0.3, 0.2))
    for x in (0.0, 1.2, -1.2):
        b.add_sphere((x, 0, -2), 0.5, m)
    scene = b.build(device="cpu")
    cam = rtt.make_camera(width=8, height=8, vfov=60.0, focus_dist=1.0,
                          look_from=(0, 0, 0), look_at=(0, 0, -1),
                          device="cpu")
    return scene, cam


@pytest.mark.parametrize("col, accepted", [(1, True), (3, False), (-1, False)],
                         ids=["twin", "wrong-sphere", "miss"])
def test_explain_bounce_indexed_recordings(col, accepted):
    """explain_paths on record_paths' recordings (idx [depth, R]): at a
    bounce after the first, where the ray is re-derived by the plain
    recorder, the ground's twin column in place of the ground (an exact
    tie) is accepted; a sphere the ray does not reach, or a miss against
    the ground's clear hit, is flagged. Equal recordings give None."""
    scene, cam = _twin_ground_scene()
    pix = torch.arange(64, dtype=torch.int32)
    o, d, tm = dk._camera_rays(cam, 1, pix, 0, False)
    rand = dk._make_rand(1, pix, 0, 3)
    idx = dk.record_paths(scene, o, d, tm, rand, max_depth=3, t_min=1e-3,
                          stream=0)
    rays = torch.cat([o.T, d.T, tm[None]]).float().contiguous()
    assert sw.explain_paths(scene, rays, rand, idx, idx, t_min=1e-3) is None
    later = torch.nonzero(idx[1:] == 0)
    assert later.shape[0] > 4  # bounces off the spheres onto the ground
    b, r = int(later[0, 0]) + 1, int(later[0, 1])
    got = idx.clone()
    got[b, r] = col
    got[b + 1:, r] = -1  # what follows a changed winner is not compared
    assert sw.explain_paths(scene, rays, rand, got, idx,
                            t_min=1e-3).tolist() == [accepted]
