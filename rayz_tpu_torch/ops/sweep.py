"""The resident kernels' coefficient-form sphere sweep, in plain torch, and
the rule that explains where its winners part from the plain versions'.

The resident megakernel (``csrc/megakernel.cu``) and the recorders
(``csrc/record_pp.cu``, and ``csrc/record.cu`` resident) sweep spheres with
``rz::sweep_packed``
(``csrc/common.cuh``): each block stages the sphere geometry as 16-byte
column records, each ray folds its side of the quadratic into coefficient
vectors once per segment, and a column costs fused multiply-adds. The
winner is then settled in the plain versions' arithmetic
(``rz::settle_winner``): its q recomputed by ``rz::sweep_spheres``'
expressions (the ray swept again in that form where they reject it or take
its other root), and two more columns tested in them: the sphere the ray
leaves, and the last column whose discriminant lies within 2^-14 |d|^2
c_term of zero (a grazing root). A path then differs from the plain
version's only at a near tie between two other columns, or where two
columns graze the ray.

* :func:`pack_spheres` and :func:`ray_coef` build, in plain torch, the
  records and coefficient vectors exactly as the kernel stages and folds
  them; :func:`coef_terms` and :func:`today_terms` evaluate ``half_b`` and
  ``c_term`` from either (the CPU tests compare them in float64), and
  :func:`coef_disc` repeats the kernel's float32 chains of fused
  multiply-adds; :func:`packed_sweep` is the column-range sweep's state
  (winner, runner-up, grazing column) carried over ranges of columns, as
  the culled kernel sweeps its blocks, and :func:`packed_sweep_lanes` the
  same state found a column per lane and merged across the warp, as the
  resident megakernel sweeps where few of a warp's lanes trace.
* :func:`candidates` bounds, per ray and candidate column, the float32
  rounding of the root test, and :func:`near_ties` is the rule that accepts
  a difference between two recordings: at the first bounce where they part,
  both candidates (a column, or -1 for a miss) are re-evaluated in float64
  from the same float32 inputs, and the difference is accepted when their
  distances lie within the sum of their rounding bounds (a near tie) or
  when the candidate that decides it, the nearer hit that one sweep passed
  over, is a grazing or range-boundary root that rounding may accept or
  reject. Its model is :func:`diffkernel._exact_ties`.
* :func:`explain_items` applies it to two recordings of the queue's
  (sample, pixel) items (the culled and streamed megakernel's winners per
  bounce against its plain version's, over the same sorted tables);
* :func:`explain` applies the rule to two recordings of the same slots
  (the kernel's and the plain recorder's), re-deriving each differing
  slot's ray at its first difference with the plain recorder;
  :func:`explain_paths` does the same for two bounce-indexed recordings
  (``diffkernel.record_paths``' idx [depth, R]) of the same rays and
  randoms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .diffkernel import _record_tables, _reference_bounces
from .megakernel import _trace_items_reference
from .pathrec import (_AUX_DX, _AUX_DY, _AUX_DZ, _AUX_FLG, _AUX_OX, _AUX_OY,
                      _AUX_OZ, _AUX_TAU, _record_slots_reference,
                      _scene_record_inputs)
from .tables import (_BIG, _CCMR2, _CV2, _CX, _CY, _CZ, _TG1V, _TG1X, _TG1Y,
                     _TG1Z, _TG2V, _TG2X, _TG2Y, _TG2Z, _TNV0, _TNX, _TNY,
                     _TNZ, _VV, _VX, _VY, _VZ, resolve, sphere_records)

__all__ = ["pack_spheres", "ray_coef", "coef_terms", "coef_disc",
           "today_terms", "candidates", "near_ties", "explain",
           "explain_paths", "explain_items", "packed_sweep",
           "packed_sweep_lanes", "GRAZE",
           "GRAZE_WIDE", "TIE_GAMMA"]

#: Unit roundoff of float32.
_U = 2.0 ** -24
#: The kernel's grazing band, ``rz::kGraze``: a column whose discriminant
#: lies within this share of |d|^2 c_term of zero.
GRAZE = 2.0 ** -14
#: The culled megakernel's band, ``rz::kGrazeWide``: a column whose
#: discriminant lies within this share of |d|^2 (| |c|^2 - r^2 | + |o|^2),
#: the magnitudes c_term cancels, of zero.
GRAZE_WIDE = 2.0 ** -19
#: Rounding operations charged to each float32 sum of the root test: both
#: forms' chains (up to 9 accumulations each) and their square roots.
TIE_GAMMA = 16.0


def pack_spheres(stab: torch.Tensor, has_motion: bool):
    """The shared-memory records ``rz::stage_spheres`` writes from the
    sphere table ``stab`` [17, N] (:func:`tables.sphere_records`)."""
    return sphere_records(stab, has_motion)


class RayCoef(NamedTuple):
    """``rz::RayCoef``: alpha = (d, tau d), beta = (-2 o, -2 tau o, tau,
    tau^2), the ray-only terms -d.o and |o|^2, |d|^2 and t_min |d|^2."""

    alpha: torch.Tensor  # [R, 6]
    beta: torch.Tensor   # [R, 8]
    ndo: torch.Tensor
    o2: torch.Tensor
    a: torch.Tensor
    tmin_a: torch.Tensor


def ray_coef(o, d, tau, t_min: float) -> RayCoef:
    """The coefficient vectors of rays with origins ``o`` and directions
    ``d`` (tuples of [R] float32) at times ``tau``, rounded in float32 as
    ``rz::ray_coef`` and ``rz::ray_terms`` round them."""
    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o2 = ox * ox + oy * oy + oz * oz
    alpha = torch.stack([dx, dy, dz, tau * dx, tau * dy, tau * dz], dim=1)
    beta = torch.stack([-2.0 * ox, -2.0 * oy, -2.0 * oz, -2.0 * (tau * ox),
                        -2.0 * (tau * oy), -2.0 * (tau * oz), tau, tau * tau],
                       dim=1)
    return RayCoef(alpha, beta, -d_dot_o, o2, a, t_min * a)


def coef_terms(packed, coef: RayCoef, dtype=torch.float64):
    """``half_b`` and ``c_term`` [R, N] of the coefficient form, evaluated
    in ``dtype`` from the float32 records and coefficients:
    half_b = alpha . (c, v) - d.o, c_term = |c|^2 - r^2 + |o|^2 +
    beta . (c, v, 2 c.v, |v|^2)."""
    c, v, vv = (None if x is None else x.to(dtype) for x in packed)
    al, be = coef.alpha.to(dtype), coef.beta.to(dtype)
    hb = al[:, :3] @ c[:, :3].T + coef.ndo.to(dtype)[:, None]
    ct = c[:, 3][None, :] + coef.o2.to(dtype)[:, None] + be[:, :3] @ c[:, :3].T
    if v is not None:
        hb = hb + al[:, 3:] @ v[:, :3].T
        ct = (ct + be[:, 3:6] @ v[:, :3].T + be[:, 6:7] * v[:, 3][None, :]
              + be[:, 7:8] * vv[None, :])
    return hb, ct


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``__fmaf_rn`` on float32 tensors: the product is exact in float64,
    the sum rounded to float64 and then to float32 (a double rounding, which
    can differ from one rounding only when the float64 sum is a float32
    half-way case)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def coef_disc(packed, coef: RayCoef, wide: bool = False):
    """The kernel's float32 ``coef_disc``: the discriminant, ``half_b`` and
    the grazing flag, each [R, N]; its chains of fused multiply-adds in
    their order (``half_b`` from -d.o, ``c_term`` from |c|^2 - r^2 +
    |o|^2), then half_b^2 - |d|^2 c_term with the product |d|^2 c_term
    rounded first, grazing where |disc| < 2^-14 |d|^2 c_term (false where
    that product overflows, as it does for the padding columns) or, with
    ``wide`` (the culled megakernel), where |disc| <
    GRAZE_WIDE |d|^2 (| |c|^2 - r^2 | + |o|^2)."""
    c, v, vv = packed
    al, be = coef.alpha, coef.beta
    hb = coef.ndo[:, None].expand(-1, c.shape[0])
    for k in range(3):
        hb = _fma32(al[:, k:k + 1], c[None, :, k], hb)
    ct = c[None, :, 3] + coef.o2[:, None]
    for k in range(3):
        ct = _fma32(be[:, k:k + 1], c[None, :, k], ct)
    if v is not None:
        for k in range(3):
            hb = _fma32(al[:, 3 + k:4 + k], v[None, :, k], hb)
        for k in range(3):
            ct = _fma32(be[:, 3 + k:4 + k], v[None, :, k], ct)
        ct = _fma32(be[:, 6:7], v[None, :, 3], ct)
        ct = _fma32(be[:, 7:8], vv[None, :], ct)
    act = coef.a[:, None] * ct
    disc = _fma32(hb, hb, -act)
    if wide:
        mag = coef.a[:, None] * (c[None, :, 3].abs() + coef.o2[:, None])
        return disc, hb, disc.abs() < GRAZE_WIDE * mag
    return disc, hb, disc.abs() < GRAZE * act


class PackedState(NamedTuple):
    """The per-ray state ``rz::sweep_packed`` carries from one column range
    to the next: the winner's q and column, the runner-up's, and the last
    grazing column (-1 where none)."""

    qb: torch.Tensor
    best: torch.Tensor
    q2: torch.Tensor
    second: torch.Tensor
    graze: torch.Tensor


def packed_sweep(packed, coef: RayCoef, j0: int, j1: int,
                 state: Optional[PackedState] = None, *,
                 wide: bool = True) -> PackedState:
    """Plain torch version of the column-range ``rz::sweep_packed`` of the
    culled megakernel over the records [j0, j1) of ``packed`` for the rays
    ``coef``, continuing ``state`` (None: a fresh sweep), as the kernel
    sweeps its blocks in turn: its float32 chains (:func:`coef_disc`, the
    wide grazing band, or with ``wide=False`` the resident kernels' narrow
    one) and root rule, the winner the first column of the smallest q, the
    runner-up the next in (q, column) order, the grazing column the last.
    The kernel's square root is ``sqrt.approx``, here the IEEE one, so a
    root within an ulp of another may rank otherwise."""
    return _sweep_columns(packed, coef,
                          torch.arange(j0, j1, device=packed[0].device),
                          state, wide)


def _sweep_columns(packed, coef: RayCoef, cols: torch.Tensor,
                   state: Optional[PackedState], wide: bool) -> PackedState:
    """:func:`packed_sweep` over the records ``cols`` (increasing column
    numbers), in that order."""
    c, v, vv = packed
    sub = (c[cols], None if v is None else v[cols],
           None if vv is None else vv[cols])
    disc, hb, grazing = coef_disc(sub, coef, wide=wide)
    r, k = disc.shape
    dev = disc.device
    if state is None:
        big = torch.full((r,), _BIG, dtype=torch.float32, device=dev)
        none = torch.full((r,), -1, dtype=torch.int64, device=dev)
        state = PackedState(big, none, big.clone(), none.clone(),
                            none.clone())
    if k == 0:
        return state
    rt = torch.sqrt(torch.clamp_min(disc, 0.0))
    q1 = hb - rt
    tm = coef.tmin_a[:, None]
    qv = torch.where(q1 >= tm, q1, hb + rt)
    ok = (disc >= 0.0) & (qv >= tm) & (qv < _BIG)
    q = torch.where(ok, qv, torch.full_like(qv, float("inf")))
    qa, ia = q.min(dim=1)  # the first column of the smallest q
    q_rest = q.scatter(1, ia[:, None], float("inf"))
    qc, ic = q_rest.min(dim=1)
    has_a, has_c = torch.isfinite(qa), torch.isfinite(qc)
    ja, jc = cols[ia], cols[ic]
    last = torch.where(grazing, cols[None, :], -1).amax(dim=1)
    graze = torch.where(last >= 0, last, state.graze)
    new_min = has_a & (qa < state.qb)
    c_second = has_c & (qc < state.qb)
    q2 = torch.where(new_min, torch.where(c_second, qc, state.qb),
                     torch.where(has_a & (qa < state.q2), qa, state.q2))
    second = torch.where(new_min, torch.where(c_second, jc, state.best),
                         torch.where(has_a & (qa < state.q2), ja,
                                     state.second))
    return PackedState(torch.where(new_min, qa, state.qb),
                       torch.where(new_min, ja, state.best), q2, second,
                       graze)


def _lane_min(q: torch.Tensor, col: torch.Tensor):
    """``rz::warp_min_column`` over the lanes' candidates ``q``, ``col``
    [32, R] (col -1: none): the smallest q, then the lowest column, and
    that column's q read from its lane (col % 32); -1 and _BIG where no
    lane has one."""
    inf = torch.full_like(q, float("inf"))
    key = torch.where(col >= 0, q, inf)
    k = key.min(dim=0).values
    found = torch.isfinite(k)
    jm = torch.where((key == k) & (col >= 0), col,
                     torch.full_like(col, 1 << 40)).min(dim=0).values
    jm = torch.where(found, jm, -1)
    rows = torch.arange(q.shape[1], device=q.device)
    qm = q[torch.remainder(jm, 32), rows]
    return torch.where(found, qm, torch.full_like(qm, _BIG)), jm


def packed_sweep_lanes(packed, coef: RayCoef, n: int) -> PackedState:
    """Plain torch version of ``rz::sweep_packed_lanes``, the resident
    megakernel's drain: a warp sweeps one ray's n records a column per lane
    (lane l the columns l, l + 32, ... in order, each lane's own sequential
    state, the resident form's narrow grazing band), then merges the lanes'
    states: the winner the smallest (q, column) of the lanes' winners, the
    runner-up the smallest of the other lanes' winners and the winning
    lane's runner-up, the grazing column the largest. Returns the state
    ``packed_sweep(packed, coef, 0, n, wide=False)`` keeps."""
    dev = packed[0].device
    st = [_sweep_columns(packed, coef, torch.arange(lane, n, 32, device=dev),
                         None, False) for lane in range(32)]
    qb, best, q2, second, graze = (torch.stack(x) for x in zip(*st))
    qw, w = _lane_min(qb, best)
    won = (w >= 0) & (best == w)
    qs, sc = _lane_min(torch.where(won, q2, qb),
                       torch.where(won, second, best))
    return PackedState(qw, w, qs, sc, graze.amax(dim=0))


def today_terms(stab: torch.Tensor, o, d, tau, has_motion: bool,
                dtype=torch.float64):
    """``half_b`` and ``c_term`` [R, N] of ``rz::sweep_spheres``' formula
    (the centre and |c|^2 - r^2 at the ray's time, then d.c - d.o and
    |c|^2 - r^2 - 2 o.c + |o|^2), evaluated in ``dtype``."""
    t = stab.to(dtype)
    o = torch.stack(o, dim=1).to(dtype)
    d = torch.stack(d, dim=1).to(dtype)
    tau = tau.to(dtype)[:, None]
    c = t[[_CX, _CY, _CZ]].T  # [N, 3]
    cc = t[_CCMR2][None, :]
    if has_motion:
        v = t[[_VX, _VY, _VZ]].T
        cx = [c[:, k][None, :] + tau * v[:, k][None, :] for k in range(3)]
        cc = cc + t[_CV2][None, :] * tau + t[_VV][None, :] * tau * tau
    else:
        cx = [c[:, k][None, :].expand(o.shape[0], -1) for k in range(3)]
    d_dot_c = sum(d[:, k:k + 1] * cx[k] for k in range(3))
    o_dot_c = sum(o[:, k:k + 1] * cx[k] for k in range(3))
    hb = d_dot_c - (d * o).sum(dim=1, keepdim=True)
    ct = cc - 2.0 * o_dot_c + (o * o).sum(dim=1, keepdim=True)
    return hb, ct


class Candidate(NamedTuple):
    """One candidate column per ray, evaluated in float64 from the float32
    inputs: whether the root test accepts it, its distance q (in t |d|^2
    units), the bound on the float32 rounding of q, whether the test is
    sensitive to rounding (a grazing root, a root at t_min, a barycentric
    edge), whether a float32 sweep may accept it (``can_hit``) or reject it
    (``can_miss``), and the range [``lo``, ``hi``] of the distances it may
    find where it accepts it (either root, where the nearer one lies at
    t_min; +inf for no column)."""

    hit: torch.Tensor
    q: torch.Tensor
    err: torch.Tensor
    sensitive: torch.Tensor
    can_hit: torch.Tensor
    can_miss: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def candidates(stab: torch.Tensor, ttab: torch.Tensor, col: torch.Tensor,
               o, d, tau, *, t_min: float, has_motion: bool) -> Candidate:
    """Evaluate column ``col`` [R] of each ray (0..N-1 spheres, N + j
    triangle j, -1 none) in float64. Rays are ``o``, ``d`` (tuples of [R]
    float32) at times ``tau``; ``stab`` [17, N], ``ttab`` [20, M]."""
    f64 = torch.float64
    g = TIE_GAMMA * _U
    o = torch.stack(o, dim=1).to(f64)
    d = torch.stack(d, dim=1).to(f64)
    tau = tau.to(f64)
    n = stab.shape[1]
    a = (d * d).sum(dim=1)
    tmin_a = t_min * a
    r = col.shape[0]
    hit = torch.zeros(r, dtype=torch.bool, device=col.device)
    q = torch.full((r,), _BIG, dtype=f64, device=col.device)
    err = torch.zeros(r, dtype=f64, device=col.device)
    sens = torch.zeros(r, dtype=torch.bool, device=col.device)
    can_hit = torch.zeros(r, dtype=torch.bool, device=col.device)
    can_miss = torch.ones(r, dtype=torch.bool, device=col.device)
    lo = torch.full((r,), float("inf"), dtype=f64, device=col.device)
    hi = lo.clone()

    sph = (col >= 0) & (col < n)
    if bool(sph.any()):
        t = stab[:, col[sph].long()].to(f64)
        os_, ds, ts = o[sph], d[sph], tau[sph][:, None]
        c = t[[_CX, _CY, _CZ]].T
        v = t[[_VX, _VY, _VZ]].T if has_motion else torch.zeros_like(c)
        cp = c + ts * v
        cc = t[_CCMR2]
        mc = cc.abs()
        if has_motion:
            cc = cc + t[_CV2] * ts[:, 0] + t[_VV] * ts[:, 0] ** 2
            mc = mc + (t[_CV2] * ts[:, 0]).abs() + t[_VV] * ts[:, 0] ** 2
        span = c.abs() + (ts * v).abs()
        hb = (ds * cp).sum(1) - (ds * os_).sum(1)
        ct = cc - 2.0 * (os_ * cp).sum(1) + (os_ * os_).sum(1)
        mh = (ds.abs() * span).sum(1) + (ds * os_).abs().sum(1)
        mc = mc + 2.0 * (os_.abs() * span).sum(1) + (os_ * os_).sum(1)
        aa, tm = a[sph], tmin_a[sph]
        disc = hb * hb - aa * ct
        e_h, e_c = g * mh, g * mc
        e_d = 2.0 * hb.abs() * e_h + aa * e_c + g * (hb * hb + aa * ct.abs())
        rt = torch.sqrt(torch.clamp_min(disc, 0.0))
        e_rt = e_d / (rt + torch.sqrt(e_d))
        q1, q2 = hb - rt, hb + rt
        qs = torch.where(q1 >= tm, q1, q2)
        e_q = e_h + e_rt + g * (qs.abs() + tm)
        hit[sph] = (disc >= 0.0) & (qs >= tm)
        q[sph] = torch.where(hit[sph], qs, q[sph])
        err[sph] = e_q
        sens[sph] = ((disc.abs() <= e_d) | ((q1 - tm).abs() <= e_q)
                     | ((q2 - tm).abs() <= e_q))
        # a float32 sweep takes q1 where it finds q1 >= t_min, else q2
        near_ok = q1 >= tm - e_q   # q1 may be taken
        near_out = q1 <= tm + e_q  # q1 may be refused
        can_hit[sph] = (disc >= -e_d) & (q2 >= tm - e_q)
        can_miss[sph] = (disc <= e_d) | (q2 <= tm + e_q)
        lo[sph] = torch.where(near_ok, q1, q2) - e_q
        hi[sph] = torch.where(near_out, q2, q1) + e_q

    tri = col >= n
    if bool(tri.any()):
        t = ttab[:, (col[tri] - n).long()].to(f64)
        ot, dt = o[tri], d[tri]
        nrm = t[[_TNX, _TNY, _TNZ]].T
        ndd = (nrm * dt).sum(1)
        ndo = (nrm * ot).sum(1)
        tt = (t[_TNV0] - ndo) / ndd
        aa, tm = a[tri], tmin_a[tri]
        qt = tt * aa
        h = ot + tt[:, None] * dt
        g1, g2 = t[[_TG1X, _TG1Y, _TG1Z]].T, t[[_TG2X, _TG2Y, _TG2Z]].T
        u = (g1 * h).sum(1) - t[_TG1V]
        v = (g2 * h).sum(1) - t[_TG2V]
        e_t = g * (t[_TNV0].abs() + (nrm * ot).abs().sum(1)) / ndd.abs()
        e_q = e_t * aa + g * qt.abs()
        e_u = g * ((g1 * h).abs().sum(1) + t[_TG1V].abs())
        e_v = g * ((g2 * h).abs().sum(1) + t[_TG2V].abs())
        ok = (qt >= tm) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        hit[tri] = ok
        q[tri] = torch.where(ok, qt, q[tri])
        err[tri] = e_q
        sens[tri] = (((qt - tm).abs() <= e_q) | (u.abs() <= e_u)
                     | (v.abs() <= e_v) | ((u + v - 1.0).abs() <= e_u + e_v))
        can_hit[tri] = ok | sens[tri]
        can_miss[tri] = ~ok | sens[tri]
        lo[tri] = qt - e_q
        hi[tri] = qt + e_q
    return Candidate(hit, q, err, sens, can_hit, can_miss, lo, hi)


def near_ties(stab: torch.Tensor, ttab: torch.Tensor, o, d, tau,
              got: torch.Tensor, want: torch.Tensor, *, t_min: float,
              has_motion: bool) -> torch.Tensor:
    """The rule: whether each ray's two winners ``got`` and ``want`` [R]
    (columns as :func:`candidates` numbers them, -1 for a miss), found by
    two sweeps of the same ray, may both be a correct float32 sweep: some
    rounding within the bounds lets the first sweep take ``got`` over
    ``want`` and the second take ``want`` over ``got``. A winner must be a
    column the root test may accept; the loser must be one it may reject,
    or one whose distances may lie at or beyond the winner's. So two hits
    are accepted where their distance ranges meet (a near tie), or where
    the nearer one, which the other sweep passed over, is sensitive to
    rounding (a grazing root, a root at t_min, a triangle edge); a hit
    against a miss where the hit is sensitive. A clear nearer hit passed
    over for a farther column, sensitive or not, is refused, and so is a
    clear miss against a clear hit."""
    kw = dict(t_min=t_min, has_motion=has_motion)
    cg = candidates(stab, ttab, got, o, d, tau, **kw)
    cw = candidates(stab, ttab, want, o, d, tau, **kw)
    valid = ((got < 0) | cg.can_hit) & ((want < 0) | cw.can_hit)
    got_over_want = cw.can_miss | ((got >= 0) & (cw.hi >= cg.lo))
    want_over_got = cg.can_miss | ((want >= 0) & (cg.hi >= cw.lo))
    return valid & got_over_want & want_over_got


def _rays_at(record_ref, cam, stab, ttab, pix, aux, first, kw, state=None):
    """The ray of each slot of ``pix`` at its iteration ``first``: the
    spawned camera ray where the recording ``aux`` [K, 13, S] flags a
    spawn, else the state the plain recorder ``record_ref`` reaches after
    ``first`` iterations from ``state`` (None: fresh slots; chained over
    the distinct iterations)."""
    s = torch.arange(pix.shape[0], device=pix.device)
    ray = torch.stack([aux[first, r, s] for r in (
        _AUX_OX, _AUX_OY, _AUX_OZ, _AUX_DX, _AUX_DY, _AUX_DZ, _AUX_TAU)])
    spawn = torch.remainder(aux[first, _AUX_FLG, s], 2.0) == 1.0
    done = 0
    for k in sorted(set(first[~spawn].tolist())):
        if k > done:
            _, _, _, state = record_ref(cam, stab, ttab, pix, iters=k - done,
                                        init_state=state, want_state=True,
                                        **kw)
            done = k
        at = (first == k) & ~spawn
        ray[:, at] = state[0][:, at]
    return (ray[0], ray[1], ray[2]), (ray[3], ray[4], ray[5]), ray[6]


def explain(scene, camera, seed: int, pix: torch.Tensor, got: torch.Tensor,
            want: torch.Tensor, want_aux: torch.Tensor, *, spp: int,
            max_depth: int, t_min: float, jitter: bool,
            record_ref=None, init_state=None) -> Optional[torch.Tensor]:
    """Apply :func:`near_ties` to two recordings of the slots ``pix``
    (:func:`pathrec.record_pp`'s idx [K, S], ``got`` the kernel's and
    ``want`` the plain recorder's, with its aux ``want_aux``), both fresh
    or both resumed from ``init_state`` (record_pp's (st, cnt, from)): for
    every slot whose indices differ, at the first iteration where they
    part. ``record_ref`` is the plain recorder
    (``pathrec._record_slots_reference`` by default). Returns bool [slots
    that differ], or None if none differs."""
    record_ref = _record_slots_reference if record_ref is None else record_ref
    part = got != want
    rows = torch.nonzero(part.any(dim=0)).flatten()
    if rows.numel() == 0:
        return None
    first = part[:, rows].int().argmax(dim=0)
    cam, stab, ttab = _scene_record_inputs(scene, camera)
    kw = dict(width=camera.width, spp=spp, max_depth=max_depth, t_min=t_min,
              jitter=jitter, has_motion=scene.has_motion, seed=int(seed))
    sub = pix[rows].contiguous()
    state = (None if init_state is None
             else tuple(t[..., rows].contiguous() for t in init_state))
    o, d, tau = _rays_at(record_ref, cam, stab, ttab, sub,
                         want_aux[:, :, rows], first, kw, state)
    return near_ties(stab, ttab, o, d, tau, got[first, rows],
                     want[first, rows], t_min=t_min,
                     has_motion=scene.has_motion)


def explain_paths(scene, rays: torch.Tensor, rand: torch.Tensor,
                  got: torch.Tensor, want: torch.Tensor, *,
                  t_min: float) -> Optional[torch.Tensor]:
    """Apply :func:`near_ties` to two bounce-indexed recordings of the rays
    ``rays`` [7, R] (origin, direction, time) with the randoms ``rand``
    [depth, 5, R] (``diffkernel.record_paths``' idx [depth, R] over the
    resident tables, ``got`` the kernel's and ``want`` the plain
    recorder's): for every ray whose indices differ, at the first bounce
    where they part, its ray there re-derived by the plain recorder (the
    two agree on every bounce before, so they trace the same ray there).
    An index is a row of ``diffkernel._diff_tables``: a sphere's column, or
    the sphere count plus a triangle's column, as :func:`candidates`
    numbers them. Returns bool [rays that differ] in ray order, or None if
    none differs."""
    part = got != want
    rid = torch.nonzero(part.any(dim=0)).flatten()
    if rid.numel() == 0:
        return None
    first = part[:, rid].int().argmax(dim=0)
    tabs = _record_tables(scene, resolve(scene, "record", stream=0))
    stab, ttab = tabs.stab, tabs.ttab
    ok = torch.zeros(rid.numel(), dtype=torch.bool, device=got.device)
    kw = dict(t_min=t_min, has_motion=scene.has_motion)
    for b, live, (o, d, tau), *_ in _reference_bounces(
            stab, ttab, rays[:, rid], rand[:, :, rid], depth=got.shape[0],
            **kw):
        sel = torch.nonzero(first[live] == b).flatten()
        if sel.numel() == 0:
            continue
        k = live[sel]
        ok[k] = near_ties(stab, ttab, tuple(x[sel] for x in o),
                          tuple(x[sel] for x in d), tau[sel],
                          got[b, rid[k]].long(), want[b, rid[k]].long(), **kw)
    return ok


def explain_items(cam: torch.Tensor, stab: torch.Tensor, ttab: torch.Tensor,
                  n_pix: int, s0: int, got: torch.Tensor, want: torch.Tensor,
                  *, width: int, max_depth: int, t_min: float, jitter: bool,
                  has_motion: bool, seed: int) -> Optional[torch.Tensor]:
    """Apply :func:`near_ties` to two recordings ``got`` and ``want``
    [max_depth, n_samples * n_pix] of the queue's items (samples s0 + 1,
    ... of pixels [0, n_pix), sample-major; ``megakernel._queue``'s
    ``hits``, the kernel's and the plain version's, over the tables
    ``stab``/``ttab``, -2 where a segment was not traced): for every item
    whose winners differ, at the first bounce where they part, its ray
    there re-derived by the plain version (the two agree on every bounce
    before, so they trace the same ray there). A segment one recording
    traced and the other did not is not explained. Returns bool [items that
    differ] in item order, or None if none differs."""
    part = got != want
    items = torch.nonzero(part.any(dim=0)).flatten()
    if items.numel() == 0:
        return None
    first = part[:, items].int().argmax(dim=0)
    rays = []
    _trace_items_reference(cam, stab, ttab, (items % n_pix).to(torch.int32),
                           (items // n_pix + s0 + 1).to(torch.int32),
                           width=width, max_depth=max_depth, t_min=t_min,
                           jitter=jitter, has_motion=has_motion, seed=seed,
                           rays=rays)
    ok = torch.zeros(items.numel(), dtype=torch.bool, device=got.device)
    for b, (live, o, d, tau) in enumerate(rays):
        sel = torch.nonzero(first[live] == b).flatten()
        if sel.numel() == 0:
            continue
        k = live[sel]
        g, w = got[b, items[k]].long(), want[b, items[k]].long()
        ok[k] = (g > -2) & (w > -2) & near_ties(
            stab, ttab, tuple(x[sel] for x in o), tuple(x[sel] for x in d),
            tau[sel], g, w, t_min=t_min, has_motion=has_motion)
    return ok
