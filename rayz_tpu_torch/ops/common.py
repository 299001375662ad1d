"""The per-ray device code of ``csrc/common.cuh`` in plain torch, over
batches of rays: the nearest hit (:func:`_nearest`), the hit's frame, the
draws and the material scatter, the camera ray, and a sample's draws and
camera rays keyed as the kernels key them (:func:`_make_rand`,
:func:`_camera_rays`). Every kernel's plain version is built from these,
and the dense integrator takes its camera rays and draws from them."""

from __future__ import annotations

from typing import Callable

import torch

from ..models.camera import Camera
from . import rng
from .tables import (_BIG, _CCMR2, _CV2, _CX, _CY, _CZ, _PKF, _TG1V, _TG1X,
                     _TG1Y, _TG1Z, _TG2V, _TG2X, _TG2Y, _TG2Z, _TNV0, _TNX,
                     _TNY, _TNZ, _TPKF, _VV, _VX, _VY, _VZ, _camera_vector)

_TWO_PI = 6.283185307179586
# Bound on the [slots, primitives] temporaries of the plain sweep.
_SWEEP_ELEMS = 1 << 25

Bits = Callable[[torch.Tensor, int], torch.Tensor]


def _sphere_at(stab, cols, tau, tau2, has_motion):
    """Sphere centers (and |c|^2 - r^2) at the rays' times. ``cols`` is a
    slice (all columns, broadcast against [S, 1] ray terms) or a [S] index
    tensor (one column per ray)."""
    cx, cy, cz = stab[_CX, cols], stab[_CY, cols], stab[_CZ, cols]
    ccmr2 = stab[_CCMR2, cols]
    if has_motion:
        cx = cx + tau * stab[_VX, cols]
        cy = cy + tau * stab[_VY, cols]
        cz = cz + tau * stab[_VZ, cols]
        ccmr2 = ccmr2 + stab[_CV2, cols] * tau + stab[_VV, cols] * tau2
    return cx, cy, cz, ccmr2


def _first_min(qv):
    """Smallest candidate per row and its first column (-1 if none)."""
    q, j = qv.min(dim=1)
    return q, torch.where(q < _BIG, j, torch.full_like(j, -1))


def _sweep(stab, ttab, o, d, tau, a, d_dot_o, o2, tmin_a, tau2, has_motion):
    """Nearest hit for a batch of rays: the kernel's sequential scans with a
    shrinking q_best, as [rays, primitives] candidates reduced by a
    first-minimum (identical winners: strictly-better updates keep the
    earliest of equal candidates). Returns (q_best, column, is_triangle)."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    tau, a, d_dot_o, o2, tmin_a, tau2 = (
        x[:, None] for x in (tau, a, d_dot_o, o2, tmin_a, tau2))
    big = torch.tensor(_BIG, dtype=torch.float32, device=ox.device)
    qb = torch.full_like(ox[:, 0], _BIG)
    best = torch.full(qb.shape, -1, dtype=torch.int64, device=qb.device)
    if stab.shape[1]:
        cx, cy, cz, ccmr2 = _sphere_at(stab, slice(None), tau, tau2,
                                       has_motion)
        half_b = dx * cx + dy * cy + dz * cz - d_dot_o
        o_dot_c = ox * cx + oy * cy + oz * cz
        c_term = ccmr2 - 2.0 * o_dot_c + o2
        disc = half_b * half_b - a * c_term
        rt = torch.sqrt(disc)  # NaN on a miss: every compare below is false
        q1 = half_b - rt
        q2 = half_b + rt
        qv = torch.where(q1 >= tmin_a, q1, q2)
        qv = torch.where((qv >= tmin_a) & (qv < big), qv, big)
        qb, best = _first_min(qv)
    is_tri = torch.zeros_like(qb, dtype=torch.bool)
    if ttab.shape[1]:
        tnx, tny, tnz = ttab[_TNX], ttab[_TNY], ttab[_TNZ]
        ndd = dx * tnx + dy * tny + dz * tnz
        ndo = ox * tnx + oy * tny + oz * tnz
        rcp = 1.0 / ndd
        tt = (ttab[_TNV0] - ndo) * rcp
        qv = tt * a
        hx = ox + tt * dx
        hy = oy + tt * dy
        hz = oz + tt * dz
        u = ttab[_TG1X] * hx + ttab[_TG1Y] * hy + ttab[_TG1Z] * hz - ttab[_TG1V]
        v = ttab[_TG2X] * hx + ttab[_TG2Y] * hy + ttab[_TG2Z] * hz - ttab[_TG2V]
        ok = ((qv >= tmin_a) & (qv < big) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0))
        qt, bt = _first_min(torch.where(ok, qv, big))
        is_tri = qt < qb
        qb = torch.where(is_tri, qt, qb)
        best = torch.where(is_tri, bt, best)
    return qb, best, is_tri


def _key_draws(key, bits: Bits):
    """The random numbers a scatter consumes under the step keys ``key``:
    a unit vector (draws 5-6), the cube root of a uniform by exp/log (draw
    7) and the Schlick uniform (draw 8), as ``rz::KeyDraws`` gives them.
    Returns (ux, uy, uz, cb, us)."""
    def uniform(k):
        return rng.uniform(bits(key, k))

    ux, uy, uz = rng.unit3(uniform(5), uniform(6))
    cb = torch.exp(torch.log(torch.clamp_min(uniform(7), 1e-24)) * (1.0 / 3.0))
    return ux, uy, uz, cb, uniform(8)


def _scatter(mat, d, dinv, p, n, front, draws):
    """Material scatter, every material evaluated and the winner's selected
    (the kernel evaluates only the winner's; same values). ``mat`` holds the
    winner's 8 material rows [8, S]; ``draws`` the random numbers (ux, uy,
    uz, cb, us), from :func:`_key_draws` or given by the caller. Returns
    (new direction, attenuation, scattered)."""
    dx, dy, dz = d
    px, py, pz = p
    nx, ny, nz = n
    ux, uy, uz, cb, us = draws

    bpk, bios = mat[0], mat[1]
    bkm = torch.floor(bpk * 0.25)
    bfz = (bpk - 4.0 * bkm) * 0.5
    kind = torch.floor(bkm * 0.25)
    method = bkm - 4.0 * kind
    is_d = kind == 2.0
    is_m = kind == 1.0

    # dielectric: Schlick coin, total internal reflection
    eta = torch.where(front, 1.0 / bios, bios)
    udx, udy, udz = dx * dinv, dy * dinv, dz * dinv
    cos_t = -(udx * nx + udy * ny + udz * nz)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    refl_p = r0 + (1.0 - r0) * om2 * om2 * om
    do_refl = cannot | (refl_p > us)
    two_ndd = 2.0 * (dx * nx + dy * ny + dz * nz)
    rfx = dx - two_ndd * nx
    rfy = dy - two_ndd * ny
    rfz = dz - two_ndd * nz
    ppx = (udx + cos_t * nx) * eta
    ppy = (udy + cos_t * ny) * eta
    ppz = (udz + cos_t * nz) * eta
    parm = -torch.sqrt(torch.clamp_min(
        1.0 - (ppx * ppx + ppy * ppy + ppz * ppz), 0.0))
    dl = [torch.where(do_refl, rf, pp + parm * nn)
          for rf, pp, nn in ((rfx, ppx, nx), (rfy, ppy, ny), (rfz, ppz, nz))]

    # checker albedo (solid textures have even == odd and scale 1)
    isc = 1.0 / bios
    par = (torch.floor(px * isc) + torch.floor(py * isc)
           + torch.floor(pz * isc))
    even_par = par - 2.0 * torch.floor(par * 0.5) < 0.5
    al = [torch.where(even_par, mat[2 + c], mat[5 + c]) for c in range(3)]

    # metal: fuzz reuses the unit sample; absorbed below the horizon
    rinv = 1.0 / torch.sqrt(torch.clamp_min(
        rfx * rfx + rfy * rfy + rfz * rfz, 1e-24))
    fz = torch.clamp_max(bfz, 1.0)
    me = [rf * rinv + fz * uu for rf, uu in ((rfx, ux), (rfy, uy), (rfz, uz))]
    metal_ok = me[0] * nx + me[1] * ny + me[2] * nz > 0.0

    # diffuse: three methods
    sx, sy, sz = ux * cb, uy * cb, uz * cb
    flip = torch.where(sx * nx + sy * ny + sz * nz > 0.0, 1.0, -1.0)
    m0 = method == 0.0  # UNIT_SPHERE
    m1 = method == 1.0  # UNIT_SPHERE_SURFACE
    off = [torch.where(m0, nn + ss, torch.where(m1, nn + uu, ss * flip))
           for nn, ss, uu in ((nx, sx, ux), (ny, sy, uy), (nz, sz, uz))]
    # reference quirk: near-zero check on the target POINT
    tg = [pp + oo for pp, oo in zip(p, off)]
    nz_tgt = ((torch.abs(tg[0]) <= 1e-8) & (torch.abs(tg[1]) <= 1e-8)
              & (torch.abs(tg[2]) <= 1e-8))
    dif = [torch.where(nz_tgt, nn, t) - pp for nn, t, pp in zip(n, tg, p)]

    ndir = [torch.where(is_d, a, torch.where(is_m, b, c))
            for a, b, c in zip(dl, me, dif)]
    att = [torch.where(is_d, 1.0, c) for c in al]
    nd2 = ndir[0] * ndir[0] + ndir[1] * ndir[1] + ndir[2] * ndir[2]
    scattered = ((~is_m) | metal_ok) & (nd2 > 1e-20)
    return ndir, att, scattered


def _spawn(cam, pxf, pyf, key, jitter: bool, bits: Bits):
    """Camera ray of each slot's next sample (draws 0-4 under ``key``):
    +-0.5 px jitter, polar defocus-disk origin, time in [0, 1). Returns
    (origin xyz, direction xyz, time)."""
    (lfx, lfy, lfz, dux, duy, duz, dvx, dvy, dvz,
     pox, poy, poz, deux, deuy, deuz, devx, devy, devz) = cam.unbind()
    if jitter:
        x = pxf + rng.uniform(bits(key, 0)) - 0.5
        y = pyf + rng.uniform(bits(key, 1)) - 0.5
        rr = torch.sqrt(rng.uniform(bits(key, 2)))
        th = _TWO_PI * rng.uniform(bits(key, 3))
        ca, sa = torch.cos(th), torch.sin(th)
        nox = lfx + rr * (ca * deux + sa * devx)
        noy = lfy + rr * (ca * deuy + sa * devy)
        noz = lfz + rr * (ca * deuz + sa * devz)
        ntau = rng.uniform(bits(key, 4))
    else:
        x, y = pxf, pyf
        nox, noy, noz = (v.expand(pxf.shape[0]) for v in (lfx, lfy, lfz))
        ntau = torch.zeros_like(pxf)
    ndx = x * dux + y * dvx + pox - nox
    ndy = x * duy + y * dvy + poy - noy
    ndz = x * duz + y * dvz + poz - noz
    return (nox, noy, noz), (ndx, ndy, ndz), ntau


def _nearest(stab, ttab, o, d, tau, t_min: float, has_motion: bool):
    """Nearest hit of every slot's ray, swept in slot chunks that bound the
    [slots, primitives] temporaries. Returns (q_best, column, is_triangle,
    |d|^2, tau^2)."""
    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o2 = ox * ox + oy * oy + oz * oz
    tmin_a = t_min * a
    tau2 = tau * tau
    cap = ox.shape[0]
    n_cols = max(stab.shape[1], ttab.shape[1], 1)
    chunk = max(1, _SWEEP_ELEMS // n_cols)
    parts = [_sweep(stab, ttab, (ox[s], oy[s], oz[s]),
                    (dx[s], dy[s], dz[s]), tau[s], a[s], d_dot_o[s],
                    o2[s], tmin_a[s], tau2[s], has_motion)
             for s in (slice(i, i + chunk) for i in range(0, cap, chunk))]
    qb, best, is_tri = (torch.cat(t) for t in zip(*parts))
    return qb, best, is_tri, a, tau2


def _hit_frame(stab, ttab, o, d, tau, tau2, a, qb, best, is_tri,
               has_motion: bool):
    """Decode the winner: hit point, unit normal turned against the ray,
    the front-face flag and the winner's 8 material rows [8, S]."""
    ox, oy, oz = o
    dx, dy, dz = d
    ts = qb * (1.0 / a)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz
    # one column per slot, read from both tables and selected after: clamp
    # it into each table (the two differ in width)
    col = torch.clamp_min(best, 0)
    if stab.shape[1]:
        scol = torch.clamp_max(col, stab.shape[1] - 1)
        cx, cy, cz, _ = _sphere_at(stab, scol, tau, tau2, has_motion)
        nx, ny, nz = px - cx, py - cy, pz - cz
        mat = stab[_PKF:_PKF + 8, scol]
    if ttab.shape[1]:
        tcol = torch.clamp_max(col, ttab.shape[1] - 1)
        tmat = ttab[_TPKF:_TPKF + 8, tcol]
        tn = ttab[_TNX:_TNZ + 1, tcol]
        if stab.shape[1]:
            nx = torch.where(is_tri, tn[0], nx)
            ny = torch.where(is_tri, tn[1], ny)
            nz = torch.where(is_tri, tn[2], nz)
            mat = torch.where(is_tri, tmat, mat)
        else:
            (nx, ny, nz), mat = tn.unbind(), tmat
    ninv = 1.0 / torch.sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz,
                                            1e-24))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    front = nx * dx + ny * dy + nz * dz < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    return (px, py, pz), (nx * sgn, ny * sgn, nz * sgn), front, mat


def _make_rand(seed: int, pix: torch.Tensor, sample,
               max_depth: int) -> torch.Tensor:
    """[max_depth, 5, R] f32 randoms of sample ``sample`` (from 0; an int,
    or an [R] tensor, one per ray) of the flat pixel ids ``pix``: bounce b
    draws 5-8 under the megakernel's key
    ``step_key(slot_key(seed, pixel), sample + 1, b)`` (megakernel.py:375
    counts samples from 1 and bounces from 0), through :func:`_key_draws`:
    the unit vector (draws 5-6), u^(1/3) by exp/log (7), the Schlick
    uniform (8)."""
    key0 = rng.slot_key(seed, pix)[None, :]
    bounce = torch.arange(max_depth, device=pix.device)[:, None]
    key = rng.step_key(key0, torch.as_tensor(sample + 1, device=pix.device),
                       bounce)
    return torch.stack(_key_draws(key, rng.draw_bits), dim=1)


def _camera_rays(camera: Camera, seed: int, pix: torch.Tensor, sample,
                 jitter: bool):
    """The megakernel's camera ray of sample ``sample`` (from 0; an int, or
    an [R] tensor) of the pixels ``pix``: ``_spawn`` with draws 0-4 under
    bounce 0's key, in the
    camera's dtype (an f64 camera spawns in f64 from the f32 draws, so with
    jitter off the rays are JAX's ``generate_rays`` bit for bit; the
    recorder takes them rounded to f32). Returns (origin [R, 3], direction
    [R, 3], time [R])."""
    cam = _camera_vector(camera, camera.dtype)
    key0 = rng.slot_key(seed, pix)
    key = rng.step_key(key0, torch.as_tensor(sample + 1, device=pix.device),
                       torch.zeros_like(key0))
    pxf = (pix % camera.width).to(camera.dtype)
    pyf = (pix // camera.width).to(camera.dtype)
    o, d, tau = _spawn(cam, pxf, pyf, key, jitter, rng.draw_bits)
    return torch.stack(o, dim=1), torch.stack(d, dim=1), tau
