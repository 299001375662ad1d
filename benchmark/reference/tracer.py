"""The plain path tracer that judges every cell: torch and numpy only.

It is written from the estimator the program states (Ray Tracing in One
Weekend's camera, spheres and triangles, diffuse, metal and dielectric
materials, checker textures, a sky gradient, moving spheres), not from the
program's code, and imports nothing of it. It takes the scene the benchmark
made (``scene.inputs``) and works out everything else again: the camera
frame, the triangles' edges and normals, each hit.

Each path (pixel, sample) draws its random numbers from the counter-based
keys of :mod:`.rng`, so the reference traces the paths the program traces;
they part only where rounding decides a near tie (a grazing hit, a coin
that lands on its edge). The textbook forms are used throughout: the
sphere's half-b quadratic on o - c, Moller-Trumbore for triangles, the
normal (p - c) / |p - c|.

Gradients: every parameter tensor of :class:`Scene` may require grad. The
nearest hit is found without autograd, then the winner's hit is computed
again with it, as are the scatter directions, with each discrete choice
(the winner, the root, the material branch, the checker's parity, the
coin, the hemisphere's flip) held as drawn: the gradient of the path with
its choices frozen.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import rng

MAT_KINDS = {"diffuse": 0, "metal": 1, "dielectric": 2}
DIFFUSE_METHODS = {"unit_sphere": 0, "unit_sphere_surface": 1,
                   "hemisphere": 2}
TEX_KINDS = {"solid": 0, "checker": 1}
SKY_BLUE = (0.5, 0.7, 1.0)

# Floating-point operations of one (segment, primitive) test, counted by
# hand from _sphere_sweep and _triangle_sweep below: additions,
# subtractions, multiplications, divisions, square roots and comparisons;
# selects and the index of the minimum are not counted.
SPHERE_TEST_FLOPS = 31   # 28 arithmetic + 3 comparisons
TRIANGLE_TEST_FLOPS = 51  # 46 arithmetic + 5 comparisons

# Bound on the [rays, primitives] temporaries of one sweep step.
_SWEEP_ELEMS = 1 << 24

# Program field names of the trainable tensors, and this module's.
LEAVES = {"sphere_center": "c", "sphere_radius": "r", "tri_v0": "v0",
          "tri_v1": "v1", "tri_v2": "v2", "tex_color": "tex_color",
          "mat_fuzz": "fuzz", "mat_ior": "ior"}


class Scene:
    """The scene as tensors of one dtype on one device. ``inputs`` is the
    benchmark's dict of numpy arrays (:func:`benchmark.scene.inputs`);
    ``params`` optionally replaces trainable tensors, keyed by the
    program's field names (see :data:`LEAVES`)."""

    def __init__(self, inputs: Dict[str, np.ndarray], dtype, device,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(
                device=device, dtype=dtype)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.dtype, self.device = dtype, torch.device(device)
        self.c, self.v, self.r = f(inputs["sph_c"]), f(inputs["sph_v"]), \
            f(inputs["sph_r"])
        self.sm = i(inputs["sph_m"])
        self.v0, self.v1, self.v2 = (f(inputs[k]) for k in
                                     ("tri_v0", "tri_v1", "tri_v2"))
        self.tm = i(inputs["tri_m"])
        self.mat_kind, self.mat_tex, self.mat_method = (
            i(inputs[k]) for k in ("mat_kind", "mat_tex", "mat_method"))
        self.fuzz, self.ior = f(inputs["mat_fuzz"]), f(inputs["mat_ior"])
        self.tex_kind, self.tex_even, self.tex_odd = (
            i(inputs[k]) for k in ("tex_kind", "tex_even", "tex_odd"))
        self.tex_color, self.tex_scale = f(inputs["tex_color"]), \
            f(inputs["tex_scale"])
        for name, t in (params or {}).items():
            setattr(self, LEAVES[name], t)

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, attr) for name, attr in LEAVES.items()}


class Camera:
    """The thin-lens camera of the book, worked out in float64 from the
    configuration's ``camera`` and ``resolution`` and held in ``dtype``:
    the pixel (0, 0) centre, the steps of one pixel across and down, and
    the defocus disk's two radii."""

    def __init__(self, cfg: dict, dtype, device):
        cam = cfg["camera"]
        self.width, self.height = (int(x) for x in cfg["resolution"])
        look_from = np.asarray(cam["look_from"], np.float64)
        look_at = np.asarray(cam["look_at"], np.float64)
        vup = np.asarray(cam["vup"], np.float64)
        focus = float(cam["focus_dist"])
        vp_h = 2.0 * math.tan(math.radians(cam["vfov"]) / 2.0) * focus
        vp_w = vp_h * self.width / self.height
        w = (look_from - look_at) / np.linalg.norm(look_from - look_at)
        u = np.cross(vup, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        du = u * vp_w / self.width
        dv = -v * vp_h / self.height
        p00 = (look_from - w * focus - u * vp_w / 2.0 + v * vp_h / 2.0
               + (du + dv) / 2.0)
        angle = float(cam["defocus_angle"])
        radius = math.tan(math.radians(angle) / 2.0) * focus if angle > 0 \
            else 0.0

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64).to(
                device=device, dtype=dtype)

        self.origin, self.du, self.dv, self.p00 = (
            t(x) for x in (look_from, du, dv, p00))
        self.disk_u, self.disk_v = t(u * radius), t(v * radius)


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a))[..., None]


def _spawn(cam: Camera, pix, key, dtype):
    """Camera rays: a jittered point of the pixel, an origin on the
    defocus disk (polar: radius sqrt(u), angle 2 pi u), a time in [0, 1)."""
    x = (pix % cam.width).to(dtype) + rng.uniform(key, 0, dtype) - 0.5
    y = (pix // cam.width).to(dtype) + rng.uniform(key, 1, dtype) - 0.5
    rr = torch.sqrt(rng.uniform(key, 2, dtype))
    th = (2.0 * math.pi) * rng.uniform(key, 3, dtype)
    o = cam.origin + rr[:, None] * (torch.cos(th)[:, None] * cam.disk_u
                                    + torch.sin(th)[:, None] * cam.disk_v)
    d = cam.p00 + x[:, None] * cam.du + y[:, None] * cam.dv - o
    return o, d, rng.uniform(key, 4, dtype)


def _sphere_sweep(sc: Scene, o, d, tau, a, inv_a, t_min):
    """Nearest sphere of each ray: (t, index, far root). Per (ray, sphere):
    centre at tau (6), o - c (3), b = d.(o - c) (5), |o - c|^2 - r^2 (6),
    b^2 - a c (3), sqrt (1), the two roots (4: (b + s)(-1/a), (s - b)/a),
    3 comparisons (near root, t >= t_min, the running minimum)."""
    r2 = sc.r * sc.r
    t_best = torch.full_like(tau, math.inf)
    j_best = torch.zeros(tau.shape, dtype=torch.int64, device=tau.device)
    far_best = torch.zeros(tau.shape, dtype=torch.bool, device=tau.device)
    n = sc.c.shape[0]
    if n == 0:
        return t_best, j_best, far_best
    step = max(1, _SWEEP_ELEMS // n)
    for s in range(0, tau.shape[0], step):
        sl = slice(s, s + step)
        ta = tau[sl, None]
        oc = [o[sl, k:k + 1] - (sc.c[None, :, k] + ta * sc.v[None, :, k])
              for k in range(3)]
        b = d[sl, 0:1] * oc[0] + d[sl, 1:2] * oc[1] + d[sl, 2:3] * oc[2]
        cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r2[None]
        disc = b * b - a[sl, None] * cc
        sq = torch.sqrt(disc)  # NaN on a miss: every comparison is false
        t1 = (b + sq) * (-inv_a[sl, None])
        t2 = (sq - b) * inv_a[sl, None]
        near = t1 >= t_min
        t = torch.where(near, t1, t2)
        t = torch.where(t >= t_min, t, math.inf)
        tb, j = t.min(dim=1)
        t_best[sl], j_best[sl] = tb, j
        far_best[sl] = ~near.gather(1, j[:, None])[:, 0]
    return t_best, j_best, far_best


def _triangle_sweep(sc: Scene, o, d, t_min):
    """Nearest triangle of each ray by Moller-Trumbore: (t, index). Per
    (ray, triangle): p = d x e2 (9), det (5), 1/det (1), o - v0 (3), u (6),
    q = (o - v0) x e1 (9), v (6), t (6), u + v (1), 5 comparisons (u, v,
    u + v, t >= t_min, the running minimum)."""
    e1, e2 = sc.v1 - sc.v0, sc.v2 - sc.v0
    n = e1.shape[0]
    t_best = torch.full(o.shape[:1], math.inf, dtype=o.dtype,
                        device=o.device)
    j_best = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
    if n == 0:
        return t_best, j_best
    step = max(1, _SWEEP_ELEMS // n)
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        dx, dy, dz = (d[sl, k:k + 1] for k in range(3))
        px = dy * e2[None, :, 2] - dz * e2[None, :, 1]
        py = dz * e2[None, :, 0] - dx * e2[None, :, 2]
        pz = dx * e2[None, :, 1] - dy * e2[None, :, 0]
        inv = 1.0 / (e1[None, :, 0] * px + e1[None, :, 1] * py
                     + e1[None, :, 2] * pz)
        tx, ty, tz = (o[sl, k:k + 1] - sc.v0[None, :, k] for k in range(3))
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1[None, :, 2] - tz * e1[None, :, 1]
        qy = tz * e1[None, :, 0] - tx * e1[None, :, 2]
        qz = tx * e1[None, :, 1] - ty * e1[None, :, 0]
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2[None, :, 0] * qx + e2[None, :, 1] * qy
             + e2[None, :, 2] * qz) * inv
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
        tb, j = torch.where(ok, t, math.inf).min(dim=1)
        t_best[sl], j_best[sl] = tb, j
    return t_best, j_best


def _sphere_frame(sc: Scene, o, d, tau, j, far):
    """Hit point and outward unit normal on sphere ``j``, with autograd."""
    c = sc.c[j] + tau[:, None] * sc.v[j]
    oc = o - c
    a = _dot(d, d)
    b = _dot(d, oc)
    disc = b * b - a * (_dot(oc, oc) - sc.r[j] * sc.r[j])
    sq = torch.sqrt(disc)
    t = torch.where(far, (sq - b) / a, -(b + sq) / a)
    p = o + t[:, None] * d
    return p, _normalize(p - c)


def _triangle_frame(sc: Scene, o, d, j):
    """Hit point and unit normal (e1 x e2) on triangle ``j``, with
    autograd."""
    v0 = sc.v0[j]
    e1, e2 = sc.v1[j] - v0, sc.v2[j] - v0
    q = _cross(o - v0, e1)
    t = _dot(e2, q) / _dot(e1, _cross(d, e2))
    return o + t[:, None] * d, _normalize(_cross(e1, e2))


def _albedo(sc: Scene, tex, p):
    """A solid texture's colour, or a checker's child's by the parity of
    floor(x/s) + floor(y/s) + floor(z/s) (one level of nesting)."""
    with torch.no_grad():
        cells = torch.floor(p.detach() / sc.tex_scale[tex][:, None])
        even = torch.remainder(cells.sum(-1), 2.0) == 0.0
        child = torch.where(even, sc.tex_even[tex], sc.tex_odd[tex])
        tex = torch.where(sc.tex_kind[tex] == TEX_KINDS["checker"], child,
                          tex)
    return sc.tex_color[tex]


def _reflect(d, n):
    return d - 2.0 * _dot(d, n)[:, None] * n


def _scatter(sc: Scene, mat, d, p, n, front, key, dtype):
    """New direction, attenuation and whether the path goes on, for rays
    of one material kind each (the caller splits them by kind)."""
    ux, uy, uz = _unit(key, dtype)
    unit = torch.stack([ux, uy, uz], -1)
    kind = sc.mat_kind[mat]
    out_d = torch.empty_like(d)
    att = torch.ones_like(d)
    alive = torch.ones(d.shape[:1], dtype=torch.bool, device=d.device)
    parts = []

    dif = torch.nonzero(kind == MAT_KINDS["diffuse"])[:, 0]
    if dif.numel():
        u7 = rng.uniform(key[dif], 7, dtype)
        ball = unit[dif] * (u7 ** (1.0 / 3.0))[:, None]
        nn, pp = n[dif], p[dif]
        method = sc.mat_method[mat[dif]][:, None]
        up = (_dot(ball, nn.detach()) > 0.0)[:, None]
        off = torch.where(method == DIFFUSE_METHODS["unit_sphere"],
                          nn + ball,
                          torch.where(method == DIFFUSE_METHODS[
                              "unit_sphere_surface"], nn + unit[dif],
                              torch.where(up, ball, -ball)))
        # the book's near-zero test is on the target point p + off, which
        # then becomes the normal
        tiny = (torch.abs((pp + off).detach()) <= 1e-8).all(-1)
        nd = torch.where(tiny[:, None], nn - pp, off)
        parts.append((dif, nd, _albedo(sc, sc.mat_tex[mat[dif]], pp),
                      _dot(nd, nd) > 1e-20))

    met = torch.nonzero(kind == MAT_KINDS["metal"])[:, 0]
    if met.numel():
        nn = n[met]
        nd = (_normalize(_reflect(d[met], nn))
              + torch.clamp_max(sc.fuzz[mat[met]], 1.0)[:, None] * unit[met])
        parts.append((met, nd, _albedo(sc, sc.mat_tex[mat[met]], p[met]),
                      (_dot(nd, nn) > 0.0) & (_dot(nd, nd) > 1e-20)))

    die = torch.nonzero(kind == MAT_KINDS["dielectric"])[:, 0]
    if die.numel():
        nn, dd = n[die], d[die]
        ior = sc.ior[mat[die]]
        eta = torch.where(front[die], 1.0 / ior, ior)
        ud = _normalize(dd)
        cos_t = -_dot(ud, nn)
        with torch.no_grad():
            e, c = eta.detach(), cos_t.detach()
            sin_t = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
            r0 = ((1.0 - e) / (1.0 + e)) ** 2
            schlick = r0 + (1.0 - r0) * (1.0 - c) ** 5
            refl = (e * sin_t > 1.0) | (schlick > rng.uniform(key[die], 8,
                                                             dtype))
        nd = torch.empty_like(dd)
        rf = torch.nonzero(refl)[:, 0]
        tr = torch.nonzero(~refl)[:, 0]
        nd = nd.index_put((rf,), _reflect(dd[rf], nn[rf]))
        perp = eta[tr, None] * (ud[tr] + cos_t[tr, None] * nn[tr])
        par = -torch.sqrt(torch.clamp_min(1.0 - _dot(perp, perp), 0.0))
        nd = nd.index_put((tr,), perp + par[:, None] * nn[tr])
        parts.append((die, nd, torch.ones_like(nd), _dot(nd, nd) > 1e-20))

    for rows, nd, at, ok in parts:
        out_d = out_d.index_put((rows,), nd)
        att = att.index_put((rows,), at)
        alive = alive.index_put((rows,), ok)
    return out_d, att, alive


def _unit(key, dtype):
    """Uniform unit vector from draws 5 (z) and 6 (angle)."""
    z = 2.0 * rng.uniform(key, 5, dtype) - 1.0
    phi = (2.0 * math.pi) * rng.uniform(key, 6, dtype)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return r * torch.cos(phi), r * torch.sin(phi), z


def trace(sc: Scene, cam: Camera, seed: int, pix: torch.Tensor,
          sample: torch.Tensor, max_depth: int, t_min: float,
          winners: Optional[list] = None):
    """Radiance [P, 3] of the paths (pixel ``pix``, sample ``sample`` from
    1), each traced to its end: the sky weighted by the path's throughput
    where it escapes, 0 where a metal absorbs it or it runs out of depth.
    Returns (radiance, segments traced).

    ``winners``: an empty list receives each bounce's nearest hits; a
    list so filled by a trace of the same paths and scene values is
    replayed instead of sweeping again (the autograd pass of
    :func:`loss_and_grad`)."""
    dtype, dev = sc.dtype, sc.device
    pkey = rng.path_keys(seed, pix, sample)
    ids = torch.arange(pix.shape[0], device=dev)
    key = rng.bounce_key(pkey, 0)
    o, d, tau = _spawn(cam, pix, key, dtype)
    thr = torch.ones_like(o)
    blue = torch.tensor(SKY_BLUE, dtype=dtype, device=dev)
    got_ids, got = [], []
    segments = 0
    for bounce in range(max_depth):
        if ids.numel() == 0:
            break
        segments += ids.numel()
        if bounce:
            key = rng.bounce_key(pkey[ids], bounce)
        if winners is not None and bounce < len(winners):
            js, far, jt, is_tri, hit = winners[bounce]
        else:
            with torch.no_grad():
                od, dd = o.detach(), d.detach()
                a = _dot(dd, dd)
                ts, js, far = _sphere_sweep(sc, od, dd, tau, a, 1.0 / a,
                                            t_min)
                tt, jt = _triangle_sweep(sc, od, dd, t_min)
                is_tri = tt < ts  # spheres win ties
                hit = torch.isfinite(torch.where(is_tri, tt, ts))
            if winners is not None:
                winners.append((js, far, jt, is_tri, hit))
        miss = torch.nonzero(~hit)[:, 0]
        if miss.numel():
            sky_t = 0.5 * (_normalize(d[miss])[:, 1] + 1.0)
            got.append(thr[miss] * ((1.0 - sky_t)[:, None] + blue)
                       * sky_t[:, None])
            got_ids.append(ids[miss])
        rs = torch.nonzero(hit & ~is_tri)[:, 0]
        rt = torch.nonzero(hit & is_tri)[:, 0]
        ps, ns = _sphere_frame(sc, o[rs], d[rs], tau[rs], js[rs], far[rs])
        pt, nt = _triangle_frame(sc, o[rt], d[rt], jt[rt])
        rows = torch.cat([rs, rt])
        p, n = torch.cat([ps, pt]), torch.cat([ns, nt])
        mat = torch.cat([sc.sm[js[rs]], sc.tm[jt[rt]]])
        dr = d[rows]
        front = _dot(dr, n.detach()) < 0.0
        n = torch.where(front[:, None], n, -n)
        nd, att, go = _scatter(sc, mat, dr, p, n, front, key[rows], dtype)
        keep = torch.nonzero(go)[:, 0]
        sel = rows[keep]
        ids, tau = ids[sel], tau[sel]
        o, d, thr = p[keep], nd[keep], thr[sel] * att[keep]
    rad = torch.zeros((pix.shape[0], 3), dtype=dtype, device=dev)
    if got:
        rad = rad.index_add(0, torch.cat(got_ids), torch.cat(got))
    return rad, segments


def render_pixels(sc: Scene, cam: Camera, seed: int, pix: torch.Tensor,
                  spp: int, max_depth: int, t_min: float,
                  chunk: int = 1 << 20):
    """Mean radiance [len(pix), 3] over samples 1..spp of each pixel, and
    the segments traced, without autograd, in chunks of paths."""
    n = pix.shape[0]
    total = torch.zeros((n, 3), dtype=sc.dtype, device=sc.device)
    segments = 0
    per = max(1, chunk // max(n, 1))
    with torch.no_grad():
        for s0 in range(0, spp, per):
            s1 = min(spp, s0 + per)
            smp = torch.arange(s0 + 1, s1 + 1, device=sc.device)
            pp = pix.repeat(s1 - s0)
            ss = smp.repeat_interleave(n)
            rad, seg = trace(sc, cam, seed, pp, ss, max_depth, t_min)
            total += rad.reshape(s1 - s0, n, 3).sum(0)
            segments += seg
    return total / spp, segments


def loss_and_grad(sc: Scene, cam: Camera, seed: int, target: torch.Tensor,
                  spp: int, max_depth: int, t_min: float,
                  chunk: int = 1 << 20):
    """The pixel loss mean((image - target)^2) over every pixel of a
    ``spp``-sample render, and its gradient in the scene's tensors that
    require grad (left in their ``.grad``). Two passes in chunks of paths:
    the image without autograd, keeping each bounce's nearest hits, then
    each chunk's paths again with autograd on those hits, weighted by
    d loss / d pixel. Returns (loss, segments of one pass)."""
    n = cam.width * cam.height
    pix = torch.arange(n, device=sc.device)
    per = max(1, chunk // n)
    chunks = [(s0, min(spp, s0 + per)) for s0 in range(0, spp, per)]

    def paths(s0, s1):
        smp = torch.arange(s0 + 1, s1 + 1, device=sc.device)
        return pix.repeat(s1 - s0), smp.repeat_interleave(n)

    total = torch.zeros((n, 3), dtype=sc.dtype, device=sc.device)
    segments, hits = 0, []
    with torch.no_grad():
        for s0, s1 in chunks:
            hits.append([])
            rad, seg = trace(sc, cam, seed, *paths(s0, s1), max_depth,
                             t_min, hits[-1])
            total += rad.reshape(s1 - s0, n, 3).sum(0)
            segments += seg
    img = total / spp
    tgt = target.reshape(n, 3).to(img.dtype)
    loss = torch.mean((img - tgt) ** 2)
    weight = 2.0 * (img - tgt) / (img.numel() * spp)
    for (s0, s1), won in zip(chunks, hits):
        rad, _ = trace(sc, cam, seed, *paths(s0, s1), max_depth, t_min, won)
        if rad.requires_grad:  # else no path of the chunk meets a leaf
            (rad.reshape(s1 - s0, n, 3) * weight).sum().backward()
    return float(loss), segments
