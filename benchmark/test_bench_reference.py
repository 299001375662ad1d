"""The reference's ray-sphere and ray-triangle tests on hand-worked
cases."""

import math

import numpy as np
import torch

from benchmark.reference import rng, tracer


def _scene(spheres=(), triangles=()):
    """A scene of the given spheres (cx, cy, cz, r, vx, vy, vz) and
    triangles (v0, v1, v2), one diffuse material."""
    s = np.asarray(spheres, np.float64).reshape(-1, 7)
    t = np.asarray(triangles, np.float64).reshape(-1, 3, 3)
    return tracer.Scene({
        "sph_c": s[:, 0:3], "sph_r": s[:, 3], "sph_v": s[:, 4:7],
        "sph_m": np.zeros(len(s), np.int64),
        "tri_v0": t[:, 0], "tri_v1": t[:, 1], "tri_v2": t[:, 2],
        "tri_m": np.zeros(len(t), np.int64),
        "mat_kind": [0], "mat_tex": [0], "mat_method": [2],
        "mat_fuzz": [0.0], "mat_ior": [1.0], "tex_kind": [0],
        "tex_color": [[0.5, 0.5, 0.5]], "tex_scale": [1.0], "tex_even": [0],
        "tex_odd": [0]}, torch.float64, "cpu")


def _ray(o, d):
    return (torch.tensor([o], dtype=torch.float64),
            torch.tensor([d], dtype=torch.float64))


def test_sphere_hit_near_root_and_normal():
    # centre (0, 0, -5), r 1; o = 0, d = (0, 0, -2): |d|^2 = 4, b = 10,
    # |o - c|^2 - r^2 = 24, disc = 100 - 96 = 4, t = (10 - 2) / 4 = 2
    sc = _scene(spheres=[(0, 0, -5, 1, 0, 0, 0)])
    o, d = _ray((0, 0, 0), (0, 0, -2))
    tau = torch.zeros(1, dtype=torch.float64)
    a = (d * d).sum(-1)
    t, j, far = tracer._sphere_sweep(sc, o, d, tau, a, 1 / a, 1e-3)
    assert float(t) == 2.0 and int(j) == 0 and not bool(far)
    p, n = tracer._sphere_frame(sc, o, d, tau, j, far)
    assert torch.equal(p, torch.tensor([[0.0, 0.0, -4.0]], dtype=p.dtype))
    assert torch.equal(n, torch.tensor([[0.0, 0.0, 1.0]], dtype=n.dtype))


def test_sphere_inside_takes_far_root_and_moves():
    # from the centre of a sphere of r 2 moving by (0, 0, 1) a unit time,
    # at tau 0.5 its centre is (0, 0, 0.5): d = (0, 0, 1) leaves at z 2.5
    sc = _scene(spheres=[(0, 0, 0, 2, 0, 0, 1)])
    o, d = _ray((0, 0, 0), (0, 0, 1))
    tau = torch.tensor([0.5], dtype=torch.float64)
    a = (d * d).sum(-1)
    t, j, far = tracer._sphere_sweep(sc, o, d, tau, a, 1 / a, 1e-3)
    assert math.isclose(float(t), 2.5) and bool(far)


def test_sphere_miss_and_t_min():
    sc = _scene(spheres=[(0, 0, -5, 1, 0, 0, 0)])
    o, d = _ray((0, 3, 0), (0, 0, -1))
    tau = torch.zeros(1, dtype=torch.float64)
    a = (d * d).sum(-1)
    t, _, _ = tracer._sphere_sweep(sc, o, d, tau, a, 1 / a, 1e-3)
    assert math.isinf(float(t))
    o, d = _ray((0, 0, -4), (0, 0, 1))  # on the surface, leaving it
    t, _, _ = tracer._sphere_sweep(sc, o, d, tau, a, 1 / a, 1e-3)
    assert math.isinf(float(t))


def test_triangle_hit_and_edges():
    # the triangle (-1,-1,-3), (1,-1,-3), (-1,1,-3); d = (-0.2, -0.2, -1)
    # reaches z = -3 at t 3, at (-0.6, -0.6): u = 0.2, v = 0.2, inside
    sc = _scene(triangles=[((-1, -1, -3), (1, -1, -3), (-1, 1, -3))])
    o, d = _ray((0, 0, 0), (-0.2, -0.2, -1))
    t, j = tracer._triangle_sweep(sc, o, d, 1e-3)
    assert math.isclose(float(t), 3.0)
    p, n = tracer._triangle_frame(sc, o, d, j)
    assert torch.allclose(p, torch.tensor([[-0.6, -0.6, -3.0]],
                                          dtype=torch.float64))
    assert torch.equal(n, torch.tensor([[0.0, 0.0, 1.0]], dtype=n.dtype))
    o, d = _ray((0, 0, 0), (0.2, 0.2, -1))  # u + v = 1.2 > 1: outside
    t, _ = tracer._triangle_sweep(sc, o, d, 1e-3)
    assert math.isinf(float(t))


def test_rng_is_the_stated_mixer():
    # hash32(0) = 0 and one hand-worked value of the mixer
    x = torch.tensor([0, 1], dtype=torch.int64)
    h = rng.hash32(x)
    assert int(h[0]) == 0
    v = 1 ^ (1 >> 16)
    v = (v * 0x21F0AAAD) & 0xFFFFFFFF
    v ^= v >> 15
    v = (v * 0x735A2D97) & 0xFFFFFFFF
    v ^= v >> 15
    assert int(h[1]) == v
    u = rng.uniform(torch.tensor([7]), 3, torch.float64)
    assert 0.0 <= float(u) < 1.0
