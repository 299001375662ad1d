"""Canonical scene builders covering the BASELINE.json benchmark configs.

PyTorch counterpart of :mod:`rayz_tpu.models.scenes`. Every constructor
draws from ``np.random.default_rng(seed)`` in the same order as its JAX
twin, so each tensor equals the JAX array exactly. Scenes and cameras are
built on the card unless ``device="cpu"`` is given (see
:func:`rayz_tpu_torch.models.scene.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import make_camera
from .scene import DIFFUSE_UNIT_SPHERE, SceneBuilder

__all__ = [
    "two_sphere",
    "three_sphere",
    "random_bouncing",
    "cornell_box",
    "sphere_grid",
    "sphere_field",
    "SCENES",
]


def two_sphere(width: int = 256, height: int | None = None,
               dtype=torch.float32, device="cuda"):
    """BASELINE config 1: Lambertian sphere + ground sphere, gradient sky.
    Default height: square."""
    if height is None:
        height = width
    b = SceneBuilder()
    ground = b.add_diffuse(color=(0.8, 0.8, 0.0))
    center = b.add_diffuse(color=(0.1, 0.2, 0.5))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, center)
    cam = make_camera(
        width=width, height=height, vfov=90.0, focus_dist=1.0,
        defocus_angle=0.0, look_from=(0, 0, 0), look_at=(0, 0, -1),
        dtype=dtype, device=device,
    )
    return b.build(dtype=dtype, device=device), cam


def three_sphere(width: int = 512, height: int | None = None,
                 dtype=torch.float32, device="cuda"):
    """BASELINE config 2: Lambertian/metal/dielectric trio on a ground
    sphere."""
    b = SceneBuilder()
    ground = b.add_diffuse(color=(0.8, 0.8, 0.0))
    lamb = b.add_diffuse(color=(0.1, 0.2, 0.5))
    glass = b.add_dielectric(1.5)
    bubble = b.add_dielectric(1.0 / 1.5)
    metal = b.add_metallic(color=(0.8, 0.6, 0.2), fuzz=1.0)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, lamb)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, glass)
    b.add_sphere((-1.0, 0.0, -1.0), 0.4, bubble)
    b.add_sphere((1.0, 0.0, -1.0), 0.5, metal)
    cam = make_camera(
        width=width, height=height, vfov=20.0, focus_dist=3.4,
        defocus_angle=10.0, look_from=(-2, 2, 1), look_at=(0, 0, -1),
        dtype=dtype, device=device,
    )
    return b.build(dtype=dtype, device=device), cam


def random_bouncing(width: int = 512, height: int | None = None,
                    seed: int = 0, dtype=torch.float32, device="cuda"):
    """BASELINE config 3 / the reference's final scene: ~500 random spheres
    with motion blur, checkered ground, three heroes."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    # ground: checkered diffuse, scale 0.32
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.32, even, odd)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.add_diffuse(texture=checker))

    # hero spheres
    b.add_sphere((0.0, 1.0, 0.0), 1.0, b.add_dielectric(1.5))
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, b.add_diffuse(color=(0.4, 0.2, 0.1)))
    b.add_sphere((4.0, 1.0, 0.0), 1.0, b.add_metallic(color=(0.7, 0.6, 0.5)))

    # 22x22 random grid
    for a in range(-11, 11):
        for bb in range(-11, 11):
            rand_mat = rng.random()
            center = np.array([
                a + 0.9 * rng.random(),
                0.2,
                bb + 0.9 * rng.random(),
            ])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            velocity = None
            if rand_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                m = b.add_diffuse(color=tuple(albedo))
                # vertical motion, dir = (0, U[0,0.5], 0)
                velocity = (0.0, rng.random() * 0.5, 0.0)
            elif rand_mat < 0.95:
                m = b.add_metallic(
                    color=tuple(rng.random(3) * 0.5 + 0.5),
                    fuzz=rng.random() * 0.5,
                )
            else:
                m = b.add_dielectric(1.5)
            b.add_sphere(tuple(center), 0.2, m, velocity=velocity)

    cam = make_camera(
        width=width, height=height, vfov=20.0, focus_dist=10.0,
        defocus_angle=0.6, look_from=(13, 2, 3), look_at=(0, 0, 0),
        dtype=dtype, device=device,
    )
    return b.build(dtype=dtype, pad_multiple=128, device=device), cam


def cornell_box(width: int = 512, height: int | None = None,
                tessellation: int = 12, dtype=torch.float32, device="cuda"):
    """BASELINE config 4: triangle-mesh Cornell box (~1.5k triangles), lit by
    the sky gradient through the open front. Default height: square."""
    if height is None:
        height = width
    b = SceneBuilder()
    white = b.add_diffuse(color=(0.73, 0.73, 0.73))
    red = b.add_diffuse(color=(0.65, 0.05, 0.05))
    green = b.add_diffuse(color=(0.12, 0.45, 0.15))
    metal = b.add_metallic(color=(0.8, 0.85, 0.88), fuzz=0.05)

    def tess_quad(corner, eu, ev, mat, n):
        corner = np.asarray(corner, dtype=np.float64)
        eu = np.asarray(eu, dtype=np.float64) / n
        ev = np.asarray(ev, dtype=np.float64) / n
        for i in range(n):
            for j in range(n):
                b.add_quad(corner + i * eu + j * ev, eu, ev, mat)

    s = 555.0
    n = tessellation
    tess_quad((0, 0, 0), (s, 0, 0), (0, 0, s), white, n)  # floor
    tess_quad((0, s, 0), (s, 0, 0), (0, 0, s), white, n)  # ceiling
    tess_quad((0, 0, s), (s, 0, 0), (0, s, 0), white, n)  # back wall
    tess_quad((0, 0, 0), (0, s, 0), (0, 0, s), red, n)  # left wall
    tess_quad((s, 0, 0), (0, s, 0), (0, 0, s), green, n)  # right wall

    def box(lo, hi, mat, n=2):
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        dx = np.array([hi[0] - lo[0], 0, 0])
        dy = np.array([0, hi[1] - lo[1], 0])
        dz = np.array([0, 0, hi[2] - lo[2]])
        tess_quad(lo, dx, dz, mat, n)
        tess_quad(lo + dy, dx, dz, mat, n)
        tess_quad(lo, dx, dy, mat, n)
        tess_quad(lo + dz, dx, dy, mat, n)
        tess_quad(lo, dy, dz, mat, n)
        tess_quad(lo + dx, dy, dz, mat, n)

    box((130, 0, 65), (295, 165, 230), white)
    box((265, 0, 295), (430, 330, 460), metal)

    cam = make_camera(
        width=width, height=height, vfov=40.0, focus_dist=10.0,
        defocus_angle=0.0, look_from=(278, 278, -800), look_at=(278, 278, 0),
        dtype=dtype, device=device,
    )
    return b.build(dtype=dtype, pad_multiple=128, device=device), cam


def sphere_grid(n: int = 100, width: int = 64, height: int | None = None,
                seed: int = 0, dtype=torch.float32, device="cuda"):
    """BASELINE config 5 scene: ``n`` diffuse spheres on a square grid, one
    independent albedo each, viewed from above. Diffuse scatter uses
    UNIT_SPHERE, which is smooth in the normal (the inverse-rendering
    target needs that)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    b = SceneBuilder()
    for i in range(n):
        gx, gz = float(i % side), float(i // side)
        albedo = 0.1 + 0.8 * rng.random(3)
        b.add_sphere((gx, 0.0, gz), 0.42,
                     b.add_diffuse(color=tuple(albedo),
                                   method=DIFFUSE_UNIT_SPHERE))
    c = (side - 1) / 2.0
    dist = 1.25 * side
    cam = make_camera(
        width=width, height=height if height is not None else width,
        vfov=2.0 * np.degrees(np.arctan((side / 2.0 + 0.7) / dist)),
        focus_dist=dist, defocus_angle=0.0,
        look_from=(c, dist, c), look_at=(c, 0.0, c), vup=(0.0, 0.0, 1.0),
        dtype=dtype, device=device,
    )
    return b.build(dtype=dtype, device=device), cam


def sphere_field(n: int = 10000, width: int = 512, height: int | None = None,
                 seed: int = 0, dtype=torch.float32, device="cuda"):
    """Large-scene stress config: ``n`` random small spheres in a slab plus
    a checkered ground. Material mix mirrors random_bouncing."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.32, even, odd)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.add_diffuse(texture=checker))
    side = float(np.sqrt(n))  # keep density constant as n grows
    for _ in range(n):
        center = (rng.uniform(-side, side), rng.uniform(0.1, 0.35),
                  rng.uniform(-side, side))
        r = rng.uniform(0.08, 0.22)
        pick = rng.random()
        if pick < 0.8:
            m = b.add_diffuse(color=tuple(rng.random(3) * rng.random(3)))
        elif pick < 0.95:
            m = b.add_metallic(color=tuple(rng.random(3) * 0.5 + 0.5),
                               fuzz=rng.random() * 0.5)
        else:
            m = b.add_dielectric(1.5)
        b.add_sphere(center, r, m)
    cam = make_camera(
        width=width, height=height, vfov=24.0, focus_dist=10.0,
        defocus_angle=0.0, look_from=(13, 3, 3), look_at=(0, 0.2, 0),
        dtype=dtype, device=device,
    )
    return b.build(dtype=dtype, pad_multiple=128, device=device), cam


SCENES = {
    "two_sphere": two_sphere,
    "three_sphere": three_sphere,
    "random_bouncing": random_bouncing,
    "cornell_box": cornell_box,
    "sphere_grid": sphere_grid,
    "sphere_field": sphere_field,
}
