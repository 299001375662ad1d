"""Writes ``configs/next_week_final.json``, the final scene of Ray Tracing:
The Next Week (``final_scene(800, 10000, 40)``):

    python3 -m benchmark.next_week_final

The book's recipe, drawn with numpy ``default_rng(0)`` in its order (the
400 box heights, i outer and j inner, then the 1,000 cluster centres, x,
y, z each): a terrain of 20 x 20 ground boxes, each the book's ``box()`` of
six quads (two triangles each); a cluster of 1,000 white spheres of
radius 10, rotated 15 degrees about y and translated, baked to world
space; a moving sphere, glass, a fuzzy metal, the boundary sphere, the
earth and the Perlin sphere. What the port cannot render (the light, the
two media, the image and noise textures) is written down under
``departures``. Every number is written as the shortest repr of its
float32 value, so the file reads back to the float32 scene bit for bit.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from .sphere_field import _f, _vec

SEED = 0
BOXES_PER_SIDE = 20
CLUSTER = 1000
PATH = Path(__file__).resolve().parent / "configs" / "next_week_final.json"

GROUND = (0.48, 0.83, 0.53)
WHITE = (0.73, 0.73, 0.73)
EARTH = (0.25, 0.35, 0.55)
PERLIN = (0.5, 0.5, 0.5)
ANGLE = math.radians(15.0)
OFFSET = (-100.0, 270.0, 395.0)


def box_quads(lo, hi):
    """The book's ``box(a, b)``: six (corner, u, v) quads, front, right,
    back, left, top, bottom."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    dx, dy, dz = (x1 - x0, 0.0, 0.0), (0.0, y1 - y0, 0.0), (0.0, 0.0, z1 - z0)
    mdx, mdz = (x0 - x1, 0.0, 0.0), (0.0, 0.0, z0 - z1)
    return [((x0, y0, z1), dx, dy), ((x1, y0, z1), mdz, dy),
            ((x1, y0, z0), mdx, dy), ((x0, y0, z0), dz, dy),
            ((x0, y1, z1), dx, mdz), ((x0, y0, z0), dx, dz)]


def cluster_world(p):
    """Cluster centres (object space, [n, 3]) after ``rotate_y(15)`` and
    ``translate(-100, 270, 395)``."""
    c, s = math.cos(ANGLE), math.sin(ANGLE)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return np.stack([c * x + s * z + OFFSET[0], y + OFFSET[1],
                     -s * x + c * z + OFFSET[2]], axis=1)


def draws(seed: int = SEED):
    """(box heights [20, 20], cluster centres in object space [1000, 3])."""
    rng = np.random.default_rng(seed)
    heights = rng.uniform(1.0, 101.0, size=(BOXES_PER_SIDE, BOXES_PER_SIDE))
    cluster = rng.uniform(0.0, 165.0, size=(CLUSTER, 3))
    return heights, cluster


def rows(seed: int = SEED):
    """(texture lines, material lines, sphere lines, quad lines)."""
    heights, cluster = draws(seed)
    tex = [f'{{"kind": "solid", "color": {_vec(c)}}}'
           for c in (GROUND, WHITE, (0.7, 0.3, 0.1), (0.8, 0.8, 0.9),
                     EARTH, PERLIN)]
    diffuse = '{{"kind": "diffuse", "texture": {}, ' \
              '"method": "unit_sphere_surface"}}'
    mat = [diffuse.format(0), diffuse.format(1), diffuse.format(2),
           '{"kind": "dielectric", "ior": 1.5}',
           '{"kind": "metal", "texture": 3, "fuzz": 1.0}',
           '{"kind": "dielectric", "ior": 1.5}',
           diffuse.format(4), diffuse.format(5)]
    quads = []
    for i in range(BOXES_PER_SIDE):
        for j in range(BOXES_PER_SIDE):
            lo = (-1000.0 + 100.0 * i, 0.0, -1000.0 + 100.0 * j)
            hi = (lo[0] + 100.0, heights[i, j], lo[2] + 100.0)
            quads += [f'{{"corner": {_vec(c)}, "u": {_vec(u)}, "v": '
                      f'{_vec(v)}, "material": 0, "tessellation": 1}}'
                      for c, u, v in box_quads(lo, hi)]

    def sphere(c, r, m, v=(0.0, 0.0, 0.0)):
        return f"[{_vec(c)[1:-1]}, {_f(r)}, {_vec(v)[1:-1]}, {m}]"

    sph = [sphere((400.0, 400.0, 200.0), 50.0, 2, (30.0, 0.0, 0.0)),
           sphere((260.0, 150.0, 45.0), 50.0, 3),
           sphere((0.0, 150.0, 145.0), 50.0, 4),
           sphere((360.0, 150.0, 145.0), 70.0, 5),
           sphere((400.0, 200.0, 400.0), 100.0, 6),
           sphere((220.0, 280.0, 300.0), 80.0, 7)]
    sph += [sphere(c, 10.0, 1) for c in cluster_world(cluster)]
    return tex, mat, sph, quads


HEAD = {
    "name": "next_week_final",
    "source": "https://raytracing.github.io/books/RayTracingTheNextWeek.html"
              " (A Scene Testing All New Features: final_scene(800, 10000,"
              " 40))",
    "upstream": {"resolution": [800, 800], "samples_per_pixel": 10000,
                 "max_depth": 40},
    "reduced": [],
    "why_reduced": "nothing cut: the book's 800x800 at depth 40; samples "
                   "per pixel belong to the traffic",
    "departures": "the port has no emitter: the light quad goes and the sky "
                  "lights the scene, as in the Cornell box; the two "
                  "constant media go (the boundary sphere stays as glass); "
                  "the image and noise textures become solids; the "
                  "cluster's rotate_y and translate are baked into its "
                  "centres; every quad is two triangles",
    "dtype": "float32",
    "pad_multiple": 128,
    "resolution": [800, 800],
    "max_depth": 40,
    "t_min": 0.001,
    "camera": {"vfov": 40.0, "look_from": [478.0, 278.0, -600.0],
               "look_at": [278.0, 278.0, 0.0], "vup": [0.0, 1.0, 0.0],
               "focus_dist": 10.0, "defocus_angle": 0.0},
    "assumed": {
        "seed": "numpy default_rng(0) for the book's random_double, drawn "
                "in its order: the 400 box heights uniform in [1, 101), "
                "i outer, then the 1,000 cluster centres uniform in "
                "[0, 165), x, y, z each",
        "earth": "the earth map's image texture as a solid "
                 f"{list(EARTH)}",
        "perlin": "the noise texture (scale 0.2) as its mean, a solid 0.5",
        "diffuse": "every Lambertian the book's own: the normal plus a "
                   "random unit vector (unit_sphere_surface)",
        "focus_dist": "10, the book camera's default (defocus 0: it "
                      "scales the ray directions only)",
    },
    "sphere_fields": ["cx", "cy", "cz", "radius", "vx", "vy", "vz",
                      "material"],
}


def text(seed: int = SEED) -> str:
    """The configuration file: the header, then one texture, material,
    sphere or quad a line."""
    tex, mat, sph, quads = rows(seed)

    def block(key, lines):
        return f' "{key}": [\n  ' + ",\n  ".join(lines) + "\n ]"

    head = [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in HEAD.items()]
    return "{\n" + ",\n".join(head + [
        block("textures", tex), block("materials", mat),
        block("spheres", sph), block("quads", quads)]) + "\n}\n"


def main() -> None:
    PATH.write_text(text())


if __name__ == "__main__":
    main()
