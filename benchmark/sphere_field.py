"""Writes ``configs/sphere_field_100k.json``, the 100,000-sphere field:

    python3 -m benchmark.sphere_field

The random-sphere recipe of the final render of Ray Tracing in One Weekend
at the port's large-scene scale, drawn as
``rayz_tpu_torch.models.scenes.sphere_field(n=100_000)`` draws it (numpy
``default_rng(0)``, in its order): a checkered ground sphere, then ``n``
small spheres in a slab of half-width sqrt(n), 80% diffuse, 15% metal, 5%
glass, each with a material of its own and each non-glass one a solid
texture of its own. Every number is written as the shortest repr of its
float32 value, so the file reads back to the float32 scene bit for bit.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

N = 100_000
SEED = 0
PATH = Path(__file__).resolve().parent / "configs" / "sphere_field_100k.json"


def _f(x) -> str:
    return str(np.float32(x))


def _vec(v) -> str:
    return "[" + ", ".join(_f(x) for x in v) + "]"


def rows(n: int = N, seed: int = SEED):
    """(texture lines, material lines, sphere lines) of the recipe."""
    rng = np.random.default_rng(seed)
    tex = ['{"kind": "solid", "color": [0.2, 0.3, 0.1]}',
           '{"kind": "solid", "color": [0.9, 0.9, 0.9]}',
           '{"kind": "checker", "scale": 0.32, "even": 0, "odd": 1}']
    mat = ['{"kind": "diffuse", "texture": 2, "method": "hemisphere"}']
    sph = ["[0.0, -1000.0, 0.0, 1000.0, 0, 0, 0, 0]"]
    side = float(np.sqrt(n))
    for _ in range(n):
        c = (rng.uniform(-side, side), rng.uniform(0.1, 0.35),
             rng.uniform(-side, side))
        r = rng.uniform(0.08, 0.22)
        pick = rng.random()
        if pick < 0.8:
            tex.append(f'{{"kind": "solid", "color": '
                       f'{_vec(rng.random(3) * rng.random(3))}}}')
            mat.append(f'{{"kind": "diffuse", "texture": {len(tex) - 1}, '
                       f'"method": "hemisphere"}}')
        elif pick < 0.95:
            tex.append(f'{{"kind": "solid", "color": '
                       f'{_vec(rng.random(3) * 0.5 + 0.5)}}}')
            mat.append(f'{{"kind": "metal", "texture": {len(tex) - 1}, '
                       f'"fuzz": {_f(rng.random() * 0.5)}}}')
        else:
            mat.append('{"kind": "dielectric", "ior": 1.5}')
        sph.append(f"[{_vec(c)[1:-1]}, {_f(r)}, 0, 0, 0, {len(mat) - 1}]")
    return tex, mat, sph


HEAD = {
    "name": "sphere_field_100k",
    "source": "https://raytracing.github.io/books/RayTracingInOneWeekend.html"
              " (Final Render: the random-sphere recipe) at 100,000 spheres,"
              " this project's sphere_field large-scene scale",
    "upstream": {"resolution": [1200, 675], "samples_per_pixel": 500,
                 "max_depth": 50},
    "reduced": ["resolution", "max_depth"],
    "why_reduced": "the port's large-scene setting (sphere_field 100k at "
                   "512x288, depth 8: the wavefront's and streamed "
                   "megakernel's measured shape): 16:9 kept; samples per "
                   "pixel belong to the traffic",
    "departures": "from the book's recipe: no three large spheres; centres "
                  "uniform in a slab, not jittered on a unit grid; radii "
                  "drawn, not 0.2; no motion. From sphere_field: each glass "
                  "sphere has a material of its own where sphere_field "
                  "shares one (the same image)",
    "dtype": "float32",
    "pad_multiple": 128,
    "resolution": [512, 288],
    "max_depth": 8,
    "t_min": 0.001,
    "camera": {"vfov": 24.0, "look_from": [13.0, 3.0, 3.0],
               "look_at": [0.0, 0.2, 0.0], "vup": [0.0, 1.0, 0.0],
               "focus_dist": 10.0, "defocus_angle": 0.0},
    "assumed": {
        "count": "100,000 spheres and the ground: the port's large-scene "
                 "scale (scenes.sphere_field(n=100_000), the top row of "
                 "scripts/bench_culling.py, tune.py's large scene)",
        "slab": "centres x, z uniform in [-sqrt(n), sqrt(n)]: one sphere "
                "a 4 square units whatever n",
        "heights": "centres y uniform in [0.1, 0.35]",
        "radii": "uniform in [0.08, 0.22]",
        "seed": "numpy default_rng(0), sphere_field's recipe drawn in its "
                "order: x, y, z, radius, pick, then the material's draws",
        "ground": "centre (0, -1000, 0), radius 1000, checker 0.32 over "
                  "(0.2, 0.3, 0.1) / (0.9, 0.9, 0.9)",
    },
}


def text(n: int = N, seed: int = SEED) -> str:
    """The configuration file: the header, then one texture, material or
    sphere a line."""
    tex, mat, sph = rows(n, seed)

    def block(key, lines):
        return f' "{key}": [\n  ' + ",\n  ".join(lines) + "\n ]"

    head = [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in HEAD.items()]
    return "{\n" + ",\n".join(head + [
        block("textures", tex), block("materials", mat),
        block("spheres", sph), ' "quads": []']) + "\n}\n"


def main() -> None:
    PATH.write_text(text())


if __name__ == "__main__":
    main()
