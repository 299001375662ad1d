"""The benchmark's Next Week final scene
(benchmark/configs/next_week_final.json) on the CPU: the file is what
``benchmark/next_week_final.py`` writes, the book's recipe (4,800 box
triangles, 1,006 spheres, one of them moving, the cluster of 1,000 inside
its rotated and translated cube); ``render_fast``'s ``"auto"`` picks the
wavefront over streamed tables with the layout the cell runs; and a 16x16
render at depth 40 through the plain versions lies within the cell's
``pixel_gap`` limit of the benchmark's float64 reference."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import rayz_tpu_torch as rtt
from benchmark import next_week_final as nwf
from benchmark import scene as bs
from benchmark.reference.tracer import DIFFUSE_METHODS, MAT_KINDS
from benchmark.traffic import render as bench_render
from rayz_tpu_torch.ops import engine, tables

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
WORKLOAD = BENCH / "workloads" / "next_week_final.render.json"
SEED = 2 ** 31 + 23
SPP = 4


@pytest.fixture(scope="module")
def cfg():
    with open(nwf.PATH) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def small(cfg):
    """The configuration at 16x16, its arrays and the program's scene and
    camera on the CPU."""
    c = dict(cfg, resolution=[16, 16])
    arrays = bs.inputs(c)
    scene, camera = bs.program_scene(arrays, c, "cpu")
    return c, arrays, scene, camera


def test_file_is_the_books_recipe(cfg):
    assert nwf.PATH.read_text() == nwf.text()
    assert cfg["resolution"] == [800, 800] and cfg["max_depth"] == 40
    assert cfg["t_min"] == 0.001 and cfg["reduced"] == []
    a = bs.inputs(cfg)
    assert a["tri_v0"].shape == (4800, 3) and a["sph_c"].shape == (1006, 3)

    # the terrain: 400 boxes of 100 x 100, 1 to 101 high, on the ground
    tri = np.stack([a["tri_v0"], a["tri_v1"], a["tri_v2"]], axis=1)
    assert tri[..., [0, 2]].min() == -1000.0
    assert tri[..., [0, 2]].max() == 1000.0
    assert tri[..., 1].min() == 0.0 and tri[..., 1].max() < 101.0
    tops = tri[:, :, 1].min(axis=1)
    assert 1.0 <= tops[tops > 0].min()

    # one moving sphere, as the book moves it
    moving = np.flatnonzero(np.any(a["sph_v"] != 0.0, axis=1))
    assert moving.tolist() == [0]
    assert a["sph_c"][0].tolist() == [400.0, 400.0, 200.0]
    assert a["sph_v"][0].tolist() == [30.0, 0.0, 0.0]

    # the cluster: 1,000 spheres of radius 10 in the cube [0, 165]^3
    # rotated 15 degrees about y and translated by (-100, 270, 395)
    small_r = np.flatnonzero(a["sph_r"] == 10.0)
    assert small_r.size == 1000
    x, y, z = (a["sph_c"][small_r] - np.asarray(nwf.OFFSET)).T
    c, s = math.cos(math.radians(15.0)), math.sin(math.radians(15.0))
    local = np.stack([c * x - s * z, y, s * x + c * z], axis=1)
    assert local.min() > -1e-3 and local.max() < 165.0 + 1e-3

    # every diffuse the book's own Lambertian; glass, metal as given
    kinds = a["mat_kind"][a["sph_m"]]
    assert (kinds == MAT_KINDS["dielectric"]).sum() == 2
    assert (kinds == MAT_KINDS["metal"]).sum() == 1
    dif = a["mat_kind"] == MAT_KINDS["diffuse"]
    assert (a["mat_method"][dif] == DIFFUSE_METHODS[
        "unit_sphere_surface"]).all()


def test_auto_picks_the_wavefront_over_streamed_tables(small):
    _, _, scene, _ = small
    assert engine.pick_engine(scene, "auto") == "wavefront"
    assert scene.has_motion
    layout = tables.resolve(scene, "wavefront")
    assert layout.mode == tables.STREAMED and layout.cull
    assert (layout.stream, layout.sc_group) == (512, 5)
    assert (layout.n_pad, layout.m_pad) == (1024, 5120)


def test_render_within_the_cells_limit_of_the_reference(small):
    c, arrays, scene, camera = small
    with open(WORKLOAD) as fh:
        limit = json.load(fh)["limits"]["pixel_gap"]
    config = rtt.RenderConfig(spp=SPP, max_depth=c["max_depth"],
                              t_min=c["t_min"])
    img = rtt.render_fast(scene, camera, SEED, config, engine="auto")
    flat = img.reshape(-1, 3)
    n_px = camera.width * camera.height
    # the harness's reading of this render, with every pixel checked
    gaps, _ = bench_render.pixel_gaps(c, arrays, SPP,
                                      [(SEED, lambda pix: flat[pix])], 0,
                                      n_px, "cpu")
    assert gaps[0] <= limit, gaps
