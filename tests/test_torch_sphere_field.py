"""The benchmark's 100,000-sphere field
(benchmark/configs/sphere_field_100k.json) at its full count on the CPU:
the file holds the recipe that ``scenes.sphere_field(n=100_000)`` draws; at
a CPU size ``render_fast``'s ``"auto"`` picks the wavefront over streamed
tables; and that render, through the plain versions, lies within the
cell's ``pixel_gap`` limit of the benchmark's float64 reference with every
pixel of the image checked."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import rayz_tpu_torch as rtt
from benchmark import scene as bs
from benchmark.traffic import render as bench_render
from rayz_tpu_torch.models import scene as sm
from rayz_tpu_torch.ops import engine, tables

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = BENCH / "configs" / "sphere_field_100k.json"
WORKLOAD = BENCH / "workloads" / "sphere_field_100k.render.json"
N = 100_000
SEED = 2 ** 31 + 17
SPP = 2


@pytest.fixture(scope="module")
def cfg():
    with open(CONFIG) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def small(cfg):
    """The configuration at 16x9 (its 16:9 kept), its arrays and the
    program's scene and camera on the CPU."""
    c = dict(cfg, resolution=[16, 9])
    arrays = bs.inputs(c)
    scene, camera = bs.program_scene(arrays, c, "cpu")
    return c, arrays, scene, camera


def test_file_is_the_sphere_field_recipe(cfg):
    a = bs.inputs(cfg)
    want, cam = rtt.scenes.sphere_field(n=N, width=512, device="cpu")
    assert a["sph_c"].shape == (N + 1, 3) and cfg["resolution"] == [512, 288]
    assert (cam.width, cam.height) == (512, 288)
    assert want.n_spheres == N + 1  # its tables padded beyond
    real = slice(0, N + 1)
    np.testing.assert_array_equal(a["sph_c"],
                                  want.sphere_center[real].numpy())
    np.testing.assert_array_equal(a["sph_r"],
                                  want.sphere_radius[real].numpy())
    assert not a["sph_v"].any() and not want.has_motion

    # each sphere's material kind, albedo, fuzz and IOR as drawn
    kinds = {sm.MAT_DIFFUSE: 0, sm.MAT_METALLIC: 1, sm.MAT_DIELECTRIC: 2}
    wm = want.sphere_material[real].long()
    wkind = np.asarray([kinds[int(k)] for k in want.mat_kind[wm]])
    m = a["sph_m"]
    np.testing.assert_array_equal(a["mat_kind"][m], wkind)
    solid = wkind[1:] != 2
    got_col = a["tex_color"][a["mat_tex"][m]][1:][solid]
    want_col = want.tex_color[want.mat_texture[wm].long()].numpy()[1:][solid]
    np.testing.assert_array_equal(got_col, want_col)
    np.testing.assert_array_equal(a["mat_fuzz"][m],
                                  want.mat_fuzz[wm].numpy())
    np.testing.assert_array_equal(a["mat_ior"][m][wkind == 2], 1.5)

    # every sphere its own material, every non-glass one its own texture
    assert len(set(m.tolist())) == N + 1
    assert len(set(a["mat_tex"][m[1:][solid]].tolist())) == int(solid.sum())

    # the ground, then the slab, heights, radii and the 80/15/5 mix
    assert a["sph_c"][0].tolist() == [0.0, -1000.0, 0.0]
    assert a["sph_r"][0] == 1000.0 and a["tex_kind"][a["mat_tex"][m[0]]] == 1
    c, r = a["sph_c"][1:], a["sph_r"][1:]
    side = np.sqrt(N)
    assert np.abs(c[:, [0, 2]]).max() <= side
    assert 0.1 <= c[:, 1].min() and c[:, 1].max() <= 0.35
    assert 0.08 <= r.min() and r.max() <= 0.22
    share = np.bincount(wkind[1:], minlength=3) / N
    np.testing.assert_allclose(share, [0.80, 0.15, 0.05], atol=0.005)


def test_auto_picks_the_wavefront_over_streamed_tables(small):
    _, _, scene, camera = small
    assert scene.n_spheres == N + 1
    assert engine.pick_engine(scene, "auto") == "wavefront"
    layout = tables.resolve(scene, "wavefront")
    assert layout.mode == tables.STREAMED and layout.stream and layout.cull
    tabs, _ = tables.layout_tables(scene, layout, camera.look_from,
                                   memo=False)
    assert isinstance(tabs, tables.StreamTables)
    assert tabs.stream == layout.stream


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
