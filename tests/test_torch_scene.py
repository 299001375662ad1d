"""The port's data model against the JAX package: scene constructors,
camera, kernel tables, the numpy round trip, image bytes, and that the port
imports without JAX. Everything here must match exactly (atol 0): both
packages build from the same float64 numpy values and the same op order."""

import dataclasses
import functools
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayz_tpu as rt
import rayz_tpu_torch as rtt
from rayz_tpu.io import image as jimage
from rayz_tpu.ops import megakernel as jmk
from rayz_tpu_torch.io import image as timage
from rayz_tpu_torch.ops import tables

torch.set_num_threads(2)

STATICS = ("n_spheres", "n_triangles", "has_motion", "deep_checker",
           "tex_depth", "uniq_checker_tex", "uniq_dielectric_mat")

# (constructor, kwargs): small sizes keep the JAX side quick.
CASES = [
    ("two_sphere", dict(width=16)),
    ("three_sphere", dict(width=16)),
    ("random_bouncing", dict(width=16, seed=3)),
    ("cornell_box", dict(width=16, tessellation=3)),
    ("sphere_grid", dict(n=12, width=16, seed=1)),
    ("sphere_field", dict(n=40, width=16, seed=2)),
]


def _jax_pair(name, kw):
    return rt.scenes.SCENES[name](dtype=jnp.float32, **kw)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in STATICS
            and f.name not in ("height", "width")}


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_scene_constructors_match_jax(name, kw):
    jscene, jcam = _jax_pair(name, kw)
    tscene, tcam = rtt.scenes.SCENES[name](device="cpu", **kw)
    for k, v in _leaves(jscene).items():
        t = getattr(tscene, k).numpy()
        assert t.dtype == v.dtype, k
        np.testing.assert_array_equal(t, v, err_msg=k)
    for k in STATICS:
        assert getattr(tscene, k) == getattr(jscene, k), k
    for k, v in _leaves(jcam).items():
        np.testing.assert_array_equal(getattr(tcam, k).numpy(), v, err_msg=k)
    assert (tcam.height, tcam.width) == (jcam.height, jcam.width)

    np.testing.assert_array_equal(
        tables._camera_vector(tcam).numpy(),
        np.asarray(jmk._camera_vector(jcam)))
    if jscene.n_spheres:
        np.testing.assert_array_equal(tables.scene_tables(tscene).numpy(),
                                      np.asarray(jmk.scene_tables(jscene)))
    if jscene.n_triangles:
        np.testing.assert_array_equal(tables.tri_tables(tscene).numpy(),
                                      np.asarray(jmk.tri_tables(jscene)))
    assert tables.supports_scene(tscene) == jmk.supports_scene(jscene)


def test_scene_and_camera_from_numpy_round_trip():
    jscene, jcam = _jax_pair("random_bouncing", dict(width=16, seed=5))
    statics = {k: getattr(jscene, k) for k in STATICS}
    tscene = rtt.scene_from_numpy(_leaves(jscene), **statics)
    for k, v in _leaves(jscene).items():
        np.testing.assert_array_equal(getattr(tscene, k).numpy(), v)
    np.testing.assert_array_equal(tables.scene_tables(tscene).numpy(),
                                  np.asarray(jmk.scene_tables(jscene)))
    tcam = rtt.camera_from_numpy(_leaves(jcam), height=jcam.height,
                                 width=jcam.width)
    np.testing.assert_array_equal(tables._camera_vector(tcam).numpy(),
                                  np.asarray(jmk._camera_vector(jcam)))
    assert tscene.to("cpu").n_spheres == jscene.n_spheres


def test_padded_tables_and_shared_memory_rule():
    """Tables pad to the sweep unroll with poisoned columns, and the H100
    residency rule admits the flagship (34.8 KB) and the Cornell box
    (122.9 KB) but not a scene past 227 KB."""
    scene, _ = rtt.scenes.random_bouncing(width=16, device="cpu")
    stab, ttab, n_pad, m_pad = tables._smem_scene_inputs(scene, 8)[:4]
    assert (n_pad, m_pad) == (512, 0) and ttab.shape == (20, 0)
    resident = functools.partial(tables._launch_bytes, "megakernel")
    assert resident(n_pad, m_pad) - 4 * tables.CAM_WORDS == 34_816
    assert tables.resolve(scene, "megakernel").smem == resident(n_pad, m_pad)
    assert tables.fits_shared(scene)
    box, _ = rtt.scenes.cornell_box(width=16, device="cpu")
    assert resident(0, 1536) - 4 * tables.CAM_WORDS == 122_880
    assert tables.fits_shared(box)
    big, _ = rtt.scenes.sphere_field(n=14_000, width=16, device="cpu")
    assert not tables.fits_shared(big)
    # the boundary: 4 * (20 + 17 * n_pad + 20 * m_pad) <= 232,448 bytes
    limit = tables.SHARED_LIMIT
    assert resident(3416, 0) <= limit < resident(3424, 0)
    assert resident(0, 2904) <= limit < resident(0, 2912)
    for n, fits in ((3416, True), (3417, False)):
        b = rtt.SceneBuilder()
        m = b.add_diffuse(color=(0.5, 0.5, 0.5))
        for i in range(n):
            b.add_sphere((float(i), 0.0, 0.0), 0.1, m)
        assert tables.fits_shared(b.build(device="cpu")) == fits, n

    b = rtt.SceneBuilder()
    b.add_sphere((0, 0, -1), 0.5, b.add_diffuse(color=(0.5, 0.5, 0.5)))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), 0)
    small = b.build(pad_multiple=4, device="cpu")
    stab, ttab, n_pad, m_pad = tables._smem_scene_inputs(small, 8)[:4]
    assert (n_pad, m_pad) == (8, 8)
    assert (stab[tables._CCMR2, 4:] == tables._BIG).all()
    assert (ttab[tables._TG1V, 4:] == tables._BIG).all()


def test_constructors_default_to_the_card(monkeypatch):
    """Scenes and cameras are built on the card unless the caller asks for
    the CPU; with no card the default raises and names device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rtt.scenes.two_sphere(width=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rtt.make_camera(width=8)
    b = rtt.SceneBuilder()
    b.add_sphere((0, 0, -1), 0.5, b.add_diffuse(color=(0.5, 0.5, 0.5)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        b.build()
    scene, cam = rtt.scenes.two_sphere(width=8, device="cpu")
    assert scene.device.type == cam.device.type == "cpu"
    assert b.build(device="cpu").device.type == "cpu"


def _ppm_png(mod, img):
    ppm, png = io.BytesIO(), io.BytesIO()
    mod.write_ppm(img, ppm)
    mod.write_png(img, png)
    return ppm.getvalue(), png.getvalue()


def test_image_bytes_match_jax_writers():
    img = np.random.default_rng(0).uniform(-0.1, 1.3, (5, 7, 3))
    jbytes = _ppm_png(jimage, img.astype(np.float32))
    assert _ppm_png(timage, torch.from_numpy(img.astype(np.float32))) == jbytes
    assert _ppm_png(timage, img.astype(np.float32)) == jbytes
    np.testing.assert_array_equal(timage.read_ppm(io.BytesIO(jbytes[0])),
                                  jimage.read_ppm(io.BytesIO(jbytes[0])))


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import rayz_tpu_torch, rayz_tpu_torch.cli, rayz_tpu_torch.tune; "
            "import rayz_tpu_torch.bench, rayz_tpu_torch.scripts.gpu_check, "
            "rayz_tpu_torch.scripts.bench_configs, "
            "rayz_tpu_torch.scripts.bench_culling; "
            "assert 'rayz_tpu' not in sys.modules; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
