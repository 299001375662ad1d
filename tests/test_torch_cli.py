"""The port's CLI (python -m rayz_tpu_torch): reference argument shape,
output formats, the perf line, and that --device cuda fails without a GPU
instead of carrying on on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from rayz_tpu_torch.cli import main
from rayz_tpu_torch.io.image import read_ppm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_module_entry_writes_png_and_perf_line(tmp_path):
    out = tmp_path / "out.png"
    proc = subprocess.run(
        [sys.executable, "-m", "rayz_tpu_torch", "32", str(out), "--scene",
         "two_sphere", "--spp", "2", "--depth", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "Finished render (" in proc.stderr
    assert " rps and " in proc.stderr and " us per ray" in proc.stderr


def test_ppm_output(tmp_path, capfd):
    out = tmp_path / "img.ppm"
    assert main(["24", str(out), "--scene", "two_sphere", "--spp", "2",
                 "--depth", "3", "--seed", "4", "--device", "cpu"]) == 0
    img = read_ppm(str(out))
    assert img.shape == (24, 24, 3) and img.max() > 0
    assert "Finished render" in capfd.readouterr().err


def test_cuda_device_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["16", str(tmp_path / "x.png"), "--scene", "two_sphere",
              "--device", "cuda"])
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("engine", ["xla"])
def test_unported_engines_raise(engine, tmp_path):
    """``--engine xla`` raised until the dense integrator was ported; now
    it renders through it, and ``--chunk`` (its chunk size) changes no
    bit of the image."""
    outs = []
    for chunk in ([], ["--chunk", "100"]):
        out = tmp_path / f"x{len(chunk)}.ppm"
        assert main(["16", str(out), "--scene", "two_sphere", "--spp", "2",
                     "--depth", "3", "--engine", engine, "--device", "cpu",
                     *chunk]) == 0
        outs.append(read_ppm(str(out)))
    assert outs[0].shape == (16, 16, 3) and outs[0].max() > 0
    assert (outs[0] == outs[1]).all()


def test_wavefront_engine_renders(tmp_path):
    out = tmp_path / "wf.ppm"
    assert main(["24", str(out), "--scene", "two_sphere", "--spp", "2",
                 "--depth", "4", "--engine", "wavefront", "--device",
                 "cpu"]) == 0
    ref = tmp_path / "mk.ppm"
    assert main(["24", str(ref), "--scene", "two_sphere", "--spp", "2",
                 "--depth", "4", "--engine", "megakernel", "--device",
                 "cpu"]) == 0
    assert (read_ppm(str(out)) == read_ppm(str(ref))).all()


def test_progress_line_and_weighted_mean(tmp_path, capfd):
    """--progress (tests/test_cli.py's check on the port): the reference's
    progress line, and the image is the spp-weighted mean of its chunk
    renders EXACTLY, each chunk at its own derived seed. spp=12 splits into
    10 chunks of 2 and 1 spp, so a missing weight or a wrong normalisation
    moves pixels far beyond the u8 step this holds them to."""
    from rayz_tpu_torch import RenderConfig, render_fast, scenes
    from rayz_tpu_torch.cli import chunk_seed, chunk_sizes
    from rayz_tpu_torch.io.image import to_u8

    out = tmp_path / "p.ppm"
    spp, seed, depth = 12, 5, 3
    assert main(["24", str(out), "--scene", "two_sphere", "--spp", str(spp),
                 "--depth", str(depth), "--engine", "xla", "--seed",
                 str(seed), "--progress", "--device", "cpu"]) == 0
    err = capfd.readouterr().err
    assert "Progress: 100.00%" in err and "Finished render" in err
    sizes = chunk_sizes(spp)
    assert sizes == [2, 2, 1, 1, 1, 1, 1, 1, 1, 1]
    assert chunk_sizes(64) == [16] * 4 and len(chunk_sizes(1000)) == 10
    seeds = [chunk_seed(seed, i) for i in range(len(sizes))]
    assert len(set(seeds)) == len(seeds) and seed not in seeds
    scene, camera = scenes.SCENES["two_sphere"](width=24, device="cpu")
    acc = None
    for s, cs in zip(sizes, seeds):
        img = render_fast(scene, camera, cs,
                          RenderConfig(spp=s, max_depth=depth), engine="xla")
        acc = img * s if acc is None else acc + img * s
    assert (read_ppm(str(out)) == to_u8(acc / spp)).all()


@pytest.mark.parametrize("engine", ["megakernel", "xla"])
def test_sharded_cli_equals_unsharded(tmp_path, engine):
    """--sharded under torchrun with two gloo processes on the CPU writes
    the unsharded CLI's image: the megakernel (its plain version) through
    render_megakernel_sharded, the dense integrator through
    render_sharded; only rank 0 prints the perf line."""
    args = ["21", "--scene", "two_sphere", "--spp", "2", "--depth", "3",
            "--seed", "6", "--engine", engine, "--device", "cpu"]
    out = tmp_path / "sharded.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "rayz_tpu_torch", args[0], str(out),
         *args[1:], "--sharded"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("Finished render (") == 1
    ref = tmp_path / "one.ppm"
    assert main([args[0], str(ref), *args[1:]]) == 0
    assert (read_ppm(str(out)) == read_ppm(str(ref))).all()
