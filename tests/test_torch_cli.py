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
