"""The port's scripts on the CPU at tiny sizes (``--device cpu``: the
kernels' plain versions): ``rayz_tpu_torch.bench`` and
``rayz_tpu_torch.scripts.{gpu_check,bench_configs,bench_culling}``.

* their constants and defaults equal the JAX scripts' (``bench.py``,
  ``scripts/*.py`` loaded unchanged with importlib, or read with ast);
* bench's line has every key of ``bench.py``'s JSON line;
* gpu_check's checks pass on the plain versions, and fail on a planted
  bias (an image + 0.05, a gradient x 2) and where the dense oracle's
  noise floor is not below the tolerance;
* without a card, and without ``device="cpu"``, every script raises.

On the card, chip_smoke.py runs gpu_check's whole list and a row of each
bench script.
"""

import ast
import importlib.util
import itertools
import json
import math
import os

import pytest
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch import bench
from rayz_tpu_torch.scripts import bench_configs, bench_culling, gpu_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, SPP = 16, 64  # gpu_check's checks: 16 wide, tol 0.04


def _load(rel: str):
    """A JAX script, unchanged, as a module (its main is not run)."""
    name = "jax_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(rel: str):
    with open(os.path.join(ROOT, rel)) as f:
        return ast.parse(f.read())


def _argparse_defaults(rel: str) -> dict:
    """``{"--flag": default}`` of every ``add_argument`` call in a file."""
    out = {}
    for node in ast.walk(_tree(rel)):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "add_argument"):
            for kw in node.keywords:
                if kw.arg == "default":
                    out[node.args[0].value] = ast.literal_eval(kw.value)
    return out


def _assigned(rel: str, name: str):
    """The literal assigned to ``name`` anywhere in a file (bench.py's
    MICRO is a local of its main)."""
    for node in ast.walk(_tree(rel)):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{rel} assigns no {name}")


@pytest.mark.parametrize("rel,port,names", [
    ("bench.py", bench, ("WIDTH", "HEIGHT", "SPP", "DEPTH", "RUNS",
                         "REFERENCE_BASELINE_MRAYS")),
    ("scripts/bench_configs.py", bench_configs, ("CONFIGS",)),
    ("scripts/bench_culling.py", bench_culling, ("SEEDS",)),
])
def test_constants_match_jax_scripts(rel, port, names):
    jax_script = _load(rel)
    for name in names:
        assert getattr(port, name) == getattr(jax_script, name), name


@pytest.mark.parametrize("rel,port_rel", [
    ("scripts/tpu_check.py", "rayz_tpu_torch/scripts/gpu_check.py"),
    ("scripts/bench_configs.py", "rayz_tpu_torch/scripts/bench_configs.py"),
    ("scripts/bench_culling.py", "rayz_tpu_torch/scripts/bench_culling.py"),
])
def test_defaults_match_jax_scripts(rel, port_rel):
    jax_defaults = _argparse_defaults(rel)
    port_defaults = _argparse_defaults(port_rel)
    assert jax_defaults, rel
    for flag, value in jax_defaults.items():
        assert port_defaults[flag] == value, flag
    assert _assigned("bench.py", "MICRO") == bench.MICRO


def test_bench_line_has_bench_py_keys():
    keys = None
    for node in ast.walk(_tree("bench.py")):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            keys = [k.value for k in node.args[0].keys]
    assert keys and "fwdbwd_leftover" in keys
    line = json.loads(json.dumps(bench.run(width=8, height=8, spp=4,
                                           depth=3, runs=2, micro=2,
                                           device="cpu")))
    assert set(keys) <= set(line)
    assert line["device"] == "cpu" and line["fwdbwd_leftover"] == 0
    assert line["value"] == line["fwd_mrays_per_s"] > 0
    assert line["fwd_stats"]["runs"] == line["fwdbwd_stats"]["runs"] == 2
    knobs = line["engine_knobs"]
    assert knobs["engine"] == "megakernel"
    assert knobs["table_mode"] == "resident"
    assert sum(k for k, _ in knobs["compact_schedule"]) == 2 * 3


def test_bench_configs_row():
    row = bench_configs.config_row("two_sphere", dict(width=8, height=8), 2,
                                   4, device="cpu")
    assert set(row) == {"config", "width", "height", "spp", "depth",
                        "fwd_mrays_per_s", "engine", "device"}
    assert row["engine"] == "megakernel" and row["fwd_mrays_per_s"] > 0


def test_culling_row_streamed():
    """A row beyond one block's shared memory: brute force streams every
    chunk untested, culling tests them; all three images equal."""
    row = bench_culling.culling_row(4000, width=16, spp=1, depth=2,
                                    device="cpu", seeds=(1,))
    want = {"n_spheres", "width", "spp", "depth", "fits_shared", "seeds",
            "speedup", "best_speedup", "auto", "device"}
    for mode in ("brute_force", "culling_on", "wavefront"):
        want |= {mode, mode + "_median", mode + "_digest"}
    assert set(row) == want
    assert row["fits_shared"] is False and row["auto"] == "wavefront"
    assert (row["brute_force_digest"] == row["culling_on_digest"]
            == row["wavefront_digest"])


def test_culling_row_slow_clock(monkeypatch):
    """A render slow enough that its rate rounds to 0.0 Mrays/s (144 rays
    in 0.5 s): the row is still formed, its speedups finite. The clock is
    a fake that moves 0.5 s a call, so no real time matters."""
    clock = itertools.count(0.0, 0.5)
    monkeypatch.setattr(bench_culling.time, "perf_counter",
                        lambda: next(clock))
    row = bench_culling.culling_row(4000, width=16, spp=1, depth=2,
                                    device="cpu", seeds=(1,))
    assert row["brute_force"] == row["culling_on"] == 0.0
    assert math.isfinite(row["speedup"]) and row["speedup"] > 0
    assert math.isfinite(row["best_speedup"]) and row["best_speedup"] > 0


def _checks(lines):
    return gpu_check.Checks(W, SPP, "cpu", out=lines.append)


@pytest.mark.parametrize("case", ["megakernel", "recorded-pp", "shading",
                                  "tri_vertices", "velocity"])
def test_checks_pass_on_plain_versions(case):
    lines = []
    c = _checks(lines)
    tol = gpu_check.forward_tol(SPP)
    if case == "megakernel":
        ok = c.parity("megakernel", "two_sphere", 8, {}, SPP, tol)
    elif case == "recorded-pp":
        ok = c.parity("recorded-pp", "three_sphere", 6, {}, SPP, tol)
        assert "leftover=0" in lines[-1]
    elif case == "shading":
        ok = c.grad_fd("shading", "sphere_grid", ("tex_color", "mat_fuzz"),
                       W)
    elif case == "tri_vertices":
        # at the check's own 64 wide: summed in float32, the loss (~3,900)
        # moved in steps of 9% of the difference, and the line failed
        name, fields, kw = gpu_check.FD_LINES[case]
        ok = c.grad_fd(case, name, fields, 64, **kw)
    else:
        ok = c.grad_velocity(W)
    assert ok and lines[-1].startswith("OK"), lines


def test_planted_image_bias_fails(monkeypatch):
    render = gpu_check.RENDER["megakernel"]
    monkeypatch.setitem(gpu_check.RENDER, "megakernel",
                        lambda *a, **kw: (render(*a, **kw)[0] + 0.05, 0))
    lines = []
    assert not _checks(lines).parity("megakernel", "two_sphere", 8, {}, SPP,
                                     gpu_check.forward_tol(SPP))
    assert lines[-1].startswith("FAIL"), lines


def test_planted_gradient_bias_fails(monkeypatch):
    grads = gpu_check._grads
    monkeypatch.setattr(gpu_check, "_grads", lambda loss, params: {
        k: 2 * g for k, g in grads(loss, params).items()})
    lines = []
    assert not _checks(lines).grad_fd("shading", "sphere_grid",
                                      ("tex_color", "mat_fuzz"), W)
    assert lines[-1].startswith("FAIL"), lines


def test_check_without_power_fails(monkeypatch):
    """An engine that returns the oracle itself (error 0) still fails
    where the noise floor is not below the tolerance, and says so."""
    monkeypatch.setitem(gpu_check.RENDER, "megakernel",
                        lambda scene, cam, seed, cfg, **kw: (rtt.render(
                            scene, cam, gpu_check.ORACLE_SEED, cfg), 0))
    lines = []
    c = _checks(lines)
    floor = c.oracle("two_sphere", 8, SPP)[1]
    assert floor > 0
    assert c.parity("megakernel", "two_sphere", 8, {}, SPP, 1.01 * floor)
    assert "mae=0.0000" in lines[-1]
    assert not c.parity("megakernel", "two_sphere", 8, {}, SPP, floor)
    assert lines[-1].startswith("FAIL") and "NO POWER" in lines[-1]


def test_check_lists_and_seeds():
    """Every engine of the lists has a renderer and a predicate, the oracle
    never shares the engine's seed, and the lists hold tpu_check.py's
    checks plus the table modes."""
    assert gpu_check.ORACLE_SEED not in (gpu_check.ENGINE_SEED,
                                         gpu_check.FLOOR_SEED)
    for engine, name, _, _ in gpu_check.FORWARD + gpu_check.RECORDED:
        assert engine in gpu_check.RENDER and engine in gpu_check.SUPPORTS
        assert name in gpu_check.SCENES
    assert len(gpu_check.FORWARD) == 11 and len(gpu_check.RECORDED) == 7
    assert gpu_check.forward_tol(256) == 0.02
    assert gpu_check.recorded_tol(256) == gpu_check.forward_tol(64)


@pytest.mark.parametrize("script", ["gpu_check", "bench", "bench_configs",
                                    "bench_culling"])
def test_scripts_refuse_to_run_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the scripts would run on it")
    calls = {"gpu_check": lambda: gpu_check.main([]),
             "bench": bench.run,
             "bench_configs": lambda: bench_configs.main([]),
             "bench_culling": lambda: bench_culling.main([])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[script]()
