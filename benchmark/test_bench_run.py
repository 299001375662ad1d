"""A run driven end to end on the CPU at a small size (the program's plain
versions): its result line, the import guard, the control, and the faults
that must turn ``correct`` false."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import faults, guard, harness
from benchmark.conftest import tiny
from benchmark.traffic import render, train

REPO = str(harness.ROOT.parent)
# Limits of the train check at 24 x 24 pixels and 4 samples, where a few
# thousand paths make sound readings wider than at the cell's size. Over
# 12 seeds sound runs here read at most loss_gap 0.0086, albedo_grad_gap
# 0.018, change_gap 0.048; on 3 seeds the faults read at least: frozen
# albedo_grad_gap and change_gap 1, half_samples loss_gap 0.45,
# loss_altered loss_gap 0.10.
SMALL_TRAIN_LIMITS = {"loss_gap": 0.03, "albedo_grad_gap": 0.08,
                      "change_gap": 0.1}


def _run(cell, trace=False, seconds=0.3):
    return harness.run(cell, 2 ** 31 + 5, seconds, trace, device="cpu")


def test_result_line_keys_and_checks_last(capsys):
    res = _run(tiny("rtiow_final.render"))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"render_mrays_per_s", "render_ms_p95",
                                   "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    harness.report(res)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(res))
    assert err.strip().splitlines()[-1].startswith("check pixel_gap ")


def test_traced_result_line():
    res = _run(tiny("rtiow_final.train", width=12, spp=2), trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["attempted"] == 2
    assert set(res["checks"]) == {"loss_gap", "albedo_grad_gap", "change_gap",
                                  "check_leftover"}


def test_import_guard_compares_top_level_names_whole():
    assert guard.loaded_forbidden(["jax.numpy", "rayz_tpu.ops", "jaxlib",
                                   "rayz_tpu_torch.ops", "flaxen",
                                   "flax"]) == ["flax", "jax.numpy", "jaxlib",
                                                "rayz_tpu.ops"]
    assert set(guard.reference_imports()) <= {"__future__", "math", "typing",
                                              "numpy", "torch"}


def test_import_guard_in_a_fresh_process():
    code = ("import sys; from benchmark import guard, harness, scene; "
            "from benchmark.traffic import render, train; "
            "import rayz_tpu_torch; guard.check_start(); "
            "sys.modules['jax'] = sys; guard.check_loaded()")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "['jax']" in p.stderr


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "rtiow_final.render", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_control_fails_the_render_check():
    cell = tiny("rtiow_final.render")
    gaps = render.control_gaps(cell, 11, "cpu", 2)
    assert min(gaps) > cell.workload["limits"]["pixel_gap"]


def test_control_fails_the_train_check():
    cell = tiny("rtiow_final.train", width=16, spp=2)
    numbers = train.control_readings(cell, 11, "cpu")
    limits = cell.workload["limits"]
    assert any(not v <= limits[k] for k, v in numbers.items())


# ---- faults planted under the timed path ----

@pytest.mark.parametrize("fault", sorted(faults.RENDER))
def test_render_fault_is_not_correct(fault):
    assert _run(tiny("rtiow_final.render"))["correct"]
    with faults.RENDER[fault]():
        assert not _run(tiny("rtiow_final.render"))["correct"]


def _small_train():
    cell = tiny("rtiow_final.train", width=24, spp=4)
    cell.workload["limits"].update(SMALL_TRAIN_LIMITS)
    return cell


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_not_correct(fault):
    assert _run(_small_train())["correct"]
    with faults.TRAIN[fault]():
        assert not _run(_small_train())["correct"]
