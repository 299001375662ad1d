"""BENCHMARK.json against the contract it is written to, and every name in
it against the file that the harness finds by that name."""

import json
import re

import pytest

from benchmark import harness

SPEC = json.loads(harness.SPEC.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(harness.SPEC.read_bytes()) <= 64 * 1024
    assert all("/" not in w and not w.startswith("/")
               for w in SPEC["command"][1:] if w.endswith(".py"))
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p


def test_names_units_and_keys():
    names = CELLS + [c["name"] for c in SPEC["configs"]] + \
        [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell, SPEC)
    assert hasattr(c.kind(), "Traffic")
    assert set(c.workload["limits"]) and "trace_requests" in c.workload
    e2e = [m["name"] for m in c.metrics["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.metrics["per_layer"]
    for m in c.metrics["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module(harness.ROOT / "metrics" / f"{metric}.py")
    assert callable(mod.read)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_and_reduced_keys(config):
    path = harness.ROOT.parent / config["file"]
    cfg = json.loads(path.read_text())
    assert config["file"].startswith("benchmark/configs/")
    assert all(k in cfg and k in cfg["upstream"] for k in config["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in config["reduced"])
    assert config["source"].startswith("https://")
