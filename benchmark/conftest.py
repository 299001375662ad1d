"""Fixtures of the benchmark's own tests: a cell cut to a size the CPU
runs in seconds (the program's plain versions, the reference in float64),
and the card for the tests marked ``cuda``."""

import json

import pytest

from benchmark import harness

# Cells whose files are kept under benchmark/ but that BENCHMARK.json
# leaves out for now (PERF.md, Open questions): the tests still drive them.
KEPT = [{"name": "rtiow_final.train", "config": "rtiow_final",
         "traffic": "train_32spp", "chips": 1}]


def tiny(name: str, width: int = 24, spp: int = 4, depth: int = 8):
    """The cell ``name`` at ``width`` x ``width``, ``spp`` samples and
    depth ``depth``, with its check cut to match."""
    spec = json.loads(harness.SPEC.read_text())
    spec["workloads"] += KEPT
    cell = harness.Cell(name, spec)
    cell.config["resolution"] = [width, width]
    cell.config["max_depth"] = depth
    tr = cell.traffic
    tr["spp"] = spp
    if tr["kind"] == "render":
        tr["warmup"] = 1
        cell.workload["check"]["pixels"] = 256
    else:
        tr["target_spp"] = spp
    cell.workload["trace_requests"] = 2
    return cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs on the card")
    return "cuda"
