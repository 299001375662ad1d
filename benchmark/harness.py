"""One run of one cell: set-up, the measured window (or the traced slice),
the check against the reference, the metrics and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the scene, camera and render settings;
* ``traffic/<traffic>.json``: the mix's parameters, whose ``kind`` names
  the module ``traffic/<kind>.py`` that drives the program and checks it;
* ``workloads/<cell>.json``: the cell's check (sizes and limits) and the
  length of its traced slice;
* ``metrics/<metric>.py``: a reader ``read(run)`` that returns the metric
  or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import guard, tracing

ROOT = Path(__file__).resolve().parent
SPEC = ROOT.parent / "BENCHMARK.json"


def load_module(path: Path):
    """Import the file ``path`` as a module of its own (names may hold
    dots)."""
    name = "benchmark._found." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A cell's entry of ``BENCHMARK.json`` and its files."""

    def __init__(self, name: str, spec: Optional[dict] = None):
        spec = _json(SPEC) if spec is None else spec
        entry = [w for w in spec["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"no cell {name!r} in {SPEC.name}")
        entry = entry[0]
        self.name, self.chips = name, int(entry["chips"])
        self.config = _json(ROOT / "configs" / f"{entry['config']}.json")
        self.traffic = _json(ROOT / "traffic" / f"{entry['traffic']}.json")
        self.workload = _json(ROOT / "workloads" / f"{name}.json")
        self.metrics = {k: [m for m in spec[k] if _applies(m, name)]
                        for k in ("end_to_end", "per_layer")}

    def kind(self):
        """The module ``traffic/<kind>.py`` of the mix's kind."""
        return importlib.import_module(
            f"benchmark.traffic.{self.traffic['kind']}")


class Run:
    """What the metric readers read. Times in seconds."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.setup_s = math.nan
        self.latencies: List[float] = []
        self.rays: List[int] = []
        self.ok: List[bool] = []
        self.window_s = math.nan
        self.slice: Optional[tracing.Slice] = None
        self.counts: Dict[str, float] = {}
        self.peak_window_bytes = 0
        self.device_kind = "cpu"


def request_seeds(seed: int, stream: int) -> np.random.Generator:
    """A generator of request seeds (or other draws) from ``--seed``: any
    whole number, negative or beyond 64 bits included."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def power_limit() -> Optional[float]:
    """The card's power limit in watts, as nvidia-smi reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def window(run: Run, request, seconds: float) -> None:
    """The closed loop: one client sends its next request when the last
    has ended, until ``seconds`` have passed; the window closes when the
    last request started in it ends."""
    start = time.perf_counter()
    end = start
    i = 0
    while i == 0 or end - start < seconds:
        t = time.perf_counter()
        rays, ok = request(i)
        end = time.perf_counter()
        run.latencies.append(end - t)
        run.rays.append(rays)
        run.ok.append(ok)
        i += 1
    run.window_s = end - start


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, runs: Optional[list] = None) -> dict:
    """Run ``cell`` once and return its result line (a dict). ``t0`` is
    the process's start on ``time.perf_counter``'s clock; ``runs``, a list,
    receives the :class:`Run` the readers read."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    on_card = torch.device(device).type == "cuda"
    r = Run(cell)
    if runs is not None:
        runs.append(r)
    traffic = cell.kind().Traffic(cell, seed, device)
    _sync(device)
    # set-up leaves out what the traffic spent on the reference's work
    r.setup_s = (time.perf_counter() - t0
                 - getattr(traffic, "reference_s", 0.0))
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        r.slice, results = tracing.trace(traffic.request,
                                         int(cell.workload["trace_requests"]))
        r.rays = [x[0] for x in results]
        r.ok = [x[1] for x in results]
        r.window_s = r.slice.window_s
    else:
        window(r, traffic.request, seconds)
    if on_card:
        r.peak_window_bytes = torch.cuda.max_memory_allocated()
        r.device_kind = torch.cuda.get_device_name(0)
    guard.check_loaded()
    numbers, failed_checked, counts = traffic.check()
    r.counts.update(counts)
    limits = cell.workload["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    failed = sum(not ok for ok in r.ok) + failed_checked
    metrics = {}
    for m in cell.metrics["per_layer" if trace else "end_to_end"]:
        value = load_module(ROOT / "metrics" / f"{m['name']}.py").read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": r.device_kind, "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, r.peak_window_bytes),
           "power_limit_w": power_limit() if on_card else None}
    if trace:
        dev["busy_s"] = r.slice.busy_s
        dev["window_s"] = r.slice.window_s
    out = {"correct": bool(correct and failed == 0),
           "attempted": len(r.ok), "failed": failed, "metrics": metrics,
           "device": dev}
    if trace:
        out["breakdown"] = r.slice.breakdown()
    out["checks"] = checks
    return out


def report(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
