"""The readers of the program's spans (``spans.py``: ``tables_ms``,
``program_host_ms``, ``program_idle_ms``) on a hand-built slice with known
spans and device operations, and in a traced run of the preview cell at a
CPU size."""

import types

import pytest

from benchmark import harness, tracing
from benchmark.conftest import tiny

READERS = ("tables_ms", "program_host_ms", "program_idle_ms")


def _ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def _slice(with_spans=True):
    """Two requests of 1,000 us each. Microseconds: rayz.* spans covering
    10-160, 900-920 / 1,010-1,090, 1,950-1,960 and 1,990-2,030 (clipped
    to 2,000), one before the slice (left out); kernels 100-140,
    145-890 and 1,060-1,900."""
    ev = [_ev("request", 0, 1000), _ev("request", 1000, 1000),
          _ev("aten::mul", 40, 20, cat="cpu_op"),
          _ev("k", 100, 40, cat="kernel", tid=7),
          _ev("k", 145, 745, cat="kernel", tid=7),
          _ev("k", 1060, 840, cat="kernel", tid=7)]
    if with_spans:
        ev += [_ev("rayz.tables", -100, 50),
               _ev("rayz.dispatch", 10, 10), _ev("rayz.dispatch", 20, 10),
               _ev("rayz.tables", 30, 100), _ev("rayz.queue", 130, 20),
               _ev("rayz.fold", 150, 10), _ev("rayz.finish", 900, 20),
               _ev("rayz.dispatch", 1010, 10), _ev("rayz.tables", 1020, 50),
               _ev("rayz.queue", 1070, 10), _ev("rayz.fold", 1080, 10),
               _ev("rayz.finish", 1950, 10), _ev("rayz.finish", 1990, 40)]
    return tracing.Slice(ev, 2)


def _read(metric, sl):
    run = types.SimpleNamespace(slice=sl)
    return harness.load_module(
        harness.ROOT / "metrics" / f"{metric}.py").read(run)


@pytest.mark.parametrize("suffix", ["render", "preview"])
def test_readers_on_a_known_slice(suffix):
    sl = _slice()
    # tables: 100 + 50 us over 2 requests
    assert _read(f"tables_ms.{suffix}", sl) == pytest.approx(0.075)
    # the union: 150 + 20 + 80 + 10 + 10 us
    assert _read(f"program_host_ms.{suffix}", sl) == pytest.approx(0.135)
    # less the kernels inside it: 40 (100-140) + 15 (145-160) + 30
    # (1,060-1,090) us
    assert _read(f"program_idle_ms.{suffix}", sl) == pytest.approx(0.0925)


@pytest.mark.parametrize("metric", [f"{m}.{s}" for m in READERS
                                    for s in ("render", "preview")])
def test_readers_read_nothing_without_spans(metric):
    assert _read(metric, _slice(with_spans=False)) is None
    assert _read(metric, None) is None


def test_traced_preview_run_reports_the_span_metrics():
    res = harness.run(tiny("rtiow_final.preview", spp=1), 2 ** 31 + 9, 0.3,
                      True, device="cpu")
    assert res["correct"]
    got = {m: res["metrics"][f"{m}.preview"]["value"] for m in READERS}
    assert 0 < got["tables_ms"] < got["program_host_ms"]
    # no device operation on the CPU: all of the spans' time is idle
    assert got["program_idle_ms"] == pytest.approx(got["program_host_ms"])
    assert any(name.startswith("rayz.")
               for name, _ in res["breakdown"]["idle_gaps"])
