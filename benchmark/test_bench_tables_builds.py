"""The reader of ``tables_builds`` (the program's ``rayz.tables_built``
spans a request) on a hand-built slice, on a program without the table
memo, and in a traced run of the preview cell at a CPU size."""

import types

import pytest

from benchmark import harness, tracing
from benchmark.conftest import tiny


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1}


def _slice(built=(), tables=True):
    """Two requests of 1,000 us, a ``rayz.tables`` span in each (if
    ``tables``) and an empty ``rayz.tables_built`` at each time in
    ``built``."""
    ev = [_ev("request", 0, 1000), _ev("request", 1000, 1000),
          _ev("k", 300, 500, cat="kernel")]
    if tables:
        ev += [_ev("rayz.tables", 10, 100), _ev("rayz.tables", 1010, 20)]
    ev += [_ev("rayz.tables_built", t, 0) for t in built]
    return tracing.Slice(ev, 2)


def _read(metric, sl):
    run = types.SimpleNamespace(slice=sl)
    return harness.load_module(
        harness.ROOT / "metrics" / f"{metric}.py").read(run)


@pytest.mark.parametrize("suffix", ["render", "preview"])
@pytest.mark.parametrize("built, want", [((), 0.0), ((110,), 0.5),
                                         ((110, 1030), 1.0),
                                         ((110, 2500), 0.5)])
def test_reader_counts_builds_a_request(suffix, built, want):
    # a span after the slice's last request is not counted
    assert _read(f"tables_builds.{suffix}", _slice(built)) == want


@pytest.mark.parametrize("suffix", ["render", "preview"])
def test_reader_reads_nothing_without_tables_spans(suffix):
    assert _read(f"tables_builds.{suffix}", _slice(tables=False)) is None
    assert _read(f"tables_builds.{suffix}", None) is None


def test_reader_reads_nothing_from_a_program_without_the_memo(monkeypatch):
    from rayz_tpu_torch.ops import tables
    monkeypatch.delattr(tables, "TABLE_MEMO")
    assert _read("tables_builds.render", _slice()) is None


def test_traced_preview_run_builds_no_tables():
    """The warm-up render builds the scene's tables; every traced frame
    finds them in the memo."""
    res = harness.run(tiny("rtiow_final.preview", spp=1), 2 ** 31 + 11, 0.3,
                      True, device="cpu")
    assert res["correct"]
    assert res["metrics"]["tables_builds.preview"]["value"] == 0.0
    assert res["metrics"]["tables_ms.preview"]["value"] > 0
