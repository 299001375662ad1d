"""The render path's spans (rayz_tpu_torch/utils/profiling.py's ``span``):
under a ``torch.profiler``, a megakernel render through ``render_fast``
records five flat stages, ``rayz.dispatch`` (2), ``rayz.tables`` (1),
``rayz.queue`` and ``rayz.fold`` (one each a sample group) and
``rayz.finish`` (1), as ``user_annotation`` events inside the caller's
own annotation; with no profiler running no ``record_function`` is entered
and the image is bit for bit the traced one. On the CPU the wrappers run
the plain versions through the same Python path as the kernels."""

import collections
import json
import os

import pytest
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.ops import megakernel as mk
from rayz_tpu_torch.utils import profiling

torch.set_num_threads(2)

STAGES = ("dispatch", "tables", "queue", "fold", "finish")
CFG = rtt.RenderConfig(spp=3, max_depth=3)


def _scene():
    return rtt.scenes.two_sphere(width=8, height=6, device="cpu")


def _render(scene, cam, engine="megakernel"):
    return rtt.render_fast(scene, cam, 7, CFG, engine=engine)


def _events(tmp_path, fn):
    """Run ``fn`` inside a ``request`` annotation under the profiler;
    returns its result and the exported trace's complete events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("request"):
            out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X"]


def _spans(events):
    return [e for e in events if e["name"].startswith("rayz.")]


def _flat(spans) -> bool:
    """No span starts before the one before it on its thread has ended
    (the export rounds times to 1 ns)."""
    by_tid = collections.defaultdict(list)
    for e in spans:
        by_tid[e["tid"]].append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: e["ts"])
        for a, b in zip(evs, evs[1:]):
            if b["ts"] < a["ts"] + a["dur"] - 2e-3:
                return False
    return True


@pytest.mark.parametrize("groups", [1, 3])
def test_megakernel_render_records_five_flat_stages(tmp_path, monkeypatch,
                                                    groups):
    scene, cam = _scene()
    if groups > 1:  # one sample a queue launch
        monkeypatch.setattr(mk, "QUEUE_BYTES", 12 * cam.width * cam.height)
    assert -(-CFG.spp // mk._queue_group(CFG.spp, cam.width * cam.height)) \
        == groups
    _, events = _events(tmp_path, lambda: _render(scene, cam))
    spans = _spans(events)
    counts = collections.Counter(e["name"] for e in spans)
    assert counts == {"rayz.dispatch": 2, "rayz.tables": 1,
                      "rayz.queue": groups, "rayz.fold": groups,
                      "rayz.finish": 1}
    assert all(e["cat"] == "user_annotation" for e in spans)
    assert _flat(spans)
    (req,) = [e for e in events if e["name"] == "request"]
    assert all(req["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= req["ts"] + req["dur"] + 2e-3 for e in spans)
    # stages in order: dispatch, dispatch, tables, (queue, fold)..., finish
    order = [e["name"][5:] for e in sorted(spans, key=lambda e: e["ts"])]
    assert order == ["dispatch", "dispatch", "tables"] + \
        ["queue", "fold"] * groups + ["finish"]


def test_other_engines_record_only_the_dispatch(tmp_path):
    scene, cam = _scene()
    _, events = _events(tmp_path, lambda: _render(scene, cam, "xla"))
    assert [e["name"] for e in _spans(events)] == ["rayz.dispatch"]


def test_no_profiler_enters_no_record_function(tmp_path, monkeypatch):
    scene, cam = _scene()
    traced, _ = _events(tmp_path, lambda: _render(scene, cam))
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        entered.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    plain = _render(scene, cam)
    assert entered == []
    assert torch.equal(plain, traced)
    # the same patch is entered once a profiler records
    _events(tmp_path, lambda: _render(scene, cam))
    assert {a[0] for a in entered} - {"request"} == {
        f"rayz.{s}" for s in STAGES}


def test_span_is_one_shared_no_op_when_off():
    assert profiling.span("tables") is profiling.span("queue")
    with profiling.span("tables") as got:
        assert got is None
    assert rtt.utils.span is profiling.span


def test_trace_dump_contains_the_spans(tmp_path):
    scene, cam = _scene()
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        _render(scene, cam)
    with open(os.path.join(log_dir, "trace.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {f"rayz.{s}" for s in STAGES} <= names
