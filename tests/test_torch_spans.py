"""The render path's spans (rayz_tpu_torch/utils/profiling.py's ``span``):
under a ``torch.profiler``, a megakernel render through ``render_fast``
records five flat stages, ``rayz.dispatch`` (2), ``rayz.tables`` (1),
``rayz.queue`` and ``rayz.fold`` (one each a sample group) and
``rayz.finish`` (1), and a wavefront render ``rayz.dispatch`` (1),
``rayz.tables`` (1), ``rayz.bounce`` (one a synchronous launch),
``rayz.tail`` (the tail launch, where the depth passes the synchronous
bounces), ``rayz.sort`` (one a sort or partition between launches) and
``rayz.finish`` (1), as
``user_annotation`` events inside the caller's own annotation; a render
that builds its scene's tables (the first of a scene) records an empty
``rayz.tables_built`` right after ``rayz.tables``, one that finds them in
the memo (ops/tables.py ``TABLE_MEMO``) does not; with no
profiler running no ``record_function`` is entered and the image is bit
for bit the traced one. On the CPU the wrappers run the plain versions
through the same Python path as the kernels."""

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
WF_STAGES = ("dispatch", "tables", "bounce", "tail", "sort", "finish")
CFG = rtt.RenderConfig(spp=3, max_depth=3)


def _scene():
    return rtt.scenes.two_sphere(width=8, height=6, device="cpu")


def _render(scene, cam, engine="megakernel", config=CFG, **kw):
    return rtt.render_fast(scene, cam, 7, config, engine=engine, **kw)


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


def _stages(events):
    """The ``rayz.*`` spans' stage names in order, after checking that they
    are user annotations, flat and inside the caller's ``request``."""
    spans = _spans(events)
    assert all(e["cat"] == "user_annotation" for e in spans)
    assert _flat(spans)
    (req,) = [e for e in events if e["name"] == "request"]
    assert all(req["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= req["ts"] + req["dur"] + 2e-3 for e in spans)
    return [e["name"][5:] for e in sorted(spans, key=lambda e: e["ts"])]


def _check_off_and_on(tmp_path, monkeypatch, render, stages):
    """With no profiler ``render`` enters no ``record_function`` and gives
    the traced image bit for bit; once a profiler records it enters one
    for each of ``stages``."""
    traced, _ = _events(tmp_path, render)
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        entered.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    plain = render()
    assert entered == []
    assert torch.equal(plain, traced)
    # the same patch is entered once a profiler records
    _events(tmp_path, render)
    assert {a[0] for a in entered} - {"request"} == {
        f"rayz.{s}" for s in stages}


@pytest.mark.parametrize("groups", [1, 3])
def test_megakernel_render_records_five_flat_stages(tmp_path, monkeypatch,
                                                    groups):
    scene, cam = _scene()
    if groups > 1:  # one sample a queue launch
        monkeypatch.setattr(mk, "QUEUE_BYTES", 12 * cam.width * cam.height)
    assert -(-CFG.spp // mk._queue_group(CFG.spp, cam.width * cam.height)) \
        == groups
    _, events = _events(tmp_path, lambda: _render(scene, cam))
    order = _stages(events)
    assert collections.Counter(order) == {
        "dispatch": 2, "tables": 1, "tables_built": 1, "queue": groups,
        "fold": groups, "finish": 1}
    # stages in order: dispatch, dispatch, tables (and, the scene's first
    # render, its build), (queue, fold)..., finish
    assert order == ["dispatch", "dispatch", "tables", "tables_built"] + \
        ["queue", "fold"] * groups + ["finish"]


@pytest.mark.parametrize("depth,sort,order", [
    # bounces 0, 1, 2 and the tail; a sort before bounce 1, a partition
    # before bounce 2 and one before the tail
    (8, True, ["bounce", "sort", "bounce", "sort", "bounce", "sort",
               "tail"]),
    # no tail at a depth of three or less
    (3, True, ["bounce", "sort", "bounce", "sort", "bounce"]),
    (2, True, ["bounce", "sort", "bounce"]),
    # without the sort only the tail's partition is left
    (8, False, ["bounce", "bounce", "bounce", "sort", "tail"]),
])
def test_wavefront_render_records_flat_stages(tmp_path, depth, sort, order):
    scene, cam = _scene()
    cfg = CFG._replace(max_depth=depth)
    _, events = _events(tmp_path, lambda: _render(scene, cam, "wavefront",
                                                  cfg, sort=sort))
    got = _stages(events)
    assert got == ["dispatch", "tables", "tables_built"] + order + ["finish"]
    if depth == 8 and sort:
        assert collections.Counter(got) == {
            "dispatch": 1, "tables": 1, "tables_built": 1, "bounce": 3,
            "tail": 1, "sort": 3, "finish": 1}
    if depth <= 3:
        assert "tail" not in got


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_tables_built_is_recorded_on_a_build_and_not_on_a_hit(tmp_path,
                                                              engine):
    scene, cam = _scene()
    _, first = _events(tmp_path, lambda: _render(scene, cam, engine))
    _, second = _events(tmp_path, lambda: _render(scene, cam, engine))
    order = _stages(first)
    assert order.count("tables_built") == 1
    assert order[order.index("tables") + 1] == "tables_built"
    assert "tables" in _stages(second)
    assert "tables_built" not in _stages(second)


def test_wavefront_without_profiler_enters_nothing(tmp_path, monkeypatch):
    scene, cam = _scene()
    cfg = CFG._replace(max_depth=8)
    _check_off_and_on(tmp_path, monkeypatch,
                      lambda: _render(scene, cam, "wavefront", cfg),
                      WF_STAGES)


def test_other_engines_record_only_the_dispatch(tmp_path):
    scene, cam = _scene()
    _, events = _events(tmp_path, lambda: _render(scene, cam, "xla"))
    assert [e["name"] for e in _spans(events)] == ["rayz.dispatch"]


def test_no_profiler_enters_no_record_function(tmp_path, monkeypatch):
    scene, cam = _scene()
    _check_off_and_on(tmp_path, monkeypatch, lambda: _render(scene, cam),
                      STAGES)


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
