"""The readers of the program's own kernels' device time and of the rest's
(``kernels_ms.preview``, ``glue_ms.preview``) on a hand-built slice with
known device operations, and their silence where there is nothing to
read."""

import types

import pytest

from benchmark import harness, tracing


def _ev(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def _read(metric, sl):
    run = types.SimpleNamespace(slice=sl)
    return harness.load_module(
        harness.ROOT / "metrics" / f"{metric}.py").read(run)


def _device_slice(own=True):
    """Two requests of 1,000 us each; device operations (microseconds): the
    wavefront's launches 100-400 and 1,100-1,500 and a fold 400-410 (if
    ``own``), a sort 420-450 and copies 900-910 and 1,990-2,010 (in the
    slice, since it starts there: an operation counts whole)."""
    ev = [_ev("request", 0, 1000), _ev("request", 1000, 1000),
          _ev("void at::native::radixSortKVInPlace", 420, 30, cat="kernel"),
          _ev("Memcpy DtoH (Device -> Pinned)", 900, 10, cat="gpu_memcpy"),
          _ev("Memcpy DtoH (Device -> Pinned)", 1990, 20,
              cat="gpu_memcpy")]
    if own:
        ev += [_ev("wavefront_kernel(WfParams)", 100, 300, cat="kernel"),
               _ev("wavefront_kernel(WfParams)", 1100, 400, cat="kernel"),
               _ev("void (anonymous namespace)::fold_kernel<float>"
                   "(float const*, int, long long, float*)", 400, 10,
                   cat="kernel")]
    return tracing.Slice(ev, 2)


def test_kernel_and_glue_readers_on_a_known_slice():
    sl = _device_slice()
    # the program's kernels: 300 + 400 + 10 us over 2 requests
    assert _read("kernels_ms.preview", sl) == pytest.approx(0.355)
    # the rest: 30 + 10 + 20 us
    assert _read("glue_ms.preview", sl) == pytest.approx(0.03)
    assert _read("kernels_ms.preview", _device_slice(own=False)) is None
    assert _read("glue_ms.preview", _device_slice(own=False)) == \
        pytest.approx(0.03)


@pytest.mark.parametrize("metric", ["kernels_ms.preview",
                                    "glue_ms.preview"])
def test_kernel_and_glue_readers_read_nothing_without_device_work(metric):
    assert _read(metric, None) is None
    # a slice with no device operation (a run on the CPU)
    host_only = tracing.Slice([_ev("request", 0, 1000),
                               _ev("rayz.tables", 10, 100)], 1)
    assert _read(metric, host_only) is None
