"""The reader of the wavefront's tail launch (``tail_ms.preview``) on
hand-built slices: kernels matched to their launches by correlation id,
matched by order where the launches carry none, and silence without a
``rayz.tail`` span."""

import types

import pytest

from benchmark import harness, tracing

WAVE = "void (anonymous namespace)::wavefront_kernel<true, 2>(WfParams)"


def _ev(name, ts, dur, cat="user_annotation", tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _read(sl):
    run = types.SimpleNamespace(slice=sl)
    return harness.load_module(
        harness.ROOT / "metrics" / "tail_ms.preview.py").read(run)


def _request(t0, tail_us, launches=True, tail=True, corr0=0):
    """One render of 1,000 us from ``t0``: spans bounce 10-20, sort 20-25,
    bounce 25-35, bounce 35-45, then the tail (or a fourth bounce) 50-60;
    each launches a wavefront kernel at 12, 27, 37 and 52 (with a
    cudaLaunchKernel event of its correlation id, if ``launches``) that
    runs 100-300, 300-400, 400-500 and 500 to 500 + ``tail_us``; the
    tail's radiance addition, a torch kernel launched inside its span, and
    the image's copy 900-910."""
    last = "rayz.tail" if tail else "rayz.bounce"
    ev = [_ev("request", t0, 1000), _ev("rayz.bounce", t0 + 10, 10),
          _ev("rayz.sort", t0 + 20, 5), _ev("rayz.bounce", t0 + 25, 10),
          _ev("rayz.bounce", t0 + 35, 10), _ev(last, t0 + 50, 10),
          _ev("Memcpy DtoH (Device -> Pinned)", t0 + 900, 10,
              cat="gpu_memcpy")]
    runs = [(12, 100, 200), (27, 300, 100), (37, 400, 100),
            (52, 500, tail_us)]
    for i, (launch, start, dur) in enumerate(runs):
        c = corr0 + i
        ev.append(_ev(WAVE, t0 + start, dur, cat="kernel", tid=7, corr=c))
        if launches:
            ev.append(_ev("cudaLaunchKernel", t0 + launch, 1,
                          cat="cuda_runtime", corr=c))
    ev.append(_ev("void at::native::vectorized_elementwise_kernel<4>",
                  t0 + 700, 5, cat="kernel", tid=7, corr=corr0 + 9))
    ev.append(_ev("cudaLaunchKernel", t0 + 58, 1, cat="cuda_runtime",
                  corr=corr0 + 9))
    return ev


@pytest.mark.parametrize("launches", [True, False],
                         ids=["by_correlation", "by_order"])
def test_tail_kernels_per_render(launches):
    # two renders whose tail launches run 250 and 350 us
    sl = tracing.Slice(_request(0, 250, launches)
                       + _request(1000, 350, launches, corr0=100), 2)
    assert _read(sl) == pytest.approx(0.3)


def test_correlation_decides_over_order():
    # a kernel launched in the tail span that runs after the request's
    # last span: correlation puts it in the tail, and order is not asked
    ev = _request(0, 250)
    ev += [_ev(WAVE, 600, 40, cat="kernel", tid=7, corr=50),
           _ev("cudaLaunchKernel", 55, 1, cat="cuda_runtime", corr=50)]
    assert _read(tracing.Slice(ev, 1)) == pytest.approx(0.29)
    # without launches the five kernels do not pair with four spans
    no_launch = [e for e in ev if e["cat"] != "cuda_runtime"]
    assert _read(tracing.Slice(no_launch, 1)) is None


def test_nothing_to_read_without_a_tail_span():
    assert _read(None) is None
    # a wavefront render of depth 4 or less in a program without the
    # span: its last launch inside rayz.bounce
    assert _read(tracing.Slice(_request(0, 250, tail=False), 1)) is None
    # a run on the CPU: the spans, no device operation
    host_only = tracing.Slice([_ev("request", 0, 1000),
                               _ev("rayz.tail", 10, 100)], 1)
    assert _read(host_only) is None
