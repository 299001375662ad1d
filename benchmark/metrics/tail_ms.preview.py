"""Device milliseconds a frame of the program's own CUDA kernels launched
inside the wavefront's ``rayz.tail`` spans: the tail launch, which carries
every bounce after the synchronous ones, unsorted.

Each kernel is matched to the host call that launched it by the trace's
correlation id. Where some of the program's kernels have no launch of
that id in the trace, they are matched by order inside each ``request``
instead: each ``rayz.bounce`` or ``rayz.tail`` span launches exactly one
``wavefront_kernel``, and a render ends in ``synchronize()``, so the k-th
such kernel of a request belongs to its k-th such span. None where the
slice holds no ``rayz.tail`` span (a program without it, or the
megakernel), or where the order does not pair up."""

from benchmark import kernels

TAIL, BOUNCE, REQUEST = "rayz.tail", "rayz.bounce", "request"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WAVEFRONT = "wavefront_kernel"


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def _annotations(sl, name):
    return sorted((e for e in sl.host if e.get("cat") == "user_annotation"
                   and e["name"] == name), key=lambda e: e["ts"])


def _inside(t, spans):
    return any(s["ts"] <= t <= s["ts"] + s["dur"] for s in spans)


def _by_correlation(sl, own, tails):
    """Device microseconds of ``own`` launched in ``tails``, or None where a
    kernel has no launch of its correlation id in the trace."""
    launch = {_corr(e): e["ts"] for e in sl.host
              if e.get("cat") in LAUNCH_CATS and _corr(e) is not None}
    if not all(_corr(k) in launch for k in own):
        return None
    return sum(k["dur"] for k in own if _inside(launch[_corr(k)], tails))


def _by_order(sl, own):
    """Device microseconds of the wavefront kernels paired, in order inside
    each request, with its ``rayz.tail`` spans; None where a request's
    kernels and spans do not pair up."""
    stages = _annotations(sl, BOUNCE) + _annotations(sl, TAIL)
    waves = [k for k in own if WAVEFRONT in k["name"]]
    total = 0.0
    for req in _annotations(sl, REQUEST):
        a, b = req["ts"], req["ts"] + req["dur"]
        spans = sorted((s for s in stages if a <= s["ts"] <= b),
                       key=lambda s: s["ts"])
        ks = sorted((k for k in waves if a <= k["ts"] <= b),
                    key=lambda k: k["ts"])
        if len(spans) != len(ks):
            return None
        total += sum(k["dur"] for s, k in zip(spans, ks)
                     if s["name"] == TAIL)
    return total


def read(run):
    sl = run.slice
    if sl is None:
        return None
    tails = _annotations(sl, TAIL)
    if not tails:
        return None
    own = [k for k in sl.kernels if kernels.is_own(k["name"])]
    if not own:
        return None
    us = _by_correlation(sl, own, tails)
    if us is None:
        us = _by_order(sl, own)
    return None if us is None else us * 1e-3 / sl.requests
