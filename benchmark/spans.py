"""The program's own stages in a traced slice: the ``rayz.*``
``user_annotation`` events that the port records while the profiler is on
(``span`` in rayz_tpu_torch/utils/profiling.py), on the same clock as the
device operations, clipped to the slice. The readers of ``tables_ms``,
``program_host_ms`` and ``program_idle_ms`` share them; each returns None
where the slice holds no such span (a program that records none)."""

from __future__ import annotations

from benchmark import tracing

PREFIX = "rayz."


def intervals(sl, name=None):
    """The union of the slice's ``rayz.*`` spans (only those called
    ``name``, if given), clipped to the slice: sorted (start, end) pairs
    in microseconds of the trace's clock."""
    if sl is None:
        return []
    return tracing._union([
        (max(e["ts"], sl.t0), min(e["ts"] + e["dur"], sl.t1))
        for e in sl.host if e.get("cat") == "user_annotation"
        and e["name"].startswith(PREFIX)
        and (name is None or e["name"] == name)])


def _overlap(a, b) -> float:
    """Microseconds two sorted unions of intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        out += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def host_ms(run, name=None):
    """Host milliseconds a request inside the spans (all, or ``name``)."""
    ivs = intervals(run.slice, name)
    if not ivs:
        return None
    return sum(b - a for a, b in ivs) * 1e-3 / run.slice.requests


def idle_ms(run):
    """Milliseconds a request in which the device is idle and the host is
    inside a span: the spans' union less its overlap with the device
    operations' union."""
    ivs = intervals(run.slice)
    if not ivs:
        return None
    idle = sum(b - a for a, b in ivs) - _overlap(ivs, run.slice.intervals)
    return idle * 1e-3 / run.slice.requests
