"""The traced slice: a ``torch.profiler`` trace of a fixed number of
requests, reduced to what the per-layer readers and the breakdown need.

The trace is written as a Chrome trace into a temporary directory under
``TMPDIR``, read back and deleted. Device operations are the events of
the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the slice is
the span from the first ``request`` annotation's start to the last one's
end, on the trace's own clock.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST = "request"


class Slice:
    """What one traced slice showed. Times in seconds."""

    def __init__(self, events: List[dict], requests: int):
        reqs = [e for e in events if e.get("name") == REQUEST
                and e.get("cat") == "user_annotation"]
        self.requests = requests
        self.t0 = min(e["ts"] for e in reqs)
        self.t1 = max(e["ts"] + e["dur"] for e in reqs)
        self.window_s = (self.t1 - self.t0) * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        self.by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            self.by_name[e["name"]] += e["dur"] * 1e-6
        self.intervals = _union([(max(e["ts"], self.t0),
                                  min(e["ts"] + e["dur"], self.t1))
                                 for e in dev])
        self.busy_s = sum(b - a for a, b in self.intervals) * 1e-6
        self.host = [e for e in events
                     if e.get("cat") in ("user_annotation", "cpu_op",
                                         "cuda_runtime", "cuda_driver")
                     and "dur" in e]

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(t for n, t in self.by_name.items() if match(n))

    def launches(self) -> int:
        return len(self.kernels)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds of the device by what the host was doing: each gap
        between device operations inside the slice is cut into up to 64
        pieces, and each piece goes to the outermost host event (torch
        operation, annotation or CUDA runtime call, on any thread) that
        covers its middle, the latest started where several do."""
        outer = _outermost(self.host)
        out: Dict[str, float] = defaultdict(float)
        edges = [self.t0] + [x for iv in self.intervals for x in iv] + \
            [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            pieces = min(64, max(1, int((b - a) / 5.0)))
            step = (b - a) / pieces
            for k in range(pieces):
                out[_covering(outer, a + (k + 0.5) * step)] += step * 1e-6
        return sorted(out.items(), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, t] for n, t in ops[:10]],
                "idle_gaps": [[n, t] for n, t in self.idle_gaps()[:10]]}


def _outermost(events):
    """Per thread, the host events not nested in another: (starts, ends,
    names) sorted by start."""
    threads = defaultdict(list)
    for e in events:
        if e["name"] != REQUEST:
            threads[e.get("tid")].append(e)
    out = []
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        keep, end = [], -math.inf
        for e in evs:
            if e["ts"] + e["dur"] > end:
                keep.append(e)
                end = e["ts"] + e["dur"]
        out.append(([e["ts"] for e in keep],
                    [e["ts"] + e["dur"] for e in keep],
                    [e["name"] for e in keep]))
    return out


def _covering(outer, t) -> str:
    best, name = -math.inf, "(host, outside any operation)"
    for starts, ends, names in outer:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ends[i] >= t and starts[i] > best:
            best, name = starts[i], names[i]
    return name


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def trace(request, n: int):
    """Run ``request(i)`` for i in range(n) under the profiler, each inside
    a ``request`` annotation, and reduce the trace. Returns the Slice and
    the requests' results."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    results = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            with torch.profiler.record_function(REQUEST):
                results.append(request(i))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return Slice([e for e in events if e.get("ph") == "X"], n), results
