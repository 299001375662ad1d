"""Profiling and render metrics.

PyTorch counterpart of :mod:`rayz_tpu.utils.profiling`. The reference's
only observability is a wall-clock line after each render: seconds, rays/s
and us/ray from the camera-ray count (rayz.zig:24-34). Here:

* :func:`timed_render`: the same metric for any render function of the
  port, with the device synchronised and the image brought to the host
  inside the timed region, and the kernels' build left out (a warm-up).
* :func:`trace`: a ``torch.profiler`` trace of a block (host and, on the
  card, CUDA activity: each kernel launch and its device time), written as
  a Chrome trace into a directory (``chrome://tracing`` or Perfetto reads
  it), the counterpart of JAX's XProf dump.
* :func:`span`: a named stage of the render path, recorded only while a
  ``torch.profiler`` is on (:func:`trace`, or any other profile): a
  ``user_annotation`` event ``rayz.<name>`` on the profiler's clock, in the
  same trace as the kernels and copies it launches. With no profiler
  running it is one check and nothing more. The render paths mark flat
  stages, none inside another. The megakernel's (``render_fast`` ->
  ``render_megakernel`` -> ``_trace_shard_queue``):

  - ``rayz.dispatch``: the engine pick in ``render_fast`` and the table
    mode's resolution in ``render_megakernel`` (two a ``render_fast``
    render; the wavefront and dense engines have only the first);
  - ``rayz.tables``: the tables, camera vector and (streamed) packed
    records of the render (``_launch_args``): their lookup in the memos of
    ``ops/tables.py``, and their build where the scene is new or changed;
  - ``rayz.tables_built``: empty, right after ``rayz.tables`` where that
    built the scene's tables (none on a memo hit);
  - ``rayz.queue``: each queue launch with its argument checks
    (``_queue``), one a sample group;
  - ``rayz.fold``: each fold of a sample group (``_fold``);
  - ``rayz.finish``: the image's reshape, division by spp and cast.

  The wavefront's (``render_fast`` -> ``render_wavefront``), after the
  dispatch:

  - ``rayz.tables`` and ``rayz.tables_built``, as the megakernel's: the
    (streamed) tables, the scene's bounds, the camera vector, the slot ->
    pixel table and the ray ids;
  - ``rayz.bounce``: each synchronous bounce's launch with its input
    checks, and the addition of its radiance (one a bounce, the first
    ``ops/wavefront.py``'s ``N_SYNC`` = 3);
  - ``rayz.tail``: the same for the tail launch, which carries every
    bounce after the synchronous ones, unsorted (one where ``max_depth``
    exceeds ``N_SYNC``);
  - ``rayz.sort``: each sort or dead-last partition between launches with
    its permutation of the ray planes;
  - ``rayz.finish``: the radiance scattered back to ray order, the sum
    over samples in order, the image's scatter, division by spp and cast.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Iterator

import torch

__all__ = ["RenderStats", "timed_render", "trace", "span"]

_OFF = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class RenderStats:
    """Render timing in the reference's units (rayz.zig:30-34)."""

    seconds: float
    rays: int  # camera rays = pixels * spp (renderer.zig:90-92 convention)
    image: object  # the image on the host

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else float("inf")

    @property
    def us_per_ray(self) -> float:
        return self.seconds / self.rays * 1e6 if self.rays else 0.0

    def summary(self) -> str:
        """The reference's perf line format (rayz.zig:30-34)."""
        return (f"Finished render ({self.seconds:.2f}s): "
                f"{self.rays_per_s:.2f} rps and {self.us_per_ray:.2f} "
                f"us per ray")


def _to_host(img: torch.Tensor) -> torch.Tensor:
    """Wait for the card's work, then copy the image to the host."""
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    return img.cpu()


def timed_render(render_fn: Callable[[], torch.Tensor], *, width: int,
                 height: int, spp: int, warmup: bool = True,
                 best_of: int = 1) -> RenderStats:
    """Time ``render_fn`` (no arguments, returns an image tensor), the
    first call (the kernels' build) excluded by a warm-up. Each timed run
    ends when the image is on the host: ``torch.cuda.synchronize`` on the
    card, then the copy (a renderer needs the image there anyway).
    ``best_of`` repeats the timed run and keeps the fastest."""
    if warmup:
        _to_host(render_fn())
    best = float("inf")
    img = None
    for _ in range(max(1, best_of)):
        start = time.perf_counter()
        img = _to_host(render_fn())
        best = min(best, time.perf_counter() - start)
    return RenderStats(seconds=best, rays=width * height * spp, image=img)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace of everything inside the block: host
    activity, and CUDA activity (kernel launches and their device time)
    where torch sees a card. On exit the trace is written into
    ``log_dir`` as ``trace.json`` (Chrome trace format); the profiler is
    yielded, so ``prof.key_averages()`` gives the time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A context manager marking the stage ``name`` as the profiler event
    ``rayz.<name>`` while a ``torch.profiler`` records, and doing nothing
    otherwise (the one check costs well under a microsecond, where an
    unchecked ``record_function`` costs ~10)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"rayz.{name}")
    return _OFF
