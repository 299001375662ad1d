"""The port's profiling utilities (rayz_tpu_torch/utils/profiling.py),
mirroring tests/test_profiling.py: RenderStats keeps the reference's units
and perf-line format (rayz.zig:24-34), timed_render counts camera rays and
returns the image on the host, and trace() writes a torch.profiler trace
(here of host activity: the CPU has no CUDA activity to record)."""

import json
import os

import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.utils.profiling import RenderStats, timed_render, trace


def test_render_stats_units_and_format():
    st = RenderStats(seconds=2.0, rays=4_000_000, image=None)
    assert st.rays_per_s == 2_000_000
    assert abs(st.us_per_ray - 0.5) < 1e-12
    s = st.summary()
    assert "Finished render (2.00s)" in s
    assert "rps" in s and "us per ray" in s
    assert RenderStats(seconds=0.0, rays=1, image=None).rays_per_s == \
        float("inf")


def test_timed_render_counts_camera_rays():
    calls = []

    def render():
        calls.append(1)
        return torch.zeros((4, 4, 3))

    st = timed_render(render, width=4, height=4, spp=7, best_of=2)
    assert st.rays == 4 * 4 * 7
    assert st.seconds > 0
    assert st.image.shape == (4, 4, 3) and st.image.device.type == "cpu"
    assert len(calls) == 3  # one warm-up, two timed


def test_trace_produces_dump(tmp_path):
    scene, cam = rtt.scenes.two_sphere(width=8, height=8, device="cpu")
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        rtt.render(scene, cam, 0, rtt.RenderConfig(spp=1, max_depth=2))
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert any(a.key.startswith("aten::") for a in prof.key_averages())
