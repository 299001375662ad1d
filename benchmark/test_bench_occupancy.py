"""The reader of the queue megakernel's warps an SM
(``queue_warps_per_sm.render``) on hand-built slices: the launch geometry
of a kernel event's ``args`` as the device trace gives it."""

import types

import pytest

from benchmark import harness, tracing

H100 = "NVIDIA H100 80GB HBM3"
QUEUE = ("void (anonymous namespace)::megakernel_queue<(anonymous "
         "namespace)::ResidentSweep<false, 1024> >((anonymous "
         "namespace)::QueueParams)")


def _read(kernels, device_kind=H100):
    ev = [{"ph": "X", "name": "request", "cat": "user_annotation", "ts": 0,
           "dur": 1000 * len(kernels)}]
    for i, (name, args) in enumerate(kernels):
        ev.append({"ph": "X", "name": name, "cat": "kernel",
                   "ts": 1000 * i + 10, "dur": 900, "args": args})
    run = types.SimpleNamespace(slice=tracing.Slice(ev, 1),
                                device_kind=device_kind)
    return harness.load_module(
        harness.ROOT / "metrics" / "queue_warps_per_sm.render.py").read(run)


@pytest.mark.parametrize("block, warps", [(128, 4.0), (1024, 32.0)])
def test_warps_from_grid_and_block(block, warps):
    """One block an SM of 128 or 1,024 threads on the H100's 132 SMs, read
    twice (two renders), beside another kernel that does not count."""
    args = {"grid": [132, 1, 1], "block": [block, 1, 1]}
    got = _read([(QUEUE, args), ("fold_kernel", {"grid": [3072, 1, 1],
                                                 "block": [256, 1, 1]}),
                 (QUEUE, args)])
    assert got == pytest.approx(warps)


def test_kinetos_own_warps_first():
    args = {"grid": [1056, 1, 1], "block": [128, 1, 1], "warps per SM": 32.0}
    assert _read([(QUEUE, args)], device_kind="another card") == 32.0


@pytest.mark.parametrize("kernels, device_kind", [
    ([("fold_kernel", {"grid": [132, 1, 1], "block": [128, 1, 1]})], H100),
    ([(QUEUE, {})], H100),
    ([(QUEUE, {"grid": [132, 1, 1]})], H100),
    ([(QUEUE, {"grid": [132, 1, 1], "block": [128, 1, 1]})], "another card")],
    ids=["no_queue_launch", "no_args", "no_block", "unknown_card"])
def test_nothing_to_read(kernels, device_kind):
    assert _read(kernels, device_kind) is None


def test_no_slice():
    run = types.SimpleNamespace(slice=None, device_kind=H100)
    assert harness.load_module(
        harness.ROOT / "metrics" / "queue_warps_per_sm.render.py"
    ).read(run) is None
