"""Faults planted under the timed path, each of which a cell's check must
turn into ``correct`` false: the readings that set the limits' upper ends
(``python3 -m benchmark.control --fault <name>``) and the tests.

Each is a context manager that patches the program's public entry the
traffic calls and restores it on exit. A cell on one card has no exchange
between cards to leave out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def stale():
    """A render that returns its first image again (its state unchanged)."""
    import rayz_tpu_torch as rtt
    real, first = rtt.render_fast, []

    def fake(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]
    return _patched(rtt, "render_fast", fake)


def half():
    """A render with half its samples left out, the mean over the rest."""
    import rayz_tpu_torch as rtt
    real = rtt.render_fast

    def fake(scene, camera, seed, config, **k):
        return real(scene, camera, seed,
                    config._replace(spp=max(1, config.spp // 2)), **k)
    return _patched(rtt, "render_fast", fake)


def altered():
    """Each image scaled by 1.05 where it is produced."""
    import rayz_tpu_torch as rtt
    real = rtt.render_fast
    return _patched(rtt, "render_fast", lambda *a, **k: real(*a, **k) * 1.05)


def frozen():
    """A train step that leaves the parameters as they were."""
    import rayz_tpu_torch as rtt
    real = rtt.make_train_step

    def fake(optimizer, *a, **k):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        return real(torch.optim.SGD(params, lr=0.0), *a, **k)
    return _patched(rtt, "make_train_step", fake)


def half_samples():
    """A train step that traces half its samples per pixel, the mean taken
    over them."""
    import rayz_tpu_torch as rtt
    real = rtt.make_train_step

    def fake(optimizer, config, *a, **k):
        return real(optimizer, config._replace(spp=max(1, config.spp // 2)),
                    *a, **k)
    return _patched(rtt, "make_train_step", fake)


def loss_altered():
    """The loss, and so its gradient, scaled by 1.1 where it is produced."""
    from rayz_tpu_torch.diff import inverse
    real = inverse.pixel_loss

    def fake(*a, **k):
        out = real(*a, **k)
        return (out[0] * 1.1, out[1]) if isinstance(out, tuple) \
            else out * 1.1
    return _patched(inverse, "pixel_loss", fake)


RENDER = {"stale": stale, "half": half, "altered": altered}
TRAIN = {"frozen": frozen, "half_samples": half_samples,
         "loss_altered": loss_altered}
