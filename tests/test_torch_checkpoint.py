"""Checkpoints of the port's fit (rayz_tpu_torch/diff/checkpoint.py and
fit(checkpoint_dir=...)), mirroring tests/test_config5.py:63-101 on the
JAX package: an interrupted fit resumed from its checkpoint reproduces the
uninterrupted run's loss history and parameters bit for bit (the Adam
state and the step-seed generator are checkpointed), and a resume of a
completed fit runs nothing. The mesh path's resume is held the same way in
tests/test_torch_parallel.py (two and three gloo processes)."""

import os

import pytest
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.diff import (latest_step, restore_checkpoint,
                                 save_checkpoint)

torch.set_num_threads(2)


def _wrong_scene(dtype=torch.float64):
    scene, cam = rtt.scenes.two_sphere(width=12, height=12, dtype=dtype,
                                       device="cpu")
    cfg = rtt.RenderConfig(spp=1, max_depth=3)
    target = rtt.render(scene, cam, 42, cfg)
    tex = scene.tex_color.clone()
    tex[1] = torch.tensor([0.2, 0.8, 0.9], dtype=dtype)
    return rtt.inject_params(scene, {"tex_color": tex}), cam, cfg, target


@pytest.mark.parametrize("engine", ["dense", "recorded-pp"])
def test_fit_checkpoint_resume_same_trajectory(tmp_path, engine):
    wrong, cam, cfg, target = _wrong_scene()
    kw = dict(config=cfg, learning_rate=5e-2, fields=("tex_color",), seed=1,
              engine=engine)
    ref, hist_ref = rtt.fit(wrong, cam, target, steps=6, **kw)

    ckpt = str(tmp_path / "resume")
    _, hist_a = rtt.fit(wrong, cam, target, steps=3, checkpoint_dir=ckpt,
                        checkpoint_every=3, **kw)
    assert latest_step(ckpt) == 3
    res, hist_b = rtt.fit(wrong, cam, target, steps=6, checkpoint_dir=ckpt,
                          checkpoint_every=3, **kw)
    assert len(hist_b) == 3  # only the remaining steps ran
    assert latest_step(ckpt) == 6
    assert torch.equal(res.tex_color, ref.tex_color)
    assert hist_a + hist_b == hist_ref
    assert hist_ref[-1] < hist_ref[0]


def test_fit_resume_noop_when_complete(tmp_path):
    scene, cam = rtt.scenes.two_sphere(width=8, height=8,
                                       dtype=torch.float64, device="cpu")
    cfg = rtt.RenderConfig(spp=1, max_depth=2)
    target = rtt.render(scene, cam, 0, cfg)
    kw = dict(config=cfg, learning_rate=1e-2, fields=("tex_color",), seed=1,
              checkpoint_dir=str(tmp_path / "done"), checkpoint_every=2)
    a, hist_a = rtt.fit(scene, cam, target, steps=4, **kw)
    assert len(hist_a) == 4
    assert sorted(os.listdir(tmp_path / "done")) == ["step_2", "step_4"]
    b, hist = rtt.fit(scene, cam, target, steps=4, **kw)
    assert hist == []  # already complete: restores and runs nothing
    assert torch.equal(a.tex_color, b.tex_color)


def test_save_restore_latest(tmp_path):
    d = str(tmp_path / "c")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d)
    gen = torch.Generator().manual_seed(3)
    state = {"params": {"x": torch.arange(3.0)}, "step": 7,
             "generator": gen.get_state(), "nested": [1, (2.5, "a")]}
    path = save_checkpoint(d, 7, state)
    save_checkpoint(d, 12, {"step": 12})
    (tmp_path / "c" / "step_x").write_text("not a step")
    assert os.path.basename(path) == "step_7" and latest_step(d) == 12
    got = restore_checkpoint(d, 7)
    assert torch.equal(got["params"]["x"], state["params"]["x"])
    assert got["nested"] == [1, (2.5, "a")]
    assert torch.equal(got["generator"], state["generator"])
    assert restore_checkpoint(d) == {"step": 12}
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
