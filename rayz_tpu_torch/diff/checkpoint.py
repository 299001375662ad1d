"""Checkpoints of an inverse-rendering fit.

PyTorch counterpart of :mod:`rayz_tpu.diff.checkpoint`, with
``torch.save``/``torch.load`` in place of orbax: a fit's state (its
trainable parameters, the Adam ``state_dict``, the step number and the
``torch.Generator`` state its step seeds come from) is saved under
``directory/step_{n}`` so that :func:`rayz_tpu_torch.diff.fit` can resume
on the trajectory an uninterrupted run takes.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Save ``state`` (nested dicts, lists and tuples of tensors and
    Python scalars) as ``directory/step_{step}``; returns the path. The
    file is written beside its final name and then renamed, so a reader
    never sees half of it."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest ``n`` of the ``step_{n}`` checkpoints in ``directory``,
    or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location=None) -> Any:
    """The state saved at ``step`` (default: the latest), its tensors on
    ``map_location`` (default: where they were saved). Loaded with
    ``weights_only=True``: tensors and plain containers only, no code.
    JAX's ``template`` has no counterpart (``torch.load`` restores the
    structure as saved)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(_path(directory, step), map_location=map_location,
                      weights_only=True)
