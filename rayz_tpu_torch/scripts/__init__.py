"""The port's checking and measuring scripts, the counterparts of the
repository's ``scripts/`` (``rayz_tpu_torch.bench`` is the root
``bench.py``'s):

* :mod:`.gpu_check` — each stochastic engine and the gradients against the
  dense integrator at an independent seed (``scripts/tpu_check.py``);
* :mod:`.bench_configs` — forward Mrays/s of the four BASELINE configs;
* :mod:`.bench_culling` — the ``sphere_field`` scaling rows.

Each runs on the card unless the caller asks for the CPU (``--device
cpu``, the kernels' plain versions), and raises on a machine without one.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device) -> torch.device:
    """The device a script runs on; ``"cuda"`` raises when torch sees no
    card (a measurement never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device: these scripts run on "
                           "an NVIDIA GPU, or on the CPU's plain versions "
                           "with --device cpu")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card(dev: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (``"cpu"`` on the
    CPU)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]
