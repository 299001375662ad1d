"""Counter-based random draws: a frozen copy of the program's stated
estimator, so that the reference traces the very paths the program traces.

A draw is keyed by (render seed, flat pixel id, sample number from 1,
bounce index from 0, draw number) and hashed with a two-multiply
xorshift-multiply mixer on 32 bits, held in int64 tensors. Draw numbers:
0-4 spawn the camera ray (x and y jitter, disk radius, disk angle, time),
5-6 a unit vector, 7 the ball radius, 8 the dielectric's Schlick coin.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_C1 = 0x21F0AAAD
_C2 = 0x735A2D97
_GOLDEN = 0x9E3779B9


def hash32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit mixer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _C1) & MASK
    x = x ^ (x >> 15)
    x = (x * _C2) & MASK
    return x ^ (x >> 15)


def path_keys(seed: int, pix: torch.Tensor,
              sample: torch.Tensor) -> torch.Tensor:
    """The key of each path (pixel ``pix``, sample ``sample`` from 1), to
    which :func:`bounce_key` adds the bounce."""
    s = hash32(torch.tensor(int(seed) & MASK, dtype=torch.int64,
                            device=pix.device))
    key0 = hash32(s ^ (pix.to(torch.int64) & MASK))
    return hash32(key0 ^ sample.to(torch.int64))


def bounce_key(path_key: torch.Tensor, bounce: int) -> torch.Tensor:
    return hash32(path_key ^ int(bounce))


def uniform(key: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Draw ``n`` under ``key``: 23 random bits as a uniform in [0, 1)."""
    bits = hash32((key + n * _GOLDEN) & MASK)
    return (bits & 0x7FFFFF).to(dtype) * (2.0 ** -23)
