"""Counter-based random numbers for the megakernel, in plain torch.

The TPU kernel draws from a per-tile hardware stream
(``pltpu.prng_seed``/``prng_random_bits``), which has no GPU counterpart. The
port keys every draw by ``(seed, pixel id, sample index, bounce index, draw
number)`` and hashes the key, so a draw depends only on what the slot is
doing and not on the launch, pass or block that computes it. The CUDA form
lives in ``csrc/common.cuh`` (``rz_hash32`` and friends); the functions here
give exactly its ``uint32`` results on int64 tensors masked to 32 bits.

Hash: a two-multiply xorshift-multiply mixer (``x ^= x >> 16; x *= C1;
x ^= x >> 15; x *= C2; x ^= x >> 15``) with both multipliers below 2^31, so
a 32-bit value times a multiplier stays below 2^63 and never overflows the
signed int64 arithmetic of torch. Every step is a bijection on 32 bits.

Draw numbers within one kernel iteration: 0-4 spawn the camera ray (x and y
jitter, disk radius, disk angle, time), 5-6 the unit vector, 7 the
cube-root radius of the diffuse sample, 8 the dielectric's Schlick coin.
"""

from __future__ import annotations

import torch

__all__ = ["MASK", "hash32", "slot_key", "step_key", "draw_bits",
           "uniform", "unit3"]

MASK = 0xFFFFFFFF
_C1 = 0x21F0AAAD
_C2 = 0x735A2D97
_GOLDEN = 0x9E3779B9  # draw-number stride (odd, 2^32 / phi)
_TWO_PI = 6.283185307179586


def hash32(x: torch.Tensor) -> torch.Tensor:
    """32-bit mixer on an int64 tensor holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _C1) & MASK
    x = x ^ (x >> 15)
    x = (x * _C2) & MASK
    return x ^ (x >> 15)


def slot_key(seed: int, pix: torch.Tensor) -> torch.Tensor:
    """Per-slot key from the render seed and the flat pixel id (int32
    tensor; a retired slot's -1 wraps to 2^32 - 1 as in C)."""
    s = hash32(torch.tensor(int(seed) & MASK, dtype=torch.int64,
                            device=pix.device))
    return hash32(s ^ (pix.to(torch.int64) & MASK))


def step_key(key0: torch.Tensor, sample: torch.Tensor,
             bounce: torch.Tensor) -> torch.Tensor:
    """Key of one (sample, bounce) step of a slot; ``sample`` and
    ``bounce`` are non-negative integer tensors."""
    k = hash32(key0 ^ sample.to(torch.int64))
    return hash32(k ^ bounce.to(torch.int64))


def draw_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits of draw number ``n`` under ``key``."""
    return hash32((key + n * _GOLDEN) & MASK)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """23 random bits -> float32 in [0, 1) (exactly representable)."""
    return (bits & 0x7FFFFF).to(torch.float32) * (2.0 ** -23)


def unit3(u_z: torch.Tensor, u_phi: torch.Tensor):
    """Uniform unit vector by the cylinder map: z ~ U[-1, 1], phi ~
    U[0, 2pi). One sqrt, one cos and one sin per vector."""
    z = 2.0 * u_z - 1.0
    phi = _TWO_PI * u_phi
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 1e-24))
    return r * torch.cos(phi), r * torch.sin(phi), z
