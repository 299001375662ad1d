"""The port's counter-based generator (rayz_tpu_torch/ops/rng.py) against a
numpy uint32 reference of the same hash. The CUDA form in csrc/common.cuh
computes in uint32, so bit equality with numpy's wrapping uint32 arithmetic
is what lets the kernel and the plain version draw the same numbers."""

import numpy as np
import pytest
import torch

from rayz_tpu_torch.ops import rng

torch.set_num_threads(2)


def _np_hash32(x):
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x21F0AAAD)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x735A2D97)
        x = x ^ (x >> np.uint32(15))
    return x


def _np_draw(seed, pix, sample, bounce, draw):
    with np.errstate(over="ignore"):
        k0 = _np_hash32(_np_hash32(np.uint32(seed & 0xFFFFFFFF))
                        ^ pix.astype(np.int32).view(np.uint32))
        k = _np_hash32(_np_hash32(k0 ^ sample.astype(np.uint32))
                       ^ bounce.astype(np.uint32))
        return _np_hash32(k + draw.astype(np.uint32) * np.uint32(0x9E3779B9))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64))


def test_hash32_matches_uint32_reference():
    r = np.random.default_rng(0)
    x = np.concatenate([r.integers(0, 2**32, 1 << 16, dtype=np.uint64),
                        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1])])
    np.testing.assert_array_equal(rng.hash32(_t(x)).numpy(),
                                  _np_hash32(x).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 + 5])
def test_keyed_draws_match_uint32_reference(seed):
    r = np.random.default_rng(1)
    n = 1 << 14
    pix = r.integers(-1, 1 << 18, n).astype(np.int32)
    sample = r.integers(0, 65, n)
    bounce = r.integers(0, 33, n)
    draw = r.integers(0, 9, n)
    key = rng.step_key(rng.slot_key(seed, torch.from_numpy(pix)),
                       _t(sample), _t(bounce))
    got = torch.stack([rng.draw_bits(key[i:i + 1], int(draw[i]))[0]
                       for i in range(256)])
    want = _np_draw(seed, pix, sample, bounce, draw)
    np.testing.assert_array_equal(got.numpy(), want[:256].astype(np.int64))
    # vectorized over the draw number too (as the kernel's draws 0-8)
    for d in range(9):
        np.testing.assert_array_equal(
            rng.draw_bits(key, d).numpy(),
            _np_draw(seed, pix, sample, bounce, np.full(n, d)).astype(np.int64))


def test_uniform_is_23_bit_unit_interval():
    bits = _t(np.random.default_rng(2).integers(0, 2**32, 1 << 16,
                                                dtype=np.uint64))
    u = rng.uniform(torch.cat([bits, _t(np.array([0, 2**32 - 1]))]))
    assert u.dtype == torch.float32
    assert float(u.min()) == 0.0 and float(u.max()) < 1.0
    assert float(u.max()) == 1.0 - 2.0 ** -23
    scaled = u.double() * 2**23
    assert torch.equal(scaled, torch.round(scaled))  # exactly 23 bits
    # a fair hash: the mean of 65k draws sits within 5 sigma of 1/2
    assert abs(float(u.double().mean()) - 0.5) < 5 * (1 / 12 / u.numel()) ** 0.5


def test_unit3_is_on_the_sphere():
    r = np.random.default_rng(3)
    uz = torch.from_numpy(r.random(4096).astype(np.float32))
    up = torch.from_numpy(r.random(4096).astype(np.float32))
    x, y, z = rng.unit3(uz, up)
    norm = (x.double() ** 2 + y.double() ** 2 + z.double() ** 2).sqrt()
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-6)
