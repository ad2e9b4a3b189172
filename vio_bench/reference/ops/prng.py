"""Bit-exact port of the JAX PRNG functions RANSAC draws from.

JAX's default generator here is ``threefry2x32`` with
``jax_threefry_partitionable=True``: ``split`` and ``random_bits`` hash the
64-bit flat counter (hi, lo words) under the key, and 32-bit draws are
``bits1 ^ bits2``. Keys are (..., 2) int64 tensors holding uint32 words;
every operation masks to 32 bits. The same code runs on the CPU and on the
card, so the front-end draws the same hypotheses as the JAX package.
"""

from __future__ import annotations

import torch

from vio_bench.reference.core.device import const
from vio_bench.reference.core.scan import cumsum

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011, as in jax._src.prng)."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return const((0, seed & _M32), torch.int64, device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` with an int32 (tensor) datum; key (..., 2) and
    data (...) broadcast, so one key folds in per-lane data (as under vmap)."""
    d = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _counters(n: int, device):
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return torch.zeros_like(lo), lo


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key (..., 2) -> (..., num, 2)."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words (as int64), key (..., 2) -> (..., *shape), row-major
    counters per key."""
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform`` in [0, 1), float32."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def choice_p(key: torch.Tensor, n: int, shape, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=True, p=p)``: inverse-CDF
    sampling, ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))`` (left).
    key (..., 2), p (..., n) -> (..., *shape), one draw per lane."""
    lead = key.shape[:-1]
    p_cuml = cumsum(p, dim=-1).contiguous()
    total = p_cuml[..., -1].reshape(*lead, *([1] * len(shape)))
    r = (total * (1 - uniform(key, shape))).reshape(*lead, -1)
    return torch.searchsorted(p_cuml, r).reshape(*lead, *shape).to(torch.int32)
