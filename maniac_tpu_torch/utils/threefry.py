"""JAX's default random stream (threefry2x32) in plain torch.

The same bits as ``jax.random`` with ``jax_threefry_partitionable`` on
(the default since JAX 0.5) and 64-bit seeds (x64): ``prng_key``,
``split``, ``fold_in`` and ``uniform`` in float32 and float64, so that one
seed walks the same chain in the port and in the JAX package.

A key is an int64 tensor whose last axis holds two 32-bit words (JAX's raw
uint32 key data); every add and shift is masked to 32 bits, since torch's
uint32 lacks most CPU operations. The functions run on the device of their
key. kernels/threefry.py draws a block's uniforms on the card with a CUDA
kernel and holds it to ``split`` and ``uniform`` here.

The recipe (jax/_src/prng.py): the key schedule (k0, k1, k0 ^ k1 ^
0x1BD11BDA) is added to the counter pair, then 5 groups of 4 rounds
(x0 += x1; x1 = rotl(x1, r); x1 ^= x0), after group i x0 += ks[(i+1) % 3]
and x1 += ks[(i+2) % 3] + i + 1. An array of n values counts its flat
index c as the pair (c >> 32, c & 0xFFFFFFFF).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_ONE_BITS = 0x3F800000          # 1.0f: 23 mantissa bits below it
F64_ONE_BITS = 0x3FF0000000000000  # 1.0: 52 mantissa bits below it


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words (seed >> 32, seed & 0xFFFFFFFF)
    of the seed as a 64-bit integer; (2,) int64."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter pairs (x0, x1) under the key (k0, k1):
    int64 tensors of 32-bit words, broadcast together. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _counters(n: int, device):
    c = torch.arange(n, dtype=torch.int64, device=device)
    return c >> 32, c & MASK


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """jax.random.split(key, n): row j is threefry(key, (j >> 32, j &
    0xFFFFFFFF)); (n, 2) int64."""
    hi, lo = _counters(n, key.device)
    y0, y1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data), data a 32-bit word: threefry(key,
    (0, data)); (2,) int64."""
    d = torch.tensor([0, int(data) & MASK], dtype=torch.int64,
                     device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], d[0], d[1])
    return torch.stack([y0, y1])


def _to_uniform(x0, x1, dtype: torch.dtype) -> torch.Tensor:
    """jax.random.uniform's conversion of threefry's output words to [0, 1)
    in ``dtype``: float32 takes the top 23 bits of x0 ^ x1, float64 the top
    52 of (x0 << 32) | x1, as the mantissa of a value in [1, 2), minus 1,
    then max(0, .)."""
    if dtype == torch.float32:
        bits = ((x0 ^ x1) >> 9) | F32_ONE_BITS
        f = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        # (((x0 << 32) | x1) >> 12) without leaving 63 bits
        bits = (x0 << 20) | (x1 >> 12) | F64_ONE_BITS
        f = bits.view(torch.float64)
    else:
        raise ValueError(f"uniform: dtype {dtype} (float32 or float64)")
    return torch.clamp(f - 1.0, min=0.0)


def uniform(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype) on [0, 1); keys of shape (...,
    2) draw one array each, shaped (..., *shape)."""
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape), key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return _to_uniform(y0, y1, dtype).reshape(*key.shape[:-1], *shape)
