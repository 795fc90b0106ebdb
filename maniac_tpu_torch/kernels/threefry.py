"""A block's random stream: CUDA kernel and plain version.

``split_uniform`` splits each replica's key and draws the block's uniforms
from the subkey, as the JAX package does a block with jax.random
(maniac_tpu/mc/driver.py::run_steps and block_body_group): for CUDA keys
it launches csrc/threefry.cu (one launch a block); for CPU keys it runs
``split_uniform_plain``, the same function in plain torch
(utils/threefry.py). No TPU kernel is replaced: JAX runs threefry as an
XLA op.
"""

from __future__ import annotations

import torch

from ..mc.moves import N_UNIFORMS
from ..utils.threefry import threefry2x32, uniform
from . import build


def split_uniform_plain(keys: torch.Tensor, n_steps: int,
                        dtype: torch.dtype):
    """keys (B, 2) int64 -> (the next keys (B, 2), uniforms (B, n_steps,
    21) in ``dtype``): per replica (k_next, k_sub) = split(k) and
    uniform(k_sub, (n_steps, 21))."""
    k0, k1 = keys[:, 0], keys[:, 1]
    zero = torch.zeros_like(k0)
    n0, n1 = threefry2x32(k0, k1, zero, zero)
    s0, s1 = threefry2x32(k0, k1, zero, zero + 1)
    u = uniform(torch.stack([s0, s1], dim=-1), (n_steps, N_UNIFORMS), dtype)
    return torch.stack([n0, n1], dim=-1), u


def split_uniform(keys: torch.Tensor, n_steps: int, dtype: torch.dtype):
    """split_uniform_plain's result; on the card from one launch of
    csrc/threefry.cu, which writes new key and uniform tensors."""
    if keys.device.type == "cpu":
        return split_uniform_plain(keys, n_steps, dtype)
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"split_uniform: keys must be (B, 2) int64, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"split_uniform: dtype {dtype} (float32 or "
                         f"float64)")
    keys = keys.contiguous()
    B = keys.shape[0]
    new_keys = torch.empty_like(keys)
    out = torch.empty((B, n_steps, N_UNIFORMS), dtype=dtype,
                      device=keys.device)
    build.launch("threefry_launch",
                 (keys.data_ptr(), new_keys.data_ptr(), out.data_ptr()),
                 (B, n_steps * N_UNIFORMS, int(dtype == torch.float64)), (),
                 keys.device)
    return new_keys, out
