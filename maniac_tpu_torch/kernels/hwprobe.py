"""One-hot f32 product of the hardware-precision probe: CUDA kernel and
plain version.

``onehot_product`` replaces the Pallas kernel of
maniac_tpu/utils/hwprobe.py::probe_onehot_exact (inner ``k``). For CUDA
tensors it launches csrc/hwprobe.cu (f32 FMA on the CUDA cores, no TF32);
for CPU tensors it runs ``onehot_product_plain``, ``x @ oh`` in torch.
utils/hwprobe.py holds both to exactness.
"""

from __future__ import annotations

import torch

from . import build
from .resync import _check


def onehot_product_plain(x: torch.Tensor, oh: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the matrix product x @ oh."""
    return x @ oh


def onehot_product(x: torch.Tensor, oh: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) f32 product, computed by f32 FMA."""
    if not x.is_cuda and x.device.type == "cpu":
        return onehot_product_plain(x, oh)
    # one test for operands that pass; _check names what fails
    if not (x.dtype == torch.float32 and oh.dtype == torch.float32
            and x.dim() == 2 and oh.dim() == 2 and x.shape[1] == oh.shape[0]
            and x.is_contiguous() and oh.is_contiguous()
            and oh.device == x.device):
        if x.dim() != 2 or oh.dim() != 2 or x.shape[1] != oh.shape[0]:
            raise ValueError(f"onehot_product: shapes {tuple(x.shape)} and "
                             f"{tuple(oh.shape)} do not multiply")
        _check("x", x, tuple(x.shape), torch.float32, x.device)
        _check("oh", oh, tuple(oh.shape), torch.float32, x.device)
    (M, K), N = x.shape, oh.shape[1]
    out = x.new_empty((M, N))
    build.launch("onehot_launch", (x.data_ptr(), oh.data_ptr(),
                                   out.data_ptr()), (M, K, N), (),
                 x.device)
    return out
