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
    if x.device.type == "cpu":
        return onehot_product_plain(x, oh)
    if x.dim() != 2 or oh.dim() != 2 or x.shape[1] != oh.shape[0]:
        raise ValueError(f"onehot_product: shapes {tuple(x.shape)} and "
                         f"{tuple(oh.shape)} do not multiply")
    (M, K), N = x.shape, oh.shape[1]
    _check("x", x, (M, K), torch.float32, x.device)
    _check("oh", oh, (K, N), torch.float32, x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch("onehot_launch", [x.data_ptr(), oh.data_ptr(),
                                   out.data_ptr()], [M, K, N], [])
    onehot_product.launches += 1
    return out


onehot_product.launches = 0
