"""Chained f32 primitives and the framework Coulomb pass's plane math:
CUDA kernels and plain versions (micro-benchmarks of the primitives the
block and step kernels are built from).

``vpu_chain`` replaces tools/vpu_bench.py::run's Pallas kernel
(``kernel``): n loop-carried applications of one op of ``VPU_OPS`` to every
element of a plane. ``cpass`` replaces tools/vpu_bench.py::run_cpass's
kernel (``kern``): n passes of the framework Coulomb plane math, with the
per-row scalars from column 0 of the planes or, ``transposed``, from a
(4, R) table. For CUDA tensors both launch csrc/vpu.cu; for CPU tensors
they run ``vpu_chain_plain`` and ``cpass_plain``, loops of torch ops with
the JAX tool's constants.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .resync import _check

VPU_OPS = ("fma", "mul2", "div", "rsqrt", "sqrt", "exp", "round", "cmpsel",
           "erfc")
# tools/vpu_bench.py's erfc cost probe: the A&S 7.1.26 coefficients applied
# highest power first (not erfc)
ERFC_PROBE = (0.254829592, -0.284496736, 1.421413741, -1.453152027,
              1.061405429)
# run_cpass's box (two wrapped axes), Ewald alpha and squared cut-off
CPASS_BOX = 34.0
CPASS_ALPHA = 0.52
CPASS_RC2 = 72.25
# the kernels against their plain versions, relative per element: K7 n *
# 2^-23 = 6.1e-5 for n = 512 chained fma's (one rounding in the kernel's
# FMA, two in torch's multiply then add; the other ops contract or round
# alike); K8 exp(-(alpha r)^2) turns an ulp of r into up to some 40 ulp of
# a term at the cut-off, and 5e-5 (some 400 ulp) leaves room for the
# libraries' exp and rsqrt
VPU_RTOL = 1e-4
CPASS_RTOL = 5e-5


def _erfc_probe(x: torch.Tensor) -> torch.Tensor:
    t = 1.0 / (1.0 + 0.3275911 * x)
    acc = ERFC_PROBE[0] * t + ERFC_PROBE[1]
    for c in ERFC_PROBE[2:]:
        acc = acc * t + c
    return acc * torch.exp(-x * x)


_PLAIN_OPS = {
    "fma": lambda x: x * 1.000001 + 1e-6,
    "mul2": lambda x: (x * 1.000001) * 0.999999,
    "div": lambda x: 1.0 / (x + 1.0),
    "rsqrt": lambda x: torch.rsqrt(x + 1.0),
    "sqrt": lambda x: torch.sqrt(x + 1.0),
    "exp": lambda x: torch.exp(-x),
    "round": lambda x: x - torch.round(x * 0.3),
    "cmpsel": lambda x: torch.where(x > 0.5, x * 0.999, x * 1.001),
    "erfc": _erfc_probe,
}


def vpu_chain_plain(x: torch.Tensor, op: str, n: int) -> torch.Tensor:
    """Plain torch version: op applied n times."""
    f = _PLAIN_OPS[op]
    for _ in range(n):
        x = f(x)
    return x


def vpu_chain(x: torch.Tensor, op: str, n: int) -> torch.Tensor:
    """op (one of VPU_OPS) applied n times to every element of x (f32)."""
    if op not in VPU_OPS:
        raise ValueError(f"unknown op {op!r} (one of {', '.join(VPU_OPS)})")
    if x.device.type == "cpu":
        return vpu_chain_plain(x, op, n)
    _check("x", x, tuple(x.shape), torch.float32, x.device)
    out = torch.empty_like(x)
    build.launch("vpu_chain_launch", [x.data_ptr(), out.data_ptr()],
                 [x.numel(), n, VPU_OPS.index(op)], [])
    vpu_chain.launches += 1
    return out


vpu_chain.launches = 0


def _offset(i: int) -> float:
    """The pass's per-iteration offset (i % 7) * 0.1, rounded in f32 as the
    JAX tool computes it."""
    return float(np.float32(i % 7) * np.float32(0.1))


def cpass_plain(px, py, pz, q, rows, n: int, transposed: bool):
    """Plain torch version of ``cpass``: the n passes as plane ops."""
    acc = torch.zeros_like(px)
    inv_box = 1.0 / CPASS_BOX
    for i in range(n):
        t = _offset(i)
        if transposed:
            rr = rows + t
            bx, by, bz, qw = (rr[k][:, None] for k in range(4))
        else:
            bx, by, bz = px[:, :1] + t, py[:, :1] + t, pz[:, :1] + t
            qw = q[:, :1]
        dx, dy, dz = px - bx, py - by, pz - bz
        dx = dx - CPASS_BOX * torch.round(dx * inv_box)
        dy = dy - CPASS_BOX * torch.round(dy * inv_box)
        r2 = torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-18)
        inv_r = torch.rsqrt(r2)
        e = _erfc_probe(CPASS_ALPHA * (r2 * inv_r))
        coulf = qw * q * e * inv_r
        acc = acc + torch.where(r2 < CPASS_RC2, coulf, 0.0)
    return acc


def cpass(px, py, pz, q, rows, n: int, transposed: bool) -> torch.Tensor:
    """The framework Coulomb pass's plane math n times on (R, C) f32 planes
    px, py, pz, q with a (4, R) table ``rows`` (read when ``transposed``):
    the (R, C) sum of the cut-off Coulomb terms."""
    if px.device.type == "cpu":
        return cpass_plain(px, py, pz, q, rows, n, transposed)
    R, C = px.shape
    for name, t in (("px", px), ("py", py), ("pz", pz), ("q", q)):
        _check(name, t, (R, C), torch.float32, px.device)
    _check("rows", rows, (4, R), torch.float32, px.device)
    out = torch.empty_like(px)
    build.launch("cpass_launch", [t.data_ptr() for t in (px, py, pz, q, rows,
                                                         out)],
                 [R, C, n, int(transposed)], [])
    cpass.launches += 1
    return out


cpass.launches = 0
