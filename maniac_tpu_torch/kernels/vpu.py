"""Chained f32 primitives and the framework Coulomb pass's plane math:
CUDA kernels and plain versions (micro-benchmarks of the primitives the
block and step kernels are built from).

``vpu_chain`` replaces tools/vpu_bench.py::run's Pallas kernel
(``kernel``): n loop-carried applications of one op of ``VPU_OPS`` to every
element of a plane; its reciprocal, root and reciprocal root are the
branch-free primitives of csrc/prims.cuh, which ``prim_check`` holds bit
for bit to the expressions they replace over their domains
(``PRIM_DOMAINS``). ``cpass`` replaces tools/vpu_bench.py::run_cpass's
kernel (``kern``): n passes of the framework Coulomb plane math, with the
per-row scalars from column 0 of the planes or, ``transposed``, from a
(4, R) table. For CUDA tensors both launch csrc/vpu.cu; for CPU tensors
they run ``vpu_chain_plain`` and ``cpass_plain``, loops of torch ops with
the JAX tool's constants. ``cpass``'s kernel takes one element a thread
and runs the n passes as groups of the seven offsets CPASS_OFFSETS.
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
    """op (one of VPU_OPS) applied n times to every element of x (f32).

    For elements in [0, 2^64] every input the chain gives a primitive of
    csrc/prims.cuh stays inside its domain (PRIM_DOMAINS) for any n: the
    kernel then gives the bits of the chain with the expressions the
    primitives replace (div, rsqrt and sqrt take x + 1 >= 1, and their
    results stay at or above 0; erfc's reciprocal takes 1 + 0.3275911 x,
    and the probe's value lies in [0, 1.07])."""
    if op not in VPU_OPS:
        raise ValueError(f"unknown op {op!r} (one of {', '.join(VPU_OPS)})")
    if x.device.type == "cpu":
        return vpu_chain_plain(x, op, n)
    _check("x", x, tuple(x.shape), torch.float32, x.device)
    out = torch.empty_like(x)
    build.launch("vpu_chain_launch", [x.data_ptr(), out.data_ptr()],
                 [x.numel(), n, VPU_OPS.index(op)], [], x.device)
    vpu_chain.launches += 1
    return out


vpu_chain.launches = 0


# the branch-free primitives of csrc/prims.cuh, in vpu.cu's PrimId order,
# with the domain each keeps the bits of its expression on (prims.cuh
# states the same bounds)
PRIMS = ("rcp", "sqrt", "rsqrt")
PRIM_DOMAINS = {
    "rcp": (float.fromhex("0x1p-126"), float.fromhex("0x1p+126")),
    "sqrt": (float.fromhex("0x1p-102"), float.fromhex("0x1.fffffep+127")),
    "rsqrt": (float.fromhex("0x1p-126"), float.fromhex("0x1.fffffep+127")),
}
_ONE_BITS = 0x3F800000
_NO_BELOW, _NO_ABOVE = 0, 0xFFFFFFFF


def f32_bits(v: float) -> int:
    """The bit pattern of v rounded to f32."""
    return int(np.float32(v).view(np.uint32))


def _check_span(name: str, lo, hi, stride: int) -> tuple[int, int]:
    """(first bit pattern, count of patterns) of the scan lo, lo + stride,
    ..., <= hi over positive f32 values (default: the primitive's
    domain)."""
    if name not in PRIMS:
        raise ValueError(f"unknown primitive {name!r} (one of "
                         f"{', '.join(PRIMS)})")
    d_lo, d_hi = PRIM_DOMAINS[name]
    lo_b = f32_bits(d_lo if lo is None else lo)
    hi_b = f32_bits(d_hi if hi is None else hi)
    if not (0 <= lo_b <= hi_b < 0x7F800000 and stride >= 1):
        raise ValueError(f"{name}: the scan must cover positive finite "
                         f"floats, lo <= hi, stride >= 1")
    return lo_b, (hi_b - lo_b) // stride + 1


def _check_result(vals) -> dict:
    bad, seen, below, above = (int(v) for v in vals)
    return {"mismatches": bad, "checked": seen,
            "below": None if below == _NO_BELOW else below,
            "above": None if above == _NO_ABOVE else above}


def prim_check_plain(name: str, lo=None, hi=None, stride: int = 1,
                     device="cpu", chunk: int = 1 << 24) -> dict:
    """Plain torch version of ``prim_check``. torch has no branch-free
    form, so its two sides are the correctly rounded value (computed in
    f64, then rounded to f32: exact for a reciprocal and a root of an f32,
    whose f64 result is never an f32 rounding midpoint) and the f32
    expression; rsqrt, an approximation, is the f32 expression both
    sides."""
    lo_b, count = _check_span(name, lo, hi, stride)
    bad = 0
    below, above = _NO_BELOW, _NO_ABOVE
    for k0 in range(0, count, chunk):
        bits = (lo_b + stride * torch.arange(
            k0, min(count, k0 + chunk), dtype=torch.int64,
            device=device)).to(torch.int32)
        y = bits.view(torch.float32)
        if name == "rcp":
            a, b = (1.0 / y.double()).float(), 1.0 / y
        elif name == "sqrt":
            a, b = torch.sqrt(y.double()).float(), torch.sqrt(y)
        else:
            a = b = torch.rsqrt(y)
        miss = bits[a.view(torch.int32) != b.view(torch.int32)].to(
            torch.int64)
        bad += int(miss.numel())
        lo_miss, hi_miss = miss[miss < _ONE_BITS], miss[miss >= _ONE_BITS]
        if lo_miss.numel():
            below = max(below, int(lo_miss.max()))
        if hi_miss.numel():
            above = min(above, int(hi_miss.min()))
    return _check_result((bad, count, below, above))


def _prim_check_launch(name: str, out: torch.Tensor, lo, hi,
                       stride: int) -> None:
    """Launch csrc/vpu.cu's prim_check_kernel over the scan into ``out``
    (four int64: the kernel's tallies, set as prim_check sets them)."""
    lo_b, count = _check_span(name, lo, hi, stride)
    build.launch("prim_check_launch", [out.data_ptr()],
                 [PRIMS.index(name), lo_b, count, stride], [], out.device)


def prim_check(name: str, device, lo=None, hi=None,
               stride: int = 1) -> dict:
    """The exhaustive check of csrc/prims.cuh's primitive ``name`` (one of
    PRIMS): every positive f32 bit pattern lo, lo + stride, ... up to hi
    (default: the primitive's domain, PRIM_DOMAINS) through the primitive
    and the expression it replaces (1.f / y, sqrtf, rsqrtf as nvcc builds
    them for the kernels). Returns {"mismatches", "checked", "below" (the
    largest mismatching pattern under 1.0, or None), "above" (the smallest
    at or over it, or None)}. On a CUDA device it launches csrc/vpu.cu's
    prim_check_kernel; on the CPU it runs prim_check_plain."""
    device = torch.device(device)
    if device.type == "cpu":
        return prim_check_plain(name, lo, hi, stride)
    out = torch.tensor([0, 0, _NO_BELOW, _NO_ABOVE], dtype=torch.int64,
                       device=device)
    _prim_check_launch(name, out, lo, hi, stride)
    prim_check.launches += 1
    return _check_result(out.tolist())


prim_check.launches = 0


def _offset(i: int) -> float:
    """The pass's per-iteration offset (i % 7) * 0.1, rounded in f32 as the
    JAX tool computes it."""
    return float(np.float32(i % 7) * np.float32(0.1))


# the seven offsets iteration k takes as CPASS_OFFSETS[k % 7]: the kernel's
# float table
CPASS_OFFSETS = tuple(_offset(j) for j in range(7))


def _cpass_term(px, py, pz, q, rows, t: float, transposed: bool):
    """One pass's (R, C) cut-off Coulomb terms at offset t."""
    if transposed:
        rr = rows + t
        bx, by, bz, qw = (rr[k][:, None] for k in range(4))
    else:
        bx, by, bz = px[:, :1] + t, py[:, :1] + t, pz[:, :1] + t
        qw = q[:, :1]
    inv_box = 1.0 / CPASS_BOX
    dx, dy, dz = px - bx, py - by, pz - bz
    dx = dx - CPASS_BOX * torch.round(dx * inv_box)
    dy = dy - CPASS_BOX * torch.round(dy * inv_box)
    r2 = torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-18)
    inv_r = torch.rsqrt(r2)
    e = _erfc_probe(CPASS_ALPHA * (r2 * inv_r))
    coulf = qw * q * e * inv_r
    return torch.where(r2 < CPASS_RC2, coulf, 0.0)


def cpass_plain(px, py, pz, q, rows, n: int, transposed: bool):
    """Plain torch version of ``cpass``: the n passes as plane ops."""
    acc = torch.zeros_like(px)
    for i in range(n):
        acc = acc + _cpass_term(px, py, pz, q, rows, _offset(i), transposed)
    return acc


def _cpass_launch(px, py, pz, q, rows, n: int, transposed: bool):
    """Check the planes and launch csrc/vpu.cu's cpass_kernel."""
    R, C = px.shape
    for name, t in (("px", px), ("py", py), ("pz", pz), ("q", q)):
        _check(name, t, (R, C), torch.float32, px.device)
    _check("rows", rows, (4, R), torch.float32, px.device)
    out = torch.empty_like(px)
    build.launch("cpass_launch", [t.data_ptr() for t in (px, py, pz, q, rows,
                                                         out)],
                 [R, C, n, int(transposed)], CPASS_OFFSETS, px.device)
    return out


def cpass(px, py, pz, q, rows, n: int, transposed: bool) -> torch.Tensor:
    """The framework Coulomb pass's plane math n times on (R, C) f32 planes
    px, py, pz, q with a (4, R) table ``rows`` (read when ``transposed``):
    the (R, C) sum of the cut-off Coulomb terms."""
    if px.device.type == "cpu":
        return cpass_plain(px, py, pz, q, rows, n, transposed)
    out = _cpass_launch(px, py, pz, q, rows, n, transposed)
    cpass.launches += 1
    return out


cpass.launches = 0
