"""The whole-block kernel's guest pair pass as a micro-benchmark: CUDA
kernel and plain version.

``gpass`` replaces tools/gpass_bench.py's Pallas kernel (``make_kernel``,
launched by ``run_variant``): ``n_steps`` passes of FL * G Lennard-Jones
rows and FQ * G Coulomb rows against the S sites of (G, S) coordinate
planes, summed to one scalar (csrc/gpass.cu says what a row computes).
FL is the number of rows of ``eps`` and ``sig`` (sig holds sigma^2, as
the JAX tool's); row r of the pass takes guest r % G and eps row r // G.
For CUDA tensors it launches csrc/gpass.cu, one (guest, site) pair a
thread, and sums the CTAs' partials in a fixed order, so two calls on the
same inputs give the same bits; for CPU tensors it runs ``gpass_plain``,
a loop over the steps of torch plane ops. Both sum in f64 (the TPU kernel
sums in f32).

``GPASS_VARIANTS`` are the JAX tool's variants that compute distinct
numbers: ``cur`` (the live kernel's math), ``noerfc`` (1/r in place of
erfc(alpha r)/r), ``nowrap`` (no minimum image) and ``read`` (the inputs'
sum only).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .resync import _check

GPASS_VARIANTS = ("cur", "noerfc", "nowrap", "read")
# tools/gpass_bench.py's box edge, squared LJ and Coulomb cut-offs, alpha
BOX_L = 40.0
RC2 = 8.5 ** 2
GGR2 = 8.57 ** 2
ALPHA = 0.514
# Abramowitz & Stegun 7.1.26, innermost coefficient last
ERFC_AS = (0.254829592, -0.284496736, 1.421413741, -1.453152027,
           1.061405429)
# the kernel against the plain version: f32 terms, summed in f64 by the
# plain version and in per-thread f32 sums of some n_steps * (FL + FQ)
# terms by the kernel; a bound relative to the sum of |terms| (gpass_scale)
GPASS_RTOL = 1e-5
# csrc/gpass.cu's threads a CTA (its THREADS): one partial sum a CTA
GPASS_THREADS = 128


def _erfc_as(x: torch.Tensor) -> torch.Tensor:
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = ERFC_AS[4] * t
    for c in ERFC_AS[3::-1]:
        poly = t * (c + poly)
    return poly * torch.exp(-x * x)


def _rows(F: int, G: int, step: int, like: torch.Tensor) -> torch.Tensor:
    """(F * G, 1) footprint coordinates r * 0.003 + step * 0.01, in f32."""
    s = float(np.float32(step) * np.float32(0.01))
    return (torch.arange(F * G, dtype=torch.float32, device=like.device)
            * 0.003 + s)[:, None]


def _r2(x, y, z, col, wrap: bool):
    dx, dy, dz = x - col, y - col * 0.5, z - col * 0.25
    if wrap:
        inv_l = 1.0 / BOX_L
        dx = dx - BOX_L * torch.round(dx * inv_l)
        dy = dy - BOX_L * torch.round(dy * inv_l)
        dz = dz - BOX_L * torch.round(dz * inv_l)
    return torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-8)


def gpass_terms(x, y, z, q, eps, sig, step: int, fq: int,
                variant: str) -> torch.Tensor:
    """Every term one step of the pass adds, flat (f32)."""
    G = x.shape[0]
    fl = eps.shape[0]
    if variant == "read":
        return (x + y + z + q).repeat(fl + fq, 1).flatten()
    wrap = variant != "nowrap"
    xl, yl, zl = x.repeat(fl, 1), y.repeat(fl, 1), z.repeat(fl, 1)
    col = _rows(fl, G, step, x)
    r2 = _r2(xl, yl, zl, col, wrap)
    sr2 = sig.repeat_interleave(G, 0) * (1.0 / r2)
    sr6 = sr2 * sr2 * sr2
    ljv = 4.0 * eps.repeat_interleave(G, 0) * (sr6 * sr6 - sr6)
    lj = torch.where(r2 < RC2, ljv, 0.0)
    xq, yq, zq = x.repeat(fq, 1), y.repeat(fq, 1), z.repeat(fq, 1)
    colq = _rows(fq, G, step, x)
    r2q = _r2(xq, yq, zq, colq, wrap)
    inv_r = torch.rsqrt(r2q)
    if variant == "noerfc":
        coul = colq * q * inv_r
    else:
        coul = colq * q * _erfc_as(ALPHA * (r2q * inv_r)) * inv_r
    return torch.cat([lj.flatten(),
                      torch.where(r2q < GGR2, coul, 0.0).flatten()])


def gpass_plain(x, y, z, q, eps, sig, n_steps: int, fq: int,
                variant: str) -> torch.Tensor:
    """Plain torch version: the steps' terms summed in f64 (0-d)."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(n_steps):
        total += gpass_terms(x, y, z, q, eps, sig, s, fq,
                             variant).sum(dtype=torch.float64)
    return total


def gpass_scale(x, y, z, q, eps, sig, n_steps: int, fq: int,
                variant: str) -> float:
    """The sum of |terms| over the steps, in f64: GPASS_RTOL's scale."""
    return sum(float(gpass_terms(x, y, z, q, eps, sig, s, fq, variant).abs()
                     .sum(dtype=torch.float64)) for s in range(n_steps))


def gpass(x, y, z, q, eps, sig, n_steps: int, fq: int,
          variant: str) -> torch.Tensor:
    """The pass of ``variant`` (one of GPASS_VARIANTS) over n_steps steps:
    x, y, z (G, S), q (S,), eps and sig (FL, S), all f32; the f64 sum
    (0-d)."""
    if variant not in GPASS_VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of "
                         f"{', '.join(GPASS_VARIANTS)})")
    if x.device.type == "cpu":
        return gpass_plain(x, y, z, q, eps, sig, n_steps, fq, variant)
    return _launch(x, y, z, q, eps, sig, n_steps, fq, variant)


def _launch(x, y, z, q, eps, sig, n_steps: int, fq: int,
            variant: str) -> torch.Tensor:
    """Check the inputs and launch csrc/gpass.cu (the pass, then the sum of
    its CTAs' partials, allocated here)."""
    (G, S), fl = x.shape, eps.shape[0]
    for name, t in (("x", x), ("y", y), ("z", z)):
        _check(name, t, (G, S), torch.float32, x.device)
    _check("q", q, (S,), torch.float32, x.device)
    _check("eps", eps, (fl, S), torch.float32, x.device)
    _check("sig", sig, (fl, S), torch.float32, x.device)
    ctas = -(-G * S // GPASS_THREADS)
    partial = torch.empty(ctas, dtype=torch.float64, device=x.device)
    out = torch.empty((), dtype=torch.float64, device=x.device)
    build.launch("gpass_launch", [t.data_ptr() for t in (x, y, z, q, eps, sig,
                                                         partial, out)],
                 [G, S, fl, fq, n_steps, GPASS_VARIANTS.index(variant),
                  ctas], [BOX_L, RC2, GGR2, ALPHA], x.device)
    return out
