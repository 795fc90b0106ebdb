"""Periodic-boundary helpers in torch (orthorhombic and triclinic boxes).

Counterparts of maniac_tpu/physics/pbc.py; semantics match the reference
(src/geometry_utils.f90:167-220 ApplyPBC, :359-415 ComputeDistance). The
box kind is static (spec.is_triclinic), so each call takes one branch.
"""

from __future__ import annotations

import torch


def _mod(x, m):
    """x mod m with the sign of m: fmod plus m where negative, the same
    float ops as jnp.mod (and as the CUDA kernels' wrap)."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def wrap_into_box(pos, spec):
    """Wrap cartesian position(s) (..., 3) into the cell at lo: [lo, lo+L)
    per axis in an orthorhombic box; through fractional coordinates
    (pos - lo) Hinv^T, taken mod 1, in a triclinic one."""
    lo = spec.bounds[:, 0]
    if not spec.is_triclinic:
        return lo + _mod(pos - lo, spec.box_diag)
    frac = _mod((pos - lo) @ spec.Hinv.T, 1.0)
    return lo + frac @ spec.H.T


def min_image_dist2(delta, spec):
    """Squared minimum-image distance; delta (..., 3) -> (...). A triclinic
    box takes the brute-force minimum over the 27 images delta + shift
    (spec.image_shifts), folded one shift at a time: no (..., 27, 3)
    temporary."""
    if not spec.is_triclinic:
        L = spec.box_diag
        d = delta - L * torch.round(delta / L)
        return torch.sum(d * d, dim=-1)
    best = None
    for shift in spec.image_shifts:
        t = delta + shift
        r2 = torch.sum(t * t, dim=-1)
        best = r2 if best is None else torch.minimum(best, r2)
    return best
