"""Periodic-boundary helpers in torch (orthorhombic boxes).

Counterparts of maniac_tpu/physics/pbc.py; semantics match the reference
(src/geometry_utils.f90:167-220 ApplyPBC, :359-415 ComputeDistance).
Triclinic boxes are not ported yet.
"""

from __future__ import annotations

import torch


def _check_ortho(spec):
    if spec.is_triclinic:
        raise NotImplementedError("triclinic boxes are not ported yet")


def wrap_into_box(pos, spec):
    """Wrap cartesian position(s) (..., 3) into [lo, lo+L). The remainder
    is fmod plus L where negative, the same float ops as jnp.mod."""
    _check_ortho(spec)
    lo = spec.bounds[:, 0]
    r = torch.fmod(pos - lo, spec.box_diag)
    return lo + torch.where(r < 0, r + spec.box_diag, r)


def min_image_dist2(delta, spec):
    """Squared minimum-image distance; delta (..., 3) -> (...)."""
    _check_ortho(spec)
    L = spec.box_diag
    d = delta - L * torch.round(delta / L)
    return torch.sum(d * d, dim=-1)
