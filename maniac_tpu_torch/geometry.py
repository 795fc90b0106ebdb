"""Box geometry: symmetry detection, metrics, inverse, PBC wrapping.

Host-side numpy versions (used by the parsers) of the reference routines in
src/geometry_utils.f90. Device-side (torch) equivalents live in
maniac_tpu_torch.physics.pbc.

Convention note (documented divergence): we use the standard LAMMPS/
crystallographic convention with cell vectors as columns of H:
a=(lx,0,0), b=(xy,ly,0), c=(xz,yz,lz); fractional s = H^-1 r; reciprocal
lattice rows of H^-1. The reference stores the matrix with these vectors as
*rows* and then uses its *columns* (lx,xy,xz),(0,ly,yz),(0,0,lz) as lattice
vectors in real space (src/geometry_utils.f90:124-153, :379-411) while its
reciprocal-space phases use the standard convention
(src/ewald_phase.f90:41-64) - internally inconsistent for triclinic boxes.
We are consistent (standard convention both spaces); for cubic/orthorhombic
boxes the two conventions coincide exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import SMALL
from .utils.errors import ManiacError

CUBIC, ORTHORHOMBIC, TRICLINIC = 1, 2, 3


@dataclass
class Box:
    """Static box geometry (host-side, numpy float64)."""

    matrix: np.ndarray        # H, 3x3, cell vectors as columns (upper triangular)
    bounds: np.ndarray        # (3,2) lo/hi
    tilt: np.ndarray          # (xy, xz, yz)
    is_triclinic: bool
    kind: int                 # CUBIC / ORTHORHOMBIC / TRICLINIC
    volume: float
    reciprocal: np.ndarray    # H^-1
    lengths: np.ndarray       # |a|,|b|,|c|
    perp_widths: np.ndarray   # perpendicular widths along each axis


def build_box(bounds: np.ndarray, tilt: np.ndarray | None = None) -> Box:
    """Construct a Box from LAMMPS-style bounds + tilt factors.

    Mirrors PrepareSimulationBox (reference: src/geometry_utils.f90:20-57):
    symmetry detection, metrics, inverse with degenerate-determinant guard.
    """
    bounds = np.asarray(bounds, dtype=np.float64)
    if tilt is None:
        tilt = np.zeros(3)
    tilt = np.asarray(tilt, dtype=np.float64)
    lx, ly, lz = bounds[:, 1] - bounds[:, 0]
    xy, xz, yz = tilt
    H = np.array([[lx, xy, xz],
                  [0.0, ly, yz],
                  [0.0, 0.0, lz]])

    is_triclinic = bool(np.max(np.abs(tilt)) > SMALL)
    if is_triclinic:
        kind = TRICLINIC
    elif abs(lx - ly) > SMALL or abs(lx - lz) > SMALL:
        kind = ORTHORHOMBIC
    else:
        kind = CUBIC

    det = float(np.linalg.det(H))
    # Degenerate box guard (reference: src/geometry_utils.f90:310-312 aborts
    # when |det| < 1; that also rejects legitimately tiny boxes, so we only
    # reject genuinely singular ones).
    if abs(det) < SMALL:
        raise ManiacError("Box matrix is singular; cannot invert", 1)
    recip = np.linalg.inv(H)

    a, b, c = H[:, 0], H[:, 1], H[:, 2]
    volume = abs(float(np.dot(a, np.cross(b, c))))
    lengths = np.array([np.linalg.norm(a), np.linalg.norm(b), np.linalg.norm(c)])
    perp = np.array([
        volume / np.linalg.norm(np.cross(b, c)),
        volume / np.linalg.norm(np.cross(c, a)),
        volume / np.linalg.norm(np.cross(a, b)),
    ])
    return Box(matrix=H, bounds=bounds, tilt=tilt, is_triclinic=is_triclinic,
               kind=kind, volume=volume, reciprocal=recip, lengths=lengths,
               perp_widths=perp)


def apply_pbc(pos: np.ndarray, box: Box) -> np.ndarray:
    """Wrap cartesian position(s) into [lo, lo+L) (reference: ApplyPBC,
    src/geometry_utils.f90:167-220). pos shape (..., 3)."""
    pos = np.asarray(pos, dtype=np.float64)
    lo = box.bounds[:, 0]
    if not box.is_triclinic:
        L = np.diag(box.matrix)
        return lo + np.mod(pos - lo, L)
    frac = (pos - lo) @ box.reciprocal.T
    frac = np.mod(frac, 1.0)
    return lo + frac @ box.matrix.T


def wrap_centered(pos: np.ndarray, box: Box) -> np.ndarray:
    """Wrap into [-L/2, L/2] (reference: WrapIntoBox,
    src/geometry_utils.f90:230-267). Used only by the writers."""
    pos = np.asarray(pos, dtype=np.float64)
    if box.kind in (CUBIC, ORTHORHOMBIC):
        L = np.diag(box.matrix)
        return pos - L * np.rint(pos / L)
    frac = pos @ box.reciprocal.T
    frac = frac - np.rint(frac)
    return frac @ box.matrix.T


def min_image_delta(delta: np.ndarray, box: Box) -> np.ndarray:
    """Minimum-image displacement vector(s); delta shape (..., 3).

    Cubic/orthorhombic: per-component modulo. Triclinic: brute-force search
    over the 27 neighbor images (reference: ComputeDistance,
    src/geometry_utils.f90:359-415).
    """
    delta = np.asarray(delta, dtype=np.float64)
    if box.kind in (CUBIC, ORTHORHOMBIC):
        L = np.diag(box.matrix)
        return np.mod(delta + 0.5 * L, L) - 0.5 * L
    shifts = image_shifts(box)  # (27, 3)
    trial = delta[..., None, :] + shifts  # (..., 27, 3)
    d2 = np.sum(trial * trial, axis=-1)
    idx = np.argmin(d2, axis=-1)
    return np.take_along_axis(trial, idx[..., None, None], axis=-2)[..., 0, :]


def image_shifts(box: Box) -> np.ndarray:
    """The 27 lattice image shifts (27, 3), grid @ H^T over {-1, 0, 1}^3
    in the JAX package's order (system.py)."""
    rng = np.array([-1, 0, 1], dtype=np.float64)
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1).reshape(27, 3)
    return grid @ box.matrix.T


def rotation_matrix(axis: int, theta: float) -> np.ndarray:
    """Axis-aligned rotation matrix; axis in {0,1,2} (reference:
    src/helper_utils.f90:39-77)."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.eye(3)
    if axis == 0:
        R[1, 1], R[1, 2], R[2, 1], R[2, 2] = c, -s, s, c
    elif axis == 1:
        R[0, 0], R[0, 2], R[2, 0], R[2, 2] = c, s, -s, c
    else:
        R[0, 0], R[0, 1], R[1, 0], R[1, 1] = c, -s, s, c
    return R
