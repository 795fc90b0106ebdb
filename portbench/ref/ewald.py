"""Ewald summation setup: damping parameter, k-vector enumeration, weights.

Host-side numpy; results are baked into the static SystemSpec. Formulas match
the reference's DL_POLY-style derivation exactly
(reference: src/prepare_utils.f90:103-214 SetupEwald/ComputeEwaldParameters/
ComputeFourierIndices, src/ewald_kvectors.f90:44-246).

Convention: cartesian k-vector for integer triple n = 2*pi * (H^-1)^T n, i.e.
phase(r) = k . r = 2*pi * n . frac(r). For cubic/orthorhombic boxes this is
identical to the reference's kvec_matrix (src/ewald_kvectors.f90:55).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import PI, SMALL, TWOPI
from .geometry import Box
from .utils.logger import Logger, default_logger


@dataclass
class EwaldSetup:
    alpha: float
    screening_factor: float
    fourier_precision: float
    kmax: np.ndarray            # (3,) int
    k_int: np.ndarray           # (K,3) integer triples (valid modes only)
    k_cart: np.ndarray          # (K,3) cartesian k-vectors (with 2*pi)
    weights: np.ndarray         # (K,) W(k) = exp(-|k|^2/(4 a^2)) / |k|^2
    form_factor: np.ndarray     # (K,) 1 for kx=0, 2 otherwise
    real_space_cutoff: float    # possibly clamped
    tolerance: float            # possibly clamped
    # Dense half-space grid (jx in [0,k1], jy in [-k2,k2], jz in [-k3,k3])
    # laid out as a 2-D array (JzP, JxyP): rows = signed jz (sublane-padded
    # to 8), cols = jx*Jy + jy_idx (lane-padded to 128). Modes outside the
    # reference's normalized ellipsoid and padding entries carry weight 0,
    # so the amplitude update is a pure separable outer product - two
    # static expansion matmuls + one (JzP, F)@(F, JxyP) contraction, with
    # NO gathers, one-hots over a k-list, or reshapes anywhere (the
    # TPU-native layout for incremental structure factors).
    grid2_shape: tuple          # (JzP, JxyP)
    dense_int: np.ndarray       # (JzP*JxyP, 3) int triples (0 for padding)
    dense_cart: np.ndarray      # (JzP*JxyP, 3)
    dense_weights: np.ndarray   # (JzP, JxyP) form * W(k); 0 invalid/pad
    dense_live: np.ndarray      # (JzP*JxyP,) 1.0 for real grid pts, 0 pad
    ex_sel: np.ndarray          # (Jx, JxyP) static 0/1: col g -> jx(g)
    ey_sel: np.ndarray          # (Jy, JxyP) static 0/1: col g -> jy(g)

    @property
    def num_kvectors(self) -> int:
        return self.k_int.shape[0]


def setup_ewald(box: Box, real_space_cutoff: float, tolerance: float,
                logger: Logger | None = None,
                alpha_override: float = 0.0) -> EwaldSetup:
    logger = logger or default_logger()

    # Step 1: clamp cutoff to the box (reference: AdjustRealSpaceCutoff)
    rc = float(real_space_cutoff)
    if rc > min(box.lengths):
        logger.warn("real_space_cutoff too large for box. Reducing to safe value.")
        rc = float(min(box.lengths)) / 2.0

    # Step 2: clamp tolerance (reference: ClampTolerance)
    tol = min(abs(float(tolerance)), 0.5)

    # Step 3: alpha & Fourier precision (reference: ComputeEwaldParameters)
    screening = np.sqrt(abs(np.log(tol * rc)))
    alpha = np.sqrt(abs(np.log(tol * rc * screening))) / rc
    if alpha_override:
        # user-chosen split (deck keyword ewald_alpha): same tolerance
        # machinery, different real/reciprocal balance. The converged total
        # is invariant (tests/test_energy.py::test_alpha_override_invariance)
        alpha = float(alpha_override)
    fourier_precision = np.sqrt(-np.log(tol * rc * (2.0 * screening * alpha) ** 2))

    # Step 4: kmax per axis (reference: ComputeFourierIndices). For
    # triclinic cells the reference's box lengths overstate the
    # perpendicular widths; use the true widths (identical for orthogonal
    # boxes) so the k-space slab actually covers the physical cutoff.
    recip_rows0 = box.reciprocal
    widths = 1.0 / np.linalg.norm(recip_rows0, axis=1)  # = lengths if ortho
    kmax = np.rint(0.25 + widths * alpha * fourier_precision / PI).astype(int)
    kmax = np.maximum(kmax, 1)

    # Step 5: enumerate valid k-vectors in the half-space ellipsoid.
    # Orthogonal boxes: the reference's integer-normalized check
    # sum (n_i/kmax_i)^2 <= 1 (exact energy parity). Triclinic: that check
    # is skewed (integer space is not |k| space when H has tilt) and
    # truncates modes with significant weight - select by the equivalent
    # PHYSICAL cutoff |k| <= 2*alpha*precision instead (the two rules
    # coincide on orthogonal cells up to kmax rounding; see DIVERGENCES.md).
    kx = np.arange(0, kmax[0] + 1)
    ky = np.arange(-kmax[1], kmax[1] + 1)
    kz = np.arange(-kmax[2], kmax[2] + 1)
    grid = np.stack(np.meshgrid(kx, ky, kz, indexing="ij"), axis=-1).reshape(-1, 3)
    if box.is_triclinic:
        kc = TWOPI * (grid @ recip_rows0)
        k_cut = 2.0 * alpha * fourier_precision
        norm_ksq = np.sum(kc * kc, axis=1) / (k_cut * k_cut)
    else:
        norm_ksq = ((grid[:, 0] / kmax[0]) ** 2 + (grid[:, 1] / kmax[1]) ** 2
                    + (grid[:, 2] / kmax[2]) ** 2)
    valid = (norm_ksq >= SMALL) & (norm_ksq <= 1.0)
    k_int = grid[valid]

    # Match the reference's enumeration order (kx outer, then ky, then kz):
    # meshgrid('ij') + reshape already yields exactly that order.

    recip_rows = box.reciprocal  # H^-1; reciprocal vectors are its rows
    k_cart = TWOPI * (k_int @ recip_rows)          # (K,3); row n . H^-1
    ksq = np.sum(k_cart * k_cart, axis=1)
    weights = np.exp(-ksq / (4.0 * alpha ** 2)) / ksq
    form = np.where(k_int[:, 0] == 0, 1.0, 2.0)

    # dense half-space grid in the 2-D (JzP, JxyP) layout
    def _round_up(x, m):
        return ((x + m - 1) // m) * m

    Jx, Jy, Jz = int(kmax[0]) + 1, 2 * int(kmax[1]) + 1, 2 * int(kmax[2]) + 1
    Jxy = Jx * Jy
    JzP, JxyP = _round_up(Jz, 8), _round_up(Jxy, 128)
    G = JzP * JxyP

    dense_int = np.zeros((G, 3), dtype=np.int64)
    live = np.zeros(G)
    g_jz, g_jxy = np.meshgrid(np.arange(JzP), np.arange(JxyP), indexing="ij")
    g_jz, g_jxy = g_jz.ravel(), g_jxy.ravel()
    real = (g_jz < Jz) & (g_jxy < Jxy)
    live[real] = 1.0
    dense_int[real, 0] = g_jxy[real] // Jy
    dense_int[real, 1] = (g_jxy[real] % Jy) - int(kmax[1])
    dense_int[real, 2] = g_jz[real] - int(kmax[2])

    dense_cart = TWOPI * (dense_int @ recip_rows)
    dksq = np.sum(dense_cart * dense_cart, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        dense_w = np.exp(-dksq / (4.0 * alpha ** 2)) / np.where(dksq > 0,
                                                                dksq, 1.0)
    dense_form = np.where(dense_int[:, 0] == 0, 1.0, 2.0)
    if box.is_triclinic:  # same validity rule as the k_int list above
        k_cut = 2.0 * alpha * fourier_precision
        norm2 = dksq / (k_cut * k_cut)
    else:
        norm2 = ((dense_int[:, 0] / kmax[0]) ** 2
                 + (dense_int[:, 1] / kmax[1]) ** 2
                 + (dense_int[:, 2] / kmax[2]) ** 2)
    dvalid = (norm2 >= SMALL) & (norm2 <= 1.0) & (live > 0)
    dense_weights = np.where(dvalid, dense_form * dense_w,
                             0.0).reshape(JzP, JxyP)

    # static per-axis expansion selectors over the jxy lane axis
    ex_sel = np.zeros((Jx, JxyP))
    ey_sel = np.zeros((Jy, JxyP))
    gx = np.arange(Jxy) // Jy
    gy = np.arange(Jxy) % Jy
    ex_sel[gx, np.arange(Jxy)] = 1.0
    ey_sel[gy, np.arange(Jxy)] = 1.0

    return EwaldSetup(alpha=float(alpha), screening_factor=float(screening),
                      fourier_precision=float(fourier_precision), kmax=kmax,
                      k_int=k_int, k_cart=k_cart, weights=weights,
                      form_factor=form, real_space_cutoff=rc, tolerance=tol,
                      grid2_shape=(JzP, JxyP), dense_int=dense_int,
                      dense_cart=dense_cart, dense_weights=dense_weights,
                      dense_live=live, ex_sel=ex_sel, ey_sel=ey_sel)
