"""Static-framework split setup: short-ranged erfc(alpha2) + far-field grid.

GCMC adsorption spends most pair-pass work on guest<->framework terms, but
the framework never moves. The reference evaluates the damped Coulomb
erfc(alpha r)/r over ALL framework sites for every move (no cutoff - its
semantic quirk, src/energy_utils.f90:374-442), which at the DL_POLY alpha
(~0.34 1/A) decays too slowly to truncate. This module rebalances the
guest<->framework REAL-SPACE term only (the alpha k-space, self and intra
terms are untouched):

    erfc(a r)/r  =  erfc(a2 r)/r                      [short: dies by rc2]
                  + [erfc(a r) - erfc(a2 r)]/r        [smooth everywhere]

with a2 > a chosen so erfc(a2 rc2) ~ 1e-9. The smooth difference term,
lattice-summed over the static framework, is a periodic harmonic field

    D(r) = sum_j q_j sum_n [erfc(a |r-r_j+Ln|) - erfc(a2 |r-r_j+Ln|)]
         = (1/V) sum_k ghat(k) conj(A_fw(k)) e^{ik.r},
    ghat(k) = 4 pi / k^2 (e^{-k^2/4a2^2} - e^{-k^2/4a^2}),

whose Fourier coefficients decay like e^{-k^2/4a2^2} and are PRECOMPUTED
here once (the framework structure factor A_fw is constant). Per move the
engine evaluates the short part over a small spatial window of a
sort-axis-ordered, ghost-padded framework table, and D(r) at the footprint
atoms with the same separable-phase MXU machinery as the main dense k-grid.

Because both the short-pass cutoff and the D-series are part of the SPEC,
every path (XLA oracle, Pallas kernels, full recompute) computes the SAME
split total, so the bookkeeping==recompute and kernel==XLA invariants hold
exactly; the split-vs-plain difference is a bounded numerical error
(measured in tests/test_fwsplit.py, target <= 1e-6 kcal/mol per move).

The min-image real-space sum equals the full lattice sum here because the
difference kernel is negligible at L/2 (erfc(a L/2) < 1e-18 on any box that
passes the reference's cutoff clamp).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import COULOMB_K, ERFC_DECAY as _ERFC_DECAY, PI, TWOPI
#: far-field series tolerance default: coefficients cut at e^{-p^2}.
#: MANIAC_FW_TOL2 overrides at build time (read in build_fwsplit: the
#: far packed dot contracts over ~kmax2_y*kmax2_z modes, so cost scales
#: with ln(1/tol); the split-error bar is 1e-6 kcal/mol per move,
#: tests/test_fwsplit.py, and the measured error headroom vs this
#: tolerance is recorded in docs/performance.md)
_TOL2 = 1e-7
#: extra window slack for f32 COM rounding and block quantization
_SLACK = 0.75


@dataclass
class FwSplitSetup:
    enabled: bool
    reason: str = ""
    # frozen-prefix layout
    S_frozen: int = 0
    guest_base: int = 0
    axis: int = 2
    # ghost framework tables (sorted along `axis`, periodic images padded)
    SG: int = 0
    pq_g: np.ndarray | None = None      # (4, SG): x, y, z, q rows
    eps_g: np.ndarray | None = None     # (R*R*8, SG) grouped-LJ-row layout
    sig2_g: np.ndarray | None = None    # (R*R*8, SG)
    blockmax: np.ndarray | None = None  # (SG//128,) max sort-coord per block
    WL: int = 0                         # LJ window width (cols)
    WC: int = 0                         # Coulomb window width (cols)
    rcw_lj: float = 0.0                 # LJ half-window (A)
    rcw_c: float = 0.0                  # Coulomb half-window (A)
    # split parameters
    alpha2: float = 0.0
    rcut2: float = 0.0
    d0: float = 0.0                     # k=0 term per unit guest charge (K)
    # far-field coefficient grid (2-D dense layout, same conventions as the
    # main k-grid in ewald.py)
    kmax2: tuple = (0, 0, 0)
    amp2_shape: tuple = (8, 128)
    c2_re: np.ndarray | None = None     # (Jz2P, Jxy2P)
    c2_im: np.ndarray | None = None
    ex2_sel: np.ndarray | None = None   # (Jx2, Jxy2P)
    ey2_sel: np.ndarray | None = None   # (Jy2, Jxy2P)
    # constant framework structure factor on the MAIN k-grid: resync /
    # full_amplitudes start from it and synthesize guest sites only
    amp_fw_re: np.ndarray | None = None  # (JzP, JxyP)
    amp_fw_im: np.ndarray | None = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _amps_on_grid(phase, q, kmaxs, shape, yb: int = 0):
    """sum_s q_s e^{i 2 pi n.frac_s} on a dense half-space grid laid out
    (JzP, JxyP) with cols jx*JyB + jy (JyB=Jy: the ewald.py convention;
    yb > Jy: jx-blocks padded to yb cols with dead modes - the far grid
    uses yb=round_up(Jy,8) so the kernel can slice per-jx sublane blocks).
    phase: (N, 3) complex e^{2 pi i frac}; returns (re, im) f64 arrays."""
    kxm, kym, kzm = kmaxs
    Jx, Jy, Jz = kxm + 1, 2 * kym + 1, 2 * kzm + 1
    JyB = max(yb, Jy)
    Jxy = Jx * JyB
    JzP, JxyP = shape
    px = phase[:, 0][:, None] ** np.arange(Jx)[None, :]
    py = np.zeros((q.size, JyB), dtype=complex)
    py[:, :Jy] = phase[:, 1][:, None] ** (np.arange(Jy)[None, :] - kym)
    pz = phase[:, 2][:, None] ** (np.arange(Jz)[None, :] - kzm)
    a_xy = np.einsum("sx,sy->sxy", px, py).reshape(q.size, Jxy)
    A = pz.T @ (q[:, None] * a_xy)                     # (Jz, Jxy) complex
    full = np.zeros((JzP, JxyP), dtype=complex)
    full[:Jz, :Jxy] = A
    return full.real.copy(), full.imag.copy()


def build_fwsplit(box, alpha: float, cutoff: float, *,
                  kmax_xyz, amp_shape,
                  R: int, active_list, A_list, cap_list, n_mol_init,
                  type_site_base, site_q, site_cls, pos0, eps_cls, sig_cls,
                  class_base, lj_idx, Lmax: int, active_ids,
                  mol_radius: float,
                  enabled: str = "auto", alpha2: float = 0.0,
                  rcut2: float = 0.0) -> FwSplitSetup:
    """Build the static-framework split tables (host-side numpy).

    pos0: (S, 3) absolute initial site positions. Eligibility: orthorhombic
    box, all inactive residue types laid out as a contiguous prefix of the
    site array, at least one live frozen site. `enabled`: "on"/"off"/"auto"
    (auto = on when eligible)."""
    if enabled == "off":
        return FwSplitSetup(False, "disabled")
    if box.is_triclinic:
        return FwSplitSetup(False, "triclinic box")

    frozen_types = [r for r in range(R) if not active_list[r]]
    if not frozen_types:
        return FwSplitSetup(False, "no inactive residue types")
    if frozen_types != list(range(len(frozen_types))):
        return FwSplitSetup(False, "inactive types not a layout prefix")

    # The site layout 128-aligns every per-type region (system.py base_list),
    # so the frozen prefix ends at the END of the LAST frozen type's region,
    # not at the raw sum of frozen site counts (which undercounts whenever an
    # earlier frozen region is padded). Inter-region pad columns are inert
    # (zero charge / zero eps), so classifying them as frozen is harmless;
    # classifying live frozen sites as mobile would double count them.
    last = frozen_types[-1]
    S_frozen = int(type_site_base[last]) + cap_list[last] * A_list[last]
    guest_base = _round_up(S_frozen, 128)

    # live frozen site columns (dead capacity slots of empty inactive types
    # are excluded here once and for all - the ghost table IS the live set)
    cols = []
    for r in frozen_types:
        for mi in range(int(n_mol_init[r])):
            s0 = type_site_base[r] + mi * A_list[r]
            cols.extend(range(s0, s0 + A_list[r]))
    cols = np.asarray(cols, dtype=np.int64)
    if cols.size == 0:
        return FwSplitSetup(False, "no live frozen sites")

    lengths = np.asarray(box.lengths, dtype=float)
    axis = int(np.argmax(lengths))
    L_ax = float(lengths[axis])
    lo_ax = float(box.bounds[axis, 0])
    hi_ax = lo_ax + L_ax

    # Default short-pass cutoff = the LJ cutoff: the Coulomb window then
    # coincides with the (already-paid) LJ window width while alpha2 -
    # and with it the far-field grid extent (kmax2 ~ alpha2) - drops by
    # ~1/0.72. Measured on the flagship bench: rcut2 0.72c -> c is
    # 1.471M -> 1.576M steps/s (kmax2 32 -> 27, far pass + phase powers
    # shrink; docs/performance.md). Accuracy is alpha2-invariant by
    # construction (a2 = _ERFC_DECAY / rc2 keeps erfc(a2 rc2) ~ 5e-10).
    rc2 = float(rcut2) if rcut2 else max(5.0, float(cutoff))
    a2 = float(alpha2) if alpha2 else _ERFC_DECAY / rc2
    if a2 <= float(alpha):
        return FwSplitSetup(False, "alpha2 <= alpha (split pointless)")

    rcw_c = rc2 + mol_radius + _SLACK
    rcw_lj = float(cutoff) + mol_radius + _SLACK
    band = max(rcw_c, rcw_lj)
    if 2.0 * band >= L_ax:
        return FwSplitSetup(False, "window would span the whole box")

    # ---- ghost-padded sorted framework table ---------------------------
    p = pos0[cols]                                     # (Nf, 3)
    # wrap the sort coordinate into [lo, hi) so ghosts are well defined
    c_ax = lo_ax + np.mod(p[:, axis] - lo_ax, L_ax)
    p = p.copy()
    p[:, axis] = c_ax
    lo_ghost = c_ax >= hi_ax - band                    # copy shifted -L
    hi_ghost = c_ax <= lo_ax + band                    # copy shifted +L
    shift = np.zeros(3)
    shift[axis] = L_ax
    pos_all = np.concatenate([p[lo_ghost] - shift, p, p[hi_ghost] + shift])
    src = np.concatenate([cols[lo_ghost], cols, cols[hi_ghost]])
    order = np.argsort(pos_all[:, axis], kind="stable")
    pos_all = pos_all[order]
    src = src[order]

    NG = pos_all.shape[0]
    SG = _round_up(NG, 128)
    # rows x, y, z, q in ONE table: the kernel's dynamic window slice must
    # be multi-row (single-row slices at lane offsets hit an unsupported
    # Mosaic broadcast layout)
    pq_g = np.zeros((4, SG))
    # pad columns: far away on the sort axis (never inside a window and
    # r^2 is huge), zero charge, zero eps
    pq_g[axis, NG:] = hi_ax + band + 1.0e6
    pq_g[:3, :NG] = pos_all.T
    pq_g[3, :NG] = site_q[src]

    # grouped-kernel LJ rows vs framework ghost cols: same 8-row (old|new)
    # ACTIVE-pair block layout as SystemSpec.eps_pair_lj
    eps_site_fw = eps_cls[:, site_cls[src]]            # (C+1, NG)
    sig_site_fw = sig_cls[:, site_cls[src]]
    nA = max(len(active_ids), 1)
    eps_g = np.zeros((nA * nA * 8, SG))
    sig2_g = np.zeros((nA * nA * 8, SG))
    if 2 * Lmax <= 8:
        for ao, to in enumerate(active_ids):
            for an, tn in enumerate(active_ids):
                base = (ao * nA + an) * 8
                for side, t in ((0, int(to)), (1, int(tn))):
                    for j, a in enumerate(lj_idx[t][:Lmax]):
                        row = class_base[t] + a
                        eps_g[base + side * Lmax + j, :NG] = eps_site_fw[row]
                        sig2_g[base + side * Lmax + j, :NG] = (
                            sig_site_fw[row] ** 2)

    nb = SG // 128
    blockmax = np.full(nb, hi_ax + band + 1.0e6)
    zg = pq_g[axis]
    for b in range(nb):
        blockmax[b] = zg[b * 128:(b + 1) * 128].max()

    # window widths: max over center positions of the column span needed
    def window_cols(rcw: float) -> int:
        z0 = np.linspace(lo_ax, hi_ax, 4097)
        starts = np.searchsorted(blockmax, z0 - rcw, side="right")
        ends = np.searchsorted(zg[:NG], z0 + rcw, side="right")
        w = int(np.max(ends - starts * 128))
        return max(128, _round_up(w, 128))

    WL = min(window_cols(rcw_lj), SG)
    WC = min(window_cols(rcw_c), SG)

    # ---- far-field coefficient grid -------------------------------------
    import os
    tol2 = float(os.environ.get("MANIAC_FW_TOL2", _TOL2))
    p2 = float(np.sqrt(np.log(1.0 / tol2)))
    k_cut = 2.0 * a2 * p2
    recip_rows = box.reciprocal
    widths = 1.0 / np.linalg.norm(recip_rows, axis=1)
    kmax2 = np.maximum(np.ceil(widths * k_cut / TWOPI).astype(int), 1)
    if np.any(kmax2 > 48):
        return FwSplitSetup(False, "far-field grid too large")

    Jx, Jy, Jz = int(kmax2[0]) + 1, 2 * int(kmax2[1]) + 1, 2 * int(kmax2[2]) + 1
    # columns laid out jx*JyB + jy with each jx block 8-row-padded: the
    # whole-block kernel contracts jz first (MZ = c2 ? pz) and then slices
    # per-jx SUBLANE blocks of the (Jxy2P, GFK)-oriented result, which
    # Mosaic only supports at multiple-of-8 offsets; the pad modes carry
    # coefficient 0 everywhere so every path sums them harmlessly
    JyB = _round_up(Jy, 8)
    Jxy = Jx * JyB
    Jz2P, Jxy2P = _round_up(Jz, 8), _round_up(Jxy, 128)
    g_jz, g_jxy = np.meshgrid(np.arange(Jz2P), np.arange(Jxy2P), indexing="ij")
    g_jz, g_jxy = g_jz.ravel(), g_jxy.ravel()
    real = (g_jz < Jz) & (g_jxy < Jxy) & (g_jxy % JyB < Jy)
    n_int = np.zeros((Jz2P * Jxy2P, 3), dtype=np.int64)
    n_int[real, 0] = g_jxy[real] // JyB
    n_int[real, 1] = (g_jxy[real] % JyB) - int(kmax2[1])
    n_int[real, 2] = g_jz[real] - int(kmax2[2])
    k_cart = TWOPI * (n_int @ recip_rows)
    ksq = np.sum(k_cart * k_cart, axis=1)
    # FT(erfc(a r)/r) = 4 pi/k^2 (1 - e^{-k^2/4a^2}), so the difference
    # kernel erfc(a r)/r - erfc(a2 r)/r transforms to:
    with np.errstate(divide="ignore", invalid="ignore"):
        ghat = (4.0 * PI / np.where(ksq > 0, ksq, 1.0)
                * (np.exp(-ksq / (4.0 * a2 ** 2))
                   - np.exp(-ksq / (4.0 * alpha ** 2))))
    form = np.where(n_int[:, 0] == 0, 1.0, 2.0)
    valid = real & (ksq > 1e-12) & (ksq <= k_cut * k_cut)
    coef = np.where(valid, form * ghat, 0.0) * COULOMB_K / box.volume

    # framework structure factor on the grid (separable, exact f64)
    frac = (pos_all @ recip_rows.T)                    # (NG', 3) = n.frac
    qf = site_q[src][:NG]
    # ghosts duplicate their originals only OUTSIDE the base cell; the
    # structure factor must count each PHYSICAL site once -> originals only
    is_orig = (pos_all[:, axis] >= lo_ax) & (pos_all[:, axis] < hi_ax)
    phase = np.exp(2j * PI * frac[is_orig])            # (Nf, 3)
    qs = qf[is_orig]
    A2_re, A2_im = _amps_on_grid(phase, qs, tuple(int(k) for k in kmax2),
                                 (Jz2P, Jxy2P), yb=JyB)

    coef2 = coef.reshape(Jz2P, Jxy2P)
    c2_re = coef2 * A2_re
    c2_im = coef2 * A2_im

    # constant framework structure factor on the MAIN grid (f64): the
    # per-block resynthesis and full_amplitudes start from this and only
    # synthesize the mutable guest columns
    amp_fw_re, amp_fw_im = _amps_on_grid(phase, qs, tuple(kmax_xyz),
                                         tuple(amp_shape))

    ex2 = np.zeros((Jx, Jxy2P))
    ey2 = np.zeros((Jy, Jxy2P))
    gx = np.arange(Jxy) // JyB
    gy = np.arange(Jxy) % JyB
    live = gy < Jy
    ex2[gx[live], np.arange(Jxy)[live]] = 1.0
    ey2[gy[live], np.arange(Jxy)[live]] = 1.0

    Q_fw = float(np.sum(qs))
    d0 = COULOMB_K * PI * (1.0 / alpha ** 2 - 1.0 / a2 ** 2) * Q_fw / box.volume

    return FwSplitSetup(
        True, "", S_frozen=S_frozen, guest_base=guest_base, axis=axis,
        SG=SG, pq_g=pq_g, eps_g=eps_g, sig2_g=sig2_g,
        blockmax=blockmax, WL=WL, WC=WC, rcw_lj=rcw_lj, rcw_c=rcw_c,
        alpha2=a2, rcut2=rc2, d0=d0,
        kmax2=tuple(int(k) for k in kmax2), amp2_shape=(Jz2P, Jxy2P),
        c2_re=c2_re, c2_im=c2_im, ex2_sel=ex2, ey2_sel=ey2,
        amp_fw_re=amp_fw_re, amp_fw_im=amp_fw_im)
