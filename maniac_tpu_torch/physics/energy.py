"""Energy engine in torch: LJ + real-space Ewald + reciprocal + corrections.

Counterpart of maniac_tpu/physics/energy.py (same physics, same reference
citations there), written over a leading replica axis B instead of vmap.
These functions are the plain (non-kernel) path: the f64 oracle on the CPU
and the reference the CUDA kernels are held to on the card.

Shapes: positions are (B, S, 3) site-major here (``site_positions``
transposes the state's (B, 3, S)); footprints are (B, F, A, 3) with F the
number of footprint molecules (2 for a move: old and new).

The dense k-grid is read by index: the per-axis phase powers are gathered
into grid columns with the ``k_col_jx``/``k_col_jy`` tables instead of the
JAX package's 0/1 expansion matmuls (exact either way).
"""

from __future__ import annotations

import torch

from ..constants import COULOMB_K, SMALL, TWOPI
from ..system import E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF, E_TOT, SystemSpec
from .fwsplit import FAR_LANES, FAR_TCH, FAR_YROWS
from .pbc import min_image_dist2

_R2_FLOOR = 1e-18


def site_positions(spec: SystemSpec, state) -> torch.Tensor:
    """Absolute site positions (B, S, 3) from the state's (B, 3, S)."""
    return state.pos.transpose(1, 2)


def active_site_mask(spec: SystemSpec, n_mol) -> torch.Tensor:
    """(B, S) bool: site belongs to an existing molecule."""
    n_site = n_mol[:, spec.site_type.long()]
    return spec.site_midx[None, :] < n_site


def tab_lookup(table, dx, r):
    """Linear interpolation with the reference's LookupTabulated semantics
    (src/tabulated_utils.f90:92-117), as maniac_tpu/physics/energy.py::
    tab_lookup: r <= 0 gives f[0], r at or beyond the grid's end 0,
    otherwise the lerp between the bracketing grid points."""
    n = table.shape[0] - 1
    x = r / dx
    i = torch.clamp(torch.floor(x).long(), 0, n - 1)
    t = x - i.to(r.dtype)
    val = (1.0 - t) * table[i] + t * table[i + 1]
    val = torch.where(r >= n * dx, 0.0, val)
    return torch.where(r <= 0.0, table[0], val)


def _tab_lj(spec: SystemSpec, eps, sig2, r):
    """Tabulated LJ: sigma^12 / interp(r^12) - sigma^6 / interp(r^6)
    (reference LennardJonesEnergy, src/energy_utils.f90:190-219), the
    interpolated denominators floored against the r ~ 0 pole of masked
    pairs, as the JAX package floors them."""
    sig6 = sig2 * sig2 * sig2
    den6 = torch.clamp(tab_lookup(spec.tab_r6, spec.tab_dx, r), min=_R2_FLOOR)
    den12 = torch.clamp(tab_lookup(spec.tab_r12, spec.tab_dx, r),
                        min=_R2_FLOOR)
    return 4.0 * eps * (sig6 * sig6 / den12 - sig6 / den6)


def pair_energy_footprint(spec: SystemSpec, others_pos, others_mask,
                          mov_pos, mov_q, mov_cls, mov_mask,
                          exclude_mol_a, exclude_mol_b):
    """LJ + real-space Coulomb of footprint molecules vs all other sites.

    others_pos (B, S, 3), others_mask (B, S); mov_pos (B, F, A, 3);
    mov_q/mov_cls/mov_mask (B, F, A); exclude_mol_a/b (B,). Returns
    (e_lj, e_coul), each (B, F), in Kelvin. Sites of molecule slots
    exclude_mol_a/b are skipped. With ``fw_split`` the frozen columns take
    the short erfc(alpha2 r)/r cut at rcut2 plus the far-field grid term;
    with ``gg_cut`` the mobile-pair erfc(alpha r)/r is cut at gg_rcut; with
    ``use_table`` LJ and Coulomb come from the tables (tab_lookup), whose
    Coulomb ends at the grid's end, the real-space cutoff."""
    delta = others_pos[:, None, None, :, :] - mov_pos[:, :, :, None, :]
    r2 = torch.clamp(min_image_dist2(delta, spec), min=_R2_FLOOR)  # (B,F,A,S)

    site_mol = spec.site_mol[None, :]
    keep = (others_mask & (site_mol != exclude_mol_a[:, None])
            & (site_mol != exclude_mol_b[:, None]))               # (B, S)
    mask = keep[:, None, None, :] & mov_mask[..., None]          # (B,F,A,S)

    cls = mov_cls.long()
    eps = spec.eps_site[cls]                                     # (B,F,A,S)
    sig2 = spec.sig2_site[cls]
    inv_r2 = 1.0 / r2
    inv_r = torch.sqrt(inv_r2)
    r = r2 * inv_r
    if spec.use_table:
        lj = _tab_lj(spec, eps, sig2, r)
    else:
        sr2 = sig2 * inv_r2
        sr6 = sr2 * sr2 * sr2
        lj = 4.0 * eps * (sr6 * sr6 - sr6)
    lj_mask = mask & (r2 < spec.cutoff * spec.cutoff)
    e_lj = torch.where(lj_mask, lj, 0.0).sum(dim=(2, 3))

    qq = mov_q[..., None] * spec.site_q
    if spec.use_table:
        coul = qq * tab_lookup(spec.tab_erfc, spec.tab_dx, r)
        e_coul = torch.where(mask, coul, 0.0).sum(dim=(2, 3)) * COULOMB_K
        return e_lj, e_coul
    coul = qq * torch.erfc(spec.alpha * r) * inv_r
    if spec.gg_cut:
        coul = coul * (r2 < spec.gg_rcut * spec.gg_rcut)
    if not spec.fw_split:
        e_coul = torch.where(mask, coul, 0.0).sum(dim=(2, 3)) * COULOMB_K
        return e_lj, e_coul
    frozen = torch.arange(spec.S, device=r2.device) < spec.S_frozen
    coul_short = (qq * torch.erfc(spec.alpha2 * r) * inv_r
                  * (r2 < spec.rcut2 * spec.rcut2))
    coul = torch.where(frozen, coul_short, coul)
    e_coul = torch.where(mask, coul, 0.0).sum(dim=(2, 3))
    w = (mov_q * mov_mask).to(mov_pos.dtype)
    return e_lj, e_coul * COULOMB_K + fw_far_energy(spec, mov_pos, w)


def intra_energy(spec: SystemSpec, pos, q, mask):
    """Intramolecular Ewald correction sum_{i<j} q_i q_j (erfc(a r)-1)/r.

    pos (..., A, 3), q/mask (..., A) -> (...). Reference:
    ComputeIntraResidueRealCoulombEnergySingleMol
    (src/ewald_energy.f90:371-411); minimum-image distances."""
    delta = pos[..., None, :, :] - pos[..., :, None, :]          # (...,A,A,3)
    r2 = torch.clamp(min_image_dist2(delta, spec), min=_R2_FLOOR)
    r = torch.sqrt(r2)
    qq = q[..., None, :] * q[..., :, None]
    pair_mask = mask[..., None, :] & mask[..., :, None]
    A = pos.shape[-2]
    iu = torch.triu(torch.ones((A, A), dtype=torch.bool, device=pos.device),
                    diagonal=1)
    pair_mask = pair_mask & iu & (r2 > SMALL * SMALL)
    e = qq * (torch.erfc(spec.alpha * r) - 1.0) / r
    return torch.where(pair_mask, e, 0.0).sum(dim=(-1, -2)) * COULOMB_K


def footprint_phases(spec: SystemSpec, pos):
    """theta(k) = k . r; pos (..., A, 3) -> (..., A, K)."""
    return pos @ spec.k_cart.T


def amp_delta_direct(spec: SystemSpec, pos, q, mask, signs):
    """Direct structure-factor update (cos/sin over the full (A, K) phase
    matrix): the precision oracle for amp_delta. pos (B, F, A, 3),
    q/mask (B, F, A), signs (B, F) -> (B, JzP, JxyP) twice."""
    theta = footprint_phases(spec, pos)                          # (B,F,A,K)
    w = (q * mask)[..., None] * signs[:, :, None, None]
    d_re = (w * torch.cos(theta)).sum(dim=(1, 2)) * spec.k_live
    d_im = (w * torch.sin(theta)).sum(dim=(1, 2)) * spec.k_live
    shape = (pos.shape[0],) + tuple(spec.amp_shape)
    return d_re.reshape(shape), d_im.reshape(shape)


def _axis_phase_tables(theta, kmax_xyz):
    """Per-axis complex phase power tables over the dense-grid index ranges.

    theta (..., N, 3) phase angles 2*pi*frac(r). Returns
    ((px_re, px_im), (py_re, py_im), (pz_re, pz_im)) shaped (..., N, kx+1),
    (..., N, 2ky+1), (..., N, 2kz+1); the y/z tables run j = -k..k
    (negative j = complex conjugate of |j|). One cos/sin per angle, powers
    by repeated complex multiply, as the JAX package does."""
    kx, ky, kz = kmax_xyz
    c1, s1 = torch.cos(theta), torch.sin(theta)
    res = [torch.ones_like(c1)]
    ims = [torch.zeros_like(s1)]
    for _ in range(max(kx, ky, kz)):
        re, im = res[-1], ims[-1]
        res.append(re * c1 - im * s1)
        ims.append(re * s1 + im * c1)
    re, im = torch.stack(res, dim=-1), torch.stack(ims, dim=-1)

    def signed(ax, k):
        j = torch.arange(-k, k + 1, device=theta.device)
        a = j.abs()
        return re[..., ax, a], torch.where(j < 0, -im[..., ax, a],
                                           im[..., ax, a])

    return (re[..., 0, :kx + 1], im[..., 0, :kx + 1]), signed(1, ky), \
        signed(2, kz)


def _separable_amp(spec: SystemSpec, theta, w, far: bool = False):
    """A[jz, jxy] = sum_n w_n e^{i(jx tx + jy ty + jz tz)} on a dense grid.

    theta (..., N, 3) angles 2*pi*frac(r), w (..., N). Returns (re, im)
    shaped (..., JzP, JxyP) on the main grid, or on the far-field (alpha2)
    grid with far=True. The x/y powers are read into grid columns by index
    (pad columns give 0), then one contraction over N per jz row."""
    if far:
        kmax, (JzP, _) = spec.kmax2_xyz, spec.amp2_shape
        col_jx, col_jy = spec.k2_col_jx, spec.k2_col_jy
    else:
        kmax, (JzP, _) = spec.kmax_xyz, spec.amp_shape
        col_jx, col_jy = spec.k_col_jx, spec.k_col_jy
    (px_re, px_im), (py_re, py_im), (pz_re, pz_im) = \
        _axis_phase_tables(theta, kmax)
    live = (col_jx >= 0).to(px_re.dtype)
    jx = col_jx.clamp(min=0).long()
    jy = (col_jy + kmax[1]).long()
    px_re = px_re * w[..., None]
    px_im = px_im * w[..., None]
    xe_re = px_re[..., jx] * live                     # (..., N, JxyP)
    xe_im = px_im[..., jx] * live
    ye_re, ye_im = py_re[..., jy], py_im[..., jy]
    t_re = xe_re * ye_re - xe_im * ye_im
    t_im = xe_re * ye_im + xe_im * ye_re
    pad = JzP - pz_re.shape[-1]
    pzT_re = torch.nn.functional.pad(pz_re, (0, pad)).transpose(-1, -2)
    pzT_im = torch.nn.functional.pad(pz_im, (0, pad)).transpose(-1, -2)
    d_re = pzT_re @ t_re - pzT_im @ t_im
    d_im = pzT_re @ t_im + pzT_im @ t_re
    return d_re, d_im


def fw_far_energy(spec: SystemSpec, pos, w):
    """Static-framework far-field Coulomb energy sum_i w_i D(r_i) in Kelvin:
    the footprint's phase amplitude on the alpha2 grid contracted against
    the precomputed framework coefficients. pos (..., N, 3), w (..., N)."""
    theta = pos @ spec.two_pi_Hinv.T
    d_re, d_im = _separable_amp(spec, theta, w, far=True)
    return ((spec.c2_re * d_re + spec.c2_im * d_im).sum(dim=(-1, -2))
            + spec.fw_d0 * w.sum(dim=-1))


def far_table_energy(spec: SystemSpec, pos, w):
    """fw_far_energy in the footprint kernels' contraction order over the
    far table (spec.far_*; csrc/common.cuh far_sweep): per row of constant
    (jz, jx), the y axis first, T = sum_jy conj(c) w y^jy (one complex
    multiply-add per element, the y index clamped into the zero-padded
    table as the kernels clamp it), then each row closed with x^jx z^jz and
    the real parts summed. pos (N, 3), w (N,)."""
    N = pos.shape[0]
    ky2, kz2 = spec.kmax2_xyz[1], spec.kmax2_xyz[2]
    cplx = torch.complex128 if pos.dtype == torch.float64 else torch.complex64
    theta = pos @ spec.two_pi_Hinv.T
    (px_re, px_im), (py_re, py_im), (pz_re, pz_im) = \
        _axis_phase_tables(theta, spec.kmax2_xyz)
    Y = torch.zeros((N, FAR_YROWS), dtype=cplx)
    Y[:, :2 * ky2 + 1] = torch.complex(py_re, py_im) * w[:, None]
    coef = torch.complex(spec.far_coef[..., 0], spec.far_coef[..., 1])
    base, t0, nt = (spec.far_units[..., i].long() for i in range(3))
    t = torch.arange(FAR_TCH)[:, None]
    row = base[..., None, None] + torch.arange(FAR_LANES)   # (T, W, 1, 32)
    yidx = torch.clamp(spec.far_rows[row, 2].long() + t0[..., None, None] + t,
                       max=FAR_YROWS - 1)                  # (T, W, TCH, 32)
    live = t < nt[..., None, None]
    terms = torch.where(live, coef.conj(), 0) * Y[:, yidx]
    T = torch.zeros((N, spec.far_rows.shape[0]), dtype=cplx)
    T.index_add_(1, row.expand_as(yidx).flatten(), terms.flatten(1))
    x = torch.complex(px_re, px_im)[:, spec.far_rows[:, 1].long()]
    z = torch.complex(pz_re, pz_im)[:, spec.far_rows[:, 0].long() + kz2]
    return (T * x * z).real.sum() + spec.fw_d0 * w.sum()


def amp_delta(spec: SystemSpec, pos, q, mask, signs):
    """Structure-factor update dA(k) = sum_f s_f sum_a q e^{i k.r_fa}.

    pos (B, F, A, 3), q/mask (B, F, A), signs (B, F) in {-1, 0, +1}.
    Returns (d_re, d_im), each (B, JzP, JxyP). The deletion sign is the
    fixed one (maniac_tpu/physics/energy.py::amp_delta)."""
    B = pos.shape[0]
    theta = (pos @ spec.two_pi_Hinv.T).reshape(B, -1, 3)
    w = ((q * mask) * signs[:, :, None]).reshape(B, -1)
    return _separable_amp(spec, theta, w)


def recip_energy(spec: SystemSpec, amp_re, amp_im):
    """E_recip = C * 2*pi/V * sum_k f_k W_k |A_k|^2 (Kelvin); (..., JzP,
    JxyP) -> (...)."""
    amp2 = amp_re * amp_re + amp_im * amp_im
    return ((spec.k_weights * amp2).sum(dim=(-1, -2))
            * COULOMB_K * TWOPI / spec.volume)


def recip_energy_delta(spec: SystemSpec, amp_re, amp_im, d_re, d_im):
    """E_recip(A + d) - E_recip(A) = scale * sum_k w_k (2 A.d + |d|^2)."""
    cross = (2.0 * (amp_re * d_re + amp_im * d_im)
             + d_re * d_re + d_im * d_im)
    return ((spec.k_weights * cross).sum(dim=(-1, -2))
            * COULOMB_K * TWOPI / spec.volume)


# ---------------------------------------------------------------------------
# full-system recompute (startup, resync, drift audits)
# ---------------------------------------------------------------------------

def _chunk_for(S: int) -> int:
    """Largest multiple of 8 up to 1024 that divides S."""
    best = 8
    for c in range(8, 1025, 8):
        if S % c == 0:
            best = c
    return best


def full_amplitudes(spec: SystemSpec, pos, active):
    """A(k) = sum_s q_s e^{i k.r_s} over active sites; pos (B, S, 3),
    active (B, S) -> (B, JzP, JxyP) twice. With the framework split the
    frozen prefix contributes the constant fw_amp; only the guest columns
    [guest_base, S) are synthesized."""
    B = pos.shape[0]
    lo = spec.guest_base if spec.fw_split else 0
    # fw_amp is all zeros when the split is off
    re = spec.fw_amp_re.to(pos.dtype).expand(B, -1, -1)
    im = spec.fw_amp_im.to(pos.dtype).expand(B, -1, -1)
    n = spec.S - lo
    qm = torch.where(active[:, lo:], spec.site_q[lo:], 0.0)
    theta = pos[:, lo:] @ spec.two_pi_Hinv.T                     # (B, n, 3)
    chunk = _chunk_for(n)
    for c in range(0, n, chunk):
        d_re, d_im = _separable_amp(spec, theta[:, c:c + chunk],
                                    qm[:, c:c + chunk])
        re, im = re + d_re, im + d_im
    return re, im


def full_pair_energy(spec: SystemSpec, pos, active):
    """Total LJ + real-space Coulomb over unordered inter-molecular pairs,
    chunked over rows (reference: ComputePairwiseEnergy,
    src/energy_utils.f90:83-187). pos (B, S, 3), active (B, S) -> (B,)
    twice."""
    S = spec.S
    chunk = _chunk_for(S)
    site_cls = spec.site_cls.long()
    col = torch.arange(S, device=pos.device)
    e_lj = pos.new_zeros(pos.shape[0])
    e_c = pos.new_zeros(pos.shape[0])
    for c in range(0, S, chunk):
        i = col[c:c + chunk]
        delta = pos[:, None, :, :] - pos[:, i, None, :]          # (B,ch,S,3)
        r2 = torch.clamp(min_image_dist2(delta, spec), min=_R2_FLOOR)
        mask = (active[:, i, None] & active[:, None, :]
                & (spec.site_mol[i][:, None] != spec.site_mol[None, :]))
        eps = spec.eps_cls[site_cls[i]][:, site_cls]             # (ch, S)
        sig = spec.sig_cls[site_cls[i]][:, site_cls]
        r = torch.sqrt(r2)
        if spec.use_table:
            lj = _tab_lj(spec, eps, sig * sig, r)
        else:
            sr2 = (sig * sig) / r2
            sr6 = sr2 * sr2 * sr2
            lj = 4.0 * eps * (sr6 * sr6 - sr6)
        lj_mask = mask & (r2 < spec.cutoff * spec.cutoff)
        e_lj = e_lj + torch.where(lj_mask, lj, 0.0).sum(dim=(1, 2))
        qq = spec.site_q[i][:, None] * spec.site_q[None, :]
        if spec.use_table:
            coul = qq * tab_lookup(spec.tab_erfc, spec.tab_dx, r)
        else:
            coul = qq * torch.erfc(spec.alpha * r) / r
        if spec.gg_cut:
            coul = coul * (r2 < spec.gg_rcut * spec.gg_rcut)
        if spec.fw_split:
            # frozen<->mobile cross pairs take the short split term; the
            # far-field remainder is added once below
            one_frozen = ((i < spec.S_frozen)[:, None]
                          ^ (col < spec.S_frozen)[None, :])
            coul_short = (qq * torch.erfc(spec.alpha2 * r) / r
                          * (r2 < spec.rcut2 * spec.rcut2))
            coul = torch.where(one_frozen, coul_short, coul)
        e_c = e_c + torch.where(mask, coul, 0.0).sum(dim=(1, 2))
    e_c = 0.5 * e_c * COULOMB_K
    if spec.fw_split:
        w = torch.where(active & (col >= spec.S_frozen), spec.site_q, 0.0)
        e_c = e_c + fw_far_energy(spec, pos, w)
    return 0.5 * e_lj, e_c


def full_intra_energy(spec: SystemSpec, state, pos):
    """Sum of intramolecular corrections over ACTIVE types only; (B,)."""
    total = pos.new_zeros(pos.shape[0])
    for r in range(spec.R):
        if not spec.active_list[r]:
            continue
        cap, A = spec.cap_list[r], spec.A_list[r]
        base = spec.site_base_list[r]
        region = cap * A
        p = pos[:, base:base + region].reshape(-1, cap, A, 3)
        q = spec.site_q[base:base + region].reshape(cap, A)
        mask = torch.ones((cap, A), dtype=torch.bool, device=pos.device)
        e_mol = intra_energy(spec, p, q, mask)                   # (B, cap)
        mol_mask = (torch.arange(cap, device=pos.device)[None, :]
                    < state.n_mol[:, r:r + 1])
        total = total + torch.where(mol_mask, e_mol, 0.0).sum(dim=1)
    return total


def system_energy(spec: SystemSpec, state):
    """Full from-scratch energy and fresh structure factors (reference:
    ComputeSystemEnergy, src/energy_utils.f90:18-35). Returns
    (energy (B, 6), amp_re, amp_im)."""
    pos = site_positions(spec, state)
    active = active_site_mask(spec, state.n_mol)
    e_lj, e_coul = full_pair_energy(spec, pos, active)
    amp_re, amp_im = full_amplitudes(spec, pos, active)
    e_recip = recip_energy(spec, amp_re, amp_im)
    e_self = (spec.type_self_energy
              * state.n_mol[:, :spec.R].to(pos.dtype)).sum(dim=1)
    e_intra = full_intra_energy(spec, state, pos)
    e = pos.new_zeros(pos.shape[0], 6)
    e[:, E_RECIP] = e_recip
    e[:, E_LJ] = e_lj
    e[:, E_COUL] = e_coul
    e[:, E_SELF] = e_self
    e[:, E_INTRA] = e_intra
    e[:, E_TOT] = e_recip + e_lj + e_coul + e_self + e_intra
    return e, amp_re, amp_im
