"""Real-material anchors run on maniac_tpu_torch: tests/test_validation.py's
4 cases.

ZIF-8 (Park et al., PNAS 103, 10186 (2006)): the published cubic cell
(I-43m, a = 16.991 A) with the Zn sublattice on the sodalite 12d sites and
idealized 2-methylimidazolate linkers (systems.zif8_cell_sites documents
which parts are published). The structure checks pin the published
geometry of the port's cell (and its positions equal the JAX package's
cell's); the geometric pore volume is a deterministic quadrature. The
two engine-driven cases stay marked ``slow`` as in the JAX test: EPM2
CO2's second virial coefficient at 300 K through the port's ghost-insertion
energetics (mc/widom.widom_delta_u) against experiment, and GCMC Ar at
87.3 K / 1 atm in ZIF-8 (f32, the port's single chain) against the
published micropore volume. They use the JAX test's sizes, seeds and
gates.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maniac_tpu.systems import zif8_cell_sites as jax_zif8_cell_sites
from maniac_tpu_torch import load_system
from maniac_tpu_torch.mc.driver import block_body, resync
from maniac_tpu_torch.systems import zif8_cell_sites

from torch_parity import build_both, files

A_CELL = 16.991           # published cell constant (Park et al. 2006)
M_CELL = 2730.9           # Zn12(C4H5N2)24 g/mol (published formula)
V_LIQ_AR = 28.7           # liquid Ar molar volume at 87 K, cm^3/mol
B2_EXP_CO2_300K = -121.7  # cm^3/mol, Dymond & Smith compilation (300 K)


def _mimg(d, a=A_CELL):
    return d - a * np.round(d / a)


def test_zif8_published_geometry():
    pos, elem = zif8_cell_sites()
    jax_pos, jax_elem = jax_zif8_cell_sites()
    np.testing.assert_array_equal(pos, jax_pos)
    assert list(elem) == list(jax_elem)
    elem = np.asarray(elem)
    # published cell content: Zn12(mIm)24, mIm = C4H5N2 with a methyl
    # united atom (E) and 2 explicit ring H
    assert len(elem) == 204
    assert (elem == "Zn").sum() == 12 and (elem == "N").sum() == 48
    zn = pos[elem == "Zn"]
    # sodalite net: every Zn has 4 equidistant Zn neighbours at ~6.0 A
    for i in range(12):
        d = np.sort(np.linalg.norm(_mimg(zn - zn[i]), axis=1))[1:5]
        assert np.allclose(d, 6.007, atol=0.01), d
    # published Zn-N bond length 1.987 A, 4 N per Zn
    npos = pos[elem == "N"]
    dzn = np.linalg.norm(_mimg(npos[:, None, :] - zn[None, :, :]), axis=2)
    assert np.allclose(dzn.min(axis=1), 1.987, atol=0.005)
    assert ((dzn < 2.1).sum(axis=0) == 4).all()
    # crystallographic density from the published cell and formula
    rho = M_CELL / (A_CELL ** 3 * 0.6022)
    assert abs(rho - 0.9245) < 0.002


@pytest.mark.slow
def test_co2_b2_vs_experiment(tmp_path):
    """Second virial coefficient of EPM2 CO2 at 300 K through the port's
    ghost-insertion energetics against the experimental B2.

    B2 = -1/2 INT < exp(-u12/T) - 1 > dr12, u12 = widom_delta_u(one
    resident) - widom_delta_u(empty box): the resident-ghost interaction
    (LJ + full Ewald Coulomb) the acceptance rule uses. The COM integral is
    quasi-MC (Sobol, seed 11, 2^16 points) in a ball of the LJ cutoff's
    radius, orientations uniform on SO(3); the r > rc dispersion tail is
    analytic. The JAX package measured -104.1 cm^3/mol (the known
    shortfall of rigid 3-site CO2 models against experiment's -121.7);
    gate [-140, -92] cm^3/mol, sharp against energy-scale faults (+-10%
    moves B2 to about -140 / -78)."""
    from scipy.stats import qmc

    from maniac_tpu_torch.mc.widom import widom_delta_u

    T = 300.0
    L, RC = 30.0, 10.0
    d = build_both("make_co2_box", tmp_path / "co2", n_co2=1, L=L,
                   seed=None, cutoff=RC, tol=1e-5, temp=T)
    sysm = load_system(*files(d), dtype=torch.float64, capacity=4,
                       device="cpu")
    spec, st1 = sysm.spec, sysm.state
    assert int(st1.n_mol[0, 0]) == 1
    # the empty box: the same spec, no molecule, zero structure factors
    st0 = dataclasses.replace(
        st1, n_mol=torch.zeros_like(st1.n_mol),
        amp_re=torch.zeros_like(st1.amp_re),
        amp_im=torch.zeros_like(st1.amp_im))

    def mayer_sum(u):
        du = widom_delta_u(spec, st1, u, 0) - widom_delta_u(spec, st0, u, 0)
        return float(torch.expm1(-du / T).sum())

    n_pts, chunk = 2 ** 16, 2 ** 13
    pts = qmc.Sobol(d=6, scramble=True, seed=11).random(n_pts)
    acc = 0.0
    for c in range(0, n_pts, chunk):
        t = pts[c:c + chunk]
        r = RC * t[:, 0] ** (1.0 / 3.0)
        cth = 2.0 * t[:, 1] - 1.0
        sth = np.sqrt(np.maximum(0.0, 1.0 - cth * cth))
        phi = 2.0 * np.pi * t[:, 2]
        com = np.stack([r * sth * np.cos(phi), r * sth * np.sin(phi),
                        r * cth], axis=1)          # resident at the origin
        u = np.concatenate([(com + L / 2) / L, t[:, 3:6]], axis=1)
        acc += mayer_sum(u)
    v_ball = 4.0 / 3.0 * np.pi * RC ** 3
    b2_core = -0.5 * v_ball * acc / n_pts          # A^3 / molecule
    # analytic r > rc dispersion tail: f ~ -u/T with u = -C6_eff/r^6,
    # C6_eff the sum over the 9 site pairs of 4 eps_ij sig_ij^6 (LB mixing,
    # eps in K) -> B2_tail = -(2 pi / 3) C6_eff / (T rc^3)
    eps = {"O": 80.507, "C": 28.129}
    sig = {"O": 3.033, "C": 2.757}
    c6 = 0.0
    for a in ("O", "C", "O"):
        for b in ("O", "C", "O"):
            c6 += 4.0 * np.sqrt(eps[a] * eps[b]) * ((sig[a] + sig[b]) / 2) ** 6
    b2_tail = -(2.0 * np.pi / 3.0) * c6 / (T * RC ** 3)
    b2 = (b2_core + b2_tail) * 0.602214            # A^3 -> cm^3/mol
    assert -140.0 < b2 < -92.0, (
        b2, b2_core * 0.602214, b2_tail * 0.602214, B2_EXP_CO2_300K)


def _zif8_geometric_pore_volume(n_samples=200_000, seed=3):
    """Ar-occupiable volume of the model framework by deterministic Monte
    Carlo integration (cm^3/g): a point counts if no framework atom sits
    within (sigma_mix - r_Ar), the occupiable (Connolly) volume a Gurvich
    liquid-filling measurement compares with. No energies, no GCMC."""
    pos, elem = zif8_cell_sites()
    a = A_CELL
    # UFF/TraPPE sigmas from make_zif8's parameter table + Ar 3.405
    sig = {"Zn": 2.462, "N": 3.261, "C": 3.431, "E": 3.75, "H": 2.571}
    r_ar = 3.405 / 2
    r_ex = np.array([(sig[e] + 3.405) / 2 - r_ar for e in elem])
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, a, (n_samples, 3))
    acc = 0
    chunk = 20_000
    for c in range(0, n_samples, chunk):
        d = pts[c:c + chunk, None, :] - pos[None, :, :]
        d -= a * np.round(d / a)
        r2 = (d * d).sum(axis=2)                     # (chunk, n_fw)
        acc += int((r2 > (r_ex * r_ex)[None, :]).all(axis=1).sum())
    frac = acc / n_samples
    return frac * a ** 3 / M_CELL * 0.6022           # cm^3/g


def test_zif8_geometric_pore_volume_vs_published():
    """The model's Ar-occupiable volume sits on the published ZIF-8
    micropore-volume window (~0.6-0.7 cm^3/g); the JAX package measured
    0.729. Deterministic quadrature, so the gate is tight: [0.60, 0.80]."""
    v_geom = _zif8_geometric_pore_volume()
    assert 0.60 < v_geom < 0.80, v_geom


@pytest.mark.slow
def test_zif8_ar_pore_volume_vs_published(tmp_path):
    """GCMC Ar at 87.3 K / 1 atm on the port's f32 single chain (14
    blocks of 2000 steps, each followed by a resync): the Gurvich micropore
    volume in the published 0.6-0.7 cm^3/g window (+-35% for the
    idealized-linker model), and its ratio to the model's own occupiable
    volume in [0.60, 1.25] (an energy-scale fault breaks the ratio before
    the absolute window sees it)."""
    d = build_both("make_zif8", tmp_path / "zif8", n_guest=40)
    sysm = load_system(*files(d), dtype=torch.float32, capacity=96,
                       device="cpu")
    spec, state = sysm.spec, sysm.state
    Ns = []
    for _ in range(14):
        state = block_body(spec, state, 2000, False)
        state = resync(spec, state)
        Ns.append(int(state.n_mol[0, 1]))            # residue 1 = Ar
    nbar = float(np.mean(Ns[7:]))
    vpore = nbar * V_LIQ_AR / M_CELL
    assert 0.45 < vpore < 0.90, (Ns, vpore)
    v_geom = _zif8_geometric_pore_volume(n_samples=100_000)
    assert 0.60 < vpore / v_geom < 1.25, (vpore, v_geom)
