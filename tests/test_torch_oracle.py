"""maniac_tpu_torch's total energy against the independent oracle
(scripts/oracle.py) and against the JAX package: tests/test_oracle.py's 6
cases, run on the port.

The oracle shares no code with either package (scripts/oracle.py:1-27):
its own Ewald split, its own Coulomb constant. The port's startup TotEng
must sit within the reference's LAMMPS bar, 0.01 kcal/mol, of it, and
within 1e-9 relative of the JAX package's TotEng on the same files (f64,
the CPU). The CO2 GCMC case also walks the JAX package's chain from one
seed and holds its energies to 1e-9 relative.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

import maniac_tpu
from maniac_tpu.mc.driver import run_block as jax_run_block
from maniac_tpu_torch import load_system
from maniac_tpu_torch.constants import COULOMB_K, KB_KCALMOL
from maniac_tpu_torch.mc.driver import block_body
from maniac_tpu_torch.physics.energy import site_positions, system_energy
from maniac_tpu_torch.system import E_TOT

from torch_parity import build_both, files

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from oracle import (COULOMB_K_ORACLE, oracle_total,  # noqa: E402
                    periodic_coulomb)

torch.set_num_threads(1)

TOL_KCALMOL = 0.01   # the reference's LAMMPS-parity bar
JAX_RTOL = 1e-9      # the port's f64 TotEng against the JAX package's


def _load(outdir, **kw):
    """The port's system on the CPU, f64; its TotEng held to the JAX
    package's on the same files."""
    sysm = load_system(*files(outdir), device="cpu", **kw)
    jax_sysm = maniac_tpu.load_system(*files(outdir), **kw)
    got = float(sysm.state.energy[0, E_TOT])
    want = float(jax_sysm.state.energy[E_TOT])
    assert abs(got - want) <= JAX_RTOL * abs(want), (got, want)
    return sysm


def _gather_inputs(sysm):
    """Positions, charges, molecule ids and per-pair LJ tables of the live
    sites, the oracle's inputs (tests/test_oracle.py:45-55)."""
    spec, state = sysm.spec, sysm.state
    pos = site_positions(spec, state)[0].double().numpy()
    q = spec.site_q.double().numpy()
    mol = spec.site_mol.numpy()
    active = (spec.site_midx < state.n_mol[0][spec.site_type.long()]).numpy()
    pos, q, mol = pos[active], q[active], mol[active]
    cls = spec.site_cls.numpy()[active]
    eps = spec.eps_cls.numpy()[np.ix_(cls, cls)]
    sig = spec.sig_cls.numpy()[np.ix_(cls, cls)]
    return pos, q, mol, eps, sig


def _assert_near_oracle(sysm, ref):
    got = float(sysm.state.energy[0, E_TOT])
    diff_kcal = abs(got - ref) * KB_KCALMOL
    assert diff_kcal < TOL_KCALMOL, (got, ref, diff_kcal)


def test_coulomb_constant_documents_reference_rounding():
    """The reference hardcodes e^2/(4 pi eps0) = 14.40198 eV*A
    (src/constants.f90:12), 1.56e-4 above CODATA; the port keeps it, as
    the JAX package does."""
    ratio = COULOMB_K / COULOMB_K_ORACLE - 1.0
    assert 1.4e-4 < ratio < 1.7e-4, ratio
    assert COULOMB_K == maniac_tpu.constants.COULOMB_K


def test_water_box_total_energy_vs_oracle(tmp_path):
    """8 rigid waters, the port's startup energy against the oracle."""
    d = build_both("make_water_box", tmp_path / "w", n_water=8, L=14.0,
                   cutoff=6.0, tol=1e-6)
    sysm = _load(d)
    pos, q, mol, eps, sig = _gather_inputs(sysm)
    ref = oracle_total(pos, q, mol, 14.0, eps, sig, cutoff=6.0,
                       alpha=0.45, n_images=3, kmax=24, coulomb_k=COULOMB_K)
    _assert_near_oracle(sysm, ref)


def test_nacl_total_energy_vs_oracle(tmp_path):
    """Rock salt: a pure Coulomb crystal through the whole pipeline."""
    a = 5.6402
    d = build_both("make_nacl", tmp_path / "nacl", n_cells=2, a=a,
                   cutoff=5.6, tol=1e-7)
    sysm = _load(d)
    pos, q, _, _, _ = _gather_inputs(sysm)
    ref = periodic_coulomb(pos, q, 2 * a, alpha=0.5, n_images=3, kmax=24,
                           coulomb_k=COULOMB_K)
    # one site per "molecule": no intra, no LJ
    _assert_near_oracle(sysm, ref)


def test_oracle_self_consistency_alpha_invariance():
    """The oracle itself is invariant to its Ewald split."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 10.0, (16, 3))
    q = rng.normal(0, 0.5, 16)
    q -= q.mean()  # neutral
    e1 = periodic_coulomb(pos, q, 10.0, alpha=0.4, n_images=3, kmax=20)
    e2 = periodic_coulomb(pos, q, 10.0, alpha=0.6, n_images=3, kmax=28)
    assert abs(e1 - e2) < 1e-6 * max(1.0, abs(e1))


def test_co2_framework_total_energy_vs_oracle(tmp_path):
    """MFI-CO2 analog: linear 3-site CO2 guests in a charged framework (the
    linear-molecule path, repeated atom types in one residue) against the
    oracle."""
    d = build_both("make_mfi_co2", tmp_path / "mfi", n_cells=3, a=6.0,
                   n_co2=5, cutoff=6.0, tol=1e-6)
    sysm = _load(d)
    pos, q, mol, eps, sig = _gather_inputs(sysm)
    ref = oracle_total(pos, q, mol, 3 * 6.0, eps, sig, cutoff=6.0,
                       alpha=0.5, n_images=3, kmax=28, coulomb_k=COULOMB_K)
    _assert_near_oracle(sysm, ref)


def test_co2_moves_consistency(tmp_path):
    """GCMC on the linear CO2 guest keeps bookkeeping == recompute (1e-7 K
    after each of 3 blocks of 50 steps) and exercises every move class; the
    deck's seed walks the JAX package's chain, energies within 1e-9
    relative and counters equal."""
    d = build_both("make_mfi_co2", tmp_path / "mfi", n_cells=3, a=6.0,
                   n_co2=5, cutoff=6.0, tol=1e-5, fugacity=60.0)
    sysm = load_system(*files(d), device="cpu", capacity=12)
    jax_sysm = maniac_tpu.load_system(*files(d), dtype=jnp.float64,
                                      capacity=12)
    spec, st = sysm.spec, sysm.state
    jst = jax_sysm.state
    for _ in range(3):
        st = block_body(spec, st, 50, False)
        jst = jax_run_block(jax_sysm.spec, jst, 50, False)
        e, _, _ = system_energy(spec, st)
        assert float(abs(st.energy[0, E_TOT] - e[0, E_TOT])) < 1e-7
        np.testing.assert_allclose(st.energy[0].numpy(),
                                   np.asarray(jst.energy), rtol=JAX_RTOL,
                                   atol=1e-9)
    c = st.counters[0].numpy()
    np.testing.assert_array_equal(c, np.asarray(jst.counters))
    assert c[0, :4].min() > 0  # every move class tried, rotation included
