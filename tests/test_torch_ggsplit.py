"""The guest cutoff turned off (DIVERGENCES.md #22, ``guest_split off``)
in the port, against the JAX package: tests/test_ggsplit.py's cases with
the cutoff off.

With the cutoff off, the real-space erfc(alpha r)/r between mobile sites
is summed over every pair, as the reference does: the ``gg_cut == 0``
branch of the pair pass (physics/energy.py, csrc/common.cuh). The fixture
(L = 24 A, ewald_alpha 0.5, so gg_rcut would be 8.8 A) has many live pairs
beyond that radius, so the branch changes the energies. The CUDA kernels
run it on the card (tests/test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maniac_tpu.mc.moves import _core_kernel_grouped
from maniac_tpu.mc.moves import _propose as jax_propose
from maniac_tpu.system import E_TOT as JAX_E_TOT
from maniac_tpu_torch.kernels import block_gate_failure, step_gate_failure
from maniac_tpu_torch.kernels.stepg import step_core_plain
from maniac_tpu_torch.mc.driver import run_steps_u
from maniac_tpu_torch.mc.moves import _core_plain, _propose
from maniac_tpu_torch.parallel.replicas import replicate, run_block_uniforms
from maniac_tpu_torch.physics.energy import system_energy
from maniac_tpu_torch.system import E_TOT, from_numpy
from maniac_tpu_torch.systems import make_water_box

from torch_parity import (F32_ENERGY_TOL, F32_POS_TOL, as_np,
                          assert_same_chain, jax_batch, jax_blockg,
                          jax_leaves, load_both, uniforms)

torch.set_num_threads(1)

KCAL_PER_K = 1.0 / 503.2189
PROPOSAL_E_RTOL = 1e-4   # tests/test_torch_stepg.py: rejected overlaps


def _fixture(d, **kw):
    """tests/test_ggsplit.py's water box, the cutoff off unless kw says."""
    kw.setdefault("guest_split", "off")
    make_water_box(d, n_water=24, L=24.0, cutoff=8.0, ewald_alpha=0.5,
                   fugacity=40000.0, probs=(0.3, 0.2, 0.5, 0.0), **kw)
    return d


def test_gg_off_total_and_per_move_match_jax(tmp_path):
    """(test_ggsplit.py:68) With the cutoff off the port's total equals
    JAX's (f64), differs from the cut total by less than the 1e-6 kcal/mol
    a molecule bar but not by 0, and 60 steps on the same uniforms give
    JAX's chain: the same decisions, positions within 1e-10 A."""
    sysm, spec, state = load_both(_fixture(str(tmp_path / "off")),
                                  capacity=32)
    assert not spec.gg_cut and not sysm.spec.gg_cut
    e_off = system_energy(spec, state)[0][0, E_TOT]
    assert abs(float(e_off) - float(sysm.state.energy[JAX_E_TOT])) \
        <= 1e-9 * abs(float(e_off))
    _, spec_on, state_on = load_both(
        _fixture(str(tmp_path / "on"), guest_split="auto"), capacity=32)
    assert spec_on.gg_cut
    e_on = system_energy(spec_on, state_on)[0][0, E_TOT]
    assert float(e_on) != float(e_off), "the cutoff excluded no pair"
    assert abs(float(e_on - e_off)) * KCAL_PER_K < 1e-6 * int(
        state.n_mol[0, 0])
    U = uniforms(2, 60, seed=9, f32=False)
    pst = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U),
                      core=_core_plain)
    jst = jax_batch(sysm.spec, sysm.state, U)
    assert_same_chain(jst, pst, pos_tol=1e-10, energy_tol=1e-6)
    assert int(pst.counters[:, 1].sum()) > 0


def test_gg_off_bookkeeping_matches_recompute(tmp_path):
    """(test_ggsplit.py:100) f64: after 3 x 40 steps with the cutoff off,
    the running total and the amplitudes equal a fresh recompute."""
    _, spec, state = load_both(_fixture(str(tmp_path)), capacity=32)
    st = replicate(spec, state, 2)
    for seed in range(3):
        U = uniforms(2, 40, seed=50 + seed, f32=False)
        st = run_steps_u(spec, st, torch.from_numpy(U), core=_core_plain)
        e, amp_re, amp_im = system_energy(spec, st)
        assert float((st.energy[:, E_TOT] - e[:, E_TOT]).abs().max()) < 1e-7
        assert float((st.amp_re - amp_re).abs().max()) < 1e-7
        assert float((st.amp_im - amp_im).abs().max()) < 1e-7


def test_gg_off_step_core_matches_pallas_stepg(tmp_path, monkeypatch):
    """(test_ggsplit.py:112) f32: the same proposals through the port's
    step core (plain on the CPU) and JAX's Pallas step core (interpret
    mode), the cutoff off: identical acceptances, energies within 5 K
    (plus 1e-4 relative), positions within 1e-4 A."""
    sysm, spec, _ = load_both(_fixture(str(tmp_path)), capacity=32,
                              f32=True)
    assert not spec.gg_cut and step_gate_failure(spec) is None
    monkeypatch.setenv("MANIAC_PALLAS", "0")
    jst = jax_batch(sysm.spec, sysm.state, uniforms(4, 10, seed=21,
                                                    f32=True))
    monkeypatch.setenv("MANIAC_PALLAS", "1")
    _, st = from_numpy(jax_leaves(sysm.spec), jax_leaves(jst), device="cpu",
                       dtype=torch.float32)
    for seed in range(3):
        u = uniforms(4, 1, seed=30 + seed, f32=True)[:, 0]
        core = step_core_plain(spec, st,
                               _propose(spec, st, torch.from_numpy(u)))
        jpre = jax.vmap(lambda s, uu: jax_propose(sysm.spec, s, uu))(
            jst, jnp.asarray(u))
        jcore = _core_kernel_grouped(sysm.spec, jst, jpre)
        np.testing.assert_array_equal(as_np(core["acc"]),
                                      np.asarray(jcore["acc"]))
        for name in ("e_lj", "e_coul", "delta_e", "e_recip_new"):
            np.testing.assert_allclose(as_np(core[name]),
                                       np.asarray(jcore[name]),
                                       atol=F32_ENERGY_TOL,
                                       rtol=PROPOSAL_E_RTOL, err_msg=name)
        assert np.abs(as_np(core["pos"]) - np.asarray(jcore["pos"])).max() \
            <= F32_POS_TOL


def test_gg_off_block_matches_pallas_blockg(tmp_path):
    """(test_ggsplit.py:146) f32: the port's block (plain on the CPU) and
    JAX's Pallas blockg (interpret mode), G = 2 x 30 steps with the cutoff
    off: identical populations and counters, positions within 1e-4 A,
    energies within 5 K."""
    sysm, spec, state = load_both(_fixture(str(tmp_path)), capacity=32,
                                  f32=True)
    assert not spec.gg_cut and block_gate_failure(spec) is None
    U = uniforms(2, 30, seed=82, f32=True)
    out = run_block_uniforms(spec, replicate(spec, state, 2),
                             torch.from_numpy(U), recalibrate=True,
                             resync=True)
    assert_same_chain(jax_blockg(sysm, U), out, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    assert int(out.counters[:, 1].sum()) > 0
