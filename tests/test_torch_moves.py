"""maniac_tpu_torch MC step against the JAX package on the same uniforms.

Both packages consume one row of 21 uniforms per step; the rows come from
a numpy seed, so the two chains are the same chain and must take the same
decisions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.kernels.blockg import run_block_grouped
from maniac_tpu.mc.moves import _core_xla as jax_core
from maniac_tpu.mc.moves import _propose as jax_propose
from maniac_tpu.mc.moves import _uint as jax_uint
from maniac_tpu_torch.constants import TYPE_CREATION
from maniac_tpu_torch.mc.driver import drift_report, run_steps_u, steps_plain
from maniac_tpu_torch.mc.moves import _core_plain, _propose, _uint, mc_step_u
from maniac_tpu_torch.parallel.replicas import replicate
from maniac_tpu_torch.systems import (make_framework_mixed, make_mixed_sizes,
                                      make_water_box, make_zif_like)

from torch_parity import (F32_ENERGY_TOL, F32_POS_TOL, assert_same_chain,
                          jax_batch, load_both, uniforms)

torch.set_num_threads(1)


def _zif(d):
    make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


def _water(d):
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.25, 0.25, 0.5, 0.0), fugacity=5000.0)


def _fw_mixed(d):
    # two active species (water and a dimer) with swaps, no framework split
    # at this box size
    make_framework_mixed(d, n_cells=2, a=5.66, n_water=3, n_dimer=3)


def _mixed_sizes(d):
    make_mixed_sizes(d, n_water=6, n_dimer=6, L=16.0, cutoff=6.0, tol=1e-4,
                     probs=(0.2, 0.1, 0.3, 0.4), fug_w=500.0, fug_d=500.0)


@pytest.mark.parametrize("make", [_zif, _water, _fw_mixed, _mixed_sizes],
                         ids=["zif", "water_gcmc", "framework_mixed",
                              "mixed_sizes"])
def test_f64_chain_matches_jax(tmp_path, make):
    """200 steps in f64: identical populations, counters and extras,
    positions within 1e-10 A, and bookkeeping equal to a recompute."""
    make(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16)
    U = uniforms(1, 200, seed=0, f32=False)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, state, torch.from_numpy(U))
    assert_same_chain(jst, pst, pos_tol=1e-10, energy_tol=1e-6)
    c = pst.counters[0].numpy()
    assert c[0, :4].min() > 0 and c[1].sum() > 0  # every move was tried
    if spec.n_active > 1:
        assert c[0, 4] > 0                        # and the swap
    rep = drift_report(spec, pst)
    assert rep["drift_K"] <= 1e-6, rep


def test_f32_chain_matches_jax(tmp_path):
    """Framework fixture in f32, B = 2, 40 steps: identical decisions,
    positions < 1e-4 A, energies < 5 K (tests/test_blockg.py bounds)."""
    _zif(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    U = uniforms(2, 40, seed=1, f32=True)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U))
    assert_same_chain(jst, pst, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    assert pst.counters[:, 1].sum() > 0


def test_uint_matches_jax_at_f32_edges():
    """floor(u*n) clamped to n-1: the same f32 arithmetic as the JAX draw,
    including u just below 1 where u*n rounds up to n."""
    one_minus = np.nextafter(np.float32(1), np.float32(0))
    u = np.array([0.0, 0.5, one_minus, np.float32(1 / 3),
                  np.float32(2 / 3), np.nextafter(np.float32(2 / 3),
                                                  np.float32(1))],
                 dtype=np.float32)
    for n in (1, 2, 3, 7, 31, 192, 2 ** 20 + 1):
        ref = np.asarray(jax_uint(jnp.asarray(u), jnp.int32(n)))
        got = _uint(torch.from_numpy(u), n).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"n={n}")
        assert got.max() <= n - 1


def test_edge_uniforms_at_move_thresholds(tmp_path):
    """Rows with u_move exactly at each p_cum threshold (and one ulp above),
    u_cd exactly at the create/delete split and the molecule draw at
    1 - ulp: both packages must pick the same move types."""
    _water(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    p = spec.p_cum.numpy()
    up = lambda x: np.nextafter(np.float32(x), np.float32(2))  # noqa: E731
    rows = []
    for u_move in (p[0], up(p[0]), p[1], up(p[1]), p[2], up(p[2])):
        for u_cd in (np.float32(0.5), up(0.5)):
            r = np.full(21, 0.37, np.float32)
            r[0], r[1] = u_move, u_cd
            r[13] = np.nextafter(np.float32(1), np.float32(0))
            r[2] = 0.0  # accept whenever the gate allows
            rows.append(r)
    U = np.stack(rows)[None]                       # one replica, n steps
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, state, torch.from_numpy(U))
    assert_same_chain(jst, pst, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    trials = pst.counters[0, 0].numpy()
    assert trials[0] > 0 and trials[1] > 0 and trials[2] > 0
    assert trials[3] > 0


def _overlap_row(spec, state):
    """A creation of molecule 0's type onto molecule 0 (the same sites, the
    identity rotation), accepted only if u_acc 0.5 says so: (1, 1, 21)
    f32."""
    com0 = state.com[0, :, 0].double()
    frac = (com0 - spec.bounds[:, 0].double()) @ spec.Hinv.double().T
    row = np.full(21, 0.37, np.float32)
    row[0], row[1], row[2] = 0.7, 0.25, 0.5    # a creation; u_acc 0.5
    row[6:9] = frac.numpy()                    # molecule 0's COM
    row[15], row[16] = 0.0, 0.25               # the identity rotation
    return row[None, None]


def test_rejected_overlap_keeps_energies_finite(tmp_path):
    """An insertion onto an existing molecule (the same sites, so r2 sits at
    the 1e-18 floor, (sigma^2/r2)^3 overflows f32 and its LJ term is
    inf - inf = NaN in both packages' cores) is rejected, and the running
    energies stay as they were, as in JAX's jitted step: the port commits
    the deltas of accepted moves only (a select; a 0/1 product would keep
    0 x NaN = NaN, as JAX's _bookkeep does when run op by op). f32; the
    block kernel's bookkeeping is the same select."""
    _water(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    U = _overlap_row(spec, state)
    row = U[0, 0]
    pre = _propose(spec, state, torch.from_numpy(U[:, 0]))
    core = _core_plain(spec, state, pre)
    assert bool(pre["gate"][0]) and not bool(torch.isfinite(core["e_lj"]).all())
    jpre = jax_propose(sysm.spec, sysm.state, jnp.asarray(row))
    jcore = jax_core(sysm.spec, sysm.state, jpre)
    np.testing.assert_array_equal(np.isfinite(np.asarray(jcore["e_lj"])),
                                  torch.isfinite(core["e_lj"][0]).numpy())
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, state, torch.from_numpy(U))
    assert torch.equal(pst.energy, state.energy)
    np.testing.assert_array_equal(pst.energy.numpy(), np.asarray(jst.energy))
    assert int(pst.counters[0, 0, 0]) == 1 and int(pst.counters[0, 1, 0]) == 0
    np.testing.assert_array_equal(pst.n_mol.numpy(), np.asarray(jst.n_mol))
    assert torch.equal(pst.pos, state.pos)


def test_rejected_overlap_in_jax_blockg_keeps_energies_finite(tmp_path):
    """The overlapping creation above through JAX's Pallas blockg
    (run_block_grouped, interpret mode) and through the port's plain block
    (steps_plain): one creation trial, none accepted, and all six energies
    finite and equal to the loaded ones in both. JAX's blockg multiplies its
    deltas by the 0/1 decision, so this asks whether it keeps the NaN the
    port's select removed; it does not (f32, capacity 16)."""
    _water(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    U = _overlap_row(spec, state)
    jst = jax.tree_util.tree_map(lambda x: jnp.stack([x]), sysm.state)
    uq = jnp.asarray(U.transpose(1, 2, 0).reshape(1, 21))
    out = run_block_grouped(sysm.spec, jst, uq, interpret=True)
    eng, cnt = np.asarray(out[5])[:6, 0], np.asarray(out[6])[:, 0]
    assert cnt[TYPE_CREATION] == 1 and cnt[8 + TYPE_CREATION] == 0
    assert np.isfinite(eng).all()
    np.testing.assert_array_equal(eng, np.asarray(sysm.state.energy))
    pst = steps_plain(spec, state, torch.from_numpy(U))
    assert int(pst.counters[0, 0, TYPE_CREATION]) == 1
    assert int(pst.counters[0, 1].sum()) == 0
    assert bool(torch.isfinite(pst.energy).all())
    np.testing.assert_array_equal(pst.energy[0].numpy(), eng)


def test_step_is_batched_over_replicas(tmp_path):
    """Replica b of a batched step equals a B = 1 step on row b (f64; the
    tolerance only absorbs summation order in batched reductions)."""
    _zif(str(tmp_path))
    _, spec, state = load_both(str(tmp_path), capacity=16)
    U = torch.from_numpy(uniforms(3, 1, seed=5, f32=False))[:, 0]
    out = mc_step_u(spec, replicate(spec, state, 3), U)
    for b in range(3):
        one = mc_step_u(spec, state, U[b:b + 1])
        for name in ("pos", "com", "amp_re", "energy", "n_mol", "counters"):
            np.testing.assert_allclose(getattr(out, name)[b].numpy(),
                                       getattr(one, name)[0].numpy(),
                                       rtol=1e-12, atol=1e-12)
