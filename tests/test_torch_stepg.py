"""maniac_tpu_torch per-step path, isotherm sweep and output writers against
the JAX package.

The whole-step CUDA kernel (kernels/stepg.py::run_steps_kernel) has no CPU
mode: on the CPU it runs its plain version, the torch loop of mc_step_u
with the plain energy core (``step_core_plain``, mc/moves.py::_core_plain).
That core is held here to the JAX package's grouped Pallas step core
(kernels/stepg.py, run in interpret mode with MANIAC_PALLAS=1, as
tests/test_kernels.py runs it) on the same proposals, and the dispatched
steps to JAX's mc_step_u chains; the kernel itself is held to the plain
steps on the card by chip_smoke.py phase 4 and tests/test_torch_gpu.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.io.writers import OutputWriter as JaxOutputWriter
from maniac_tpu.io.writers import snapshot as jax_snapshot
from maniac_tpu.mc.moves import _core_kernel_grouped
from maniac_tpu.mc.moves import _propose as jax_propose
from maniac_tpu.mc.moves import mc_step_u as jax_mc_step_u
from maniac_tpu.parallel.replicas import _with_activity
from maniac_tpu_torch.io.writers import OutputWriter, snapshot
from maniac_tpu_torch.kernels import step_gate_failure, use_step_kernel
from maniac_tpu_torch.kernels.stepg import (run_steps_kernel,
                                            step_core_plain)
from maniac_tpu_torch.mc.driver import run_steps_u
from maniac_tpu_torch.mc.moves import _propose
from maniac_tpu_torch.parallel.mesh import gather_replica_stats
from maniac_tpu_torch.parallel.replicas import (perturb_activity, replicate,
                                                run_block_sweep,
                                                run_block_sweep_uniforms)
from maniac_tpu_torch.system import E_TOT, from_numpy, to_device
from maniac_tpu_torch.systems import (make_framework_mixed,
                                      make_framework_water, make_lj_gas,
                                      make_mixed_sizes, make_water_box)
from maniac_tpu_torch.utils.logger import NullLogger
from maniac_tpu_torch.utils.threefry import prng_key

from torch_parity import (F32_ENERGY_TOL, F32_POS_TOL, as_np,
                          assert_same_chain, jax_batch, jax_leaves, load_both,
                          uniforms)

torch.set_num_threads(1)

# one proposal's pair energies reach 1e7 K on overlapping insertions (which
# reject); two f32 sums over the sites in another order then differ by some
# 1e-5 relative
PROPOSAL_E_RTOL = 1e-4


def _fw_water(d):
    make_framework_water(d, n_cells=2, a=8.0, n_water=6, cutoff=5.0,
                         tol=1e-4, probs=(0.3, 0.2, 0.5, 0.0),
                         fugacity=200.0)


def _fw_mixed(d):
    make_framework_mixed(d, n_cells=3, a=5.66, n_water=3, n_dimer=3,
                         cutoff=5.0, tol=1e-4)


def _mixed_sizes(d):
    make_mixed_sizes(d, n_water=6, n_dimer=6, L=16.0, cutoff=6.0, tol=1e-4,
                     probs=(0.2, 0.1, 0.3, 0.4), fug_w=500.0, fug_d=500.0)


def _water(d):
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0)


CASES = {"fw_water": (_fw_water, True, 1), "fw_mixed": (_fw_mixed, True, 2),
         "mixed_sizes": (_mixed_sizes, False, 2),
         "water_gcmc": (_water, False, 1)}


@pytest.fixture(params=list(CASES))
def case32(request, tmp_path, monkeypatch):
    """(JAX system, port spec, a batch of 4 states after 10 JAX steps, the
    JAX batch) in f32; from then on the JAX step runs its Pallas step
    core."""
    make, split, n_active = CASES[request.param]
    make(str(tmp_path))
    sysm, spec, _ = load_both(str(tmp_path), capacity=12, f32=True)
    assert spec.fw_split == split and spec.n_active == n_active
    assert step_gate_failure(spec) is None
    monkeypatch.setenv("MANIAC_PALLAS", "0")
    jst = jax_batch(sysm.spec, sysm.state, uniforms(4, 10, seed=21,
                                                    f32=True))
    monkeypatch.setenv("MANIAC_PALLAS", "1")
    _, st = from_numpy(jax_leaves(sysm.spec), jax_leaves(jst), device="cpu",
                       dtype=torch.float32)
    return sysm, spec, st, jst


def test_step_core_matches_pallas_stepg(case32):
    """The same proposals through the port's plain step core and JAX's
    _core_kernel_grouped (the Pallas kernel in interpret mode): identical
    acceptances, energies within 5 K (plus 1e-4 relative for the huge
    overlaps of rejected insertions), positions within 1e-4 A."""
    sysm, spec, st, jst = case32
    for seed in range(3):
        u = uniforms(4, 1, seed=30 + seed, f32=True)[:, 0]
        pre = _propose(spec, st, torch.from_numpy(u))
        core = step_core_plain(spec, st, pre)
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
        np.testing.assert_allclose(as_np(core["amp_re"]),
                                   np.asarray(jcore["amp_re"]), atol=2e-4)


def test_step_chain_matches_pallas_stepg(case32):
    """25 steps of the port's dispatched run_steps_u (run_steps_kernel,
    plain on the CPU) against JAX's mc_step_u on its Pallas step core, on
    the same uniforms; the CPU never launches the kernel."""
    sysm, spec, st, jst = case32
    U = uniforms(4, 25, seed=40, f32=True)
    before = run_steps_kernel.launches
    pst = run_steps_u(spec, st, torch.from_numpy(U))
    assert run_steps_kernel.launches == before
    jout = jax_batch(sysm.spec, jst, U)
    assert_same_chain(jout, pst, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    assert int(pst.counters[:, 1].sum()) > 0


def test_step_gate(tmp_path):
    """The step kernel takes two species with the split (and every case
    above); it refuses f64. A per-replica activity never reaches the block
    kernel, even for a spec that is otherwise inside its gate."""
    from maniac_tpu_torch.kernels import block_gate_failure
    _fw_mixed(str(tmp_path / "mixed"))
    _, spec, _ = load_both(str(tmp_path / "mixed"), capacity=12, f32=True)
    assert use_step_kernel(spec, "cuda") and not use_step_kernel(spec, "cpu")
    spec64 = to_device(spec, "cpu", torch.float64)
    assert "float64" in step_gate_failure(spec64)
    _fw_water(str(tmp_path / "water"))
    _, spec, _ = load_both(str(tmp_path / "water"), capacity=12, f32=True)
    assert block_gate_failure(spec) is None
    sweep = perturb_activity(spec, spec.type_activity.expand(3, -1))
    assert "per-replica activity" in block_gate_failure(sweep)
    assert step_gate_failure(sweep) is None


def _lj_ideal(d, **kw):
    make_lj_gas(d, n=8, L=16.0, probs=(0.0, 0.0, 1.0, 0.0), fugacity=100.0,
                cutoff=6.0, tol=1e-3, **kw)
    # ideal gas: zero out the LJ
    with open(f"{d}/parameters.inc", "w") as f:
        f.write("pair_coeff 1 1 0.0 0.0\n")


def test_sweep_matches_jax_per_replica_activity(tmp_path):
    """run_block_sweep_uniforms with a (B, R) activity against a JAX vmap
    of per-replica scans of mc_step_u on _with_activity(spec, act), f64:
    identical decisions."""
    make_water_box(str(tmp_path), n_water=6, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=500.0)
    sysm, spec, state = load_both(str(tmp_path), capacity=16)
    B = 4
    acts = (np.asarray(sysm.spec.type_activity)[None, :]
            * np.array([0.25, 1.0, 4.0, 16.0])[:, None])
    U = uniforms(B, 40, seed=50, f32=False)
    pst = run_block_sweep_uniforms(perturb_activity(spec, acts),
                                   replicate(spec, state, B),
                                   torch.from_numpy(U), recalibrate=True)

    def one(act, u):
        s = _with_activity(sysm.spec, act)

        def body(c, row):
            return jax_mc_step_u(s, c, row), None
        return jax.lax.scan(body, sysm.state, u)[0]

    jst = jax.jit(jax.vmap(one))(jnp.asarray(acts), jnp.asarray(U))
    from maniac_tpu.mc.driver import _recalibrate
    jst = jax.vmap(lambda s: _recalibrate(s, True, sysm.spec.dtype))(jst)
    assert_same_chain(jst, pst, pos_tol=1e-10, energy_tol=1e-6)
    np.testing.assert_allclose(as_np(pst.trans_step),
                               np.asarray(jst.trans_step))
    n = as_np(pst.n_mol)[:, 0]
    assert n[0] < n[3]                        # the activities matter


def test_sweep_matches_jax_per_replica_activity_f32(tmp_path, monkeypatch):
    """f32, the framework split on: run_block_sweep_uniforms with a (B, R)
    activity (the per-step path, run_steps_kernel: plain on the CPU)
    against a JAX vmap of per-replica scans of mc_step_u on
    _with_activity(spec, act), whose step core is the Pallas stepg in
    interpret mode (MANIAC_PALLAS=1, as case32; the per-replica spec reaches
    it, use_pair_kernel reads no activity): identical decisions, positions
    within 1e-4 A and energies within 5 K (F32_POS_TOL, F32_ENERGY_TOL)."""
    _fw_water(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=12, f32=True)
    assert spec.fw_split and step_gate_failure(spec) is None
    monkeypatch.setenv("MANIAC_PALLAS", "1")
    from maniac_tpu.kernels import use_pair_kernel
    assert use_pair_kernel(sysm.spec)
    B = 4
    acts = (np.asarray(sysm.spec.type_activity)[None, :]
            * np.array([0.25, 1.0, 4.0, 16.0])[:, None]).astype(np.float32)
    U = uniforms(B, 30, seed=52, f32=True)
    sweep = perturb_activity(spec, acts)
    assert step_gate_failure(sweep) is None
    before = run_steps_kernel.launches
    pst = run_block_sweep_uniforms(sweep, replicate(spec, state, B),
                                   torch.from_numpy(U), recalibrate=True)
    assert run_steps_kernel.launches == before

    def one(act, u):
        s = _with_activity(sysm.spec, act)

        def body(c, row):
            return jax_mc_step_u(s, c, row), None
        return jax.lax.scan(body, sysm.state, u)[0]

    jst = jax.jit(jax.vmap(one))(jnp.asarray(acts), jnp.asarray(U))
    from maniac_tpu.mc.driver import _recalibrate
    jst = jax.vmap(lambda s: _recalibrate(s, True, sysm.spec.dtype))(jst)
    assert_same_chain(jst, pst, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    np.testing.assert_allclose(as_np(pst.trans_step),
                               np.asarray(jst.trans_step), rtol=1e-6)
    assert int(pst.counters[:, 1].sum()) > 0
    assert not np.array_equal(as_np(pst.n_mol)[0], as_np(pst.n_mol)[3])


def test_sweep_ideal_gas_isotherm(tmp_path):
    """Ideal gas: <N> = activity * V per replica, so the sweep's population
    means scale with the activities (the JAX package's
    test_isotherm_sweep statistic, cut in steps)."""
    _lj_ideal(str(tmp_path))
    _, spec, state = load_both(str(tmp_path))
    B = 4
    base = float(spec.type_activity[0])
    scale = np.array([0.5, 1.0, 2.0, 4.0])
    sweep = perturb_activity(spec, (base * scale)[:, None])
    states = replicate(spec, state.replace(key=prng_key(3)[None]), B)
    states = run_block_sweep(sweep, states, 1000, False, False)
    counts = np.zeros(B)
    n_samp = 20
    for _ in range(n_samp):
        states = run_block_sweep(sweep, states, 100, False, False)
        counts += as_np(states.n_mol)[:, 0]
    mean_n = counts / n_samp
    expected = base * scale * float(spec.volume)
    for b in range(B):
        tol = max(5 * np.sqrt(expected[b] / 8), 0.35 * expected[b])
        assert abs(mean_n[b] - expected[b]) < tol, (b, mean_n, expected)
    assert mean_n[0] < mean_n[1] < mean_n[2] < mean_n[3]


def test_gather_replica_stats_matches_jax(tmp_path):
    """Cross-replica mean and population std of N and E_TOT."""
    from maniac_tpu.parallel.mesh import (gather_replica_stats as
                                          jax_stats)
    _water(str(tmp_path))
    sysm, spec, _ = load_both(str(tmp_path), capacity=16)
    jst = jax_batch(sysm.spec, sysm.state, uniforms(3, 30, seed=60,
                                                    f32=False))
    _, st = from_numpy(jax_leaves(sysm.spec), jax_leaves(jst), device="cpu",
                       dtype=torch.float64)
    got = gather_replica_stats(st, spec.R, E_TOT)
    ref = jax_stats(jst, spec.R, E_TOT)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(as_np(g), np.asarray(r), rtol=1e-12)
    assert float(got[1][0]) > 0.0                  # the replicas differ


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _assert_same_file(a, b):
    """Line by line: the same words, numbers within 1e-9 relative."""
    la, lb = _lines(a), _lines(b)
    assert len(la) == len(lb), os.path.basename(a)
    for x, y in zip(la, lb):
        wx, wy = x.split(), y.split()
        assert len(wx) == len(wy), (x, y)
        for s, t in zip(wx, wy):
            try:
                fs, ft = float(s), float(t)
            except ValueError:
                assert s == t, (x, y)
                continue
            assert abs(fs - ft) <= 1e-9 * max(1.0, abs(ft)), (x, y)


@pytest.mark.parametrize("make", [_fw_mixed, _water],
                         ids=["fw_mixed", "water_gcmc"])
def test_writers_match_jax(tmp_path, make):
    """Block-0 and block-1 files written by both packages' OutputWriter from
    the same carried-over state (f64)."""
    make(str(tmp_path / "sys"))
    sysm, spec, _ = load_both(str(tmp_path / "sys"), capacity=12)
    jst = jax_batch(sysm.spec, sysm.state, uniforms(1, 30, seed=70,
                                                    f32=False))
    _, st = from_numpy(jax_leaves(sysm.spec), jax_leaves(jst), device="cpu",
                       dtype=torch.float64)
    j1 = jax.tree_util.tree_map(lambda x: x[0], jst)
    outs = {}
    for name, writer_cls, snap in (
            ("jax", JaxOutputWriter,
             lambda: jax_snapshot(sysm.spec, j1)),
            ("torch", OutputWriter, lambda: snapshot(spec, st))):
        out = str(tmp_path / name)
        w = writer_cls(out, sysm.deck, sysm.parsed, NullLogger())
        s = snap()
        w.update_files(s, 0, append=False)
        w.update_files(s, 1, append=True)
        w.write_profile(s, 0, 5, "z")
        outs[name] = out
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["torch"]))
    for f in ("energy.dat", "moves.dat", "topology.data",
              "trajectory.lammpstrj"):
        assert f in names
    assert any(n.startswith("number_") for n in names)
    for f in names:
        _assert_same_file(f"{outs['jax']}/{f}", f"{outs['torch']}/{f}")
