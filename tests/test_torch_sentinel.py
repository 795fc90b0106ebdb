"""maniac_tpu_torch sentinel (mc/driver.py::sentinel_check and the command
line's --sentinel N) on the CPU: a JAX block carried over and replayed by
the port (tests/test_sentinel.py's fixtures and bounds), a block further on
flagged, and the command line's log, outputs and isotherm warning."""

import jax
import numpy as np
import torch

from maniac_tpu.mc.driver import _recalibrate as jax_recalibrate
from maniac_tpu.mc.driver import resync_amplitudes_body as jax_resync
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.mc.driver import sentinel_check
from maniac_tpu_torch.parallel.replicas import replicate
from maniac_tpu_torch.system import from_numpy
from maniac_tpu_torch.systems import make_water_box, make_zif_like

from torch_parity import jax_batch, jax_leaves, load_both, uniforms

torch.set_num_threads(1)


def _jax_block(sysm, state, U, recalibrate, resync):
    """JAX's block on numpy uniforms: the mc_step_u scan per replica, the
    recalibration and (resync) the amplitude resynthesis."""
    spec = sysm.spec
    jst = jax_batch(spec, state, U)

    def finish(st):
        st = jax_recalibrate(st, recalibrate, spec.dtype)
        return jax_resync(spec, st) if resync else st
    return jax.vmap(finish)(jst)


def _port_state(sysm, jst):
    return from_numpy(jax_leaves(sysm.spec), jax_leaves(jst), device="cpu",
                      dtype=torch.float32)[1]


def test_sentinel_replays_a_jax_block(tmp_path):
    """A JAX block (60 steps, recalibration and resync, f32, B = 2) carried
    over: the port's replay of replica 0 on the same uniforms gives 0
    mismatches, positions within 1e-4 A and energies within 5 K
    (tests/test_sentinel.py's bounds)."""
    make_zif_like(str(tmp_path), n_cells=4, a=5.66, n_water=10,
                  fugacity=50.0, cutoff=6.0)
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    U = uniforms(2, 60, seed=21, f32=True)
    post = _port_state(sysm, _jax_block(sysm, sysm.state, U, True, True))
    rep = sentinel_check(spec, replicate(spec, state, 2), post,
                         torch.from_numpy(U), True, resync=True)
    assert rep["n_mol_mismatch"] == 0
    assert rep["counter_mismatch"] == 0
    assert rep["pos_max_diff"] < 1e-4
    assert rep["energy_max_diff"] < 5.0


def test_sentinel_flags_a_block_further_on(tmp_path):
    """A post-state one block further on is flagged: the comparison is a
    real one (tests/test_sentinel.py::test_sentinel_detects_divergence)."""
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0)
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    U1, U2 = uniforms(2, 50, seed=22, f32=True), uniforms(2, 50, seed=23,
                                                           f32=True)
    post = _jax_block(sysm, sysm.state, U1, False, False)
    post2 = _jax_block(sysm, post, U2, False, False)
    pre = replicate(spec, state, 2)
    rep = sentinel_check(spec, pre, _port_state(sysm, post2),
                         torch.from_numpy(U1), False)
    assert rep["counter_mismatch"] > 0
    same = sentinel_check(spec, pre, _port_state(sysm, post),
                          torch.from_numpy(U1), False)
    assert same["counter_mismatch"] == 0 and same["n_mol_mismatch"] == 0


def _deck(d, **kw):
    return make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                          probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0,
                          nb_block=2, nb_step=25, **kw)


def _run(d, out, *extra):
    return cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                     "-p", f"{d}/parameters.inc", "-o", out, "--platform",
                     "cpu", "--capacity", "16", *extra])


def test_sentinel_cli_flag(tmp_path):
    """--sentinel 1 on replicas (f32, with the resync) and on a single
    chain: every block cross-checked, 0 divergences, no warning."""
    d = _deck(str(tmp_path / "sys"))
    for i, extra in enumerate((["--replicas", "2", "--dtype", "f32"],
                               ["--dtype", "f32"])):
        out = str(tmp_path / f"out{i}")
        assert _run(d, out, "--sentinel", "1", *extra) == 0
        log = open(f"{out}/log.maniac").read()
        assert "sentinel: 2 cross-checked blocks, 0 divergences" in log
        assert log.count("kernel == plain") == 2
        assert "SENTINEL" not in log and "Simulation Completed" in log


def test_sentinel_does_not_perturb_the_chain(tmp_path):
    """The same run with and without --sentinel writes the same energy.dat
    and trajectory: the check consumes no uniforms of the chain."""
    d = _deck(str(tmp_path / "sys"), recal=True)
    outs = []
    for i, extra in enumerate(([], ["--sentinel", "1"])):
        out = str(tmp_path / f"out{i}")
        assert _run(d, out, "--replicas", "2", *extra) == 0
        outs.append(out)
    for name in ("energy.dat", "trajectory.lammpstrj", "number_wat.dat"):
        a, b = (open(f"{o}/{name}").read() for o in outs)
        assert a == b, name


def test_sentinel_ignored_by_isotherm(tmp_path):
    """--isotherm warns that --sentinel is ignored, as the JAX CLI does."""
    d = _deck(str(tmp_path / "sys"))
    out = str(tmp_path / "out")
    assert _run(d, out, "--isotherm", "100,1000", "--sentinel", "1") == 0
    log = open(f"{out}/log.maniac").read()
    assert "--sentinel is ignored in --isotherm mode" in log
    assert "cross-checked" not in log
    assert np.isfinite(float(open(f"{out}/isotherm.dat").read()
                             .splitlines()[-1].split()[2]))
