"""Triclinic boxes in maniac_tpu_torch against the JAX package: the
periodic-boundary helpers (fractional wrap, 27-image minimum image), an f64
chain, and the command line on a triclinic deck. The triclinic energy
(system_energy) is a case of tests/test_torch_energy.py, the block kernel's
triclinic form one of tests/test_torch_block_forms.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.io.writers import OutputWriter as JaxWriter
from maniac_tpu.io.writers import snapshot as jax_snapshot
from maniac_tpu.physics import pbc as jpbc
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.mc.driver import drift_report, run_steps_u
from maniac_tpu_torch.mc.moves import _core_plain
from maniac_tpu_torch.parallel.replicas import replicate
from maniac_tpu_torch.physics import pbc
from maniac_tpu_torch.systems import make_triclinic_water
from maniac_tpu_torch.utils.logger import Logger

from torch_parity import (as_np, assert_same_chain, jax_batch, load_both,
                          uniforms)

torch.set_num_threads(1)


def _tricl(d, **kw):
    # the tests/test_blockg.py triclinic fixture
    make_triclinic_water(d, n_water=8, L=14.0, tilt=(2.0, 1.2, 0.8),
                         cutoff=5.0, tol=1e-4, probs=(0.3, 0.2, 0.5, 0.0),
                         fugacity=20000.0, **kw)


@pytest.mark.parametrize("f32,tol", [(False, 1e-12), (True, 1e-5)],
                         ids=["f64", "f32"])
def test_pbc_matches_jax(tmp_path, f32, tol):
    """wrap_into_box and min_image_dist2 on seeded deltas and positions
    spread over several cells: within 1e-12 (f64) or 1e-5 (f32; A, A^2) of
    JAX's physics/pbc.py."""
    _tricl(str(tmp_path))
    sysm, spec, _ = load_both(str(tmp_path), f32=f32)
    assert spec.is_triclinic
    dt = np.float32 if f32 else np.float64
    rng = np.random.default_rng(90)
    delta = rng.uniform(-21.0, 21.0, (4, 64, 3)).astype(dt)
    d2_p = pbc.min_image_dist2(torch.from_numpy(delta), spec)
    d2_j = jpbc.min_image_dist2(jnp.asarray(delta), sysm.spec)
    assert d2_p.shape == (4, 64)
    np.testing.assert_allclose(d2_p.numpy(), np.asarray(d2_j), rtol=0,
                               atol=tol)
    pos = rng.uniform(-30.0, 30.0, (256, 3)).astype(dt)
    w_p = pbc.wrap_into_box(torch.from_numpy(pos), spec)
    w_j = jpbc.wrap_into_box(jnp.asarray(pos), sysm.spec)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0,
                               atol=tol)
    # wrapped points lie in the cell: fractional coordinates in [0, 1)
    frac = (w_p - spec.bounds[:, 0]) @ spec.Hinv.T
    assert float(frac.min()) >= -tol and float(frac.max()) < 1.0 + tol


def test_f64_chain_matches_jax(tmp_path):
    """200 steps at B = 2 in f64: identical decisions, positions within
    1e-10 A, bookkeeping equal to a full recompute within 1e-8 K."""
    _tricl(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16)
    U = uniforms(2, 200, seed=91, f32=False)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U),
                      core=_core_plain)
    assert_same_chain(jst, pst, pos_tol=1e-10, energy_tol=1e-6)
    c = pst.counters.numpy()
    assert c[:, 1, :4].min() > 0        # every move type accepted
    for b in range(2):
        assert drift_report(spec, pst, b)["drift_K"] < 1e-8


def test_cli_triclinic(tmp_path):
    """The command line on a triclinic deck (CPU, f64): exit 0, the
    completion banner, block 0's trajectory frame line for line equal to
    the JAX writer's of the same state, and the triclinic box lines of
    topology.data equal to JAX's."""
    d = str(tmp_path / "sys")
    _tricl(d, nb_block=2, nb_step=30)
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out, "--capacity",
                   "16", "--platform", "cpu"])
    assert rc == 0
    assert "Simulation Completed" in open(f"{out}/log.maniac").read()
    frames = open(f"{out}/trajectory.lammpstrj").read().split("ITEM: TIMESTEP")
    assert len(frames) == 1 + 3                  # block 0 and 2 blocks
    sysm_j, _, _ = load_both(d, capacity=16)
    jdir = str(tmp_path / "jax")
    jw = JaxWriter(jdir, sysm_j.deck, sysm_j.parsed, Logger(None, quiet=True))
    jw.update_files(jax_snapshot(sysm_j.spec, sysm_j.state), 0, append=False)
    ref = open(f"{jdir}/trajectory.lammpstrj").read()
    assert "ITEM: TIMESTEP" + frames[1] == ref

    def box_lines(path):
        return [ln for ln in open(path).read().splitlines()
                if ln.endswith(("xlo xhi", "ylo yhi", "zlo zhi", "xy xz yz"))]
    got = box_lines(f"{out}/topology.data")
    assert len(got) == 4 and got == box_lines(f"{jdir}/topology.data")
    assert as_np(sysm_j.spec.H)[0, 1] != 0.0      # a tilted cell
