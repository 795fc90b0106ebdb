"""Reservoir GCMC (-r) in maniac_tpu_torch against the JAX package.

The same numpy uniforms go through JAX's mc_step_u (its XLA path) and the
port's run_steps_u with the plain energy core, from the same loaded state
carried over with from_numpy: insertions copy a reservoir molecule as it
is, accepted insertions pop it, accepted deletions push the molecule back
(or drop it when the reservoir is full). The kernels' reservoir forms are
held to these plain versions on the card (tests/test_torch_gpu.py)."""

import os

import numpy as np
import pytest
import torch

import maniac_tpu_torch
from maniac_tpu.io.writers import OutputWriter as JaxWriter
from maniac_tpu.io.writers import snapshot as jax_snapshot
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.io.writers import OutputWriter, snapshot
from maniac_tpu_torch.kernels import dispatch_report
from maniac_tpu_torch.mc.driver import drift_report, run_steps_u
from maniac_tpu_torch.mc.moves import _core_plain, mc_step_u
from maniac_tpu_torch.parallel.replicas import replicate
from maniac_tpu_torch.system import tensor_fields
from maniac_tpu_torch.systems import (make_framework_mixed, make_water_box,
                                      make_water_reservoir)
from maniac_tpu_torch.utils.logger import Logger

from torch_parity import (F32_ENERGY_TOL, F32_POS_TOL, as_np, files,
                          jax_batch, load_both, uniforms)

torch.set_num_threads(1)

# the tests/test_reservoir.py fixture: 8 waters, a 12-water reservoir
GCMC_PROBS = (0.2, 0.2, 0.6, 0.0)


@pytest.fixture(autouse=True)
def _xla_path(monkeypatch):
    """JAX's XLA step (no Pallas kernel) is the reference."""
    monkeypatch.setenv("MANIAC_PALLAS", "0")


def _resv(d, n_res=12, **kw):
    kw = {"probs": GCMC_PROBS, "fugacity": 2000.0, **kw}
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4, **kw)
    return make_water_reservoir(d, n_water=n_res)


def _assert_same_reservoir_chain(jst, pst, *, pos_tol):
    """Identical decisions, populations and reservoir counts; positions,
    COMs and reservoir offsets/COMs within pos_tol."""
    for name in ("n_mol", "res_n", "counters", "extras"):
        np.testing.assert_array_equal(as_np(getattr(pst, name)),
                                      as_np(getattr(jst, name)), err_msg=name)
    for name in ("pos", "com", "res_offset", "res_com"):
        err = np.abs(as_np(getattr(pst, name))
                     - as_np(getattr(jst, name))).max()
        assert err <= pos_tol, (name, err)


def _conserved(st):
    """Box + reservoir + dropped molecules, per replica (one species)."""
    return (st.n_mol[:, :-1].sum(1) + st.res_n[:, :-1].sum(1)
            + st.extras[:, 1])


def test_f64_chain_matches_jax(tmp_path):
    """200 steps in f64 at B = 2: identical decisions, n_mol, res_n,
    counters and extras; positions, res_offset and res_com within 1e-10 A;
    bookkeeping equal to a full recompute within 1e-8 K."""
    res = _resv(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), reservoir=res)
    assert spec.has_reservoir
    U = uniforms(2, 200, seed=0, f32=False)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U),
                      core=_core_plain)
    _assert_same_reservoir_chain(jst, pst, pos_tol=1e-10)
    np.testing.assert_allclose(as_np(pst.energy), as_np(jst.energy),
                               rtol=0, atol=1e-6)
    c = pst.counters.numpy()
    assert c[:, 1, 0].min() > 0 and c[:, 1, 1].min() > 0  # pops and pushes
    for b in range(2):
        assert drift_report(spec, pst, b)["drift_K"] < 1e-8


def test_f32_chain_matches_jax(tmp_path):
    """The same chain in f32: the same decisions, positions within
    1e-4 A, energies within 5 K (tests/test_blockg.py bounds)."""
    res = _resv(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), f32=True, reservoir=res)
    U = uniforms(2, 200, seed=1, f32=True)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U),
                      core=_core_plain)
    _assert_same_reservoir_chain(jst, pst, pos_tol=F32_POS_TOL)
    assert np.abs(as_np(pst.energy) - as_np(jst.energy)).max() \
        <= F32_ENERGY_TOL


def test_conservation_every_step(tmp_path):
    """n_mol + res_n + extras[:, 1] is unchanged by every step of every
    replica, and molecules did move between box and reservoir."""
    res = _resv(str(tmp_path))
    _, spec, state = load_both(str(tmp_path), reservoir=res)
    st = replicate(spec, state, 4)
    total0 = _conserved(st)
    U = torch.from_numpy(uniforms(4, 120, seed=2, f32=False))
    for i in range(U.shape[1]):
        st = mc_step_u(spec, st, U[:, i], core=_core_plain)
        assert torch.equal(_conserved(st), total0), i
    assert int(st.counters[:, 1, :2].sum()) > 0
    assert not torch.equal(st.res_n, state.res_n.expand(4, -1))


def test_reservoir_geometry_copied_verbatim(tmp_path):
    """Insertions only: every water in the box has the reservoir's internal
    distances within 1e-5 A, and its offsets are one of the reservoir's or
    the initial box's molecules as they were (no rotation)."""
    d = str(tmp_path)
    make_water_box(d, n_water=2, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.0, 0.0, 1.0, 0.0), fugacity=50000.0)
    res = make_water_reservoir(d, n_water=8)
    sysm, spec, state = load_both(d, reservoir=res)
    U = uniforms(2, 60, seed=3, f32=False)
    st = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U),
                     core=_core_plain)
    known = np.concatenate([np.asarray(sysm.reservoir.site_offset[0]),
                            np.asarray(sysm.parsed.site_offset[0])])
    d_ref = np.linalg.norm(known[0][:, None] - known[0][None], axis=-1)
    for b in range(2):
        snap = snapshot(spec, st, b)
        assert snap.n_mol[0] > 2                   # insertions were accepted
        for off in snap.offset[0]:
            dm = np.linalg.norm(off[:, None] - off[None], axis=-1)
            np.testing.assert_allclose(dm, d_ref, atol=1e-5)
            assert np.abs(known - off[None]).max(axis=(1, 2)).min() < 1e-9


def test_full_reservoir_drops_like_jax(tmp_path):
    """A reservoir at its capacity (12 of 12): accepted deletions drop the
    molecule and count it in extras[:, 1], as the JAX package counts it."""
    res = _resv(str(tmp_path), probs=(0.0, 0.0, 1.0, 0.0), fugacity=1.0)
    sysm, spec, state = load_both(str(tmp_path), capacity=12, reservoir=res)
    assert spec.res_cap_list[0] == 12 and int(state.res_n[0, 0]) == 12
    U = uniforms(2, 60, seed=4, f32=False)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U),
                      core=_core_plain)
    _assert_same_reservoir_chain(jst, pst, pos_tol=1e-10)
    assert int(pst.extras[:, 1].min()) > 0
    assert torch.equal(_conserved(pst), _conserved(replicate(spec, state, 2)))


def test_load_system_with_reservoir_matches_jax(tmp_path):
    """load_system(..., reservoir_file=...) leaf for leaf against JAX's
    (f64, CPU), the reservoir tables and state included."""
    res = _resv(str(tmp_path))
    sysm_j, spec_j, state_j = load_both(str(tmp_path), capacity=16,
                                        reservoir=res)
    sysm = maniac_tpu_torch.load_system(*files(str(tmp_path)),
                                        reservoir_file=res, capacity=16,
                                        device="cpu")
    assert sysm.reservoir is not None and sysm.spec.has_reservoir
    for obj_p, obj_j in ((sysm.spec, spec_j), (sysm.state, state_j)):
        for (name, a), (_, b) in zip(tensor_fields(obj_p),
                                     tensor_fields(obj_j)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.is_floating_point():
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                           atol=1e-12, err_msg=name)
            else:
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=name)
    assert sysm.spec.res_cap_list == sysm_j.spec.res_cap_list
    assert sysm.state.res_offset.shape[1:] == sysm_j.state.res_offset.shape


def test_gates_widened(tmp_path):
    """The block kernel takes a reservoir and the water box without the
    split (every type active); the step kernel takes the reservoir. Two
    active species take the block kernel where the split covers the
    framework; with the split off, the framework is an inactive type
    outside the block gate, and such a system runs the per-step path."""
    res = _resv(str(tmp_path / "resv"))
    _, spec_r, _ = load_both(str(tmp_path / "resv"), capacity=16, f32=True,
                             reservoir=res)
    _, spec_w, _ = load_both(str(tmp_path / "resv"), capacity=16, f32=True)
    make_framework_mixed(str(tmp_path / "mixed"), n_cells=3, a=5.66,
                         n_water=3, n_dimer=3, cutoff=5.0, tol=1e-4)
    _, spec_m, _ = load_both(str(tmp_path / "mixed"), capacity=16, f32=True)
    assert spec_m.fw_split and spec_m.n_active == 2
    for spec in (spec_r, spec_w, spec_m):
        rep = dispatch_report(spec, "cuda")
        assert ("block: CUDA whole-block kernel; step: CUDA per-step "
                "kernel; resync: CUDA resync kernel") in rep, rep
    assert not spec_w.fw_split and spec_w.R == spec_w.n_active
    make_framework_mixed(str(tmp_path / "small"), n_cells=2, a=5.66,
                         n_water=3, n_dimer=3)
    _, spec_s, _ = load_both(str(tmp_path / "small"), capacity=16, f32=True)
    rep = dispatch_report(spec_s, "cuda")
    assert not spec_s.fw_split
    assert "per-step path (framework split off with inactive types" in rep
    assert "step: CUDA per-step kernel" in rep


def test_cli_with_reservoir(tmp_path):
    """-r on the CPU in f64: exit 0, the completion banner, one
    reservoir.lammpstrj frame per block, its first frame equal line for
    line to the JAX package's write_trajectory of the same reservoir, and
    a missing reservoir file aborts with exit 1."""
    d = str(tmp_path / "sys")
    res = _resv(d, n_res=10, probs=(0.3, 0.3, 0.4, 0.0), fugacity=1000.0,
                nb_block=2, nb_step=40)
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-r", res, "-o", out,
                   "--platform", "cpu", "--dtype", "f64"])
    assert rc == 0
    assert "Simulation Completed" in open(f"{out}/log.maniac").read()
    frames = open(f"{out}/reservoir.lammpstrj").read().split("ITEM: TIMESTEP")
    assert len(frames) == 1 + 3                # block 0 and 2 blocks
    sysm_j, _, _ = load_both(d, reservoir=res)
    jdir = str(tmp_path / "jax")
    jw = JaxWriter(jdir, sysm_j.deck, sysm_j.parsed,
                   Logger(None, quiet=True))
    jw.write_trajectory(jax_snapshot(sysm_j.spec, sysm_j.state,
                                     reservoir=True), 0, False,
                        filename="reservoir.lammpstrj",
                        box=sysm_j.reservoir.box)
    ref = open(f"{jdir}/reservoir.lammpstrj").read()
    assert "ITEM: TIMESTEP" + frames[1] == ref
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-r", f"{d}/missing.data",
                   "-o", str(tmp_path / "out2"), "--platform", "cpu"])
    assert rc == 1
    assert "Reservoir file not found" in open(
        f"{tmp_path}/out2/log.maniac").read()


def test_reservoir_trajectory_matches_jax_writer(tmp_path):
    """After the same 100-step chain, the port's reservoir snapshot written
    by its OutputWriter equals JAX's line for line."""
    d = str(tmp_path / "sys")
    res = _resv(d)
    sysm_j, spec, state = load_both(d, reservoir=res)
    sysm = maniac_tpu_torch.load_system(*files(d), reservoir_file=res,
                                        device="cpu")
    U = uniforms(1, 100, seed=5, f32=False)
    jst = jax_batch(sysm_j.spec, sysm_j.state, U)
    pst = run_steps_u(spec, state, torch.from_numpy(U), core=_core_plain)
    assert int(pst.counters[0, 1, :2].sum()) > 0   # pops or pushes
    texts = []
    for name, writer, loaded, snap in (
            ("port", OutputWriter, sysm,
             snapshot(spec, pst, 0, reservoir=True)),
            ("jax", JaxWriter, sysm_j,
             jax_snapshot(sysm_j.spec, jst, 0, reservoir=True))):
        outdir = str(tmp_path / name)
        w = writer(outdir, loaded.deck, loaded.parsed, Logger(None,
                                                              quiet=True))
        w.write_trajectory(snap, 1, False, filename="reservoir.lammpstrj",
                           box=loaded.reservoir.box)
        texts.append(open(os.path.join(outdir, "reservoir.lammpstrj")).read())
    assert texts[0] == texts[1]
