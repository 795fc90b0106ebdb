"""maniac_tpu_torch checkpoint/resume (io/checkpoint.py): tests/
test_checkpoint.py's cases against the port, and checkpoints crossing
between the packages.

  * a bit-exact round trip of every state field, the threefry keys
    included, and the same next block from both;
  * a layout mismatch (another capacity) raises ValueError;
  * the command line (f64, CPU): a run of 2 blocks with --checkpoint, then
    --resume on the deck with 4 blocks, gives blocks 3 and 4 of energy.dat
    as the uninterrupted 4-block run writes them;
  * a checkpoint written by the JAX CLI resumes in the port's CLI and gives
    the energy.dat rows of JAX's uninterrupted run (f64, 1e-9 relative);
  * a checkpoint of the port's former generator stream (rng__generator, no
    state__key) is refused with ValueError, and --resume of it exits 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maniac_tpu.cli import main as jax_cli_main
from maniac_tpu_torch import load_system
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from maniac_tpu_torch.mc.driver import block_body
from maniac_tpu_torch.systems import make_water_box

torch.set_num_threads(1)


def _files(d):
    return (f"{d}/input.maniac", f"{d}/topology.data", f"{d}/parameters.inc")


def _water(d, **kw):
    return make_water_box(str(d), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                          **kw)


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    """Every SimState field, the threefry key included, comes back with
    the same bits (the key written as JAX writes it, uint32); both copies
    then run the same next block."""
    d = _water(tmp_path / "sys", probs=(0.4, 0.3, 0.3, 0.0), fugacity=500.0)
    sysm = load_system(*_files(d), dtype=torch.float64, device="cpu",
                       seed=5)
    spec = sysm.spec
    state = block_body(spec, sysm.state, 50, True)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, spec, state, block=3)
    with np.load(path) as z:
        assert z["state__key"].dtype == np.uint32
    loaded, block = load_checkpoint(path, spec)
    assert block == 3
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(loaded, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    s1 = block_body(spec, state, 20, False)
    s2 = block_body(spec, loaded, 20, False)
    assert torch.equal(s1.energy, s2.energy)
    assert torch.equal(s1.pos, s2.pos)


def test_checkpoint_layout_mismatch(tmp_path):
    """A checkpoint of another layout (capacity) is refused."""
    d = _water(tmp_path / "sys")
    sysm = load_system(*_files(d), dtype=torch.float64, device="cpu")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, sysm.spec, sysm.state)
    other = load_system(*_files(d), capacity=999, dtype=torch.float64,
                        device="cpu")
    with pytest.raises(ValueError, match="layout"):
        load_checkpoint(path, other.spec)


def _rows(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#")]


def _four_block_deck(tmp_path, d):
    deck4 = tmp_path / "input4.maniac"
    deck4.write_text(open(f"{d}/input.maniac").read().replace(
        "nb_block 2\n", "nb_block 4\n"))
    return str(deck4)


def test_cli_checkpoint_resume(tmp_path):
    """--resume continues the chain: the resumed run's blocks 3 and 4 are
    the uninterrupted run's, byte for byte."""
    d = _water(tmp_path / "sys", probs=(0.5, 0.5, 0.0, 0.0), nb_block=2,
               nb_step=20)
    deck4 = _four_block_deck(tmp_path, d)
    base = ["-d", f"{d}/topology.data", "-p", f"{d}/parameters.inc",
            "--platform", "cpu", "--dtype", "f64", "--seed", "7"]
    ck = str(tmp_path / "ck.npz")
    out, out2, full = (str(tmp_path / n) for n in ("out", "out2", "full"))
    assert cli_main(["-i", f"{d}/input.maniac", "-o", out, "--checkpoint",
                     ck] + base) == 0
    assert cli_main(["-i", deck4, "-o", out2, "--resume", ck]
                    + base) == 0
    assert cli_main(["-i", deck4, "-o", full] + base) == 0
    log = open(f"{out2}/log.maniac").read()
    assert "Resumed" in log and "Simulation Completed" in log
    resumed = _rows(f"{out2}/energy.dat")
    uninterrupted = _rows(f"{full}/energy.dat")
    assert [r.split()[0] for r in resumed] == ["0", "3", "4"]
    assert resumed[1:] == uninterrupted[3:]
    # the resumed run's block 0 row is the checkpointed state, block 2
    assert resumed[0].split()[1:] == uninterrupted[2].split()[1:]


def test_jax_checkpoint_resumes(tmp_path):
    """The JAX CLI's checkpoint after block 2 (threefry key, uint32)
    resumes in the port's CLI on the 4-block deck: blocks 3 and 4 of
    energy.dat are the JAX CLI's uninterrupted 4-block run's, within 1e-9
    relative (f64, CPU)."""
    d = _water(tmp_path / "sys", probs=(0.3, 0.2, 0.5, 0.0), fugacity=800.0,
               nb_block=2, nb_step=20)
    deck4 = _four_block_deck(tmp_path, d)
    base = ["-d", f"{d}/topology.data", "-p", f"{d}/parameters.inc",
            "--platform", "cpu", "--dtype", "f64", "--seed", "9"]
    ck = str(tmp_path / "jax.npz")
    out, out2, full = (str(tmp_path / n) for n in ("out", "out2", "full"))
    assert jax_cli_main(["-i", f"{d}/input.maniac", "-o", out,
                         "--checkpoint", ck] + base) == 0
    assert jax_cli_main(["-i", deck4, "-o", full] + base) == 0
    assert cli_main(["-i", deck4, "-o", out2, "--resume", ck] + base) == 0
    log = open(f"{out2}/log.maniac").read()
    assert "Resumed" in log and "Simulation Completed" in log
    resumed = np.array([r.split() for r in _rows(f"{out2}/energy.dat")],
                       dtype=float)
    uninterrupted = np.array([r.split() for r in _rows(f"{full}/energy.dat")],
                             dtype=float)
    assert resumed[:, 0].tolist() == [0, 3, 4]
    np.testing.assert_allclose(resumed[1:], uninterrupted[3:], rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(resumed[0, 1:], uninterrupted[2, 1:],
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("replicas", [1, 4])
def test_port_checkpoint_resumes_in_jax(tmp_path, replicas):
    """The port's CLI checkpoint after block 2 resumes in the JAX CLI on
    the 4-block deck: blocks 3 and 4 of energy.dat are the JAX CLI's
    uninterrupted run's, within 1e-9 relative (f64, CPU). Every field has
    the shape and dtype of the JAX CLI's own checkpoint: a single chain
    without the B = 1 axis, --replicas 4 with its B axis."""
    d = _water(tmp_path / "sys", probs=(0.3, 0.2, 0.5, 0.0), fugacity=800.0,
               nb_block=2, nb_step=20)
    deck4 = _four_block_deck(tmp_path, d)
    base = ["-d", f"{d}/topology.data", "-p", f"{d}/parameters.inc",
            "--platform", "cpu", "--dtype", "f64", "--seed", "9",
            "--replicas", str(replicas)]
    ck, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    out, out2, full = (str(tmp_path / n) for n in ("out", "out2", "full"))
    assert cli_main(["-i", f"{d}/input.maniac", "-o", out,
                     "--checkpoint", ck] + base) == 0
    assert jax_cli_main(["-i", deck4, "-o", full, "--checkpoint", jax_ck]
                        + base) == 0
    with np.load(ck) as z, np.load(jax_ck) as zj:
        assert sorted(z.files) == sorted(zj.files)
        for f in z.files:
            assert (z[f].shape, z[f].dtype) == (zj[f].shape, zj[f].dtype), f
    assert jax_cli_main(["-i", deck4, "-o", out2, "--resume", ck]
                        + base) == 0
    log = open(f"{out2}/log.maniac").read()
    assert "Resumed" in log and "Simulation Completed" in log
    resumed = np.array([r.split() for r in _rows(f"{out2}/energy.dat")],
                       dtype=float)
    uninterrupted = np.array([r.split() for r in _rows(f"{full}/energy.dat")],
                             dtype=float)
    assert resumed[:, 0].tolist() == [0, 3, 4]
    np.testing.assert_allclose(resumed[1:], uninterrupted[3:], rtol=1e-9,
                               atol=1e-9)


def test_generator_checkpoint_is_refused(tmp_path):
    """A checkpoint in the format of the port's former torch.Generator
    stream (rng__generator and rng__device, no state__key) is refused:
    load_checkpoint raises a ValueError that names the format and --resume
    exits 1, never starting a fresh stream."""
    d = _water(tmp_path / "sys")
    sysm = load_system(*_files(d), dtype=torch.float64, device="cpu")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, sysm.spec, sysm.state, block=1)
    with np.load(path) as z:
        old = {k: z[k] for k in z.files if k != "state__key"}
    old["rng__generator"] = torch.Generator().manual_seed(1).get_state() \
        .numpy()
    old["rng__device"] = np.asarray("cpu")
    np.savez_compressed(path, **old)
    with pytest.raises(ValueError, match="rng__generator"):
        load_checkpoint(path, sysm.spec)
    out = str(tmp_path / "out")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out, "--platform",
                   "cpu", "--resume", path])
    assert rc == 1
    log = open(f"{out}/log.maniac").read()
    assert "rng__generator" in log and "Simulation Completed" not in log
