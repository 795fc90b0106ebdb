"""maniac_tpu_torch checkpoint/resume (io/checkpoint.py): tests/
test_checkpoint.py's cases against the port, and the refusal of a JAX
package checkpoint.

  * a bit-exact round trip of every state field and of the chain's
    generator state, and the same next block from both;
  * a layout mismatch (another capacity) raises ValueError;
  * the command line (f64, CPU): a run of 2 blocks with --checkpoint, then
    --resume on the deck with 4 blocks, gives blocks 3 and 4 of energy.dat
    as the uninterrupted 4-block run writes them;
  * a checkpoint written by the JAX package (a threefry key, no generator
    state) is refused with ValueError, and --resume of it exits 1.
"""

import dataclasses

import pytest
import torch

import maniac_tpu
from maniac_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
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
    """Every SimState field and the generator state come back with the
    same bits; both copies then run the same next block."""
    d = _water(tmp_path / "sys", probs=(0.4, 0.3, 0.3, 0.0), fugacity=500.0)
    sysm = load_system(*_files(d), dtype=torch.float64, device="cpu")
    spec = sysm.spec
    gen = torch.Generator().manual_seed(5)
    state = block_body(spec, sysm.state, 50, True, gen)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, spec, state, block=3, generator=gen)
    gen2 = torch.Generator().manual_seed(99)
    loaded, block = load_checkpoint(path, spec, gen2)
    assert block == 3
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(loaded, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    assert torch.equal(gen.get_state(), gen2.get_state())
    s1 = block_body(spec, state, 20, False, gen)
    s2 = block_body(spec, loaded, 20, False, gen2)
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


def test_cli_checkpoint_resume(tmp_path):
    """--resume continues the chain: the resumed run's blocks 3 and 4 are
    the uninterrupted run's, byte for byte."""
    d = _water(tmp_path / "sys", probs=(0.5, 0.5, 0.0, 0.0), nb_block=2,
               nb_step=20)
    deck4 = tmp_path / "input4.maniac"
    deck4.write_text(open(f"{d}/input.maniac").read().replace(
        "nb_block 2\n", "nb_block 4\n"))
    base = ["-d", f"{d}/topology.data", "-p", f"{d}/parameters.inc",
            "--platform", "cpu", "--dtype", "f64", "--seed", "7"]
    ck = str(tmp_path / "ck.npz")
    out, out2, full = (str(tmp_path / n) for n in ("out", "out2", "full"))
    assert cli_main(["-i", f"{d}/input.maniac", "-o", out, "--checkpoint",
                     ck] + base) == 0
    assert cli_main(["-i", str(deck4), "-o", out2, "--resume", ck]
                    + base) == 0
    assert cli_main(["-i", str(deck4), "-o", full] + base) == 0
    log = open(f"{out2}/log.maniac").read()
    assert "Resumed" in log and "Simulation Completed" in log
    resumed = _rows(f"{out2}/energy.dat")
    uninterrupted = _rows(f"{full}/energy.dat")
    assert [r.split()[0] for r in resumed] == ["0", "3", "4"]
    assert resumed[1:] == uninterrupted[3:]
    # the resumed run's block 0 row is the checkpointed state, block 2
    assert resumed[0].split()[1:] == uninterrupted[2].split()[1:]


def test_jax_checkpoint_is_refused(tmp_path):
    """A JAX package checkpoint carries a threefry key, not a generator
    state: load_checkpoint raises and --resume exits 1, never starting a
    fresh stream."""
    d = _water(tmp_path / "sys")
    jsys = maniac_tpu.load_system(*_files(d))
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, jsys.spec, jsys.state, block=1)
    sysm = load_system(*_files(d), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="JAX package"):
        load_checkpoint(path, sysm.spec, torch.Generator())
    out = str(tmp_path / "out")
    rc = cli_main(["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out, "--platform",
                   "cpu", "--resume", path])
    assert rc == 1
    log = open(f"{out}/log.maniac").read()
    assert "JAX package" in log and "Simulation Completed" not in log
