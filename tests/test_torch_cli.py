"""maniac_tpu_torch command line: the JAX package's CLI contract tests
(tests/test_cli_and_parallel.py) run against the port on the CPU."""

import os
import subprocess
import sys

import numpy as np
import torch

from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.systems import make_lj_gas, make_water_box

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flags(d, out, *extra):
    return ["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
            "-p", f"{d}/parameters.inc", "-o", out, *extra]


def _rows(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def _ideal_lj(d, **kw):
    make_lj_gas(d, n=4, L=16.0, probs=(0.0, 0.0, 1.0, 0.0), cutoff=6.0,
                tol=1e-3, **kw)
    # ideal gas: zero LJ makes <N> = activity * V exactly
    with open(f"{d}/parameters.inc", "w") as f:
        f.write("pair_coeff 1 1 0.0 0.0\n")
    return d


def test_cli_end_to_end(tmp_path):
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.3, 0.4, 0.0), fugacity=500.0,
                       nb_block=2, nb_step=50, recal=True)
    out = str(tmp_path / "outputs")
    rc = cli_main(_flags(d, out, "--platform", "cpu", "--dtype", "f64",
                         "--audit", "--profile", "4"))
    assert rc == 0
    log = open(f"{out}/log.maniac").read()
    # the black-box contract greps (reference: tests/readers/*/run-test.sh)
    assert "Simulation Completed" in log and "TotEng" in log
    # awk contract: line after last TotEng, second field is the energy
    lines = log.splitlines()
    idx = max(i for i, line in enumerate(lines) if "TotEng" in line)
    float(lines[idx + 1].lstrip("| ").split()[1])
    for f in ("energy.dat", "moves.dat", "number_wat.dat",
              "trajectory.lammpstrj", "topology.data"):
        assert os.path.exists(f"{out}/{f}"), f
    assert len(_rows(f"{out}/energy.dat")) == 3   # block 0 + 2 blocks
    profile = [r.split() for r in _rows(f"{out}/profile_wat.dat")]
    n_wat = [int(r.split()[1]) for r in _rows(f"{out}/number_wat.dat")]
    assert [sum(map(int, r[1:])) for r in profile] == n_wat
    # the f64 audit: running energy equals a full recompute
    drifts = [float(line.split("=")[1].split()[0]) for line in lines
              if "audit:" in line]
    assert len(drifts) == 2 and max(drifts) < 1e-6


def test_cli_error_contract(tmp_path):
    d = make_water_box(str(tmp_path / "sys"))
    bad = str(tmp_path / "bad.maniac")
    text = open(f"{d}/input.maniac").read().replace("nb_block 1\n", "")
    open(bad, "w").write(text)
    out = str(tmp_path / "outputs")
    rc = cli_main(["-i", bad, "-d", f"{d}/topology.data",
                   "-p", f"{d}/parameters.inc", "-o", out,
                   "--platform", "cpu"])
    assert rc != 0
    log = open(f"{out}/log.maniac").read()
    assert "ERROR" in log or "Error" in log


def test_cli_restart_roundtrip(tmp_path):
    """The topology.data the port's command line writes loads as a -d
    input (tests/test_cli_and_parallel.py::test_cli_restart_roundtrip):
    the second run completes and starts from the first run's molecules."""
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.5, 0.5, 0.0, 0.0), nb_block=1,
                       nb_step=30)
    out, out2 = str(tmp_path / "out1"), str(tmp_path / "out2")
    assert cli_main(_flags(d, out, "--platform", "cpu", "--dtype",
                           "f64")) == 0
    assert cli_main(["-i", f"{d}/input.maniac", "-d", f"{out}/topology.data",
                     "-p", f"{d}/parameters.inc", "-o", out2, "--platform",
                     "cpu", "--dtype", "f64"]) == 0
    assert "Simulation Completed" in open(f"{out2}/log.maniac").read()
    # translations and rotations only: the restart holds the 8 waters
    assert int(_rows(f"{out2}/number_wat.dat")[0].split()[1]) == 8


def test_cli_without_cuda_is_an_error(tmp_path):
    """The default --platform cuda on a machine without a CUDA device is an
    error (exit 1, a logged message), never a run on the CPU."""
    d = make_water_box(str(tmp_path / "sys"))
    if not torch.cuda.is_available():
        out = str(tmp_path / "out_cuda")
        assert cli_main(_flags(d, out)) == 1
        log = open(f"{out}/log.maniac").read()
        assert "no CUDA device" in log and "Simulation Completed" not in log


def test_cli_isotherm_mode(tmp_path):
    """--isotherm runs every fugacity as parallel state points and writes
    isotherm_<RES>.dat series and the isotherm.dat summary; the ideal gas's
    fluctuation isosteric heat is RT = 0.5962 kcal/mol at 300 K."""
    d = _ideal_lj(str(tmp_path / "sys"), fugacity=100.0, nb_block=8,
                  nb_step=400)
    out = str(tmp_path / "outputs")
    rc = cli_main(_flags(d, out, "--platform", "cpu", "--dtype", "f64",
                         "--isotherm", "50,400", "--replicas", "2"))
    assert rc == 0
    log = open(f"{out}/log.maniac").read()
    assert "Isotherm summary" in log and "Simulation Completed" in log
    series = _rows(f"{out}/isotherm_lj.dat")
    assert len(series) == 8 and len(series[0].split()) == 3
    rows = [r.split() for r in _rows(f"{out}/isotherm.dat")]
    assert [r[0] for r in rows] == ["lj", "lj"]
    assert [float(r[1]) for r in rows] == [50.0, 400.0]
    n_vals = [float(r[2]) for r in rows]
    assert n_vals[1] > 2.0 * n_vals[0] > 0.0, rows
    for r in rows:
        assert abs(float(r[4]) - 0.5962) < 0.01, rows


def test_cli_isotherm_f32_resync(tmp_path):
    """--isotherm at f32 runs the per-block amplitude resync of the
    sweep."""
    d = _ideal_lj(str(tmp_path / "sys"), fugacity=100.0, nb_block=3,
                  nb_step=100)
    with open(f"{d}/parameters.inc", "w") as f:   # the LJ back on
        f.write("pair_coeff 1 1 0.2 3.0\n")
    out = str(tmp_path / "outputs")
    rc = cli_main(_flags(d, out, "--platform", "cpu", "--dtype", "f32",
                         "--isotherm", "100", "--replicas", "2"))
    assert rc == 0
    rows = _rows(f"{out}/isotherm.dat")
    assert len(rows) == 1 and float(rows[0].split()[2]) >= 0.0


def test_cli_isotherm_zero_fugacity_aborts(tmp_path):
    """A deck fugacity of 0 cannot be scaled: a logged abort with exit 1
    (maniac_tpu.cli divides by it)."""
    d = _ideal_lj(str(tmp_path / "sys"), fugacity=0.0, nb_block=2,
                  nb_step=10)
    out = str(tmp_path / "outputs")
    rc = cli_main(_flags(d, out, "--platform", "cpu", "--isotherm", "10,20"))
    assert rc == 1
    log = open(f"{out}/log.maniac").read()
    assert "FATAL ERROR" in log and "fugacity 0" in log


def test_cli_replicas_dat_contract(tmp_path):
    """--replicas N > 1 writes replicas.dat: one row per block with the
    cross-replica mean and std of N per active species and of the running
    total energy; single-chain runs do not write it."""
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.3, 0.4, 0.0), fugacity=500.0,
                       nb_block=3, nb_step=40, recal=False)
    out = str(tmp_path / "outputs")
    rc = cli_main(_flags(d, out, "--platform", "cpu", "--dtype", "f64",
                         "--replicas", "4"))
    assert rc == 0
    lines = open(f"{out}/replicas.dat").read().splitlines()
    assert lines[0].startswith("#") and "<N(wat)>" in lines[0] \
        and "std(N(wat))" in lines[0] and "<E_tot>" in lines[0]
    rows = [line.split() for line in lines[1:]]
    assert len(rows) == 3
    for i, r in enumerate(rows):
        assert int(r[0]) == i + 1
        mean_n, std_n, mean_e, std_e = map(float, r[1:5])
        assert mean_n >= 0.0 and std_n >= 0.0 and std_e >= 0.0
        assert np.isfinite(mean_e)
    out1 = str(tmp_path / "outputs1")
    assert cli_main(_flags(d, out1, "--platform", "cpu", "--dtype",
                           "f64")) == 0
    assert not os.path.exists(f"{out1}/replicas.dat")


def test_cli_imports_no_jax():
    """The command line and every module it reaches import neither jax nor
    the JAX package."""
    code = ("import sys, maniac_tpu_torch.cli, maniac_tpu_torch.io.writers, "
            "maniac_tpu_torch.kernels.stepg, maniac_tpu_torch.parallel.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.split('.')[0] == 'maniac_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
