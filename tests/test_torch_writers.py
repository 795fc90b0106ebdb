"""maniac_tpu_torch's output files (io/writers.py through the command line)
against the reference's format contracts and the JAX CLI: tests/
test_writers.py's 5 cases, run on the port's CLI (--platform cpu).

The four format cases parse the files of one shared module-scoped run
(f64), as the JAX test does. Beside it the JAX CLI runs the same deck with
the same --seed: one seed walks one chain in both packages, so the port's
energy.dat must be within 1e-9 relative of the JAX CLI's and its moves.dat
equal. The f32 case holds the last energy row to an f64 recompute of the
written restart configuration within the JAX test's 5e-3 kcal/mol (it
compares no f32 bytes: f32 sums on the CPU depend on the thread count).
"""

import numpy as np
import pytest
import torch

from maniac_tpu.cli import main as jax_cli_main
from maniac_tpu_torch import load_system
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.constants import KB_KCALMOL
from maniac_tpu_torch.system import E_TOT

from torch_parity import build_both, files

SEED = 2024
E_RTOL = 1e-9


def _argv(d, out, dtype):
    return ["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
            "-p", f"{d}/parameters.inc", "-o", out, "--platform", "cpu",
            "--dtype", dtype, "--seed", str(SEED)]


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f if not ln.startswith("#")]


@pytest.fixture(scope="module")
def _run(tmp_path_factory):
    """One shared run of the port's CLI (the four format cases parse its
    files) and the JAX CLI's run of the same deck and seed; returns both
    output directories."""
    tmp_path = tmp_path_factory.mktemp("writers")
    d = build_both("make_water_box", tmp_path / "sys", n_water=8, L=14.0,
                   cutoff=5.0, tol=1e-4, probs=(0.3, 0.3, 0.4, 0.0),
                   fugacity=800.0, nb_block=3, nb_step=40)
    out, out_jax = str(tmp_path / "outputs"), str(tmp_path / "outputs_jax")
    assert cli_main(_argv(d, out, "f64")) == 0
    assert jax_cli_main(_argv(d, out_jax, "f64")) == 0
    return out, out_jax


def test_energy_dat_columns(_run):
    out, out_jax = _run
    rows = _rows(f"{out}/energy.dat")
    assert len(rows) == 4                      # block 0 + 3 blocks
    for r in rows:
        assert len(r) == 7                     # block + 6 components
        vals = list(map(float, r))
        # total == recip + lj + coul + self + intra (kcal/mol; the file
        # prints 6 decimals, so the identity holds to print precision)
        assert abs(vals[1] - sum(vals[2:7])) < 5e-6, r
    # the JAX CLI's chain from the same seed
    np.testing.assert_allclose(np.array(rows, dtype=float),
                               np.array(_rows(f"{out_jax}/energy.dat"),
                                        dtype=float),
                               rtol=E_RTOL, atol=E_RTOL)


def test_moves_dat_full_eleven_columns(_run):
    out, out_jax = _run
    lines = open(f"{out}/moves.dat").read().splitlines()
    header = lines[0]
    for col in ("Trial_Trans", "Trans_Moves", "Trial_Create", "Create_Moves",
                "Trial_Delete", "Delete_Moves", "Trial_Rotate",
                "Rotate_Moves", "Trial_Swap", "Swap_Moves"):
        assert col in header
    rows = [ln.split() for ln in lines[1:] if ln.strip()]
    assert all(len(r) == 11 for r in rows)
    last = list(map(int, rows[-1]))
    # counters are cumulative and monotone; accepted <= trials per type
    for t_col, a_col in ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10)):
        assert last[a_col] <= last[t_col]
    assert last[1] + last[3] + last[5] + last[7] + last[9] > 0
    # the JAX CLI's chain from the same seed: the same header and counts
    jax_lines = open(f"{out_jax}/moves.dat").read().splitlines()
    assert jax_lines[0] == header
    assert [ln.split() for ln in jax_lines[1:] if ln.strip()] == rows


def test_trajectory_timesteps_and_counts(_run):
    out, _ = _run
    text = open(f"{out}/trajectory.lammpstrj").read().splitlines()
    steps = [int(text[i + 1]) for i, ln in enumerate(text)
             if ln.startswith("ITEM: TIMESTEP")]
    assert steps == [0, 1, 2, 3]   # actual block ids (DIVERGENCES.md #15)
    counts = [int(text[i + 1]) for i, ln in enumerate(text)
              if ln.startswith("ITEM: NUMBER OF ATOMS")]
    n_rows = [ln for ln in text if ln.startswith("ITEM: ATOMS")]
    assert len(counts) == 4 and len(n_rows) == 4
    # atom counts match the number_<RES>.dat series (4 sites per water)
    series = [int(ln.split()[1]) for ln in open(f"{out}/number_wat.dat")
              if not ln.startswith("#")]
    assert counts == [4 * n for n in series]


def test_log_status_rows_parse(_run):
    out, _ = _run
    log = open(f"{out}/log.maniac").read().splitlines()
    idx = [i for i, ln in enumerate(log) if "TotEng" in ln]
    assert len(idx) >= 3
    for i in idx[:3]:
        fields = log[i + 1].split()
        int(fields[0])                      # Step
        for f in fields[1:5]:
            float(f)                        # TotEng E_vdwl E_coul E_long


def test_f32_energy_rows_exact(tmp_path):
    """f32 runs report exact energies every block, as the reference does
    (src/write_utils.f90:94-188), not the wandering f32 running totals
    (DIVERGENCES.md #13): the last energy.dat row matches a from-scratch
    f64 recompute of the written restart configuration within 5e-3
    kcal/mol (the restart prints 10-decimal positions; f32 recompute
    noise is some 1e-3)."""
    d = build_both("make_water_box", tmp_path / "sys", n_water=8, L=14.0,
                   cutoff=5.0, tol=1e-4, probs=(0.3, 0.2, 0.5, 0.0),
                   fugacity=8000.0, nb_block=3, nb_step=120)
    out = str(tmp_path / "outputs")
    assert cli_main(_argv(d, out, "f32")) == 0
    last_tot = float(_rows(f"{out}/energy.dat")[-1][1])
    # topology.data is the final configuration; recompute it in f64
    inp, _, inc = files(d)
    sys2 = load_system(inp, f"{out}/topology.data", inc,
                       dtype=torch.float64, device="cpu")
    e_fresh = float(sys2.state.energy[0, E_TOT]) * KB_KCALMOL
    assert abs(last_tot - e_fresh) < 5e-3, (last_tot, e_fresh)
