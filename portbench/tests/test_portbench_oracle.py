"""The independent oracle against the exact periodic sum and against the
frozen copy of the plain path, on the CPU at a small size."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import compare, run
from portbench.oracle import REAL, INTRA, RECIP, SELF, Oracle
from portbench.ref import driver as ref
from portbench.writers import spce_box

CONFIG = json.loads((run.PKG / "configs" / "spce750.json").read_text())
COULOMB = [RECIP, REAL, SELF, INTRA]


def small(tmp_path, tol, seed=11):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["writer_args"].update(n_water=12, L=16.0, cutoff_A=6.0,
                              ewald_tolerance=tol)
    arrays = spce_box.write(str(tmp_path), seed, cfg)
    return cfg, arrays, torch.as_tensor(arrays["pos"])


@pytest.mark.parametrize("tol", [1e-5, 1e-8])
def test_oracle_agrees_with_the_plain_path(tmp_path, tol):
    """Same definitions, written apart: the six components agree in
    float64 but for the plain path's real-space cutoff where erfc(alpha r)
    < 5e-10 (DIVERGENCES.md #22), some 5e-8 of the median component."""
    cfg, arrays, pos = small(tmp_path, tol)
    _, st = ref.load(f"{tmp_path}/input.maniac", f"{tmp_path}/topology.data",
                     f"{tmp_path}/parameters.inc", capacity=16,
                     dtype=torch.float64, device="cpu", seed=11)
    o = Oracle(cfg["model"], arrays["L"], 6.0, tol, "cpu")
    gaps = compare.energy_gaps(st.energy, o.energies(pos)[None])
    assert float(gaps.max()) < 2e-7


def test_split_converges_to_the_exact_sum(tmp_path):
    """At a tight tolerance the split's Coulomb energy is the exact
    periodic one; at the configuration's it is off by its truncation."""
    cfg, arrays, pos = small(tmp_path, 1e-12)
    exact = Oracle(cfg["model"], arrays["L"], 6.0, 0, "cpu",
                   converged=True).energies(pos)[COULOMB].sum()
    tight = Oracle(cfg["model"], arrays["L"], 6.0, 1e-12,
                   "cpu").energies(pos)[COULOMB].sum()
    assert abs(float(tight - exact)) < 1e-7 * abs(float(exact)) + 1e-3
