"""maniac_tpu_torch's GCMC sampling against the virial expansion of the
dilute LJ gas: tests/test_virial_anchor.py's 3 cases, run on the port.

The anchor and its estimators are maniac_tpu_torch/virial.py (its
docstring has the physics): B2 of the engine's exact pair potential by
quadrature, pinned to the published LJ Boyle temperature T_B* = 3.4179;
the occupancy at z* = 0.032, T* = 1.5 within 3 sem + 0.6% of the virial
value and more than 4 sem from the ideal value; the Widom factor within
3 sem + 1% of exp(-2 B2 rho) and more than 3 sem from 1. The JAX test's
sizes, seeds and tolerances, on the CPU in f64 (the plain torch step): 64
replicas, capacity 96, 10 equilibration blocks of 150 steps, then 30
blocks for the occupancy and 12 for Widom (64 ghosts a replica a block,
widom_block_replicated on the JAX test's keys). The two GCMC cases share
one module-scoped equilibrated state (the JAX cases each equilibrate the
same state from the same seed) and run their own sampling blocks from it.
"""

import numpy as np
import pytest
import torch

from maniac_tpu_torch import virial

from torch_parity import build_both

torch.set_num_threads(1)


def test_quadrature_pinned_to_boyle_temperature():
    """The B2 quadrature reproduces the published LJ Boyle temperature
    T_B* = 3.4179 (where B2 of the full potential vanishes)."""
    t_boyle = virial.BOYLE_TSTAR * virial.EPS_K
    b2_star = virial.b2_full(t_boyle) / virial.SIG ** 3
    assert abs(b2_star) < 5e-3
    # and is monotone around it (the root is the right one)
    assert virial.b2_full(0.95 * t_boyle) < 0 < virial.b2_full(1.3 * t_boyle)


@pytest.fixture(scope="module")
def equilibrated(tmp_path_factory):
    """(spec, states): the gas, 64 replicas after 10 blocks of 150 steps."""
    d = build_both("make_lj_gas", tmp_path_factory.mktemp("virial") / "lj",
                   **virial.lj_gas_kwargs())
    spec, state = virial.load(d, torch.float64, "cpu")
    np.testing.assert_allclose(float(spec.type_activity[0]), virial.Z_A3,
                               rtol=1e-12)
    return spec, virial.equilibrate(spec, state)


def test_gcmc_occupancy_matches_virial_expansion(equilibrated):
    rep = virial.occupancy(*equilibrated)
    assert rep["matches"], rep
    # the anchor must resolve the B2 correction: the ideal-gas null rejected
    assert rep["resolved"], rep


def test_widom_matches_virial_expansion(equilibrated):
    rep = virial.widom(*equilibrated)
    assert rep["matches"], rep
    assert rep["resolved"], rep   # mu_ex != 0 (B != 1)
