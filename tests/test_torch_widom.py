"""maniac_tpu_torch Widom insertion (mc/widom.py) against the JAX package:
tests/test_widom.py's cases with the same inputs into both packages.

  * widom_delta_u on the water box and on the framework-split fixture, the
    same uniforms into both (f64 within 1e-9 relative; f32 within
    F32_DU_ATOL + F32_DU_RTOL |dU|: the ghost's pair and k-space sums in
    f32, added in another order);
  * the two-species widom_block from fed uniforms against numpy's
    log-mean-exp of JAX's per-trial dU;
  * the command line with --widom 4 --profile 8: energy.dat byte-identical
    to a run without it, widom.dat's shape and cumulative mean as
    tests/test_widom.py checks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.mc.widom import widom_delta_u as jax_widom_delta_u
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.mc.widom import (mu_excess_K, widom_block,
                                       widom_delta_u, widom_factor,
                                       widom_key)
from maniac_tpu_torch.systems import make_lj_gas, make_water_box, \
    make_zif_like

from torch_parity import load_both

torch.set_num_threads(1)

# tests/test_widom.py's placements: the water box's two, the framework's
# three (the first in a pore, dU ~ 5e3 K; the others near or on framework
# sites, dU up to ~1e15 K)
WATER_U = ([0.31, 0.72, 0.11, 0.55, 0.23, 0.91],
           [0.93, 0.04, 0.66, 0.12, 0.79, 0.38])
FW_U = ([0.4888, 0.9765, 0.7757, 0.3089, 0.2698, 0.8631],
        [0.42, 0.17, 0.83, 0.29, 0.61, 0.07],
        [0.55, 0.31, 0.12, 0.33, 0.97, 0.26])
F64_RTOL = 1e-9
# f32: a ghost's dU sums some thousand pair terms and ~1e3 k-modes in f32,
# added in another order by the two packages: some ulp of a few-1e3 K sum
# (an ulp of 5e3 K is 5e-4 K), and 1e-6 relative for the overlapping
# placements' up to ~1e15 K
F32_DU_ATOL, F32_DU_RTOL = 0.05, 1e-6


def _jax_du(sysm, u):
    spec = sysm.spec
    t = int(spec.active_type_ids[0])
    return np.array([float(jax_widom_delta_u(spec, sysm.state,
                                             jnp.asarray(row, spec.dtype), t))
                     for row in u])


def _water(d):
    make_water_box(str(d), n_water=8, L=14.0)
    return 16, WATER_U


def _framework(d):
    make_zif_like(str(d), n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)
    return 16, FW_U


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("fixture", [_water, _framework],
                         ids=["water", "fwsplit"])
def test_widom_du_matches_jax(tmp_path, fixture, f32):
    """The ghost's dU of the same placements in both packages."""
    capacity, u = fixture(tmp_path)
    sysm, spec, state = load_both(str(tmp_path), capacity=capacity, f32=f32)
    if fixture is _framework:
        assert spec.fw_split and sysm.spec.fw_split
    want = _jax_du(sysm, u)
    t = int(spec.active_type_ids[0])
    got = widom_delta_u(spec, state, np.asarray(u), t).numpy()
    if f32:
        np.testing.assert_allclose(got, want, rtol=F32_DU_RTOL,
                                   atol=F32_DU_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=0)
    if fixture is _framework:
        # the pore placement keeps the absolute tolerance in play
        assert min(abs(want)) < 1e5, want


def test_widom_block_two_species_matches_jax(tmp_path):
    """Two active species from fed uniforms: the port's log Widom factor
    against numpy's log-mean-exp of JAX's per-trial dU."""
    make_lj_gas(str(tmp_path), n=12, L=18.0, two_species=True)
    sysm, spec, state = load_both(str(tmp_path), capacity=16)
    assert spec.n_active == 2
    n = 16
    u = np.random.default_rng(7).random((n, 2, 6))
    temp = float(sysm.spec.temp_K)
    want = []
    for i, t in enumerate(np.asarray(sysm.spec.active_type_ids)):
        du = np.array([float(jax_widom_delta_u(sysm.spec, sysm.state,
                                               jnp.asarray(u[k, i]), int(t)))
                       for k in range(n)])
        x = -du / temp
        m = x.max()
        want.append(m + np.log(np.mean(np.exp(x - m))))
    log_b = widom_block(spec, state, n, uniforms=u)
    assert log_b.shape == (2,)
    np.testing.assert_allclose(log_b.numpy(), want, rtol=1e-9, atol=1e-12)
    B = widom_factor(log_b)
    assert np.all(np.isfinite(B)) and np.all(B > 0)
    assert np.all(np.isfinite(mu_excess_K(B, temp)))


def test_widom_key_is_per_block_and_leaves_the_chain(tmp_path):
    """widom_block draws from its own per-block key, folded off replica 0's
    as the JAX CLI folds it: the same key and block give the same factor,
    another block another one, and the chain's key is not advanced."""
    make_lj_gas(str(tmp_path), n=12, L=18.0, two_species=True)
    _, spec, state = load_both(str(tmp_path), capacity=16)
    before = state.key.clone()
    keys = [widom_key(state, b) for b in (1, 1, 2)]
    want = jax.random.fold_in(jax.random.fold_in(
        jnp.asarray(state.key[0].numpy().astype(np.uint32)), 0x5749444F), 2)
    np.testing.assert_array_equal(keys[2].numpy(),
                                  np.asarray(want).astype(np.int64))
    one, two, other = (widom_block(spec, state, 8, key=k) for k in keys)
    assert torch.equal(one, two) and not torch.equal(one, other)
    assert torch.equal(state.key, before)


def test_widom_cli_does_not_perturb_chain(tmp_path):
    """--widom 4 --profile 8 on the CPU: energy.dat byte-identical to the
    run without it; widom.dat one row a block of (B_block, B_cum, mu_ex),
    B_cum the mean of the block factors; the profile's rows sum to the
    population series."""
    src = tmp_path / "sys"
    src.mkdir()
    make_water_box(str(src), n_water=8, L=14.0, nb_block=2, nb_step=8,
                   fugacity=800.0)
    argv = ["-i", f"{src}/input.maniac", "-d", f"{src}/topology.data",
            "-p", f"{src}/parameters.inc", "--seed", "11", "--platform",
            "cpu"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    assert cli_main(argv + ["-o", str(out_a)]) == 0
    assert cli_main(argv + ["-o", str(out_b), "--widom", "4",
                            "--profile", "8"]) == 0
    assert ((out_a / "energy.dat").read_text()
            == (out_b / "energy.dat").read_text())
    rows = [ln for ln in (out_b / "widom.dat").read_text().splitlines()
            if not ln.startswith("#")]
    assert len(rows) == 2
    vals = np.array([ln.split()[1:] for ln in rows], dtype=float)
    assert vals.shape == (2, 3)
    assert np.all(np.isfinite(vals)) and np.all(vals[:, 0] > 0)
    assert np.isclose(vals[1, 1], vals[:, 0].mean(), rtol=1e-6)
    prows = [ln.split() for ln in
             (out_b / "profile_wat.dat").read_text().splitlines()
             if not ln.startswith("#")]
    nrows = [ln.split() for ln in
             (out_b / "number_wat.dat").read_text().splitlines()
             if not ln.startswith("#")]
    assert len(prows) == 3 and all(len(r) == 9 for r in prows)
    for p, n in zip(prows, nrows):
        assert p[0] == n[0]
        assert sum(int(c) for c in p[1:]) == int(n[1])
