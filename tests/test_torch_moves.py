"""maniac_tpu_torch MC step against the JAX package on the same uniforms.

Both packages consume one row of 21 uniforms per step; the rows come from
a numpy seed, so the two chains are the same chain and must take the same
decisions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.mc.moves import _uint as jax_uint
from maniac_tpu_torch.mc.driver import drift_report, run_steps_u
from maniac_tpu_torch.mc.moves import _uint, mc_step_u
from maniac_tpu_torch.parallel.replicas import replicate
from maniac_tpu_torch.systems import make_water_box, make_zif_like

from torch_parity import (F32_ENERGY_TOL, F32_POS_TOL, assert_same_chain,
                          jax_batch, load_both, uniforms)

torch.set_num_threads(1)


def _zif(d):
    make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


def _water(d):
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.25, 0.25, 0.5, 0.0), fugacity=5000.0)


@pytest.mark.parametrize("make", [_zif, _water], ids=["zif", "water_gcmc"])
def test_f64_chain_matches_jax(tmp_path, make):
    """200 steps in f64: identical populations, counters and extras,
    positions within 1e-10 A, and bookkeeping equal to a recompute."""
    make(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16)
    U = uniforms(1, 200, seed=0, f32=False)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, state, torch.from_numpy(U))
    assert_same_chain(jst, pst, pos_tol=1e-10, energy_tol=1e-6)
    c = pst.counters[0].numpy()
    assert c[0, :4].min() > 0 and c[1].sum() > 0  # every move was tried
    rep = drift_report(spec, pst)
    assert rep["drift_K"] <= 1e-6, rep


def test_f32_chain_matches_jax(tmp_path):
    """Framework fixture in f32, B = 2, 40 steps: identical decisions,
    positions < 1e-4 A, energies < 5 K (tests/test_blockg.py bounds)."""
    _zif(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    U = uniforms(2, 40, seed=1, f32=True)
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, replicate(spec, state, 2), torch.from_numpy(U))
    assert_same_chain(jst, pst, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    assert pst.counters[:, 1].sum() > 0


def test_uint_matches_jax_at_f32_edges():
    """floor(u*n) clamped to n-1: the same f32 arithmetic as the JAX draw,
    including u just below 1 where u*n rounds up to n."""
    one_minus = np.nextafter(np.float32(1), np.float32(0))
    u = np.array([0.0, 0.5, one_minus, np.float32(1 / 3),
                  np.float32(2 / 3), np.nextafter(np.float32(2 / 3),
                                                  np.float32(1))],
                 dtype=np.float32)
    for n in (1, 2, 3, 7, 31, 192, 2 ** 20 + 1):
        ref = np.asarray(jax_uint(jnp.asarray(u), jnp.int32(n)))
        got = _uint(torch.from_numpy(u), n).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"n={n}")
        assert got.max() <= n - 1


def test_edge_uniforms_at_move_thresholds(tmp_path):
    """Rows with u_move exactly at each p_cum threshold (and one ulp above),
    u_cd exactly at the create/delete split and the molecule draw at
    1 - ulp: both packages must pick the same move types."""
    _water(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16, f32=True)
    p = spec.p_cum.numpy()
    up = lambda x: np.nextafter(np.float32(x), np.float32(2))  # noqa: E731
    rows = []
    for u_move in (p[0], up(p[0]), p[1], up(p[1]), p[2], up(p[2])):
        for u_cd in (np.float32(0.5), up(0.5)):
            r = np.full(21, 0.37, np.float32)
            r[0], r[1] = u_move, u_cd
            r[13] = np.nextafter(np.float32(1), np.float32(0))
            r[2] = 0.0  # accept whenever the gate allows
            rows.append(r)
    U = np.stack(rows)[None]                       # one replica, n steps
    jst = jax_batch(sysm.spec, sysm.state, U)
    pst = run_steps_u(spec, state, torch.from_numpy(U))
    assert_same_chain(jst, pst, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    trials = pst.counters[0, 0].numpy()
    assert trials[0] > 0 and trials[1] > 0 and trials[2] > 0
    assert trials[3] > 0


def test_step_is_batched_over_replicas(tmp_path):
    """Replica b of a batched step equals a B = 1 step on row b (f64; the
    tolerance only absorbs summation order in batched reductions)."""
    _zif(str(tmp_path))
    _, spec, state = load_both(str(tmp_path), capacity=16)
    U = torch.from_numpy(uniforms(3, 1, seed=5, f32=False))[:, 0]
    out = mc_step_u(spec, replicate(spec, state, 3), U)
    for b in range(3):
        one = mc_step_u(spec, state, U[b:b + 1])
        for name in ("pos", "com", "amp_re", "energy", "n_mol", "counters"):
            np.testing.assert_allclose(getattr(out, name)[b].numpy(),
                                       getattr(one, name)[0].numpy(),
                                       rtol=1e-12, atol=1e-12)
