"""maniac_tpu_torch's per-move dE precision (tools/delta_e_report.py)
against the JAX package: tests/test_precision.py's 2 cases, run on the
port.

  * the f32 envelope: the port's f32 chain on the flagship chemistry,
    200 steps from seed 3 (JAX's keys, split(prng_key(3), 200)), every
    accepted move's running dE against the f64 recompute: the JAX test's
    bounds, max < 5e-4 and mean < 1e-4 kcal/mol, more than 20 moves;
  * f64: the port's per-move dE equals a from-scratch f64 recompute within
    1e-6 kcal/mol (the JAX test's bar) on the JAX test's system and keys
    (split(PRNGKey(5), 80)); and the port walks the JAX package's chain on
    those keys: the same moves accepted at the same steps, each dE within
    1e-9 kcal/mol of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import maniac_tpu
from maniac_tpu.mc.moves import mc_step as jax_mc_step
from maniac_tpu.physics.energy import system_energy as jax_system_energy
from maniac_tpu.system import E_TOT
from maniac_tpu_torch import load_system
from maniac_tpu_torch.constants import KB_KCALMOL
from maniac_tpu_torch.tools.delta_e_report import measure, per_move_delta_e
from maniac_tpu_torch.utils.threefry import prng_key, split

from torch_parity import build_both, files

torch.set_num_threads(1)


def test_f32_per_move_delta_e_envelope():
    rep = measure(n_steps=200, seed=3, verbose=False, device="cpu")
    assert rep["accepted_moves"] > 20
    assert rep["max_abs_dE_err_kcalmol"] < 5e-4, rep
    assert rep["mean_abs_dE_err_kcalmol"] < 1e-4, rep


def _jax_moves(d, n_steps, seed):
    """tests/test_precision.py's f64 chain: (accepted steps, running dE) in
    Kelvin."""
    sysm = maniac_tpu.load_system(*files(d), dtype=jnp.float64, capacity=32)
    spec, st = sysm.spec, sysm.state
    step = jax.jit(lambda s, k: jax_mc_step(spec, s, k))
    efull = jax.jit(lambda s: jax_system_energy(spec, s)[0][E_TOT])
    steps, de, de_full = [], [], []
    e_prev, e_prev_full = float(st.energy[E_TOT]), float(efull(st))
    for i, k in enumerate(jax.random.split(jax.random.PRNGKey(seed),
                                           n_steps)):
        st = step(st, k)
        e_run = float(st.energy[E_TOT])
        if e_run != e_prev:
            e_full = float(efull(st))
            steps.append(i)
            de.append(e_run - e_prev)
            de_full.append(e_full - e_prev_full)
            e_prev_full = e_full
        e_prev = e_run
    return np.array(steps), np.array(de), np.array(de_full)


def test_f64_per_move_delta_e_exact(tmp_path):
    """The f64 engine's per-move dE matches a from-scratch f64 recompute to
    ~1e-9 kcal/mol (far below the 1e-6 bar), at flagship chemistry; and the
    port's chain is JAX's on the same keys."""
    d = build_both("make_zif_like", tmp_path / "zif", n_cells=3, a=5.66,
                   n_water=8, fugacity=50.0)
    sysm = load_system(*files(d), dtype=torch.float64, capacity=32,
                       device="cpu")
    steps, _, de_run, de_exact = per_move_delta_e(
        sysm.spec, sysm.state, sysm.spec, sysm.state, split(prng_key(5), 80))
    assert steps.size > 10
    assert np.abs(de_run - de_exact).max() * KB_KCALMOL < 1e-6
    jax_steps, jax_de, jax_de_full = _jax_moves(d, 80, 5)
    np.testing.assert_array_equal(steps, jax_steps)
    assert np.abs(de_run - jax_de).max() * KB_KCALMOL < 1e-9
    assert np.abs(de_exact - jax_de_full).max() * KB_KCALMOL < 1e-9
