"""maniac_tpu_torch's threefry stream (utils/threefry.py, kernels/threefry.py)
against jax.random, and one seed walking one chain in both packages.

  * prng_key, split (2 and 1024 keys), fold_in and uniform (f32 and f64,
    at (400, 21) and (3, 7)) bit-equal to jax.random over four seeds, one
    above 2**32; the kernel's plain version (split_uniform_plain) equal to
    JAX's per-replica split and draw of a block;
  * replicate and two run_block_replicated blocks, f64, B = 4, from one
    seed in both packages: keys, populations and counters equal, energies
    within 1e-9 relative;
  * the command line with one --seed, f64 on the CPU, as a single chain and
    with --replicas 4: energy.dat within 1e-9 relative of the JAX CLI's and
    the integer columns of moves.dat equal.

Only f64 chains are compared: f32 sums on the CPU depend on the thread
count (ROADMAP section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.cli import main as jax_cli_main
from maniac_tpu.parallel.replicas import replicate as jax_replicate
from maniac_tpu.parallel.replicas import \
    run_block_replicated as jax_run_block_replicated
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.kernels.threefry import (split_uniform,
                                               split_uniform_plain)
from maniac_tpu_torch.parallel.replicas import replicate, run_block_replicated
from maniac_tpu_torch.systems import make_water_box
from maniac_tpu_torch.utils import threefry

from torch_parity import as_np, load_both

torch.set_num_threads(1)

SEEDS = (0, 7, 1234, 2**32 + 5)
E_RTOL = 1e-9
DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(got, want.astype(np.int64))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


CASES = {
    "prng_key": (lambda k: k, lambda t: t),
    "split2": (lambda k: jax.random.split(k), lambda t: threefry.split(t)),
    "split1024": (lambda k: jax.random.split(k, 1024),
                  lambda t: threefry.split(t, 1024)),
    "fold_in": (lambda k: jax.random.fold_in(k, 0x5749444F),
                lambda t: threefry.fold_in(t, 0x5749444F)),
}
for _name, _shape in (("400x21", (400, 21)), ("3x7", (3, 7))):
    for _dt, (_jdt, _tdt) in DTYPES.items():
        CASES[f"uniform_{_dt}_{_name}"] = (
            lambda k, s=_shape, d=_jdt: jax.random.uniform(k, s, dtype=d),
            lambda t, s=_shape, d=_tdt: threefry.uniform(t, s, d))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_is_jax_random(case, seed):
    """Each function of the stream gives jax.random's bits."""
    jax_fn, port_fn = CASES[case]
    _same_bits(port_fn(threefry.prng_key(seed)),
               jax_fn(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_draw_is_jax_block_draw(dtype):
    """split_uniform (its plain version on CPU keys) is JAX's per-replica
    block draw: (key, sub) = split(key), uniform(sub, (n_steps, 21))."""
    jdt, tdt = DTYPES[dtype]
    keys = jax.random.split(jax.random.PRNGKey(2**33 + 11), 5)
    split = jax.vmap(jax.random.split)(keys)
    want_u = jax.vmap(lambda k: jax.random.uniform(k, (7, 21), dtype=jdt))(
        split[:, 1])
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    for fn in (split_uniform, split_uniform_plain):
        new, u = fn(tkeys, 7, tdt)
        _same_bits(new, split[:, 0])
        _same_bits(u, want_u)


def test_replicated_blocks_walk_jax_chain(tmp_path):
    """One seed, replicate(B = 4) and two f64 blocks of run_block_replicated
    in each package: the same keys, populations and counters, energies
    within 1e-9 relative."""
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=800.0, seed=3)
    sysm, spec, state = load_both(str(tmp_path), capacity=24)
    jst = jax_replicate(sysm.spec, sysm.state, 4)
    pst = replicate(spec, state, 4)
    for _ in range(2):
        jst = jax_run_block_replicated(sysm.spec, jst, 25, True)
        pst = run_block_replicated(spec, pst, 25, True)
    np.testing.assert_array_equal(as_np(pst.key),
                                  np.asarray(jst.key).astype(np.int64))
    for name in ("n_mol", "counters", "extras"):
        np.testing.assert_array_equal(as_np(getattr(pst, name)),
                                      np.asarray(getattr(jst, name)), name)
    assert int(as_np(pst.counters)[:, 1].sum()) > 0
    np.testing.assert_allclose(as_np(pst.energy), np.asarray(jst.energy),
                               rtol=E_RTOL, atol=E_RTOL)
    np.testing.assert_allclose(as_np(pst.pos), np.asarray(jst.pos),
                               rtol=0, atol=1e-9)


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f if not ln.startswith("#")]


@pytest.mark.parametrize("replicas", [1, 4])
def test_cli_seed_walks_jax_cli_chain(tmp_path, replicas):
    """The port's CLI and the JAX CLI with one --seed (f64, CPU): energy.dat
    within 1e-9 relative, the integer columns of moves.dat equal."""
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.2, 0.5, 0.0), fugacity=800.0,
                       nb_block=2, nb_step=20, recal=True)
    argv = ["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data", "-p",
            f"{d}/parameters.inc", "--dtype", "f64", "--seed", "4242",
            "--replicas", str(replicas), "--platform", "cpu"]
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli_main(argv + ["-o", out_j]) == 0
    assert cli_main(argv + ["-o", out_p]) == 0
    ej = np.array(_rows(f"{out_j}/energy.dat"), dtype=float)
    ep = np.array(_rows(f"{out_p}/energy.dat"), dtype=float)
    assert ej.shape == ep.shape == (3, ej.shape[1])
    np.testing.assert_allclose(ep, ej, rtol=E_RTOL, atol=1e-9)
    mj, mp = _rows(f"{out_j}/moves.dat"), _rows(f"{out_p}/moves.dat")
    assert len(mj) == len(mp) == 3
    ints = [[c for c in row if c.lstrip("-").isdigit()] for row in mj]
    assert all(len(r) >= 5 for r in ints)
    assert ints == [[c for c in row if c.lstrip("-").isdigit()]
                    for row in mp]
    assert sum(int(c) for c in ints[-1][1:]) > 0
