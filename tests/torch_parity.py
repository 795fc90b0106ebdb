"""Helpers shared by the tests/test_torch_*.py parity tests: load a system
in both packages, carry JAX leaves into the port, run JAX scans of
mc_step_u on explicit uniforms, and compare batched states."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import maniac_tpu
from maniac_tpu.mc.moves import mc_step_u as jax_mc_step_u
from maniac_tpu_torch.system import from_numpy

# tolerances of the f32 parity tests: the bounds tests/test_blockg.py holds
# the TPU kernel to against the XLA scan (f32 ulp on positions, running
# energies summed in another order)
F32_POS_TOL = 1e-4       # Angstrom
F32_ENERGY_TOL = 5.0     # Kelvin


def files(outdir) -> tuple:
    return (f"{outdir}/input.maniac", f"{outdir}/topology.data",
            f"{outdir}/parameters.inc")


def jax_leaves(obj) -> dict:
    """Field name -> numpy array (or the meta value) of a JAX dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (v if isinstance(v, (bool, int, float, str, tuple))
                       else np.asarray(v))
    return out


def load_both(outdir, *, capacity=None, f32=False):
    """(JAX LoadedSystem, port (spec, state) carried over from it)."""
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.float64,
                                                        torch.float64)
    sysm = maniac_tpu.load_system(*files(outdir), capacity=capacity,
                                  dtype=jdt)
    spec, state = from_numpy(jax_leaves(sysm.spec), jax_leaves(sysm.state),
                             device="cpu", dtype=tdt)
    return sysm, spec, state


def uniforms(B: int, n_steps: int, seed: int, f32: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((B, n_steps, 21)).astype(np.float32 if f32
                                               else np.float64)


def jax_scan(spec, state, u):
    """JAX mc_step_u scanned over one replica's uniforms (n, 21)."""
    def run(st, uu):
        def body(c, row):
            return jax_mc_step_u(spec, c, row), None
        return jax.lax.scan(body, st, uu)[0]
    return jax.jit(run)(state, jnp.asarray(u))


def jax_batch(spec, state, U):
    """Run each replica's uniforms through jax_scan; stack to a batched
    JAX state (leading axis B)."""
    outs = [jax_scan(spec, state, U[b]) for b in range(U.shape[0])]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)


def as_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_chain(jst, pst, *, pos_tol, energy_tol):
    """Identical decisions (populations, counters, extras), positions and
    energy components within the given tolerances."""
    for name in ("n_mol", "counters", "extras"):
        np.testing.assert_array_equal(as_np(getattr(pst, name)),
                                      as_np(getattr(jst, name)), err_msg=name)
    assert np.abs(as_np(pst.pos) - as_np(jst.pos)).max() <= pos_tol
    assert np.abs(as_np(pst.com) - as_np(jst.com)).max() <= pos_tol
    assert np.abs(as_np(pst.energy) - as_np(jst.energy)).max() <= energy_tol

