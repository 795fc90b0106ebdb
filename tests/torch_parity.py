"""Helpers shared by the tests/test_torch_*.py parity tests: build a
system's files with both packages' system writers, load a system in both
packages, carry JAX leaves into the port, run JAX scans of mc_step_u and
JAX's Pallas blockg (interpret mode) on explicit uniforms, and compare
batched states and parse results."""

from __future__ import annotations

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import maniac_tpu
import maniac_tpu.systems as jax_systems
import maniac_tpu_torch.systems as torch_systems
from maniac_tpu.kernels.blockg import run_block_grouped
from maniac_tpu.mc.driver import _recalibrate as jax_recalibrate
from maniac_tpu.mc.driver import resync_amplitudes_body
from maniac_tpu.mc.moves import N_UNIFORMS
from maniac_tpu.mc.moves import mc_step_u as jax_mc_step_u
from maniac_tpu_torch.system import from_numpy
from maniac_tpu_torch.systems import make_mixed_reservoir, make_mixed_sizes

# tolerances of the f32 parity tests: the bounds tests/test_blockg.py holds
# the TPU kernel to against the XLA scan (f32 ulp on positions, running
# energies summed in another order)
F32_POS_TOL = 1e-4       # Angstrom
F32_ENERGY_TOL = 5.0     # Kelvin


def files(outdir) -> tuple:
    return (f"{outdir}/input.maniac", f"{outdir}/topology.data",
            f"{outdir}/parameters.inc")


def build_both(make: str, outdir, **kw) -> str:
    """Write a system's files with maniac_tpu_torch.systems.<make> into
    outdir and with maniac_tpu.systems.<make> into outdir + "_jax", from
    the same arguments (and so the same seed); assert the two packages
    wrote the same bytes and return outdir."""
    outdir = str(outdir)
    getattr(torch_systems, make)(outdir, **kw)
    getattr(jax_systems, make)(outdir + "_jax", **kw)
    names = sorted(os.listdir(outdir))
    assert names == sorted(os.listdir(outdir + "_jax"))
    _, mismatch, errors = filecmp.cmpfiles(outdir, outdir + "_jax", names,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return outdir


def assert_same_fields(got, want, path="") -> None:
    """The port's parse result equals the JAX package's, field by field and
    exactly: dataclasses of the same name, lists, dicts, numpy arrays (dtype,
    shape and values) and scalars."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same_fields(getattr(got, f.name), getattr(want, f.name),
                               f"{path}.{f.name}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, type(want)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_fields(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same_fields(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and (got == want or got != got
                                            and want != want), \
            (path, got, want)


def jax_leaves(obj) -> dict:
    """Field name -> numpy array (or the meta value) of a JAX dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (v if isinstance(v, (bool, int, float, str, tuple))
                       else np.asarray(v))
    return out


def load_both(outdir, *, capacity=None, f32=False, reservoir=None):
    """(JAX LoadedSystem, port (spec, state) carried over from it);
    ``reservoir`` is the path of a reservoir data file."""
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.float64,
                                                        torch.float64)
    sysm = maniac_tpu.load_system(*files(outdir), reservoir_file=reservoir,
                                  capacity=capacity, dtype=jdt)
    spec, state = from_numpy(jax_leaves(sysm.spec), jax_leaves(sysm.state),
                             device="cpu", dtype=tdt)
    return sysm, spec, state


def mixed_with_reservoir(outdir) -> str:
    """Two active species (4-site water, 2-site dimer, no framework) with a
    reservoir of both: make_mixed_sizes and make_mixed_reservoir, 4 of each
    in the box and in the reservoir. Returns the reservoir file's path."""
    make_mixed_sizes(outdir, n_water=4, n_dimer=4, L=16.0, cutoff=5.0,
                     tol=1e-4, probs=(0.2, 0.1, 0.3, 0.4))
    return make_mixed_reservoir(outdir, n_water=4, n_dimer=4, L=16.0)


def uniforms(B: int, n_steps: int, seed: int, f32: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((B, n_steps, 21)).astype(np.float32 if f32
                                               else np.float64)


def jax_scan_fn(spec):
    """A jitted JAX mc_step_u scan over one replica's uniforms (n, 21):
    (state, u) -> state."""
    def run(st, uu):
        def body(c, row):
            return jax_mc_step_u(spec, c, row), None
        return jax.lax.scan(body, st, uu)[0]
    return jax.jit(run)


def jax_scan(spec, state, u):
    """JAX mc_step_u scanned over one replica's uniforms (n, 21)."""
    return jax_scan_fn(spec)(state, jnp.asarray(u))


def jax_batch(spec, state, U):
    """Run each replica's uniforms (B, n, 21) through one jitted scan from
    ``state`` (one state, or a batch with a leading axis B); stack to a
    batched JAX state."""
    run = jax_scan_fn(spec)
    batched = np.ndim(state.pos) == 3
    outs = [run(jax.tree_util.tree_map(lambda x: x[b], state) if batched
                else state, jnp.asarray(U[b])) for b in range(U.shape[0])]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)


def jax_blockg(sysm, U):
    """JAX's Pallas blockg (interpret mode) over uniforms U (G, n, 21) from
    the loaded state, unpacked as driver.block_body_group, then the
    recalibration and the amplitude resync."""
    spec = sysm.spec
    G, n = U.shape[:2]
    st = jax.tree_util.tree_map(lambda x: jnp.stack([x] * G), sysm.state)
    uq = jnp.asarray(U.transpose(1, 2, 0).reshape(n, N_UNIFORMS * G))
    (pos, com, amp_re, amp_im, nrow, eng, cnt, resoff, rescom,
     resn) = run_block_grouped(spec, st, uq, interpret=True)
    aids = [r for r in range(spec.R) if spec.active_list[r]]
    r_idx = jnp.arange(spec.R + 1)
    n_mol, res_n = st.n_mol, st.res_n
    for j, t in enumerate(aids):
        n_mol = jnp.where(r_idx[None, :] == t, nrow[j][:, None], n_mol)
        res_n = jnp.where(r_idx[None, :] == t, resn[j][:, None], res_n)
    counters = st.counters + jnp.stack(
        [cnt[0:5, :].T.astype(jnp.int32), cnt[8:13, :].T.astype(jnp.int32)],
        axis=1)
    extras = st.extras.at[:, 0].add(cnt[5].astype(jnp.int32))
    extras = extras.at[:, 1].add(cnt[6].astype(jnp.int32))
    st = st.replace(pos=pos, com=com, amp_re=amp_re, amp_im=amp_im,
                    n_mol=n_mol, energy=eng[:6, :].T, counters=counters,
                    extras=extras)
    if spec.has_reservoir:
        Sres, Mres = st.res_offset.shape[1], st.res_com.shape[1]
        st = st.replace(res_offset=resoff[:, :, :Sres].transpose(0, 2, 1),
                        res_com=rescom[:, :, :Mres].transpose(0, 2, 1),
                        res_n=res_n)
    st = jax.vmap(lambda s: jax_recalibrate(s, True, spec.dtype))(st)
    return jax.vmap(lambda s: resync_amplitudes_body(spec, s))(st)


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

