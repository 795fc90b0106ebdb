"""maniac_tpu_torch tabulated pair potentials (use_table) against the JAX
package: tests/test_tabulated.py's five cases on the port, in f64.

  * tab_lookup's LookupTabulated semantics, the port's and JAX's on one
    table;
  * the tables the port builds and the pair energies they give, against
    JAX's tables and energies (1e-9 relative) and a numpy brute force;
  * 60 GCMC steps from the same threefry keys in both packages: the same
    decisions, energies within 1e-9 relative, bookkeeping equal to a
    recompute;
  * the kernels refuse a tabulated spec: the gates and dispatch_report
    name tabulated potentials, as JAX's gates refuse it;
  * framework_split on with use_table aborts the deck;
  * the command line with use_table and --widom against the JAX CLI's
    widom.dat and energy.dat for one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maniac_tpu
from maniac_tpu.cli import main as jax_cli_main
from maniac_tpu.kernels import use_blockg, use_pair_kernel
from maniac_tpu.mc.moves import mc_step as jax_mc_step
from maniac_tpu.physics.energy import tab_lookup as jax_tab_lookup
from maniac_tpu_torch import load_system
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.constants import COULOMB_K
from maniac_tpu_torch.io.deck import parse_deck
from maniac_tpu_torch.kernels import (block_gate_failure, dispatch_report,
                                      step_gate_failure)
from maniac_tpu_torch.mc.driver import drift_report
from maniac_tpu_torch.mc.moves import _core_plain, mc_step_u
from maniac_tpu_torch.physics.energy import tab_lookup
from maniac_tpu_torch.system import E_COUL, E_LJ
from maniac_tpu_torch.systems import make_water_box
from maniac_tpu_torch.utils.errors import ManiacError
from maniac_tpu_torch.utils.threefry import prng_key, split, uniform

from torch_parity import as_np, files

torch.set_num_threads(1)

F64_RTOL = 1e-9


def _both(d, **kw):
    """(JAX LoadedSystem, the port's LoadedSystem), each built from the
    files by its own package, f64 on the CPU."""
    return (maniac_tpu.load_system(*files(d), **kw),
            load_system(*files(d), dtype=torch.float64, device="cpu", **kw))


def _np_lookup(table, dx, r):
    """tests/test_tabulated.py's numpy LookupTabulated."""
    n = len(table) - 1
    if r <= 0.0:
        return table[0]
    if r >= n * dx:
        return 0.0
    i = int(r / dx)
    t = (r - i * dx) / dx
    return (1.0 - t) * table[i] + t * table[i + 1]


def test_lookup_semantics():
    """f[0] at r <= 0, the lerp inside, 0 at and beyond the grid's end;
    the same values as JAX's tab_lookup."""
    table = np.array([1.0, 3.0, 2.0, 5.0])
    r = np.array([-1.0, 0.0, 0.25, 0.5, 1.2, 1.5, 99.0])
    got = tab_lookup(torch.from_numpy(table), 0.5,
                     torch.from_numpy(r)).numpy()
    want = np.array([1.0, 1.0, 2.0, 3.0, 2.0 + 0.4 * 3.0, 0.0, 0.0])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_array_equal(got, np.asarray(jax_tab_lookup(
        jnp.asarray(table), 0.5, jnp.asarray(r))))


def test_tabulated_pair_energy_vs_jax_and_bruteforce(tmp_path):
    """The port's own tables equal JAX's, and so do its LJ and Coulomb
    energies; both equal the brute-force sum over live pairs."""
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=6.0, tol=1e-4,
                   probs=(1.0, 0.0, 0.0, 0.0), use_table="true",
                   tabulated_points=2000)
    jsys, psys = _both(str(tmp_path))
    spec, state = psys.spec, psys.state
    assert spec.use_table and not spec.fw_split and not spec.gg_cut
    for name in ("tab_erfc", "tab_r6", "tab_r12", "tab_dx"):
        np.testing.assert_array_equal(as_np(getattr(spec, name)),
                                      np.asarray(getattr(jsys.spec, name)))
    for k in (E_LJ, E_COUL):
        np.testing.assert_allclose(float(state.energy[0, k]),
                                   float(jsys.state.energy[k]),
                                   rtol=F64_RTOL)

    pos = as_np(state.pos[0]).T
    q, cls, mol = (as_np(getattr(spec, n)) for n in ("site_q", "site_cls",
                                                     "site_mol"))
    live = np.flatnonzero(as_np(spec.site_midx)
                          < as_np(state.n_mol[0])[as_np(spec.site_type)])
    eps_cls, sig_cls = as_np(spec.eps_cls), as_np(spec.sig_cls)
    dx, cutoff = float(spec.tab_dx), float(spec.cutoff)
    t_erfc, t_r6, t_r12 = (as_np(getattr(spec, n))
                           for n in ("tab_erfc", "tab_r6", "tab_r12"))
    e_lj = e_c = 0.0
    for a in live:
        for b in live:
            if b <= a or mol[a] == mol[b]:
                continue
            d = pos[a] - pos[b]
            d -= 14.0 * np.round(d / 14.0)
            r = float(np.linalg.norm(d))
            sig, epsv = sig_cls[cls[a], cls[b]], eps_cls[cls[a], cls[b]]
            if r < cutoff and epsv != 0.0:
                e_lj += 4.0 * epsv * (sig**12 / _np_lookup(t_r12, dx, r)
                                      - sig**6 / _np_lookup(t_r6, dx, r))
            e_c += q[a] * q[b] * _np_lookup(t_erfc, dx, r)
    np.testing.assert_allclose(float(state.energy[0, E_LJ]), e_lj,
                               rtol=F64_RTOL, atol=1e-9)
    np.testing.assert_allclose(float(state.energy[0, E_COUL]),
                               e_c * COULOMB_K, rtol=F64_RTOL, atol=1e-9)


def test_tabulated_gcmc_consistency(tmp_path):
    """60 steps, each from one key of split(PRNGKey(3), 60) in both
    packages (JAX's mc_step): the same populations and counters, energies
    within 1e-9 relative, and the port's bookkeeping equal to a
    recompute."""
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=5000.0,
                   use_table="true")
    jsys, psys = _both(str(tmp_path))
    jspec, jst = jsys.spec, jsys.state
    spec, st = psys.spec, psys.state
    step = jax.jit(lambda s, k: jax_mc_step(jspec, s, k))
    jkeys = jax.random.split(jax.random.PRNGKey(3), 60)
    keys = split(prng_key(3), 60)
    for i in range(60):
        jst = step(jst, jkeys[i])
        st = mc_step_u(spec, st, uniform(keys[i], (21,), torch.float64)[None],
                       _core_plain)
    np.testing.assert_array_equal(as_np(st.n_mol[0]), np.asarray(jst.n_mol))
    np.testing.assert_array_equal(as_np(st.counters[0]),
                                  np.asarray(jst.counters))
    np.testing.assert_allclose(as_np(st.energy[0]), np.asarray(jst.energy),
                               rtol=F64_RTOL, atol=1e-9)
    rep = drift_report(spec, st)
    assert rep["drift_K"] < 1e-7 and rep["amp_drift"] < 1e-7
    c = as_np(st.counters[0])
    assert c[0].sum() == 60 and c[1].sum() > 0


def test_tabulated_disables_kernels(tmp_path, monkeypatch):
    """The step and block gates refuse use_table and dispatch_report names
    it for the card: on every device a tabulated spec runs the plain
    torch step, as the JAX package runs XLA (its gates refuse it too)."""
    make_water_box(str(tmp_path), n_water=4, L=12.0, cutoff=5.0, tol=1e-3,
                   use_table="true")
    sysm = load_system(*files(str(tmp_path)), dtype=torch.float32,
                       device="cpu", compute_initial_energy=False)
    assert step_gate_failure(sysm.spec) == "tabulated potentials"
    assert block_gate_failure(sysm.spec) == "tabulated potentials"
    line = dispatch_report(sysm.spec, "cuda")
    assert ("block: per-step path (tabulated potentials)" in line
            and "step: plain torch path (tabulated potentials)" in line)
    jsys = maniac_tpu.load_system(*files(str(tmp_path)), dtype=jnp.float32,
                                  compute_initial_energy=False)
    monkeypatch.setenv("MANIAC_PALLAS", "blockg")
    assert not use_blockg(jsys.spec)
    monkeypatch.setenv("MANIAC_PALLAS", "1")
    assert not use_pair_kernel(jsys.spec)


def test_use_table_rejects_forced_framework_split(tmp_path):
    make_water_box(str(tmp_path), n_water=4, L=12.0, cutoff=5.0, tol=1e-3,
                   use_table="true", framework_split="on")
    with pytest.raises(ManiacError):
        parse_deck(f"{tmp_path}/input.maniac")


def _rows(path):
    with open(path) as f:
        return np.array([ln.split() for ln in f if not ln.startswith("#")],
                        dtype=float)


def test_cli_widom_with_tables_matches_jax(tmp_path):
    """use_table and --widom 16 on the command line, one --seed, f64 on the
    CPU: widom.dat and energy.dat within 1e-9 relative of the JAX CLI's."""
    d = make_water_box(str(tmp_path / "sys"), n_water=8, L=14.0, cutoff=5.0,
                       tol=1e-4, probs=(0.3, 0.2, 0.5, 0.0), fugacity=800.0,
                       nb_block=2, nb_step=20, use_table="true")
    argv = ["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data", "-p",
            f"{d}/parameters.inc", "--dtype", "f64", "--seed", "31",
            "--platform", "cpu", "--widom", "16"]
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli_main(argv + ["-o", out_j]) == 0
    assert cli_main(argv + ["-o", out_p]) == 0
    for name in ("widom.dat", "energy.dat"):
        want, got = _rows(f"{out_j}/{name}"), _rows(f"{out_p}/{name}")
        assert got.shape == want.shape and len(got) >= 2, name
        np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=1e-12,
                                   err_msg=name)
