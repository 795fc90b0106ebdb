"""maniac_tpu_torch energy engine against the JAX package, in float64.

Inputs are the JAX-loaded systems carried over with from_numpy, plus
footprints drawn from a numpy seed, so both packages see identical
numbers; the tolerances bound float64 summation-order differences."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.constants import COULOMB_K
from maniac_tpu.physics import energy as jen
from maniac_tpu_torch.physics import energy as pen
from maniac_tpu_torch.systems import make_nacl, make_water_box, make_zif_like

from torch_parity import load_both

torch.set_num_threads(1)

MADELUNG = 1.747564594633


def _water(d):
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0)


def _nacl(d):
    make_nacl(d, n_cells=2, a=5.6402, cutoff=5.6, tol=1e-7)


def _zif(d):
    make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


@pytest.mark.parametrize("make", [_water, _nacl, _zif],
                         ids=["water", "nacl", "zif_fwsplit"])
def test_system_energy_matches_jax(tmp_path, make):
    make(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16)
    e_j, re_j, im_j = jen.system_energy(sysm.spec, sysm.state)
    e_p, re_p, im_p = pen.system_energy(spec, state)
    np.testing.assert_allclose(e_p[0].numpy(), np.asarray(e_j), rtol=1e-11,
                               atol=1e-9)
    np.testing.assert_allclose(re_p[0].numpy(), np.asarray(re_j), atol=1e-10)
    np.testing.assert_allclose(im_p[0].numpy(), np.asarray(im_j), atol=1e-10)
    if make is _zif:
        assert spec.fw_split
    if make is _nacl:
        # absolute anchor: the Madelung constant through the whole Ewald
        # pipeline (tests/test_energy.py)
        e = e_p[0].numpy()
        a = 5.6402
        expected = -4 * 2 ** 3 * MADELUNG * COULOMB_K / (a / 2)
        assert abs(e[1]) < 1e-10
        np.testing.assert_allclose(e[0] + e[2] + e[3], expected, rtol=2e-6)


def _footprints(spec, n_fp, seed):
    """Random footprints of the active type inside the box: positions
    (n_fp, A, 3), charges, classes and masks."""
    rng = np.random.default_rng(seed)
    t = int(spec.active_type_ids[0])
    A = spec.A_act
    lo = spec.bounds[:, 0].numpy()
    L = spec.box_diag.numpy()
    com = lo + rng.random((n_fp, 1, 3)) * L
    pos = com + spec.type_template_off[t].numpy()[None] @ _rot(rng).T
    q = np.broadcast_to(spec.type_q_rows[t].numpy(), (n_fp, A)).copy()
    cls = np.broadcast_to(spec.type_cls_rows[t].numpy(), (n_fp, A)).copy()
    mask = np.ones((n_fp, A), bool)
    return pos, q, cls, mask


def _rot(rng):
    qv = rng.normal(size=4)
    w, x, y, z = qv / np.linalg.norm(qv)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)]])


def test_axis_phase_tables_match_jax():
    """Per-axis power tables (signed y/z ranges) against the JAX helper."""
    rng = np.random.default_rng(7)
    theta = rng.uniform(-np.pi, np.pi, size=(5, 3))
    kmax = (4, 6, 3)
    ref = jen._axis_phase_tables(None, jnp.asarray(theta), kmax)
    got = pen._axis_phase_tables(torch.from_numpy(theta), kmax)
    for (r_re, r_im), (g_re, g_im) in zip(ref, got):
        np.testing.assert_allclose(g_re.numpy(), np.asarray(r_re), atol=1e-13)
        np.testing.assert_allclose(g_im.numpy(), np.asarray(r_im), atol=1e-13)


def test_amp_delta_matches_direct(tmp_path):
    """The separable indexed synthesis against the direct cos/sin over the
    (A, K) phase matrix, on the main grid of the framework fixture."""
    _zif(str(tmp_path))
    _, spec, _ = load_both(str(tmp_path), capacity=16)
    pos, q, _, mask = _footprints(spec, 6, seed=3)
    P = torch.from_numpy(pos).reshape(3, 2, spec.A_act, 3)
    Q = torch.from_numpy(q).reshape(3, 2, spec.A_act)
    M = torch.from_numpy(mask).reshape(3, 2, spec.A_act)
    signs = torch.tensor([[-1.0, 1.0], [1.0, 0.0], [0.0, -1.0]],
                         dtype=torch.float64)
    d_re, d_im = pen.amp_delta(spec, P, Q, M, signs)
    r_re, r_im = pen.amp_delta_direct(spec, P, Q, M, signs)
    np.testing.assert_allclose(d_re.numpy(), r_re.numpy(), atol=1e-10)
    np.testing.assert_allclose(d_im.numpy(), r_im.numpy(), atol=1e-10)
    assert float(torch.abs(d_re).max()) > 0.1  # a nontrivial delta


def test_footprint_energies_match_jax(tmp_path):
    """pair_energy_footprint (LJ, guest cutoff, framework split) and the
    far-field term fw_far_energy against JAX, to 1e-9 relative."""
    _zif(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=16)
    pos, q, cls, mask = _footprints(spec, 2, seed=11)
    mask[1, -1] = False
    ex_a, ex_b = 3, spec.Mtot + 1

    jst = sysm.state
    e_lj_j, e_c_j = jen.pair_energy_footprint(
        sysm.spec, jen.site_positions(sysm.spec, jst),
        jen.active_site_mask(sysm.spec, jst.n_mol), jnp.asarray(pos),
        jnp.asarray(q), jnp.asarray(cls), jnp.asarray(mask), ex_a, ex_b)
    e_lj_p, e_c_p = pen.pair_energy_footprint(
        spec, pen.site_positions(spec, state),
        pen.active_site_mask(spec, state.n_mol),
        torch.from_numpy(pos)[None], torch.from_numpy(q)[None],
        torch.from_numpy(cls)[None], torch.from_numpy(mask)[None],
        torch.tensor([ex_a]), torch.tensor([ex_b]))
    np.testing.assert_allclose(e_lj_p[0].numpy(), np.asarray(e_lj_j),
                               rtol=1e-9)
    np.testing.assert_allclose(e_c_p[0].numpy(), np.asarray(e_c_j),
                               rtol=1e-9)

    w = q * mask
    for i in range(2):
        f_j = float(jen.fw_far_energy(sysm.spec, jnp.asarray(pos[i]),
                                      jnp.asarray(w[i])))
        f_p = float(pen.fw_far_energy(spec, torch.from_numpy(pos[i]),
                                      torch.from_numpy(w[i])))
        assert math.isclose(f_p, f_j, rel_tol=1e-9), (f_p, f_j)
        assert abs(f_j) > 0.0
