"""The far table (maniac_tpu_torch/physics/fwsplit.py FarTable): the nonzero
far-field coefficients as the footprint kernels (csrc/common.cuh
far_sweep) contract them, y axis first.

physics/energy.py::far_table_energy transcribes the kernels' contraction
order over the table in plain torch; it is held here to JAX's
maniac_tpu/physics/energy.py::fw_far_energy on numpy-seeded positions and
weights, on the split framework fixture of tests/test_torch_energy.py, a
two-species framework (bench.py's mixed shape) and a slit pore, whose box
is not cubic and whose rows are ragged. The kernels themselves are held to
the plain path on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniac_tpu.physics import energy as jen
from maniac_tpu_torch.physics import energy as pen
from maniac_tpu_torch.physics.fwsplit import (FAR_FIRST, FAR_LANES,
                                              FAR_LAST, FAR_TCH, FAR_WARPS,
                                              build_far_table)
from maniac_tpu_torch.systems import (make_framework_mixed, make_slit_pore,
                                      make_water_box, make_zif_like)

from torch_parity import load_both

torch.set_num_threads(1)

# f32: each term is at most |c| |w|, and the contraction sums rows of up to
# ~50 products, closes them and adds ~1000 rows: the error stays within a
# few dozen f32 roundings (6e-8) of sum|c| sum|w| (measured: <= 9e-8 of it)
F32_RTOL_OF_SCALE = 1e-6


def _zif(d):
    # tests/test_torch_energy.py's split framework
    make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


def _fw_mixed(d):
    # a framework with the split and two active species (bench.py's mixed)
    make_framework_mixed(d, n_cells=3, a=5.66, n_water=3, n_dimer=3,
                         cutoff=5.0, tol=1e-4)


def _slit(d):
    # 12 x 12 x 30 A: kmax2 (13, 13, 31), rows of uneven lengths
    make_slit_pore(d)


SPLIT = {"zif_fwsplit": _zif, "fw_mixed": _fw_mixed, "slit": _slit}


def _footprint(spec, rng, n=6):
    """n positions uniform in the box and weights of either sign, one 0."""
    lo, L = spec.bounds[:, 0].numpy(), spec.box_diag.numpy()
    pos = lo + rng.random((n, 3)) * L
    w = rng.uniform(-1.2, 1.2, n)
    w[rng.integers(n)] = 0.0
    return pos, w


@pytest.fixture(params=list(SPLIT))
def split_system(request, tmp_path):
    SPLIT[request.param](str(tmp_path))
    sysm, spec, _ = load_both(str(tmp_path), capacity=16)
    _, spec32, _ = load_both(str(tmp_path), capacity=16, f32=True)
    assert spec.fw_split and spec.far_units.shape[0] > 0
    return sysm, spec, spec32


def test_far_table_energy_matches_jax(split_system):
    """The table's contraction against JAX's fw_far_energy: f64 within 1e-9
    relative; f32 within F32_RTOL_OF_SCALE of sum|c| sum|w|."""
    sysm, spec, spec32 = split_system
    rng = np.random.default_rng(5)
    scale_c = float(spec.far_coef.norm(dim=-1).sum())
    for _ in range(4):
        pos, w = _footprint(spec, rng)
        ref = float(jen.fw_far_energy(sysm.spec, jnp.asarray(pos),
                                      jnp.asarray(w)))
        e64 = float(pen.far_table_energy(spec, torch.from_numpy(pos),
                                         torch.from_numpy(w)))
        assert abs(e64 - ref) <= 1e-9 * abs(ref), (e64, ref)
        e32 = float(pen.far_table_energy(spec32,
                                         torch.from_numpy(pos).float(),
                                         torch.from_numpy(w).float()))
        bound = F32_RTOL_OF_SCALE * scale_c * np.abs(w).sum()
        assert abs(e32 - ref) <= bound, (e32, ref, bound)
        assert abs(ref) > 0.0


def _grid_from_table(spec):
    """{(jz, jx, jy): (re, im)} of every element the table's units cover,
    and the number of times each was covered."""
    coef = spec.far_coef.numpy()
    rows = spec.far_rows.numpy()
    seen, count = {}, {}
    for k, w in np.ndindex(spec.far_units.shape[:2]):
        base, t0, nt, _ = spec.far_units[k, w].tolist()
        for t in range(nt):
            for lane in range(FAR_LANES):
                jz, jx, yb, length = rows[base + lane]
                if t0 + t >= length:
                    assert not coef[k, w, t, lane].any()  # padding is zero
                    continue
                key = (int(jz), int(jx), int(yb) - spec.kmax2_xyz[1] + t0 + t)
                seen[key] = tuple(coef[k, w, t, lane])
                count[key] = count.get(key, 0) + 1
    return seen, count


def test_far_table_keeps_every_coefficient_once(split_system):
    """Every nonzero coefficient of the grid is in the table once, with its
    value; the table holds nothing else but exact zeros inside rows; each
    warp's units sweep each of its rows from first to last."""
    _, spec, _ = split_system
    seen, count = _grid_from_table(spec)
    assert set(count.values()) == {1}
    c2_re, c2_im = spec.c2_re.numpy(), spec.c2_im.numpy()
    jx_col, jy_col = spec.k2_col_jx.numpy(), spec.k2_col_jy.numpy()
    kz2 = spec.kmax2_xyz[2]
    nonzero = 0
    for zr, col in zip(*np.nonzero((c2_re != 0) | (c2_im != 0))):
        key = (int(zr) - kz2, int(jx_col[col]), int(jy_col[col]))
        assert seen.pop(key) == (c2_re[zr, col], c2_im[zr, col]), key
        nonzero += 1
    assert nonzero > 0
    assert all(v == (0.0, 0.0) for v in seen.values())   # gaps inside rows
    units = spec.far_units.numpy()
    for w in range(FAR_WARPS):
        open_base = None
        for base, t0, nt, flags in units[:, w]:
            if nt == 0:
                assert flags == 0
                continue
            assert 0 < nt <= FAR_TCH
            assert bool(flags & FAR_FIRST) == (t0 == 0)
            assert t0 == 0 or base == open_base
            open_base = None if flags & FAR_LAST else base
        assert open_base is None
    # the warps' unit counts differ by little (the longest-first deal)
    live = (units[..., 2] > 0).sum(axis=0)
    assert live.max() - live.min() <= -(-int(spec.far_rows[0, 3]) // FAR_TCH)


def test_far_table_empty_without_split(tmp_path):
    """A water box (no framework, so no split) has an empty table, and its
    far-field energy is 0."""
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4)
    _, spec, _ = load_both(str(tmp_path), capacity=16)
    assert not spec.fw_split
    assert spec.far_units.shape[0] == 0 and spec.far_coef.numel() == 0
    assert spec.far_rows.shape[0] == 0
    pos, w = _footprint(spec, np.random.default_rng(3))
    assert float(pen.far_table_energy(spec, torch.from_numpy(pos),
                                      torch.from_numpy(w))) == 0.0


def test_far_table_rows_and_deal():
    """build_far_table on a small hand-made grid: rows of constant (jz, jx)
    from the first to the last nonzero jy (an exact zero inside stays),
    longest first, cut into units of FAR_TCH and dealt to the warps."""
    ky2, kz2 = 3, 1
    col_jx = np.repeat(np.arange(2), 2 * ky2 + 1)
    col_jy = np.tile(np.arange(-ky2, ky2 + 1), 2)
    c2_re = np.zeros((2 * kz2 + 1, col_jx.size))
    c2_im = np.zeros_like(c2_re)
    c2_re[0, 1:6] = [1.0, 2.0, 0.0, 4.0, 5.0]    # jz -1, jx 0, jy -2..2
    c2_im[2, 7 + 3] = 7.0                        # jz 1, jx 1, jy 0
    t = build_far_table(c2_re, c2_im, col_jx, col_jy, ky2, kz2)
    assert t.rows.shape == (FAR_LANES, 4)
    np.testing.assert_array_equal(t.rows[0], [-1, 0, -2 + ky2, 5])
    np.testing.assert_array_equal(t.rows[1], [1, 1, 0 + ky2, 1])
    assert not t.rows[2:].any()
    # one group of 5 elements: units of 4 and 1 on one warp
    assert t.units.shape == (2, FAR_WARPS, 4)
    w = int(np.nonzero(t.units[0, :, 2])[0][0])
    np.testing.assert_array_equal(t.units[0, w], [0, 0, 4, FAR_FIRST])
    np.testing.assert_array_equal(t.units[1, w], [0, 4, 1, FAR_LAST])
    np.testing.assert_array_equal(t.coef[0, w, :, 0, 0], [1, 2, 0, 4])
    assert t.coef[1, w, 0, 0, 0] == 5.0 and t.coef[0, w, 2, 1, 1] == 0.0
    assert t.coef[0, w, 0, 1, 1] == 7.0
    assert t.units[:, [v for v in range(FAR_WARPS) if v != w], 2].sum() == 0
