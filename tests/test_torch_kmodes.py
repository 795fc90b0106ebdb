"""The k-space mode lists the footprint kernels walk (system._mode_lists),
on the CPU: the weighted list is exactly the modes of nonzero weight,
ascending, with their weights; the real list is exactly the modes the
padded grid's walk committed (row < 2 kz + 1 and a live column); each row's
(jx, jy, jz) is the column tables' and the row's. On the benchmark's two
configurations, a triclinic box and a framework with a far table."""

import numpy as np
import pytest
import torch

from maniac_tpu_torch import load_system
from maniac_tpu_torch.system import to_device
from maniac_tpu_torch.systems import make_zif_like, tiny_system
from maniac_tpu_torch.utils.logger import NullLogger

torch.set_num_threads(1)


def _files(d):
    return f"{d}/input.maniac", f"{d}/topology.data", f"{d}/parameters.inc"


def _config(name, d):
    from portbench import run
    cfg = run.read_json(run.PKG / "configs" / f"{name}.json")
    files, _ = run.write_files(cfg, 2 ** 33 + 7, str(d))
    return load_system(files["input"], files["data"], files["params"],
                       capacity=cfg["capacity"], device="cpu",
                       logger=NullLogger(), seed=2 ** 33 + 7,
                       compute_initial_energy=False).spec


def _tricl(d):
    tiny_system(str(d), "tricl")
    return load_system(*_files(d), capacity=16, device="cpu",
                       logger=NullLogger(),
                       compute_initial_energy=False).spec


def _zif(d):
    # the flagship's framework (bench.py's zif) and its far
    # table, at the flagship's size
    make_zif_like(str(d), n_cells=6, a=5.66, n_water=32, fugacity=30.0)
    return load_system(*_files(d), capacity=192, device="cpu",
                       logger=NullLogger(),
                       compute_initial_energy=False).spec


SYSTEMS = {"spce750": lambda d: _config("spce750", d),
           "flue_slit": lambda d: _config("flue_slit", d),
           "tricl": _tricl, "zif": _zif}


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def spec(request, tmp_path_factory):
    return SYSTEMS[request.param](tmp_path_factory.mktemp(request.param))


def _padded_walk(spec):
    """The modes the padded grid's loops took, one m at a time as the
    kernels walked them: (the k-space delta's, those of nonzero weight;
    the commit's, row < Jz and a live column)."""
    kw = spec.k_weights.numpy().ravel()
    col_jx = spec.k_col_jx.numpy()
    JxyP, Jz = spec.amp_shape[1], 2 * spec.kmax_xyz[2] + 1
    delta, commit = [], []
    for m in range(kw.shape[0]):
        row, col = divmod(m, JxyP)
        if kw[m] != 0.0:
            delta.append(m)
        if row < Jz and col_jx[col] >= 0:
            commit.append(m)
    return delta, commit


def test_weighted_list_is_every_mode_of_nonzero_weight(spec):
    """Exactly flatnonzero(k_weights), ascending, each mode once, with its
    weight bit for bit; the padded walk's delta took the same modes."""
    modes = spec.k_weighted_modes.numpy()
    kw = spec.k_weights.numpy().ravel()
    assert modes.dtype == np.int32 and modes.shape[1] == 4
    np.testing.assert_array_equal(modes[:, 0], np.flatnonzero(kw))
    assert (np.diff(modes[:, 0]) > 0).all()
    np.testing.assert_array_equal(spec.k_weighted_w.numpy(),
                                  kw[modes[:, 0]])
    assert list(modes[:, 0]) == _padded_walk(spec)[0]


def test_real_list_is_the_set_the_commit_took(spec):
    """Exactly the modes the padded grid's commit updated (row < 2 kz + 1
    and col_jx >= 0), ascending, each once; every weighted mode is one."""
    real = spec.k_real_modes.numpy()
    assert real.dtype == np.int32 and real.shape[1] == 4
    assert list(real[:, 0]) == _padded_walk(spec)[1]
    assert (np.diff(real[:, 0]) > 0).all()
    assert set(spec.k_weighted_modes[:, 0].tolist()) <= set(real[:, 0])
    Jz, (JzP, JxyP) = 2 * spec.kmax_xyz[2] + 1, spec.amp_shape
    assert real.shape[0] == Jz * int((spec.k_col_jx >= 0).sum())
    assert real.shape[0] < JzP * JxyP


@pytest.mark.parametrize("name", ["k_weighted_modes", "k_real_modes"])
def test_mode_indices_are_the_column_tables(spec, name):
    """Each row's (jx, jy, jz) is k_col_jx, k_col_jy of its column and its
    row less kz, and lies within the kernels' phase tables (|j| <= kmax)."""
    modes = getattr(spec, name).numpy()
    row, col = np.divmod(modes[:, 0], spec.amp_shape[1])
    np.testing.assert_array_equal(modes[:, 1], spec.k_col_jx.numpy()[col])
    np.testing.assert_array_equal(modes[:, 2], spec.k_col_jy.numpy()[col])
    np.testing.assert_array_equal(modes[:, 3], row - spec.kmax_xyz[2])
    for axis in range(3):
        k = spec.kmax_xyz[axis]
        assert np.abs(modes[:, 1 + axis]).max() <= k
    assert modes[:, 1].min() >= 0


def test_weights_cast_with_the_grid(spec):
    """Moved to float32 as the card's spec is, the list's weights are
    k_weights' float32 values bit for bit, and the int lists stay int32."""
    s32 = to_device(spec, "cpu", torch.float32)
    m = s32.k_weighted_modes[:, 0].long()
    assert s32.k_weighted_w.dtype == torch.float32
    assert torch.equal(s32.k_weighted_w, s32.k_weights.flatten()[m])
    assert s32.k_real_modes.dtype == torch.int32


def test_benchmark_grids_have_the_counted_modes(tmp_path):
    """The benchmark's grids: spce750's (24, 256) has 1,152 weighted and
    2,601 real modes, flue_slit's (16, 256) 1,073 and 2,470."""
    for name, shape, n_w, n_r in (("spce750", (24, 256), 1152, 2601),
                                  ("flue_slit", (16, 256), 1073, 2470)):
        s = SYSTEMS[name](tmp_path / name)
        assert tuple(s.amp_shape) == shape
        assert s.k_weighted_modes.shape[0] == n_w
        assert s.k_real_modes.shape[0] == n_r


def test_a_weight_in_the_padding_is_refused(spec):
    """A grid whose weights reach a pad mode (the first in the padding) is
    refused at load, not walked."""
    from maniac_tpu_torch.system import _mode_lists
    kw = spec.k_weights.numpy().copy()
    pad = np.setdiff1d(np.arange(kw.size), spec.k_real_modes[:, 0].numpy())
    kw.ravel()[pad[0]] = 1.0
    with pytest.raises(ValueError, match="padding"):
        _mode_lists(kw, spec.k_col_jx, spec.k_col_jy, spec.kmax_xyz[2])
