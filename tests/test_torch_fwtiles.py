"""The frozen tiles (maniac_tpu_torch/physics/fwsplit.py FrozenTiles), which
the footprint kernels sweep in place of the frozen prefix, and the cull that
picks the tiles within a move's reach (tiles_in_reach, the float32 copy of
csrc/common.cuh tile_in_reach; side_reach, of csrc/common.cuh
footprint_reach).

On the CPU: the tiles of the benchmark's graphite slit, of the flagship's
ZIF-like framework and of a 27-site framework hold every live frozen site
once with the prefix's own entries, inside boxes under half the box; over
random footprints, footprints across each periodic face, a site at the
cutoff less 1e-4 A through the boundary and a charged framework whose
rcut2 passes the cutoff, no site whose pair with a footprint atom adds a
term (the pair pass's float32 test) lies in a tile the cull drops.

The file imports no jax:

    python -m pytest tests/test_torch_fwtiles.py --noconftest -q
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from maniac_tpu_torch import load_system
from maniac_tpu_torch.physics.fwsplit import (FW_CULL_EPS, FW_TILE,
                                              build_frozen_tiles, side_reach,
                                              tiles_in_reach)
from maniac_tpu_torch.systems import (make_framework_water, make_water_box,
                                      make_zif_like)
from maniac_tpu_torch.utils.logger import NullLogger

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32 = np.float32


def _slit(d):
    from portbench import run
    cfg = run.read_json(run.PKG / "configs" / "flue_slit.json")
    files, _ = run.write_files(cfg, 2 ** 33 + 29, str(d))
    return (files["input"], files["data"], files["params"]), cfg["capacity"]


def _deck(make, **kw):
    def write(d):
        make(str(d), **kw)
        return (f"{d}/input.maniac", f"{d}/topology.data",
                f"{d}/parameters.inc"), 16
    return write


# the benchmark's slab (1,792 C), bench.py's flagship (about 2,160 sites in
# a 34 A box), a sparse framework (27 sites 8 A apart in a 24 A box) and a
# water box without a frozen type
SYSTEMS = {
    "flue_slit": _slit,
    "zif": _deck(make_zif_like, n_cells=6, a=5.66, n_water=32,
                 fugacity=30.0),
    "fw_water": _deck(make_framework_water),
    "water": _deck(make_water_box, n_water=8, L=14.0, cutoff=5.0, tol=1e-4),
}


def _load(name, d):
    files, capacity = SYSTEMS[name](d)
    return load_system(*files, capacity=capacity, dtype=torch.float64,
                       device="cpu", logger=NullLogger(),
                       compute_initial_energy=False)


def _live_frozen(spec, state):
    """The live frozen sites, read off the site tables."""
    s = np.arange(spec.S_frozen)
    n_mol = state.n_mol[0].numpy()
    live = spec.site_midx.numpy()[s] < n_mol[spec.site_type.numpy()[s]]
    return s[live]


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_tiles_hold_the_live_frozen_prefix(tmp_path, name):
    """Every live frozen site lies in exactly one tile; each slot holds its
    site's position, charge and LJ entries against every class as the
    prefix does (a pad slot: no site, no charge, eps and sigma^2 0); a
    tile's box holds its sites, spans under half the box on each axis and
    carries the charge flag of its sites; on the dense frameworks every tile
    but the last is full (the 27 sites 8 A apart are cut further, to stay
    under half the box). Without a frozen type there is no tile."""
    sysm = _load(name, tmp_path)
    spec, state = sysm.spec, sysm.state
    site = spec.fw_tile_site.numpy()
    pq, box = spec.fw_tile_pq.numpy(), spec.fw_tile_box.numpy()
    if not spec.fw_split:
        assert name == "water" and site.size == 0 and box.shape[0] == 0
        assert spec.fw_tile_eps.shape == (spec.eps_site.shape[0], 0)
        return
    n_tiles = box.shape[0]
    assert site.size == pq.shape[0] == n_tiles * FW_TILE > 0
    live = _live_frozen(spec, state)
    assert np.array_equal(np.sort(site[site >= 0]), live)
    full = (site.reshape(n_tiles, FW_TILE) >= 0).all(1)
    assert full[:-1].all() or name == "fw_water"
    pos = state.pos[0].numpy().T
    real, pad = site >= 0, site < 0
    np.testing.assert_array_equal(pq[real, :3], pos[site[real]])
    np.testing.assert_array_equal(pq[real, 3],
                                  spec.site_q.numpy()[site[real]])
    for tab, ref in ((spec.fw_tile_eps, spec.eps_site),
                     (spec.fw_tile_sig2, spec.sig2_site)):
        np.testing.assert_array_equal(tab.numpy()[:, real],
                                      ref.numpy()[:, site[real]])
        assert (tab.numpy()[:, pad] == 0).all()
    assert (pq[pad, 3] == 0).all()
    slots = pq[:, :3].reshape(n_tiles, FW_TILE, 3)
    centre, half = box[:, 0, None, :3], box[:, 1, None, :3]
    assert (np.abs(slots - centre) <= half * (1 + 1e-12) + 1e-12).all()
    L = spec.box_diag.numpy()
    assert (box[:, 1, :3] < L / 2).all()
    q = pq[:, 3].reshape(n_tiles, FW_TILE)
    np.testing.assert_array_equal(box[:, 0, 3], (q != 0).any(1))
    assert (box[:, 1, 3] == 0).all()


def _min_image_r2(sites, atom, L):
    """float32 squared distances of ``sites`` (n, 3) to ``atom`` (3,) under
    the minimum image, as the pair pass forms them."""
    d = sites.astype(F32) - atom.astype(F32)
    d = d - L * np.rint(d / L)
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def _assert_nothing_within_reach_dropped(tiles, L, sides, cutoff, rcut2):
    """No site whose pair with an atom of ``sides`` adds a term (LJ within
    the cutoff where eps is not 0, Coulomb within rcut2 where both carry
    charge: the pair pass's float32 test) lies in a tile that
    tiles_in_reach drops. sides: (COM (3,), atoms (A, 3), charges (A,)).
    Returns the kept share."""
    L = np.asarray(L, dtype=F32)
    box = np.asarray(tiles.box)
    reach = [(c, *side_reach(p, q, c, cutoff, rcut2)) for c, p, q in sides]
    keep = tiles_in_reach(box, reach, L)
    real = tiles.site >= 0
    pos, qs = tiles.pq[real, :3], tiles.pq[real, 3]
    lj_on = (tiles.eps[:, real] != 0).any(0)
    tile_of = np.nonzero(real)[0] // (tiles.site.size // box.shape[0])
    cut_sq, rc2_sq = F32(cutoff) * F32(cutoff), F32(rcut2) * F32(rcut2)
    for _, p, q in sides:
        for atom, qa in zip(np.asarray(p), np.asarray(q)):
            r2 = _min_image_r2(pos, atom, L)
            adds = (lj_on & (r2 < cut_sq)) | ((qa * qs != 0) & (r2 < rc2_sq))
            assert keep[tile_of[adds]].all(), np.nonzero(
                adds & ~keep[tile_of])[0]
    return float(keep.mean())


def _molecule(rng, com, n_atoms=3, radius=1.2):
    """Atoms of a rigid molecule about ``com``: random directions at up to
    ``radius``, and their charges (the first neutral, as a TraPPE site)."""
    v = rng.normal(size=(n_atoms, 3))
    v *= rng.uniform(0.3, radius, size=(n_atoms, 1)) / np.linalg.norm(
        v, axis=1, keepdims=True)
    return com + v, np.r_[0.0, rng.uniform(-0.7, 0.7, n_atoms - 1)]


def _lattice(rng, L, n, q=None):
    """n random frozen sites in the box [0, L), their charges (0 unless
    ``q``) and LJ rows (one class, eps 1)."""
    pos = rng.uniform(0.0, 1.0, size=(n, 3)) * L
    site_q = np.zeros(n) if q is None else rng.uniform(-q, q, n)
    return pos, site_q, np.ones((2, n)), np.ones((2, n))


def _synthetic(rng, L, n, cutoff, q=None):
    pos, site_q, eps, sig2 = _lattice(rng, L, n, q)
    return build_frozen_tiles(pos, np.arange(n), site_q, eps, sig2, L)


@pytest.mark.parametrize("case", ["random_slit", "random_zif", "faces",
                                  "cutoff_edge", "charged_rcut2"])
def test_cull_never_drops_a_site_within_reach(tmp_path, case):
    """The cull against the pair pass's own float32 test, over: 200 random
    footprints (old and new sides a translation apart) on the graphite slit
    and on the flagship's framework; footprints astride each periodic face
    of a random framework; a site at the cutoff less 1e-4 A from an atom
    through the boundary; and a charged framework whose rcut2 passes the
    cutoff, with a site at rcut2 less 1e-4 A from a charged atom. The cull
    drops some tiles in every case but the last two, which keep what they
    must."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("random"):
        sysm = _load("flue_slit" if case == "random_slit" else "zif",
                     tmp_path)
        spec = sysm.spec
        tiles = build_frozen_tiles(
            sysm.state.pos[0].numpy().T, _live_frozen(spec, sysm.state),
            spec.site_q.numpy(), spec.eps_site.numpy(),
            spec.sig2_site.numpy(), spec.box_diag.numpy())
        L, lo = spec.box_diag.numpy(), spec.bounds[:, 0].numpy()
        cutoff, rcut2 = float(spec.cutoff), float(spec.rcut2)
        shares = []
        for _ in range(200):
            com = lo + rng.uniform(size=3) * L
            p, q = _molecule(rng, com)
            step = rng.uniform(-1.0, 1.0, size=3)
            shares.append(_assert_nothing_within_reach_dropped(
                tiles, L, [(com, p, q), (com + step, p + step, q)], cutoff,
                rcut2))
        assert 0.0 < np.mean(shares) < 0.8
        return
    L = np.array([30.0, 26.0, 22.0])
    if case == "faces":
        cutoff = 6.0
        tiles = _synthetic(rng, L, 1500, cutoff)
        shares = []
        for ax in range(3):
            for edge in (0.0, L[ax]):
                for _ in range(10):
                    com = rng.uniform(size=3) * L
                    com[ax] = edge + rng.uniform(-0.5, 0.5)
                    p, q = _molecule(rng, com)
                    shares.append(_assert_nothing_within_reach_dropped(
                        tiles, L, [(com, p, q)], cutoff, cutoff))
        assert 0.0 < np.mean(shares) < 0.8
        return
    cutoff = 6.0
    rcut2 = 9.0 if case == "charged_rcut2" else cutoff
    pos, site_q, eps, sig2 = _lattice(rng, L, 800,
                                      0.5 if case == "charged_rcut2" else None)
    com = np.array([0.4, 13.0, 11.0])
    p, q = _molecule(rng, com)
    q[1] = 0.4                     # a charged atom for the Coulomb reach
    # one site at rcut2 - 1e-4 A from atom 1 along -x, through the x = 0 face
    reach = rcut2 - 1e-4
    far = p[1] - np.array([reach, 0.0, 0.0])
    pos[0] = far + np.array([L[0], 0.0, 0.0])
    site_q[0] = 0.3
    if case == "charged_rcut2":
        eps[:, 0] = sig2[:, 0] = 0.0    # a Coulomb term only
    assert 0.0 <= pos[0, 0] < L[0]
    r2 = _min_image_r2(pos[:1], p[1], L.astype(F32))[0]
    assert r2 < F32(rcut2) * F32(rcut2)
    tiles = build_frozen_tiles(pos, np.arange(pos.shape[0]), site_q, eps,
                               sig2, L)
    _assert_nothing_within_reach_dropped(tiles, L, [(com, p, q)], cutoff,
                                         rcut2)
    keep = tiles_in_reach(tiles.box, [(com, *side_reach(p, q, com, cutoff,
                                                        rcut2))], L)
    assert keep[list(tiles.site).index(0) // FW_TILE]


def test_kernel_margin_matches_fwsplit():
    """csrc/common.cuh's FW_CULL_EPS is physics/fwsplit.py's, and its pass
    holds at least one tile a thread."""
    text = (ROOT / "maniac_tpu_torch" / "kernels" / "csrc" /
            "common.cuh").read_text()
    eps = re.search(r"constexpr float FW_CULL_EPS = ([0-9.e+-]+)f;", text)
    assert float(eps.group(1)) == FW_CULL_EPS
    assert re.search(r"constexpr int FW_PASS = STEP_THREADS;", text)
    assert FW_TILE & (FW_TILE - 1) == 0 and FW_TILE <= 32
