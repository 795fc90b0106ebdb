"""The benchmark's flue_slit configuration (portbench/configs/flue_slit.json):
TraPPE CO2 and N2 in a graphite slit pore, the carbon frozen.

On the CPU: the writer's slab (portbench/writers/graphite_slit.py) against
graphite's published geometry; the port's float64 energies of the written
full-width configuration against portbench/oracle.py; a small-width
variant through the harness's run.run, judged correct; and the swap and
insertion bookkeeping against a float64 recompute. On the card (``gpu``):
the block kernel against the plain block on the full configuration, the
block and step kernels against the plain steps where a 6.5 A cutoff leaves
most frozen tiles out of a move's reach, and the instrumented build's
share of the tiles kept.

The file imports no jax, so its card test runs without the suite's
conftest:

    python -m pytest tests/test_torch_flue_slit.py --noconftest -q
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from maniac_tpu_torch import load_system, replicate
from maniac_tpu_torch.constants import TYPE_CREATION, TYPE_SWAP
from maniac_tpu_torch.kernels.blockg import run_block_kernel
from maniac_tpu_torch.kernels.resync import resync_plain
from maniac_tpu_torch.kernels.stepg import run_steps_kernel
from maniac_tpu_torch.mc.driver import draw_uniforms, drift_report, steps_plain
from maniac_tpu_torch.parallel.replicas import run_block_uniforms
from maniac_tpu_torch.physics.energy import (full_intra_energy,
                                             site_positions, system_energy)
from maniac_tpu_torch.system import (E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF,
                                     E_TOT)
from maniac_tpu_torch.utils.logger import NullLogger
from portbench import compare, run
from portbench.oracle import Oracle
from portbench.writers import graphite_slit, residues

from frozen_tiles import kept_share

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "flue_slit.json")
                    .read_text())
SEED = 2 ** 33 + 29     # more than 32 bits, as the benchmark's seeds are


def small_config() -> dict:
    """The configuration at a small width of slab (4 x 3 cells, 192 C)
    with a 4.5 A cutoff, so that it fits the CPU, at fugacities that keep
    a few guests of each species in the pore; the split stays on."""
    cfg = copy.deepcopy(CONFIG)
    cfg["slab"]["cells"] = [4, 3]
    cfg["writer_args"]["cutoff_A"] = 4.5
    for res in cfg["residues"]:
        res["fugacity_atm"], res["molecules"] = 20.0, 3
    cfg["capacity"] = 16
    return cfg


def _load(cfg, outdir, dtype, device="cpu", energy=True, layers=False):
    """The configuration written and loaded; with ``layers`` the slab is
    written as one frozen molecule a graphene layer."""
    if layers:
        (slab,) = graphite_slit.slab_residues(cfg["slab"])
        geo = np.asarray(slab["geometry_A"])
        n = len(geo) // int(cfg["slab"]["layers"])
        order = np.argsort(geo[:, 2], kind="stable")
        frozen = [{**slab, "name": f"gra{k}", "sites": slab["sites"][:n],
                   "q_e": slab["q_e"][:n], "eps_K": slab["eps_K"][:n],
                   "sigma_A": slab["sigma_A"][:n], "mass": slab["mass"][:n],
                   "geometry_A": geo[order[k * n:(k + 1) * n]].tolist()}
                  for k in range(int(cfg["slab"]["layers"]))]
        cfg = {**cfg, "writer": "residues",
               "residues": frozen + cfg["residues"],
               "writer_args": {**cfg["writer_args"], "box_A": list(
                   graphite_slit.box(cfg["slab"]))}}
    files, arrays = run.write_files(cfg, SEED, str(outdir))
    sysm = load_system(files["input"], files["data"], files["params"],
                       capacity=cfg["capacity"], dtype=dtype, device=device,
                       logger=NullLogger(), seed=SEED,
                       compute_initial_energy=energy)
    return sysm, arrays


def test_slab_is_graphite():
    """448 C a layer, each with three in-plane neighbours at 1.42 A and no
    nearer site (to 2e-6 A: the box's six decimals leave a seam at the x
    boundary); four planes 3.35 A apart with the 10.4 A pore between the
    outer two across the boundary; AB registry (half of a layer's atoms
    over the next layer's, half over its hexagons' centres); no charge;
    the whole slab one frozen molecule."""
    slab = CONFIG["slab"]
    pos = graphite_slit.slab_sites(slab)
    L = np.asarray(graphite_slit.box(slab))
    # twice the half edges of the data file's six decimals
    np.testing.assert_allclose(L, [14 * math.sqrt(3) * 1.42, 8 * 3 * 1.42,
                                   3 * 3.35 + 10.4], rtol=0, atol=1e-6)
    assert pos.shape == (1792, 3)
    assert (pos >= -L / 2).all() and (pos < L / 2).all()
    planes = np.unique(np.round(pos[:, 2], 9))
    np.testing.assert_allclose(planes, [-8.55, -5.2, 5.2, 8.55], atol=1e-9)
    gaps = np.diff(np.concatenate([planes, [planes[0] + L[2]]]))
    np.testing.assert_allclose(sorted(gaps), [3.35, 3.35, 3.35, 10.4],
                               atol=1e-9)
    layers = [pos[np.abs(pos[:, 2] - z) < 1e-6][:, :2] for z in planes]
    assert [len(x) for x in layers] == [448] * 4

    def in_plane(a, b):
        d = a[:, None] - b[None]
        d -= L[:2] * np.round(d / L[:2])
        return np.sqrt((d * d).sum(-1))
    for xy in layers:
        r = in_plane(xy, xy)
        np.fill_diagonal(r, np.inf)
        assert r.min() == pytest.approx(1.42, abs=2e-6)
        assert ((np.abs(r - 1.42) < 2e-6).sum(1) == 3).all()
    for a, b in zip(layers, layers[1:]):
        r = in_plane(a, b).min(1)
        over_atom = r < 2e-6
        over_centre = np.abs(r - 1.42) < 2e-6
        assert over_atom.sum() == over_centre.sum() == 224
    (res,) = graphite_slit.slab_residues(slab)
    assert res["frozen"] and len(res["sites"]) == 1792
    assert sum(res["q_e"]) == 0.0
    np.testing.assert_array_equal(res["geometry_A"], pos)


def test_full_width_energies_match_the_oracle(tmp_path):
    """The port's float64 loaded energy of the written configuration at its
    full width against the oracle's independent sums: each of the six
    components within 1e-9, relative as the comparison takes it
    (compare.energy_gaps: against the larger of the component and the
    median of the six magnitudes, the frozen slab's own energy taken out);
    the split is on over one frozen molecule of 1,792 sites, with no far
    table and two active species."""
    sysm, arrays = _load(CONFIG, tmp_path, torch.float64)
    spec = sysm.spec
    assert spec.fw_split and spec.n_active == 2 and spec.R == 3
    assert list(spec.active_list) == [False, True, True]
    assert int(sysm.state.n_mol[0, 0]) * spec.A_list[0] == 1792
    assert spec.S_frozen == 1792
    assert spec.far_units.shape[0] == 0
    # the positions as loaded (the data file's ten decimals), so that
    # both sides sum one configuration
    st, loaded = sysm.state, []
    for r, t in enumerate(arrays["residues"]):
        base, A, n = (spec.site_base_list[r], spec.A_list[r],
                      int(st.n_mol[0, r]))
        loaded.append(dict(t, pos=st.pos[0, :, base:base + n * A].T
                           .reshape(n, A, 3)))
    args = CONFIG["writer_args"]
    oracle = Oracle(loaded, arrays["box"], args["cutoff_A"],
                    args["ewald_tolerance"], "cpu")
    want = oracle.energies([t["pos"] for t in loaded if not t["frozen"]])
    gaps = compare.energy_gaps(sysm.state.energy, want[None],
                               oracle.frozen_energy)
    assert float(gaps.max()) <= 1e-9, gaps


# the harness refuses to run where JAX is loaded, as it is in the suite's
# process: the rehearsal runs in a process of its own
REHEARSAL = """
import json, shutil, sys
from pathlib import Path
from types import SimpleNamespace
from portbench import run
root, cfg = Path(sys.argv[1]), json.loads(sys.argv[2])
shutil.copytree(run.PKG, root / "portbench",
                ignore=shutil.ignore_patterns("__pycache__"))
bench = run.read_json(run.ROOT / "BENCHMARK.json")
bench["configs"].append({"name": "flue_small", "source": "test",
                         "file": "portbench/configs/flue_small.json",
                         "reduced": [], "why": "rehearsal"})
bench["workloads"].append({"name": "flue_small.tiny", "config": "flue_small",
                           "traffic": "tiny", "chips": 1,
                           "why": "rehearsal"})
pkg = root / "portbench"
(pkg / "configs" / "flue_small.json").write_text(json.dumps(cfg))
(pkg / "traffic" / "tiny.json").write_text(json.dumps(
    {"driver": "replicas", "replicas": 4, "steps_per_block": 40,
     "resync": True, "judged_replicas": 4, "judged_blocks": 1}))
shutil.copy(pkg / "limits" / "flue_slit.replicas.json",
            pkg / "limits" / "flue_small.tiny.json")
args = SimpleNamespace(workload="flue_small.tiny", seed=int(sys.argv[3]),
                       seconds=0.0, trace=0)
res = run.run(args, root=root, device="cpu", bench=bench)
print(json.dumps(res))
"""


def test_small_width_is_judged_correct_by_the_harness(tmp_path):
    """The small-width variant as a cell of the harness (4 replicas, the
    replicas driver, the new cell's limits), one window block after the
    warm-up: judged correct, no frozen site moved, every replica moved."""
    out = subprocess.run(
        [sys.executable, "-c", REHEARSAL, str(tmp_path),
         json.dumps(small_config()), str(SEED)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"] is True, checks
    assert res["attempted"] == 1
    assert checks["frozen_moved"] == 0 and checks["stalled_replicas"] == 0


def test_swap_and_insertion_bookkeeping_match_a_recompute(tmp_path):
    """Five 40-step blocks of 4 replicas of the small variant in float64,
    without the resync, so that the amplitudes and energies are the moves'
    running sums: swaps and insertions are accepted, the frozen slab
    stays, and every replica's running energy and amplitudes equal a full
    recompute."""
    sysm, _ = _load(small_config(), tmp_path, torch.float64)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 4)
    for _ in range(5):
        states, u = draw_uniforms(spec, states, 40)
        states = run_block_uniforms(spec, states, u, False, False)
    accepted = states.counters[:, 1].sum(0)
    assert int(accepted[TYPE_SWAP]) > 0 and int(accepted[TYPE_CREATION]) > 0
    assert bool((states.n_mol[:, 0] == 1).all())
    for r in range(4):
        d = drift_report(spec, states, r)
        assert d["drift_K"] <= 1e-9 * max(1.0, abs(d["e_total_fresh"])), d
        assert d["amp_drift"] <= 1e-9, d


def _emptied(spec, states, row):
    """``states`` with replica ``row`` holding no guest."""
    n = states.n_mol.clone()
    n[row, spec.active_type_ids.long()] = 0
    return states.replace(n_mol=n)


@pytest.mark.parametrize("layers", [False, True])
def test_resync_sets_the_terms_a_population_fixes(tmp_path, layers):
    """After 200 steps of 4 replicas of the small variant in float32 on the
    running sums alone, the resync sets E_SELF and E_INTRA from the
    populations, type by type (E_INTRA what the positions give, to float32
    rounding), E_TOT to the sum of the five,
    and a replica without guests to the frozen sites' own LJ and
    real-space Coulomb (spec.fw_pair_energy: 0 for the slab as one
    molecule, the layers' interlayer energy as one molecule a layer, which
    is what a float64 recompute of that replica gives); the guests' pair
    terms of the others stay as they ran."""
    sysm, _ = _load(small_config(), tmp_path, torch.float32, layers=layers)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 4)
    for _ in range(5):
        states, u = draw_uniforms(spec, states, 40)
        states = run_block_uniforms(spec, states, u, False, False)
    assert int(states.counters[:, 1, TYPE_CREATION].sum()) > 0
    states = _emptied(spec, states, 0)
    out = resync_plain(spec, states)
    e, n = out.energy, states.n_mol
    self_e = intra = torch.zeros(4)
    for r in range(spec.R):
        self_e = self_e + spec.type_self_energy[r] * n[:, r].float()
        intra = intra + spec.type_intra_energy[r] * n[:, r].float()
    assert torch.equal(e[:, E_SELF], self_e)
    assert torch.equal(e[:, E_INTRA], intra)
    # the template's constant is every molecule's: what the positions give
    torch.testing.assert_close(e[:, E_INTRA], full_intra_energy(
        spec, states, site_positions(spec, states)), rtol=1e-6, atol=1e-3)
    guests = n[:, spec.active_type_ids.long()].sum(1) > 0
    assert not guests[0] and guests.any()
    pair = [E_LJ, E_COUL]
    assert torch.equal(e[guests][:, pair], states.energy[guests][:, pair])
    assert torch.equal(e[~guests][:, pair],
                       spec.fw_pair_energy.expand(int((~guests).sum()), 2))
    assert torch.equal(e[:, E_TOT], e[:, E_RECIP] + e[:, E_LJ] + e[:, E_COUL]
                       + e[:, E_SELF] + e[:, E_INTRA])
    f64, _ = _load(small_config(), tmp_path / "f64", torch.float64,
                   layers=layers)
    fresh, _, _ = system_energy(f64.spec, _emptied(
        f64.spec, replicate(f64.spec, f64.state, 1), 0))
    want = fresh[0, pair]
    if layers:
        assert float(want[0]) < -1e4    # the interlayer LJ
    else:
        assert torch.equal(want, torch.zeros(2, dtype=torch.float64))
    torch.testing.assert_close(spec.fw_pair_energy.double(), want,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(f64.spec.fw_pair_energy, want, rtol=1e-12,
                               atol=0)


@pytest.mark.gpu
def test_block_kernel_matches_plain_on_the_full_configuration(tmp_path):
    """K2 in its frozen-prefix two-species form (blockg_kernel<false, true,
    false, true>) against the plain block on the full configuration, B = 8
    x 50 steps in float32: identical decisions (populations, counters,
    extras), positions within 1e-4 A and running energies within 5 K
    (tests/test_torch_gpu.py's bounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    sysm, _ = _load(CONFIG, tmp_path, torch.float32, device=dev)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 8)
    states, u = draw_uniforms(spec, states, 50)
    k = run_block_kernel(spec, states, u)
    p = steps_plain(spec, states, u)
    for name in ("n_mol", "counters", "extras"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert int(k.counters[:, 1].sum()) > 0
    assert float((k.pos - p.pos).abs().max()) <= 1e-4
    assert float((k.energy - p.energy).abs().max()) <= 5.0


@pytest.mark.gpu
def test_kernels_match_plain_where_most_tiles_are_culled(tmp_path):
    """The full slab at a 6.5 A cutoff (rcut2 6.5 A; a shorter one takes
    a k-grid past the kernels' order 31), where a move reaches under half
    of the 112 frozen tiles (some 14% at the loaded guests, tiles_in_reach):
    K2 and K3 against the plain steps on the same uniforms, B = 8
    x 50 steps in float32, with the bounds of the test above: identical
    decisions, positions within 1e-4 A, running energies within 5 K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = copy.deepcopy(CONFIG)
    cfg["writer_args"]["cutoff_A"] = 6.5
    sysm, _ = _load(cfg, tmp_path, torch.float32, device=dev)
    spec = sysm.spec
    assert spec.fw_split and float(spec.rcut2) == 6.5
    assert spec.fw_tile_box.shape[0] == 112
    assert 0.0 < kept_share(spec, sysm.state) < 0.5
    states = replicate(spec, sysm.state, 8)
    states, u = draw_uniforms(spec, states, 50)
    p = steps_plain(spec, states, u)
    for k in (run_block_kernel(spec, states, u),
              run_steps_kernel(spec, states, u)):
        for name in ("n_mol", "counters", "extras"):
            assert torch.equal(getattr(k, name), getattr(p, name)), name
        assert int(k.counters[:, 1].sum()) > 0
        assert float((k.pos - p.pos).abs().max()) <= 1e-4
        assert float((k.energy - p.energy).abs().max()) <= 5.0


@pytest.mark.gpu
def test_instrumented_build_reads_the_kept_share_on_the_slit(tmp_path):
    """tools/section_split on the full configuration, B = 64 x 50 steps:
    its instrumented build counts the frozen tiles each step tested and
    kept, and frozen.kept_share lies strictly between 0 and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from maniac_tpu_torch.tools.section_split import section_split
    sysm, _ = _load(CONFIG, tmp_path, torch.float32,
                    device=torch.device("cuda"))
    shares, _, _, kept = section_split(sysm, 64, 50)
    assert kept is not None and 0.0 < kept < 1.0, kept
    assert abs(float(shares.sum()) - 1.0) < 1e-9
