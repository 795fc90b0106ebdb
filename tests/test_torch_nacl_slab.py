"""The benchmark's nacl001_h2o configuration (portbench/configs/
nacl001_h2o.json): SPC/E water over a frozen, charged NaCl(001) slab.

On the CPU: the writer's slab (portbench/writers/nacl_slab.py) against
rock salt's geometry; its start, the configuration's equilibrated waters
moved with the slab by the seed; the port's float64 energies of the
written full-width configuration against portbench/oracle.py; the spec's
block form, the one with the far table; a small-width variant from the
start at the configuration's own fugacity through the harness's run.run,
judged correct; the resync of a replica without guests; the insertion
and deletion bookkeeping against a float64 recompute; and the load's
counters of the far table. On the card (``gpu``): the block kernel's
far-table form against the plain block on the full configuration.

The file imports no jax, so its card test runs without the suite's
conftest:

    python -m pytest tests/test_torch_nacl_slab.py --noconftest -q
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from maniac_tpu_torch import load_system, replicate
from maniac_tpu_torch.constants import TYPE_CREATION, TYPE_DELETION
from maniac_tpu_torch.kernels import block_gate_failure, blockg
from maniac_tpu_torch.kernels.blockg import run_block_kernel
from maniac_tpu_torch.kernels.resync import resync_plain
from maniac_tpu_torch.mc.driver import draw_uniforms, drift_report, steps_plain
from maniac_tpu_torch.parallel.replicas import run_block_uniforms
from maniac_tpu_torch.physics.energy import system_energy
from maniac_tpu_torch.system import (E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF,
                                     E_TOT)
from maniac_tpu_torch.utils import trace
from maniac_tpu_torch.utils.logger import NullLogger
from portbench import compare, run
from portbench.oracle import Oracle
from portbench.writers import nacl_slab
from portbench.writers.residues import KB_KCALMOL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "nacl001_h2o.json")
                    .read_text())
SEED = 2 ** 33 + 31     # more than 32 bits, as the benchmark's seeds are
HALF = 5.6402 / 2       # rock salt's nearest-neighbour distance, a/2


def small_config(outdir: Path, fugacity_atm: float | None = None) -> dict:
    """The configuration at a small width of slab (3 x 3 cells, 144 ions)
    with a 5 A cutoff, so that it fits the CPU, at ``fugacity_atm`` (the
    configuration's own where None), started from the waters of the
    configuration's start that lie in the small slab's box across x and y,
    every site 1.5 A inside its edges, so that no two sites meet closer
    than 3 A through its periodic faces (the small slab is the full one's
    ions in that box); the split and the far table stay on. The start is
    written to ``outdir``."""
    cfg = copy.deepcopy(CONFIG)
    cfg["slab"]["cells"] = 3
    cfg["writer_args"]["cutoff_A"] = 5.0
    start = json.loads((ROOT / "portbench" / CONFIG["start"]).read_text())
    pos = np.asarray(start["pos"])
    half = nacl_slab.box(cfg["slab"])[0] / 2 - 1.5
    keep = (np.abs(pos[..., :2]) < half).all(axis=(1, 2))
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / "small_start.json"
    path.write_text(json.dumps({"box_A": list(nacl_slab.box(cfg["slab"])),
                                "pos": pos[keep].tolist()}))
    cfg["start"] = str(path)
    (water,) = cfg["residues"]
    water["molecules"] = int(keep.sum())
    if fugacity_atm is not None:
        water["fugacity_atm"] = fugacity_atm
    cfg["capacity"] = 2 * int(keep.sum())
    return cfg


def _load(cfg, outdir, dtype, device="cpu", energy=True):
    files, arrays = run.write_files(cfg, SEED, str(outdir))
    sysm = load_system(files["input"], files["data"], files["params"],
                       capacity=cfg["capacity"], dtype=dtype, device=device,
                       logger=NullLogger(), seed=SEED,
                       compute_initial_energy=energy)
    return sysm, arrays


def test_slab_is_rock_salt():
    """576 ions in four (001) planes of 144, a/2 apart, with the 20 A gap
    between the outer two across z = 0; each ion's nearest sites are its 4
    in-plane and 1 (a face) or 2 (inside) out-of-plane neighbours at a/2,
    every one of the other ion; each plane neutral, so the slab is too;
    the whole slab one frozen molecule."""
    slab = CONFIG["slab"]
    pos, na = nacl_slab.slab_sites(slab)
    L = np.asarray(nacl_slab.box(slab))
    np.testing.assert_allclose(L, [6 * 5.6402, 6 * 5.6402, 3 * HALF + 20.0],
                               rtol=0, atol=1e-6)
    assert pos.shape == (576, 3) and na.sum() == 288
    assert (pos >= -L / 2).all() and (pos < L / 2).all()
    planes = np.unique(np.round(pos[:, 2], 9))
    np.testing.assert_allclose(planes, [-10 - HALF, -10, 10, 10 + HALF],
                               atol=1e-9)
    gaps = np.diff(np.concatenate([planes, [planes[0] + L[2]]]))
    np.testing.assert_allclose(sorted(gaps), [HALF, HALF, HALF, 20.0],
                               atol=1e-6)
    q = np.where(na, 1.0, -1.0)
    for z in planes:
        here = np.abs(pos[:, 2] - z) < 1e-6
        assert here.sum() == 144 and q[here].sum() == 0
    d = pos[:, None] - pos[None]
    d -= L * np.round(d / L)
    r = np.sqrt((d * d).sum(-1))
    np.fill_diagonal(r, np.inf)
    assert r.min() == pytest.approx(HALF, abs=1e-6)
    near = np.abs(r - HALF) < 1e-6
    in_plane = near & (np.abs(d[..., 2]) < 1e-6)
    assert (in_plane.sum(1) == 4).all()
    face = np.isin(np.round(np.abs(pos[:, 2]), 6), [10.0])
    assert ((near & ~in_plane).sum(1) == np.where(face, 1, 2)).all()
    assert (q[:, None] * q[None])[near].max() == -1.0
    (res,) = nacl_slab.slab_residues(slab)
    assert res["frozen"] and len(res["sites"]) == 576
    assert sum(res["q_e"]) == 0.0
    assert res["sites"] == ["Na" if x else "Cl" for x in na]
    np.testing.assert_array_equal(res["geometry_A"], pos)


def test_start_is_the_equilibrated_waters_moved_with_the_slab():
    """The writer starts from the configuration's ``start``, its count of
    waters, each seed's copy the same waters moved by a translation that
    maps the slab onto itself (a multiple of a/2 along x and y, Na onto
    Na), each water whole (O-H 1 A, as float32 kept it on the card) with
    its O in the box, and none of them inside the slab."""
    slab, (water,) = CONFIG["slab"], CONFIG["residues"]
    start = np.asarray(json.loads(
        (ROOT / "portbench" / CONFIG["start"]).read_text())["pos"])
    assert start.shape == (water["molecules"], 3, 3)
    L = np.asarray(nacl_slab.box(slab))
    ions, na = nacl_slab.slab_sites(slab)
    shifts = set()
    for seed in (SEED, SEED + 1, 7):
        pos = nacl_slab.start_sites(CONFIG, seed)
        assert pos.shape == start.shape
        assert (np.abs(pos[:, 0]) <= L / 2).all()
        oh = np.linalg.norm(pos[:, 1:] - pos[:, :1], axis=-1)
        np.testing.assert_allclose(oh, 1.0, atol=1e-4)
        d = pos - start
        shift = d[0, 0].copy()
        d -= shift
        d -= L * np.round(d / L)
        np.testing.assert_allclose(d, 0, atol=1e-9)
        steps = shift[:2] / HALF
        np.testing.assert_allclose(steps, np.round(steps), atol=1e-9)
        moved = ions + shift
        moved -= L * np.round(moved / L)
        gap = moved[:, None] - ions[None]
        gap -= L * np.round(gap / L)
        match = np.linalg.norm(gap, axis=-1).argmin(axis=1)
        assert (na[match] == na).all()
        shifts.add(tuple(np.round(np.mod(shift[:2], L[:2]), 6)))
        assert (np.abs(pos[..., 2]) < 10.0).all()
    assert len(shifts) > 1


def test_full_width_energies_match_the_oracle(tmp_path):
    """The port's float64 loaded energy of the written configuration at its
    full width against the oracle's independent sums, relative as the
    comparison takes it (compare.energy_gaps, the slab's own energy taken
    out of the scale): LJ, reciprocal, self, intramolecular and total within
    1e-9; real space within the framework split's error, 1e-6 kcal/mol a
    water (the split sums the slab's real-space Coulomb at its own
    alpha2 and rcut2 and the rest of it in the far table); the split is on
    over one frozen molecule of 576 charged sites."""
    sysm, arrays = _load(CONFIG, tmp_path, torch.float64)
    spec = sysm.spec
    assert spec.fw_split and spec.n_active == 1 and spec.R == 2
    assert list(spec.active_list) == [False, True]
    assert spec.S_frozen == 576
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
    gaps = compare.energy_gaps(st.energy, want[None], oracle.frozen_energy)
    assert float(gaps[0, [0, 1, 3, 4]].max()) <= 1e-9, gaps
    waters = int(st.n_mol[0, 1])
    real = float((compare.components(st.energy)[0, 2] - want[2]).abs())
    assert 0 < real <= 1e-6 / KB_KCALMOL * waters, real
    tot = float((compare.components(st.energy)[0, 5] - want[5]).abs())
    assert tot <= real + 1e-9 * float(want[5].abs()), (tot, real)


def test_spec_takes_the_far_table_form(tmp_path):
    """In float32 the spec passes the block kernel's gate and takes its
    frozen-prefix form with the far table (blockg.form 'far_tiles'): a far
    grid under the kernels' order 31 and a far table of nonzero work
    units over the slab's charges."""
    sysm, _ = _load(CONFIG, tmp_path, torch.float32, energy=False)
    spec = sysm.spec
    assert block_gate_failure(spec) is None
    assert blockg.form(spec) == "far_tiles"
    assert max(spec.kmax2_xyz) <= 31
    assert int((spec.far_units[..., 2] > 0).sum()) > 0
    assert int((spec.far_coef != 0).sum()) > 0


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
bench["configs"].append({"name": "nacl_small", "source": "test",
                         "file": "portbench/configs/nacl_small.json",
                         "reduced": [], "why": "rehearsal"})
bench["workloads"].append({"name": "nacl_small.tiny", "config": "nacl_small",
                           "traffic": "tiny", "chips": 1,
                           "why": "rehearsal"})
pkg = root / "portbench"
(pkg / "configs" / "nacl_small.json").write_text(json.dumps(cfg))
(pkg / "traffic" / "tiny.json").write_text(json.dumps(
    {"driver": "replicas", "replicas": 4, "steps_per_block": 40,
     "resync": True, "judged_replicas": 4, "judged_blocks": 1}))
shutil.copy(pkg / "limits" / "nacl001_h2o.replicas.json",
            pkg / "limits" / "nacl_small.tiny.json")
args = SimpleNamespace(workload="nacl_small.tiny", seed=int(sys.argv[3]),
                       seconds=0.0, trace=0)
res = run.run(args, root=root, device="cpu", bench=bench)
print(json.dumps(res))
"""


def test_small_width_is_judged_correct_by_the_harness(tmp_path):
    """The small-width variant as a cell of the harness (4 replicas, the
    replicas driver, the new cell's limits) at the configuration's own
    fugacity from its start, one window block after the warm-up: judged
    correct, no frozen ion moved, every replica moved."""
    cfg = small_config(tmp_path)
    assert cfg["residues"][0]["molecules"] >= 40
    out = subprocess.run(
        [sys.executable, "-c", REHEARSAL, str(tmp_path / "root"),
         json.dumps(cfg), str(SEED)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"] is True, checks
    assert res["attempted"] == 1
    assert checks["frozen_moved"] == 0 and checks["stalled_replicas"] == 0


def _emptied(spec, states, row):
    """``states`` with replica ``row`` holding no water."""
    n = states.n_mol.clone()
    n[row, spec.active_type_ids.long()] = 0
    return states.replace(n_mol=n)


def test_resync_sets_the_slab_terms_of_a_replica_without_guests(tmp_path):
    """After 200 steps of 4 replicas of the small variant in float32 on the
    running sums alone, one replica emptied: the resync gives it the
    slab's own energy, E_SELF and E_RECIP those of a float64 recompute of
    that replica (the slab's self term, some -3.9e6 K, and its reciprocal
    energy over its images, within float32 rounding), E_LJ and E_COUL the
    frozen sites' own (0: the slab is one molecule), E_INTRA 0 and E_TOT
    the sum; the others keep their guests' pair terms as they ran."""
    sysm, _ = _load(small_config(tmp_path), tmp_path, torch.float32)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 4)
    for _ in range(5):
        states, u = draw_uniforms(spec, states, 40)
        states = run_block_uniforms(spec, states, u, False, False)
    states = _emptied(spec, states, 0)
    out = resync_plain(spec, states)
    e = out.energy
    guests = states.n_mol[:, 1] > 0
    assert not guests[0] and guests[1:].all()
    pair = [E_LJ, E_COUL]
    assert torch.equal(e[guests][:, pair], states.energy[guests][:, pair])
    assert torch.equal(e[0, pair], torch.zeros(2))
    assert float(e[0, E_INTRA]) == 0.0
    assert torch.equal(e[:, E_TOT], e[:, E_RECIP] + e[:, E_LJ] + e[:, E_COUL]
                       + e[:, E_SELF] + e[:, E_INTRA])
    f64, _ = _load(small_config(tmp_path), tmp_path / "f64", torch.float64)
    fresh, _, _ = system_energy(f64.spec, _emptied(
        f64.spec, replicate(f64.spec, f64.state, 1), 0))
    assert float(fresh[0, E_SELF]) < -1e6 and float(fresh[0, E_RECIP]) > 0
    for c in (E_SELF, E_RECIP):
        torch.testing.assert_close(e[0, c].double(), fresh[0, c],
                                   rtol=1e-6, atol=0)


def test_insertion_and_deletion_bookkeeping_match_a_recompute(tmp_path):
    """Five 40-step blocks of 4 replicas of the small variant at 30 atm
    (so that insertions are accepted within them) in float64, without the
    resync, so that the amplitudes and energies are the moves' running
    sums: insertions and deletions are accepted, the frozen slab stays,
    and every replica's running energy equals a full recompute within 1e-6
    K (against totals of some -1e6 K and more) and its amplitudes within
    1e-9."""
    sysm, _ = _load(small_config(tmp_path, 30.0), tmp_path, torch.float64)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 4)
    for _ in range(5):
        states, u = draw_uniforms(spec, states, 40)
        states = run_block_uniforms(spec, states, u, False, False)
    accepted = states.counters[:, 1].sum(0)
    assert int(accepted[TYPE_CREATION]) > 0
    assert int(accepted[TYPE_DELETION]) > 0
    assert bool((states.n_mol[:, 0] == 1).all())
    for r in range(4):
        d = drift_report(spec, states, r)
        assert abs(d["e_total_fresh"]) > 1e6
        assert d["drift_K"] <= 1e-6, d
        assert d["amp_drift"] <= 1e-9, d


def test_load_counts_the_far_table_and_the_charged_sites(tmp_path):
    """With the program's tracing on, the load of the small variant counts
    its 144 charged frozen sites (``load.frozen_charged_sites``) and the far
    table's work units (``load.far_units``), as the spec holds them, inside
    a ``load.far_table`` span."""
    trace.reset()
    trace.enable(True)
    try:
        sysm, _ = _load(small_config(tmp_path), tmp_path, torch.float32,
                        energy=False)
        got = trace.counters()
        names = [s.name for s in trace.spans()]
    finally:
        trace.enable(False)
        trace.reset()
    spec = sysm.spec
    units = int((spec.far_units[..., 2] > 0).sum())
    assert units > 0 and "load.far_rows" not in got
    assert got["load.frozen_charged_sites"] == 144
    assert got["load.far_units"] == units
    assert "load.far_table" in names


@pytest.mark.gpu
def test_block_kernel_matches_plain_on_the_full_configuration(tmp_path):
    """K2 in its frozen-prefix form with the far table (blockg.form
    'far_tiles') against the plain block on the full configuration, B = 8
    x 50 steps in float32: identical decisions (populations, counters,
    extras), positions within 1e-4 A and running energies within
    bench.energy_bound, 5 K plus one float32 ulp of each component's
    load-time magnitude per accepted step (the self term of the slab and
    the 610 waters, some -3.3e7 K, has an ulp of 2 K, and every accepted
    move's delta is added to it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from maniac_tpu_torch import bench
    dev = torch.device("cuda")
    sysm, _ = _load(CONFIG, tmp_path, torch.float32, device=dev)
    spec = sysm.spec
    assert blockg.form(spec) == "far_tiles"
    states = replicate(spec, sysm.state, 8)
    states, u = draw_uniforms(spec, states, 50)
    k = run_block_kernel(spec, states, u)
    p = steps_plain(spec, states, u)
    for name in ("n_mol", "counters", "extras"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    accepted = (k.counters[:, 1] - states.counters[:, 1]).sum(1)
    assert int(accepted.sum()) > 0
    assert float((k.pos - p.pos).abs().max()) <= 1e-4
    bound = bench.energy_bound(sysm.state.energy[0], accepted)
    assert bool(((k.energy - p.energy).double().abs() <= bound).all())
