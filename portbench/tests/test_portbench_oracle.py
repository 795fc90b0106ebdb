"""The independent oracle against the exact periodic sum, against
brute-force double loops, against its own numbers before it took residue
types, and against the frozen copy of the plain path, on the CPU at a
small size."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from portbench import compare, run
from portbench.oracle import (COULOMB_K, INTRA, LJ, REAL, RECIP, SELF,
                              Oracle)
from portbench.ref import driver as ref
from portbench.tests import framework, tiny
from portbench.writers import residues as residues_writer
from portbench.writers import spce_box

CONFIG = json.loads((run.PKG / "configs" / "spce750.json").read_text())
COULOMB = [RECIP, REAL, SELF, INTRA]


def small(tmp_path, tol, seed=11):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["writer_args"].update(n_water=12, L=16.0, cutoff_A=6.0,
                              ewald_tolerance=tol)
    arrays = spce_box.write(str(tmp_path), seed, cfg)
    return cfg, arrays, [torch.as_tensor(arrays["residues"][0]["pos"])]


@pytest.mark.parametrize("tol", [1e-5, 1e-8])
def test_oracle_agrees_with_the_plain_path(tmp_path, tol):
    """Same definitions, written apart: the six components agree in
    float64 but for the plain path's real-space cutoff where erfc(alpha r)
    < 5e-10 (DIVERGENCES.md #22), some 5e-8 of the median component."""
    cfg, arrays, pos = small(tmp_path, tol)
    _, st = ref.load(f"{tmp_path}/input.maniac", f"{tmp_path}/topology.data",
                     f"{tmp_path}/parameters.inc", capacity=16,
                     dtype=torch.float64, device="cpu", seed=11)
    o = Oracle(arrays["residues"], arrays["box"], 6.0, tol, "cpu")
    gaps = compare.energy_gaps(st.energy, o.energies(pos)[None])
    assert float(gaps.max()) < 2e-7


def test_split_converges_to_the_exact_sum(tmp_path):
    """At a tight tolerance the split's Coulomb energy is the exact
    periodic one; at the configuration's it is off by its truncation."""
    cfg, arrays, pos = small(tmp_path, 1e-12)
    exact = Oracle(arrays["residues"], arrays["box"], 6.0, 0, "cpu",
                   converged=True).energies(pos)[COULOMB].sum()
    tight = Oracle(arrays["residues"], arrays["box"], 6.0, 1e-12,
                   "cpu").energies(pos)[COULOMB].sum()
    assert abs(float(tight - exact)) < 1e-7 * abs(float(exact)) + 1e-3


# The single-type oracle's numbers before it took residue types (tiny.py's
# system, and a denser one with LJ and real-space pairs): alpha, kmax, the
# number of modes, the six components, S(k)'s sum of re and of im, sum of
# |S|^2, re at mode 7 and im at the third mode from the end, and the
# converged split's six components.
PARENT = {
    ("tiny", 5): (
        0.4883081111489381, 7, 783,
        [0.0, 15761.26936149949, -0.07070379691696731, -396943.6337612152,
         381136.89581839024, -45.53928512241691],
        [3.6493392748570184, -9.936423216343421, 2978.2757503402745,
         -1.8868068456799896, 0.7216318822004704],
        [0.0, 11148.807769706369, -0.3033288040305116, -355641.93140662997,
         344470.42027731467, -23.006688412977383]),
    ("tiny", 2 ** 33 + 17): (
        0.4883081111489381, 7, 783,
        [0.0, 15947.007392451993, 0.38859337780383907, -396943.6337612152,
         381136.89581839024, 140.65804300480522],
        [11.187514042217245, -3.938612751768634, 2983.840212242284,
         -0.20469587482214713, -1.7414146736655094],
        [0.0, 11334.624859827729, 1.8907889822338313, -355641.93140662997,
         344470.42027731467, 165.00451949465787]),
    ("dense", 5): (
        0.5918460632957373, 6, 518,
        [-3073.577501168769, 73621.66653362723, 7468.054710319145,
         -1202773.0116908946, 1130073.3485774316, 5316.4806293146685],
        [-71.83970751355139, 41.7360675142982, 7683.628328160318,
         4.6228524724615, 3.6912649253385004],
        [-3073.577501168769, 93496.93906716215, 6419.98498295711,
         -1293243.3869331998, 1201763.3214398874, 5363.281055638101]),
    ("dense", 2 ** 33 + 17): (
        0.5918460632957373, 6, 518,
        [-2814.585913474657, 70446.18940052694, 3452.1044287748655,
         -1202773.0116908946, 1130073.3485774316, -1615.9551976358052],
        [-50.32885567188012, -23.126233171727744, 7874.157710948761,
         -1.3518117358035318, -1.7987691230454423],
        [-2814.585913474657, 89566.45710982493, 3153.495268741252,
         -1293243.3869331998, 1201763.3214398876, -1574.6990282207262]),
}
SYSTEMS = {"tiny": {}, "dense": {"n_water": 20, "L": 11.0, "cutoff_A": 5.0}}


def close(got, want, rel=1e-12):
    got, want = np.asarray(got, float), np.asarray(want, float)
    floor = rel * np.abs(want).max()
    assert np.all(np.abs(got - want) <= rel * np.abs(want) + floor), (
        got.tolist(), want.tolist())


@pytest.mark.parametrize("system,seed", sorted(PARENT))
def test_single_type_numbers_are_the_parents(tmp_path, system, seed):
    cfg = {**tiny.CONFIGS["tiny_spce"], "model": CONFIG["model"]}
    cfg["writer_args"] = {**cfg["writer_args"], **SYSTEMS[system]}
    arrays = spce_box.write(str(tmp_path), seed, cfg)
    a = cfg["writer_args"]
    o = Oracle(arrays["residues"], arrays["box"], a["cutoff_A"],
               a["ewald_tolerance"], "cpu")
    pos = [torch.as_tensor(arrays["residues"][0]["pos"])]
    alpha, kmax, modes, energies, amps, converged = PARENT[(system, seed)]
    assert o.alpha == alpha and o.kmax == (kmax,) * 3
    assert o.n.shape[0] == modes
    close(o.energies(pos), energies)
    re, im = o.structure_factors(pos)
    close([re.sum(), im.sum(), (re * re + im * im).sum(), re[7], im[-3]],
          amps)
    close(Oracle(arrays["residues"], arrays["box"], a["cutoff_A"], 0, "cpu",
                 converged=True).energies(pos), converged)


def framework_system(tmp_path, variant, seed=7, tol=1e-5):
    """The rehearsal's small framework (120 charged frozen sites in 13 x
    19.5 x 13 A) as written, and its oracle."""
    cfg = framework.config(variant, "small")
    cfg["writer_args"]["ewald_tolerance"] = tol
    arrays = residues_writer.write(str(tmp_path), seed, cfg)
    return cfg, arrays


def brute(arrays, cutoff, alpha, modes):
    """The six components by double loops over sites in float64: the
    reference's definitions written out pair by pair, and the
    reciprocal sum mode by mode over ``modes`` (n, 3) integer triples
    (n_x >= 0, n_x = 0 weighted once)."""
    L = np.asarray(arrays["box"], float)
    sites = []      # (type, molecule, frozen, q, eps, sig, position)
    mol = 0
    for r, t in enumerate(arrays["residues"]):
        for m in range(t["pos"].shape[0]):
            for a in range(t["pos"].shape[1]):
                sites.append((r, mol, t["frozen"], t["q_e"][a], t["eps_K"][a],
                              t["sigma_A"][a], t["pos"][m, a]))
            mol += 1
    lj = real = intra = 0.0
    for i in range(len(sites)):
        ri, mi, fi, qi, ei, si, pi = sites[i]
        for j in range(i + 1, len(sites)):
            rj, mj, fj, qj, ej, sj, pj = sites[j]
            d = pi - pj
            d -= L * np.round(d / L)
            r = math.sqrt(float(d @ d))
            if mi != mj:
                if r < cutoff and ei > 0 and ej > 0:
                    s6 = (((si + sj) / 2) / r) ** 6
                    lj += 4 * math.sqrt(ei * ej) * (s6 * s6 - s6)
                real += qi * qj * math.erfc(alpha * r) / r
            elif not fi:
                intra += qi * qj * (math.erfc(alpha * r) - 1) / r
    q = np.array([s[3] for s in sites])
    p = np.array([s[6] for s in sites])
    recip = 0.0
    for n in modes:
        k = 2 * np.pi * np.asarray(n, float) / L
        k2 = float(k @ k)
        ph = p @ k
        s2 = (q @ np.cos(ph)) ** 2 + (q @ np.sin(ph)) ** 2
        form = 2.0 if n[0] > 0 else 1.0
        recip += form * 2 * np.pi / L.prod() * math.exp(
            -k2 / (4 * alpha ** 2)) / k2 * s2
    self_ = -alpha / math.sqrt(math.pi) * float(q @ q)
    e = [lj, recip * COULOMB_K, real * COULOMB_K, self_ * COULOMB_K,
         intra * COULOMB_K]
    return e + [sum(e)]


@pytest.mark.parametrize("variant", framework.VARIANTS)
def test_framework_oracle_against_double_loops(tmp_path, variant):
    cfg, arrays = framework_system(tmp_path, variant)
    a = cfg["writer_args"]
    o = Oracle(arrays["residues"], arrays["box"], a["cutoff_A"],
               a["ewald_tolerance"], "cpu")
    assert len(set(o.kmax)) > 1, "a non-cubic box has a kmax for each axis"
    guests = [t["pos"] for t in arrays["residues"] if not t["frozen"]]
    want = brute(arrays, a["cutoff_A"], o.alpha, o.n.tolist())
    got = o.energies(guests)
    close(got, want, rel=1e-10)
    assert float(got[LJ]) != 0 and float(got[REAL]) != 0
    # the frozen sites alone: their energy is the oracle's constant part
    alone = {**arrays, "residues": [
        dict(t, pos=t["pos"][:0]) if not t["frozen"] else t
        for t in arrays["residues"]]}
    close(o.frozen_energy, brute(alone, a["cutoff_A"], o.alpha,
                                 o.n.tolist()), rel=1e-10)


@pytest.mark.parametrize("variant", framework.VARIANTS)
def test_framework_oracle_matches_the_program_grid(tmp_path, variant):
    """The oracle's alpha, kmax and modes are those ref/ derives from the
    written files, and its energy is ref/'s plain split to within the
    split's error (DIVERGENCES.md #21, #22); its structure factors are
    ref/'s to the files' 1e-10 A rounding of the positions."""
    cfg, arrays = framework_system(tmp_path, variant, tol=1e-8)
    a = cfg["writer_args"]
    o = Oracle(arrays["residues"], arrays["box"], a["cutoff_A"],
               a["ewald_tolerance"], "cpu")
    spec, st = ref.load(f"{tmp_path}/input.maniac",
                        f"{tmp_path}/topology.data",
                        f"{tmp_path}/parameters.inc", capacity=16,
                        dtype=torch.float64, device="cpu", seed=7)
    assert spec.fw_split and spec.S_frozen == 120
    assert abs(float(spec.alpha) - o.alpha) < 1e-15 * o.alpha
    assert tuple(spec.kmax_xyz) == o.kmax
    modes = o.grid_index(spec.amp_shape[1])
    weights = spec.k_weights.flatten()
    assert int((weights != 0).sum()) == len(modes)
    assert bool((weights[modes] != 0).all())
    guests = [t["pos"] for t in arrays["residues"] if not t["frozen"]]
    gaps = compare.energy_gaps(st.energy, o.energies(guests)[None],
                               o.frozen_energy)
    assert float(gaps.max()) < 1e-6
    re, im = o.structure_factors(guests)
    assert float((st.amp_re.flatten(1)[0, modes] - re).abs().max()
                 + (st.amp_im.flatten(1)[0, modes] - im).abs().max()) < 1e-8


def test_framework_guest_energy_converges_to_the_exact_sum(tmp_path):
    """What the guests add to the Coulomb energy of the framework at a
    tight tolerance is the exact periodic one (the framework's own
    molecule is one, so its internal reciprocal part, a constant that
    the reference keeps, depends on alpha and is taken out)."""
    cfg, arrays = framework_system(tmp_path, "fw_mixed", tol=1e-12)
    guests = [t["pos"] for t in arrays["residues"] if not t["frozen"]]
    added = []
    for converged in (True, False):
        o = Oracle(arrays["residues"], arrays["box"], 5.0, 1e-12, "cpu",
                   converged=converged)
        e = o.energies(guests) - o.frozen_energy
        added.append(float(e[COULOMB].sum()))
    assert abs(added[1] - added[0]) < 1e-7 * abs(added[0]) + 1e-3
