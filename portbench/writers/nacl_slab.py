"""A rock-salt (001) slab: a frozen, bulk-terminated NaCl slab built
from its published lattice constant, with guests in the gap between the
slab and its periodic image along z.

The configuration's ``slab`` gives ``a_A`` (the cubic lattice constant,
5.6402 A), ``cells`` (conventional cells along x and along y),
``layers`` ((001) planes, a/2 apart), ``pore_A`` (ion plane to ion plane
across the gap) and ``ions``: for ``Na`` and ``Cl`` their ``q_e``,
``eps_K``, ``sigma_A`` and ``mass``. The site at (i a/2, j a/2) of plane
k is Na where i + j + k is even and Cl otherwise, so each plane is
neutral and the slab has no dipole along z. The box is the slab's own
period in x and y and (layers - 1) a/2 + pore in z; the gap is centred
at z = 0, so the planes lie at +-pore/2 and beyond, wrapped into the box.
The slab is one frozen residue type of one molecule, placed before the
configuration's one guest type, in residues.py's residue form.

The guests are not placed at random: the configuration names a ``start``,
a JSON file (a path under the portbench package, or an absolute one) of
``box_A`` and ``pos``, the sites of an equilibrated population of the
guest type, (n, A, 3) in the box, n the guest's ``molecules``. Every
guest is moved by one translation of the slab onto itself drawn from the
seed (i a/2 along x and j a/2 along y, i + j even). At the configuration's
fugacity guests placed at random leave within a block or two and leave
replicas empty, while the start's population stays.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..systems import _write_data, _write_deck, _write_inc
from . import residues


def box(slab: dict) -> tuple:
    """The box's three edges in A, each twice a half edge of six decimals,
    as the data file writes its bounds -L/2 and L/2."""
    half = float(slab["a_A"]) / 2
    side = 2 * int(slab["cells"]) * half
    return tuple(2 * round(edge / 2, 6) for edge in (
        side, side, (int(slab["layers"]) - 1) * half
        + float(slab["pore_A"])))


def slab_sites(slab: dict) -> tuple[np.ndarray, np.ndarray]:
    """((n, 3) ion positions in the box, each axis in [-L/2, L/2); (n,)
    True where the ion is Na), plane after plane from the gap's upper
    face up through the periodic boundary to its lower face."""
    half = float(slab["a_A"]) / 2
    m = 2 * int(slab["cells"])
    L = np.asarray(box(slab))
    i, j = (g.reshape(-1) for g in np.meshgrid(np.arange(m), np.arange(m),
                                               indexing="ij"))
    pos, na = [], []
    for k in range(int(slab["layers"])):
        z = float(slab["pore_A"]) / 2 + k * half
        pos.append(np.column_stack([i * half, j * half,
                                    np.full(m * m, z)]))
        na.append((i + j + k) % 2 == 0)
    pos = np.concatenate(pos)
    return pos - L * np.floor((pos + L / 2) / L), np.concatenate(na)


def slab_residues(slab: dict) -> list:
    """The slab as one frozen residue type: one molecule of Na and Cl
    sites in the order of slab_sites."""
    pos, na = slab_sites(slab)
    ions = [slab["ions"]["Na" if x else "Cl"] for x in na]
    return [{"name": "nacl", "frozen": True,
             "sites": ["Na" if x else "Cl" for x in na],
             "q_e": [float(ion["q_e"]) for ion in ions],
             "eps_K": [float(ion["eps_K"]) for ion in ions],
             "sigma_A": [float(ion["sigma_A"]) for ion in ions],
             "mass": [float(ion["mass"]) for ion in ions],
             "geometry_A": pos.tolist()}]


def start_sites(config: dict, seed: int) -> np.ndarray:
    """(n, A, 3) the guests of the configuration's ``start``, moved by the
    seed's translation of the slab onto itself, each molecule whole and its
    first site in the box."""
    slab = config["slab"]
    start = json.loads((Path(__file__).resolve().parents[1]
                        / config["start"]).read_text())
    L = np.asarray(box(slab))
    (guest,) = config["residues"]
    pos = np.asarray(start["pos"], dtype=float)
    if not np.allclose(start["box_A"], L, rtol=0, atol=1e-6):
        raise ValueError(f"the start's box {start['box_A']} is not the "
                         f"slab's {L.tolist()}")
    if pos.shape != (int(guest["molecules"]), len(guest["sites"]), 3):
        raise ValueError(f"the start holds {pos.shape[0]} of "
                         f"{guest['molecules']} guests")
    m = 2 * int(slab["cells"])
    i, j = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFFFFFF).integers(
        m, size=2)
    pos = pos + np.array([i, (j + (i + j) % 2) % m, 0]) * float(
        slab["a_A"]) / 2
    return pos - (L * np.floor((pos[:, :1] + L / 2) / L))


def write(outdir: str, seed: int, config: dict) -> dict:
    """The deck, data and pair-coefficient files of the slab and the
    start's guests in the slab's box, written as residues.write writes its
    residue types; returns what residues.write returns."""
    slab = config["slab"]
    args = {**config["writer_args"], "box_A": list(box(slab))}
    types = slab_residues(slab) + config["residues"]
    os.makedirs(outdir, exist_ok=True)
    kinds = residues.atom_types(types)
    pos = [np.asarray(types[0]["geometry_A"])[None],
           start_sites(config, seed)]
    atoms, mol = [], 0
    for res, kind, p in zip(types, kinds, pos):
        for k in range(p.shape[0]):
            mol += 1
            atoms += [(mol, kind[name][0], res["q_e"][a], *p[k, a])
                      for a, name in enumerate(res["sites"])]
    masses = {t: mass for kind in kinds for t, _, _, mass in kind.values()}
    _write_data(f"{outdir}/topology.data", args["box_A"], atoms, masses,
                len(masses))
    _write_deck(f"{outdir}/input.maniac", [
        dict(name=res["name"], active=not res["frozen"],
             fugacity=None if res["frozen"] else res["fugacity_atm"],
             types=[t for t, _, _, _ in kind.values()],
             names=list(kind), nb_atoms=len(res["sites"]))
        for res, kind in zip(types, kinds)],
        temp=args["temp_K"], tol=args["ewald_tolerance"],
        cutoff=args["cutoff_A"], probs=tuple(args["move_probabilities"]))
    _write_inc(f"{outdir}/parameters.inc",
               [(t, t, eps * residues.KB_KCALMOL, sig) for kind in kinds
                for t, eps, sig, _ in kind.values()])
    return {"box": tuple(args["box_A"]),
            "residues": [dict(name=res["name"], frozen=bool(res["frozen"]),
                              q_e=list(res["q_e"]), eps_K=list(res["eps_K"]),
                              sigma_A=list(res["sigma_A"]), pos=p)
                         for res, p in zip(types, pos)]}
