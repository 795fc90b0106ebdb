"""Residue types in an orthorhombic box: frozen frameworks where the
configuration puts their sites, guests placed from the seed.

The configuration lists its residue types in ``residues``, in the deck's
order, the frozen ones first (the program's framework split takes them
as a prefix). Each gives ``name``, ``frozen``, its sites (``sites``,
names; ``q_e``; ``eps_K``; ``sigma_A``; ``mass``) and ``geometry_A``:

* a frozen type is one rigid molecule, ``geometry_A`` its sites'
  positions in the box;
* an active type gives its molecule's sites in its own frame in
  ``geometry_A``, ``fugacity_atm`` and ``molecules``, the number placed
  at the start.

``writer_args`` holds ``box_A`` (three edges; the box runs from -L/2 to
L/2 on each axis), ``cutoff_A``, ``ewald_tolerance``, ``temp_K``,
``move_probabilities`` (translation, rotation, insertion/deletion, swap)
and ``clearance_A``. Each guest is placed at a centre drawn uniformly in
the box, turned by a random rotation, and drawn again while one of its
sites lies within ``clearance_A`` of a site already placed, at the minimum
image. Sites of one name in a type share one LAMMPS atom type and so one
LJ pair; each type's atom types are its own. The files follow the layout
of portbench/systems.py.
"""

from __future__ import annotations

import os

import numpy as np

from ..systems import _random_rotation, _write_data, _write_deck, _write_inc

KB_KCALMOL = 0.0019872041   # the reference's kB (src/constants.f90)
TRIES = 10000               # draws for one guest before the writer gives up


def atom_types(residues) -> list:
    """For each type, {site name: (LAMMPS type, eps_K, sigma_A, mass)},
    numbered from 1 in order of appearance."""
    out, n = [], 0
    for res in residues:
        kinds = {}
        for a, name in enumerate(res["sites"]):
            here = (res["eps_K"][a], res["sigma_A"][a], res["mass"][a])
            if name in kinds and kinds[name][1:] != here:
                raise ValueError(f"{res['name']}: sites named {name} differ "
                                 f"in eps, sigma or mass")
            if name not in kinds:
                n += 1
                kinds[name] = (n, *here)
        out.append(kinds)
    return out


def place(residues, box, clearance: float, seed: int) -> list:
    """[(n, A, 3)] site positions of each type: the frozen ones as given,
    the guests placed from the seed."""
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFFFFFF)
    L = np.asarray(box, dtype=float)
    taken = [np.asarray(r["geometry_A"], float).reshape(-1, 3)
             for r in residues if r["frozen"]]
    out = []
    for res in residues:
        geo = np.asarray(res["geometry_A"], dtype=float)
        if res["frozen"]:
            out.append(geo[None])
            continue
        frame = geo - geo.mean(axis=0)
        mols = []
        for _ in range(int(res["molecules"])):
            others = np.concatenate(taken) if taken else np.zeros((0, 3))
            for _ in range(TRIES):
                sites = (rng.uniform(-0.5, 0.5, 3) * L
                         + frame @ _random_rotation(rng).T)
                d = sites[:, None] - others[None]
                d -= L * np.round(d / L)
                if not len(others) or np.sqrt(
                        (d * d).sum(-1)).min() >= clearance:
                    break
            else:
                raise ValueError(f"no room for a {res['name']} at "
                                 f"{clearance} A from every site")
            mols.append(sites)
            taken.append(sites)
        out.append(np.stack(mols) if mols else np.zeros((0, len(geo), 3)))
    return out


def write(outdir: str, seed: int, config: dict) -> dict:
    """The deck, data and pair-coefficient files of the configuration;
    returns {"residues": [...], "box": (Lx, Ly, Lz)}, each type with its
    sites' q_e, eps_K, sigma_A, ``frozen`` and the written ``pos``."""
    args, residues = config["writer_args"], config["residues"]
    box = tuple(float(x) for x in args["box_A"])
    os.makedirs(outdir, exist_ok=True)
    kinds = atom_types(residues)
    pos = place(residues, box, float(args["clearance_A"]), seed)
    atoms, mol = [], 0
    for res, kind, p in zip(residues, kinds, pos):
        types = [kind[name][0] for name in res["sites"]]
        for m in range(p.shape[0]):
            mol += 1
            atoms += [(mol, types[a], res["q_e"][a], *p[m, a])
                      for a in range(p.shape[1])]
    masses = {t: mass for kind in kinds for t, _, _, mass in kind.values()}
    _write_data(f"{outdir}/topology.data", box, atoms, masses, len(masses))
    _write_deck(f"{outdir}/input.maniac", [
        dict(name=res["name"], active=not res["frozen"],
             fugacity=None if res["frozen"] else res["fugacity_atm"],
             types=[t for t, _, _, _ in kind.values()],
             names=list(kind), nb_atoms=len(res["sites"]))
        for res, kind in zip(residues, kinds)],
        temp=args["temp_K"], tol=args["ewald_tolerance"],
        cutoff=args["cutoff_A"], probs=tuple(args["move_probabilities"]))
    _write_inc(f"{outdir}/parameters.inc",
               [(t, t, eps * KB_KCALMOL, sig) for kind in kinds
                for t, eps, sig, _ in kind.values()])
    return {"box": box,
            "residues": [dict(name=res["name"], frozen=bool(res["frozen"]),
                              q_e=list(res["q_e"]), eps_K=list(res["eps_K"]),
                              sigma_A=list(res["sigma_A"]), pos=p)
                         for res, p in zip(residues, pos)]}
