"""A graphite slit pore: a frozen slab of AB-stacked graphene layers
built from two published constants, with guests in the pore between
the slab and its periodic image along z.

The configuration's ``slab`` gives ``cc_A`` (the C-C bond, 1.42 A),
``interlayer_A`` (3.35 A), ``layers``, ``cells`` (rectangular cells of
graphene along x and y, each sqrt(3) cc by 3 cc with four atoms),
``pore_A`` (carbon plane to carbon plane across the pore) and the carbon
site's ``eps_K``, ``sigma_A``, ``mass`` (neutral). Odd layers are shifted
by one bond along y (AB, Bernal stacking). The box is the slab's own
period in x and y and (layers - 1) interlayer + pore in z; the pore is
centred at z = 0, so the slab's layers lie at +-pore/2 and beyond,
wrapped into the box. The slab is one frozen residue type of one
molecule, as Steele's solid, placed before the configuration's
``residues`` (the guests), and the whole list is written by
residues.write unchanged.
"""

from __future__ import annotations

import math

import numpy as np

from . import residues


def cell_sites(cc: float) -> np.ndarray:
    """(4, 2) x, y of the atoms of one rectangular graphene cell,
    sqrt(3) cc along x (zigzag) by 3 cc along y (armchair)."""
    a = math.sqrt(3.0) * cc
    return np.array([[0.0, 0.0], [0.0, cc], [a / 2, 1.5 * cc],
                     [a / 2, 2.5 * cc]])


def box(slab: dict) -> tuple:
    """The box's three edges in A, each twice a half edge of six decimals:
    the data file writes the bounds -L/2 and L/2 so, and the program and
    the references then take one box (sqrt(3) cc is irrational: the seam
    left at the x boundary is under 2e-6 A)."""
    cc, (nx, ny) = float(slab["cc_A"]), slab["cells"]
    return tuple(2 * round(edge / 2, 6) for edge in (
        nx * math.sqrt(3.0) * cc, ny * 3.0 * cc,
        (int(slab["layers"]) - 1) * float(slab["interlayer_A"])
        + float(slab["pore_A"])))


def slab_sites(slab: dict) -> np.ndarray:
    """(n, 3) carbon positions in the box (each axis in [-L/2, L/2)),
    layer after layer from the pore's upper wall up through the periodic
    boundary to its lower wall."""
    cc, (nx, ny) = float(slab["cc_A"]), slab["cells"]
    L = np.asarray(box(slab))
    a, b = math.sqrt(3.0) * cc, 3.0 * cc
    ij = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij"),
                  -1).reshape(-1, 1, 2) * np.array([a, b])
    layer = (ij + cell_sites(cc)[None]).reshape(-1, 2)
    out = []
    for k in range(int(slab["layers"])):
        z = float(slab["pore_A"]) / 2 + k * float(slab["interlayer_A"])
        xy = layer + np.array([0.0, cc * (k % 2)])
        out.append(np.column_stack([xy, np.full(len(xy), z)]))
    pos = np.concatenate(out)
    return pos - L * np.floor((pos + L / 2) / L)


def slab_residues(slab: dict) -> list:
    """The slab as one frozen residue type: one molecule of neutral carbon
    sites in the order of slab_sites."""
    pos = slab_sites(slab)
    n = len(pos)
    return [{"name": "graphite", "frozen": True, "sites": ["CG"] * n,
             "q_e": [0.0] * n, "eps_K": [float(slab["eps_K"])] * n,
             "sigma_A": [float(slab["sigma_A"])] * n,
             "mass": [float(slab["mass"])] * n,
             "geometry_A": pos.tolist()}]


def write(outdir: str, seed: int, config: dict) -> dict:
    """residues.write of the slab and the configuration's guests in the
    slab's box."""
    slab = config["slab"]
    return residues.write(outdir, seed, {
        **config, "residues": slab_residues(slab) + config["residues"],
        "writer_args": {**config["writer_args"], "box_A": list(box(slab))}})
