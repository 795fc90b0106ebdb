"""Bulk SPC/E water: rigid three-site waters placed from the seed in a
cubic box.

The molecule (sites, charges, geometry, LJ) is the configuration's
``model``; the placement: the n_water molecules on n_water of the
ceil(n_water^(1/3))^3 points of a cubic grid drawn from the seed, each
jittered by up to a tenth of the spacing and turned by a random rotation.
The layout of the files follows make_spce_box of maniac_tpu_torch/
systems.py at commit c8d5b755d87bdce149bdc4a95542cd5e6a434222, with the
box edge given and the grid points drawn, where that fills the first
n_water points of its grid. A configuration whose "writer" is
"spce_box" has its files written by ``write``, which returns the
generated arrays that the reference takes.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..systems import _random_rotation, _write_data, _write_deck, _write_inc

KB_KCALMOL = 0.0019872041   # the reference's kB (src/constants.f90)


def template(model: dict) -> np.ndarray:
    """(A, 3) site offsets from the first site (O), H-O-H in the xz
    plane."""
    half = math.radians(model["angle_HOH_deg"]) / 2
    r = model["r_OH_A"]
    return np.array([[0.0, 0.0, 0.0],
                     [r * math.sin(half), 0.0, r * math.cos(half)],
                     [-r * math.sin(half), 0.0, r * math.cos(half)]])


def place(n_water: int, L: float, model: dict, seed: int) -> np.ndarray:
    """(n_water, A, 3) site positions from the seed."""
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFFFFFF)
    per_axis = max(2, int(math.ceil(n_water ** (1 / 3) - 1e-9)))
    spacing = L / per_axis
    grid = np.stack(np.meshgrid(*[np.arange(per_axis)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    pick = rng.permutation(len(grid))[:n_water]
    centers = -L / 2 + (grid[np.sort(pick)] + 0.5) * spacing
    centers = centers + rng.uniform(-0.1, 0.1, centers.shape) * spacing
    sites = template(model)
    return np.stack([c + sites @ _random_rotation(rng).T for c in centers])


def write(outdir: str, seed: int, config: dict) -> dict:
    """The deck, data and pair-coefficient files of the configuration;
    returns the written arrays in the residue form: {"residues": [the
    model as one active type, with its "pos" (n_water, A, 3)], "box": the
    three edges}."""
    args, model = config["writer_args"], config["model"]
    os.makedirs(outdir, exist_ok=True)
    pos = place(args["n_water"], args["L"], model, seed)
    q = model["q_e"]
    types = [1, 2, 2]
    atoms = [(m, types[a], q[a], *pos[m - 1, a])
             for m in range(1, len(pos) + 1) for a in range(3)]
    _write_data(f"{outdir}/topology.data", args["L"], atoms,
                {1: model["mass"][0], 2: model["mass"][1]}, 2)
    residues = [dict(name="wat", active=True, fugacity=args["fugacity"],
                     types=[1, 2], names=["OW", "HW"], nb_atoms=3)]
    _write_deck(f"{outdir}/input.maniac", residues, temp=args["temp_K"],
                tol=args["ewald_tolerance"], cutoff=args["cutoff_A"],
                probs=tuple(args["move_probabilities"]))
    eps = [e * KB_KCALMOL for e in model["eps_K"]]
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, eps[0], model["sigma_A"][0]),
                (2, 2, eps[1], model["sigma_A"][1])])
    return {"residues": [dict(model, frozen=False, pos=pos)],
            "box": (float(args["L"]),) * 3}
