"""The systems the benchmark's configurations use, written as files.

A frozen copy of maniac_tpu_torch/systems.py at commit
c8d5b755d87bdce149bdc4a95542cd5e6a434222: the random rotation and the
deck, data and pair-coefficient writers, unchanged. Each writer of a
configuration is a module of its own in writers/; the harness writes the
files once and hands the same files to the program, and the same arrays
to the reference.
"""

from __future__ import annotations

import numpy as np


def _random_rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _write_data(path, L, atoms, masses, n_types, tilt=None):
    """atoms: list of (mol_id, type, q, x, y, z). L: scalar (cubic) or
    3-sequence (orthorhombic box lengths)."""
    Lx, Ly, Lz = (L, L, L) if np.ndim(L) == 0 else L
    with open(path, "w") as f:
        f.write("LAMMPS data file (maniac-tpu test fixture)\n\n")
        f.write(f"{len(atoms)} atoms\n{n_types} atom types\n")
        f.write("0 bonds\n0 bond types\n0 angles\n0 angle types\n")
        f.write("0 dihedrals\n0 dihedral types\n0 impropers\n0 improper types\n\n")
        f.write(f"{-Lx / 2:.6f} {Lx / 2:.6f} xlo xhi\n")
        f.write(f"{-Ly / 2:.6f} {Ly / 2:.6f} ylo yhi\n")
        f.write(f"{-Lz / 2:.6f} {Lz / 2:.6f} zlo zhi\n")
        if tilt is not None:
            f.write(f"{tilt[0]:.6f} {tilt[1]:.6f} {tilt[2]:.6f} xy xz yz\n")
        f.write("\nMasses\n\n")
        for t in range(1, n_types + 1):
            f.write(f"{t} {masses[t]}\n")
        f.write("\nAtoms # full\n\n")
        for i, (mol, typ, q, x, y, z) in enumerate(atoms, 1):
            f.write(f"{i} {mol} {typ} {q:.6f} {x:.10f} {y:.10f} {z:.10f} 0 0 0\n")


def _write_deck(path, residues, nb_block=1, nb_step=0, temp=300.0,
                tol=1e-5, cutoff=8.0, tstep=0.6, rstep=0.5,
                probs=(0.5, 0.5, 0.0, 0.0), seed=12345, recal=False,
                **extra):
    with open(path, "w") as f:
        f.write("# maniac-tpu test deck\n")
        f.write(f"nb_block {nb_block}\nnb_step {nb_step}\n")
        f.write(f"temperature {temp}\nseed {seed}\n")
        f.write(f"ewald_tolerance {tol}\nreal_space_cutoff {cutoff}\n")
        f.write(f"translation_step {tstep}\nrotation_step_angle {rstep}\n")
        f.write(f"recalibrate_moves {'true' if recal else 'false'}\n")
        f.write(f"translation_proba {probs[0]}\nrotation_proba {probs[1]}\n")
        f.write(f"insertion_deletion_proba {probs[2]}\nswap_proba {probs[3]}\n")
        # remaining keywords (ewald_alpha, fw_alpha2, fw_rcut2,
        # framework_split, ...) pass straight through to the deck
        for k, v in extra.items():
            f.write(f"{k} {v}\n")
        f.write("\n")
        for res in residues:
            f.write("begin_residue\n")
            f.write(f"  name {res['name']}\n")
            f.write(f"  state {'actif' if res['active'] else 'inactif'}\n")
            if res.get("fugacity") is not None:
                f.write(f"  fugacity {res['fugacity']}\n")
            f.write(f"  types {' '.join(str(t) for t in res['types'])}\n")
            f.write(f"  names {' '.join(res['names'])}\n")
            f.write(f"  nb-atoms {res['nb_atoms']}\nend_residue\n\n")


def _write_inc(path, coeffs):
    with open(path, "w") as f:
        f.write("# pair coefficients (eps kcal/mol, sigma A)\n")
        for (i, j, e, s) in coeffs:
            f.write(f"pair_coeff {i} {j} {e} {s}\n")
