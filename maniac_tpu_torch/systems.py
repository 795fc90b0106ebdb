"""Synthetic system builders (LAMMPS .data / .maniac / .inc writers).

Used by the test suite, benchmarks, and as user-facing examples.

The reference's example topologies live in an mc-topology submodule that is
not available, so tests generate their own systems: TIP4P/2005-like water,
NaCl rock salt (analytic Madelung anchor), LJ gas, and a synthetic
framework+guest adsorption system.
"""

from __future__ import annotations

import math
import os

import numpy as np

# TIP4P/2005 rigid water geometry/charges
R_OH = 0.9572
ANG_HOH = math.radians(104.52)
R_OM = 0.1546
Q_H = 0.5564
Q_M = -2 * Q_H
EPS_O = 0.1852   # kcal/mol
SIG_O = 3.1589   # Angstrom
MASS = {"O": 15.9994, "H": 1.008, "M": 0.0001, "Na": 22.99, "Cl": 35.453,
        "LJ": 39.948, "F": 12.011}


def water_sites() -> tuple[np.ndarray, np.ndarray, list]:
    """Returns (positions (4,3) relative to O, charges (4,), type slots)."""
    h1 = R_OH * np.array([math.sin(ANG_HOH / 2), 0.0, math.cos(ANG_HOH / 2)])
    h2 = R_OH * np.array([-math.sin(ANG_HOH / 2), 0.0, math.cos(ANG_HOH / 2)])
    m = R_OM * np.array([0.0, 0.0, 1.0])
    pos = np.stack([np.zeros(3), h1, h2, m])
    q = np.array([0.0, Q_H, Q_H, Q_M])
    return pos, q, ["O", "H", "H", "M"]


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


def make_water_box(outdir, n_water=8, L=14.0, seed=7, **deck_kw):
    """N rigid waters on a jittered grid in a cubic box."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sites, q, names = water_sites()
    per_axis = max(2, int(math.ceil(n_water ** (1 / 3))))
    spacing = L / per_axis
    centers = []
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                centers.append((-L / 2 + (np.array([i, j, k]) + 0.5) * spacing))
    centers = np.asarray(centers[:n_water])
    centers += rng.uniform(-0.15, 0.15, centers.shape) * spacing

    atoms = []
    type_of = {"O": 1, "H": 2, "M": 3}
    for m, c in enumerate(centers, 1):
        R = _random_rotation(rng)
        pos = c + sites @ R.T
        for a in range(4):
            atoms.append((m, type_of[names[a]], q[a], *pos[a]))

    masses = {1: MASS["O"], 2: MASS["H"], 3: MASS["M"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 3)
    residues = [dict(name="wat", active=True, fugacity=deck_kw.pop("fugacity", 50.0),
                     types=[1, 2, 3], names=["OW", "HW", "MW"], nb_atoms=4)]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc", [(1, 1, EPS_O, SIG_O),
                                            (2, 2, 0.0, 0.0),
                                            (3, 3, 0.0, 0.0)])
    return outdir


def make_spce_box(outdir, n_water=216, density=0.997, seed=41, **deck_kw):
    """Literature-parameter SPC/E water at a target mass density (g/cm^3).

    SPC/E (Berendsen, Grigera, Straatsma 1987): 3 sites, r_OH = 1.0 A,
    HOH = 109.47 deg (tetrahedral), q_O = -0.8476 e, q_H = +0.4238 e,
    O-O LJ eps = 0.15535 kcal/mol, sigma = 3.166 A. Used by the external
    validation anchor (scripts/validate_spce.py): Widom mu_ex at 298 K /
    0.997 g/cm^3 is published at -28..-30.5 kJ/mol (Widom/TI on SPC/E
    with Ewald; e.g. Hermans et al., Quintana & Haymet), i.e.
    -6.7..-7.3 kcal/mol."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ang = math.radians(109.47)
    h1 = 1.0 * np.array([math.sin(ang / 2), 0.0, math.cos(ang / 2)])
    h2 = 1.0 * np.array([-math.sin(ang / 2), 0.0, math.cos(ang / 2)])
    sites = np.stack([np.zeros(3), h1, h2])
    q = np.array([-0.8476, 0.4238, 0.4238])
    mass_w = 15.9994 + 2 * 1.008
    # box edge from the target density
    L = (n_water * mass_w / (density * 0.1 * 6.0221408)) ** (1.0 / 3.0)
    per_axis = max(2, int(math.ceil(n_water ** (1 / 3))))
    spacing = L / per_axis
    centers = []
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                centers.append(-L / 2 + (np.array([i, j, k]) + 0.5) * spacing)
    centers = np.asarray(centers[:n_water])
    centers += rng.uniform(-0.1, 0.1, centers.shape) * spacing
    atoms = []
    for m, c in enumerate(centers, 1):
        R = _random_rotation(rng)
        pos = c + sites @ R.T
        for a in range(3):
            atoms.append((m, 1 if a == 0 else 2, q[a], *pos[a]))
    masses = {1: 15.9994, 2: 1.008}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 2)
    residues = [dict(name="wat", active=True,
                     fugacity=deck_kw.pop("fugacity", 10.0),
                     types=[1, 2], names=["OW", "HW"], nb_atoms=3)]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc", [(1, 1, 0.15535, 3.166),
                                            (2, 2, 0.0, 0.0)])
    return outdir


def make_water_reservoir(outdir, n_water=16, L=20.0, seed=23):
    """A reservoir data file matching make_water_box's residue declaration
    (for the -r flag). Returns the file path."""
    rng = np.random.default_rng(seed)
    sites, q, names = water_sites()
    per_axis = max(2, int(math.ceil(n_water ** (1 / 3))))
    spacing = L / per_axis
    atoms = []
    type_of = {"O": 1, "H": 2, "M": 3}
    m = 0
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                if m >= n_water:
                    break
                m += 1
                c = -L / 2 + (np.array([i, j, k]) + 0.5) * spacing
                R = _random_rotation(rng)
                pos = c + sites @ R.T
                for a in range(4):
                    atoms.append((m, type_of[names[a]], q[a], *pos[a]))
    masses = {1: MASS["O"], 2: MASS["H"], 3: MASS["M"]}
    os.makedirs(outdir, exist_ok=True)
    path = f"{outdir}/reservoir.data"
    _write_data(path, L, atoms, masses, 3)
    return path


def make_nacl(outdir, n_cells=2, a=5.6402, **deck_kw):
    """Rock-salt NaCl, n_cells^3 conventional cells. Pure Coulomb (LJ=0)."""
    os.makedirs(outdir, exist_ok=True)
    L = n_cells * a
    na_frac = [(0, 0, 0), (0.5, 0.5, 0), (0.5, 0, 0.5), (0, 0.5, 0.5)]
    cl_frac = [(0.5, 0, 0), (0, 0.5, 0), (0, 0, 0.5), (0.5, 0.5, 0.5)]
    atoms = []
    mol = 0
    for frac, typ, q in ((na_frac, 1, 1.0), (cl_frac, 2, -1.0)):
        for i in range(n_cells):
            for j in range(n_cells):
                for k in range(n_cells):
                    for fx, fy, fz in frac:
                        mol += 1
                        x = -L / 2 + (i + fx) * a
                        y = -L / 2 + (j + fy) * a
                        z = -L / 2 + (k + fz) * a
                        atoms.append((mol, typ, q, x, y, z))
    masses = {1: MASS["Na"], 2: MASS["Cl"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 2)
    residues = [
        dict(name="na", active=True, fugacity=1.0, types=[1], names=["Na"], nb_atoms=1),
        dict(name="cl", active=True, fugacity=1.0, types=[2], names=["Cl"], nb_atoms=1),
    ]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc", [(1, 1, 0.0, 0.0), (2, 2, 0.0, 0.0)])
    return outdir


def make_lj_gas(outdir, n=32, L=18.0, seed=3, two_species=False, **deck_kw):
    """Single-site LJ particles, no charges (tests GCMC statistics/swaps)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    per_axis = max(2, int(math.ceil(n ** (1 / 3))))
    spacing = L / per_axis
    atoms = []
    m = 0
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                if m >= n:
                    break
                m += 1
                c = -L / 2 + (np.array([i, j, k]) + 0.5) * spacing \
                    + rng.uniform(-0.2, 0.2, 3)
                typ = 1 if (not two_species or m % 2) else 2
                atoms.append((m, typ, 0.0, *c))
    n_types = 2 if two_species else 1
    masses = {1: MASS["LJ"], 2: MASS["LJ"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, n_types)
    if two_species:
        residues = [
            dict(name="lja", active=True, fugacity=deck_kw.pop("fug_a", 2.0),
                 types=[1], names=["A"], nb_atoms=1),
            dict(name="ljb", active=True, fugacity=deck_kw.pop("fug_b", 2.0),
                 types=[2], names=["B"], nb_atoms=1),
        ]
        coeffs = [(1, 1, 0.2, 3.4), (2, 2, 0.3, 3.0)]
    else:
        residues = [dict(name="lj", active=True,
                         fugacity=deck_kw.pop("fugacity", 2.0),
                         types=[1], names=["A"], nb_atoms=1)]
        coeffs = [(1, 1, deck_kw.pop("eps", 0.2), deck_kw.pop("sig", 3.4))]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc", coeffs)
    return outdir


def make_lj_chain(outdir, n_atoms=6, n_mol=4, L=18.0, bond=1.2, seed=5,
                  **deck_kw):
    """Rigid linear chains of n_atoms uncharged LJ sites (one type). With
    n_atoms > 4 this exceeds the grouped kernel's 8-row LJ slab layout
    (2*Lmax > 8), exercising the ungrouped fallback."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    atoms = []
    per_axis = max(2, int(math.ceil(n_mol ** (1 / 3))))
    spacing = L / per_axis
    m = 0
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                if m >= n_mol:
                    break
                m += 1
                c = -L / 2 + (np.array([i, j, k]) + 0.5) * spacing
                R = _random_rotation(rng)
                axis = R @ np.array([1.0, 0.0, 0.0])
                for a in range(n_atoms):
                    p = c + (a - (n_atoms - 1) / 2) * bond * axis
                    atoms.append((m, 1, 0.0, *p))
    _write_data(f"{outdir}/topology.data", L, atoms, {1: MASS["LJ"]}, 1)
    residues = [dict(name="chn", active=True,
                     fugacity=deck_kw.pop("fugacity", 2.0),
                     types=[1], names=["A"], nb_atoms=n_atoms)]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc", [(1, 1, 0.2, 3.0)])
    return outdir


def make_triclinic_water(outdir, n_water=8, L=14.0, tilt=(2.0, 1.2, 0.8),
                         seed=7, **deck_kw):
    """N rigid waters in a TRICLINIC box (LAMMPS convention: a=(lx,0,0),
    b=(xy,ly,0), c=(xz,yz,lz)). Exercises the 27-image minimum-image path
    (reference: src/geometry_utils.f90:359-415) and the triclinic
    reciprocal lattice. tilt=(xy, xz, yz)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sites, q, names = water_sites()
    xy, xz, yz = tilt
    H = np.array([[L, xy, xz], [0.0, L, yz], [0.0, 0.0, L]])  # cols = a,b,c
    per_axis = max(2, int(math.ceil(n_water ** (1 / 3))))
    atoms = []
    type_of = {"O": 1, "H": 2, "M": 3}
    m = 0
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                if m >= n_water:
                    break
                m += 1
                frac = (np.array([i, j, k]) + 0.5) / per_axis \
                    + rng.uniform(-0.02, 0.02, 3)
                c = H @ frac + np.array([-L / 2, -L / 2, -L / 2])
                R = _random_rotation(rng)
                pos = c + sites @ R.T
                for a in range(4):
                    atoms.append((m, type_of[names[a]], q[a], *pos[a]))
    masses = {1: MASS["O"], 2: MASS["H"], 3: MASS["M"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 3,
                tilt=(xy, xz, yz))
    residues = [dict(name="wat", active=True,
                     fugacity=deck_kw.pop("fugacity", 50.0),
                     types=[1, 2, 3], names=["OW", "HW", "MW"], nb_atoms=4)]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc", [(1, 1, EPS_O, SIG_O),
                                            (2, 2, 0.0, 0.0),
                                            (3, 3, 0.0, 0.0)])
    return outdir


def make_framework_water(outdir, n_cells=3, a=8.0, n_water=12, seed=11,
                         **deck_kw):
    """Synthetic nanoporous framework (simple-cubic LJ lattice, one inactive
    rigid molecule) + water guests. Stand-in for the ZIF-8+H2O flagship."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = n_cells * a
    atoms = []
    # framework: one molecule, type 1 sites on an SC lattice with partial
    # charges alternating to exercise framework electrostatics
    fw_sites = []
    for i in range(n_cells):
        for j in range(n_cells):
            for k in range(n_cells):
                fw_sites.append((-L / 2 + np.array([i, j, k]) * a))
    nq = len(fw_sites)
    for idx, p in enumerate(fw_sites):
        qf = 0.4 if idx % 2 == 0 else -0.4
        if nq % 2 == 1 and idx == nq - 1:
            qf = 0.0  # keep the framework neutral
        atoms.append((1, 1, qf, *p))
    sites, q, names = water_sites()
    type_of = {"O": 2, "H": 3, "M": 4}
    taken = set()
    m = 1
    placed = 0
    while placed < n_water:
        cell = tuple(rng.integers(0, n_cells, 3))
        if cell in taken:
            continue
        taken.add(cell)
        c = -L / 2 + (np.asarray(cell) + 0.5) * a
        R = _random_rotation(rng)
        pos = c + sites @ R.T
        m += 1
        for aa in range(4):
            atoms.append((m, type_of[names[aa]], q[aa], *pos[aa]))
        placed += 1
    masses = {1: MASS["F"], 2: MASS["O"], 3: MASS["H"], 4: MASS["M"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 4)
    residues = [
        dict(name="fwk", active=False, types=[1], names=["F"],
             nb_atoms=len(fw_sites)),
        dict(name="wat", active=True, fugacity=deck_kw.pop("fugacity", 50.0),
             types=[2, 3, 4], names=["OW", "HW", "MW"], nb_atoms=4),
    ]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.3, 3.2), (2, 2, EPS_O, SIG_O),
                (3, 3, 0.0, 0.0), (4, 4, 0.0, 0.0)])
    return outdir


def make_zif_like(outdir, n_cells=6, a=5.66, atoms_per_cell=10, n_water=32,
                  seed=17, **deck_kw):
    """ZIF-8-scale synthetic adsorbent: ~2160 framework atoms in a ~34 A box
    (ZIF-8 reference scale: 2208 atoms, SURVEY.md section 2; the real
    mc-topology files are not available). Each cell carries a charged cage
    cluster at its center, leaving interstitial pores for water guests.
    This is the flagship benchmark system."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = n_cells * a
    atoms = []
    # cage cluster: cube corners (alternating charge) + 2 axial sites
    base = np.array([[sx, sy, sz] for sx in (-1.1, 1.1)
                     for sy in (-1.1, 1.1) for sz in (-1.1, 1.1)])
    extra = np.array([[0.0, 0.0, 1.9], [0.0, 0.0, -1.9]])
    cluster = np.vstack([base, extra])[:atoms_per_cell]
    qs = np.array([0.18 if i % 2 == 0 else -0.18
                   for i in range(len(cluster))])
    qs -= qs.mean()  # exact neutrality
    n_fw = 0
    for i in range(n_cells):
        for j in range(n_cells):
            for k in range(n_cells):
                c = -L / 2 + (np.array([i, j, k]) + 0.5) * a
                for s, qf in zip(cluster, qs):
                    n_fw += 1
                    atoms.append((1, 1, qf, *(c + s)))
    sites, q, names = water_sites()
    type_of = {"O": 2, "H": 3, "M": 4}
    # waters at cell-corner interstitials (pore space)
    corners = [(i, j, k) for i in range(n_cells) for j in range(n_cells)
               for k in range(n_cells)]
    rng.shuffle(corners)
    m = 1
    for cell in corners[:n_water]:
        c = -L / 2 + np.asarray(cell, dtype=float) * a
        R = _random_rotation(rng)
        pos = c + sites @ R.T
        m += 1
        for aa in range(4):
            atoms.append((m, type_of[names[aa]], q[aa], *pos[aa]))
    masses = {1: MASS["F"], 2: MASS["O"], 3: MASS["H"], 4: MASS["M"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 4)
    residues = [
        dict(name="zif", active=False, types=[1], names=["F"], nb_atoms=n_fw),
        dict(name="wat", active=True, fugacity=deck_kw.pop("fugacity", 30.0),
             types=[2, 3, 4], names=["OW", "HW", "MW"], nb_atoms=4),
    ]
    deck_kw.setdefault("cutoff", 8.5)
    deck_kw.setdefault("tol", 1e-5)
    deck_kw.setdefault("probs", (0.3, 0.2, 0.5, 0.0))
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.25, 3.0), (2, 2, EPS_O, SIG_O),
                (3, 3, 0.0, 0.0), (4, 4, 0.0, 0.0)])
    return outdir


def make_framework_mixed(outdir, n_cells=4, a=5.66, n_water=8, n_dimer=4,
                         seed=29, **deck_kw):
    """Framework + TWO active species of different sizes (4-site water and
    a 2-site charged dimer): stresses the static-framework split with
    multiple active types - active-pair LJ table blocks, swap moves under
    the split, and guest chunk ranges with a gap between the type blocks."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = n_cells * a
    atoms = []
    base = np.array([[sx, sy, sz] for sx in (-1.1, 1.1)
                     for sy in (-1.1, 1.1) for sz in (-1.1, 1.1)])
    qs = np.array([0.18 if i % 2 == 0 else -0.18 for i in range(len(base))])
    qs -= qs.mean()
    n_fw = 0
    for i in range(n_cells):
        for j in range(n_cells):
            for k in range(n_cells):
                c = -L / 2 + (np.array([i, j, k]) + 0.5) * a
                for s, qf in zip(base, qs):
                    n_fw += 1
                    atoms.append((1, 1, qf, *(c + s)))
    sites_w, q_w, names_w = water_sites()
    sites_d = np.array([[0.0, 0.0, -0.6], [0.0, 0.0, 0.6]])
    q_d = np.array([0.25, -0.25])
    type_of_w = {"O": 2, "H": 3, "M": 4}
    corners = [(i, j, k) for i in range(n_cells) for j in range(n_cells)
               for k in range(n_cells)]
    rng.shuffle(corners)
    m = 1
    for cell in corners[:n_water]:
        c = -L / 2 + np.asarray(cell, dtype=float) * a
        R = _random_rotation(rng)
        pos = c + sites_w @ R.T
        m += 1
        for aa in range(4):
            atoms.append((m, type_of_w[names_w[aa]], q_w[aa], *pos[aa]))
    for cell in corners[n_water:n_water + n_dimer]:
        c = -L / 2 + np.asarray(cell, dtype=float) * a
        R = _random_rotation(rng)
        pos = c + sites_d @ R.T
        m += 1
        for aa in range(2):
            atoms.append((m, 5 + aa, q_d[aa], *pos[aa]))
    masses = {1: MASS["F"], 2: MASS["O"], 3: MASS["H"], 4: MASS["M"],
              5: MASS["F"], 6: MASS["F"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 6)
    residues = [
        dict(name="zif", active=False, types=[1], names=["F"], nb_atoms=n_fw),
        dict(name="wat", active=True, fugacity=deck_kw.pop("fug_w", 60.0),
             types=[2, 3, 4], names=["OW", "HW", "MW"], nb_atoms=4),
        dict(name="dim", active=True, fugacity=deck_kw.pop("fug_d", 60.0),
             types=[5, 6], names=["DA", "DB"], nb_atoms=2),
    ]
    deck_kw.setdefault("cutoff", 6.0)
    deck_kw.setdefault("tol", 1e-5)
    deck_kw.setdefault("probs", (0.25, 0.15, 0.4, 0.2))
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.25, 3.0), (2, 2, EPS_O, SIG_O),
                (3, 3, 0.0, 0.0), (4, 4, 0.0, 0.0),
                (5, 5, 0.15, 3.2), (6, 6, 0.1, 3.0)])
    return outdir


def make_mixed_sizes(outdir, n_water=6, n_dimer=6, L=16.0, seed=13,
                     **deck_kw):
    """Two active species with DIFFERENT molecule sizes (4-site water +
    2-site charged dimer) - stresses swap moves between unequal footprints
    and per-type padding throughout the engine."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sites_w, q_w, names_w = water_sites()
    sites_d = np.array([[0.0, 0.0, -0.6], [0.0, 0.0, 0.6]])
    q_d = np.array([0.25, -0.25])
    atoms = []
    type_of_w = {"O": 1, "H": 2, "M": 3}
    n_total = n_water + n_dimer
    per_axis = max(2, int(math.ceil(n_total ** (1 / 3))))
    spacing = L / per_axis
    centers = []
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                centers.append(-L / 2 + (np.array([i, j, k]) + 0.5) * spacing)
    m = 0
    for c in centers[:n_water]:
        m += 1
        R = _random_rotation(rng)
        pos = c + sites_w @ R.T
        for a in range(4):
            atoms.append((m, type_of_w[names_w[a]], q_w[a], *pos[a]))
    for c in centers[n_water:n_total]:
        m += 1
        R = _random_rotation(rng)
        pos = c + sites_d @ R.T
        for a in range(2):
            atoms.append((m, 4 + a, q_d[a], *pos[a]))
    masses = {1: MASS["O"], 2: MASS["H"], 3: MASS["M"],
              4: MASS["F"], 5: MASS["F"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 5)
    residues = [
        dict(name="wat", active=True, fugacity=deck_kw.pop("fug_w", 200.0),
             types=[1, 2, 3], names=["OW", "HW", "MW"], nb_atoms=4),
        dict(name="dim", active=True, fugacity=deck_kw.pop("fug_d", 200.0),
             types=[4, 5], names=["DA", "DB"], nb_atoms=2),
    ]
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, EPS_O, SIG_O), (2, 2, 0.0, 0.0), (3, 3, 0.0, 0.0),
                (4, 4, 0.15, 3.2), (5, 5, 0.1, 3.0)])
    return outdir

def make_slit_pore(outdir, nx=5, ny=5, wall_layers=2, n_water=10,
                   Lxy=12.0, Lz=30.0, seed=19, **deck_kw):
    """Slit pore (analog of the reference run.sh SLIT case,
    reference run.sh:4-96): two rigid walls perpendicular to z, each
    its OWN inactive residue type, with water guests confined in the gap.

    Having TWO frozen residue types makes this the regression fixture for
    the fwsplit frozen-prefix alignment: the first wall's site region is
    128-padded, so the frozen prefix must end at the LAST frozen region's
    end, not at the raw frozen-site count (ADVICE r1, high)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    a = Lxy / nx
    zw = Lz / 2 - 2.0            # wall center planes at +-zw
    atoms = []

    def wall(z0, typ, mol_id, qmag):
        n = 0
        for layer in range(wall_layers):
            for i in range(nx):
                for j in range(ny):
                    q = qmag if (i + j + layer) % 2 == 0 else -qmag
                    atoms.append((mol_id, typ,  q,
                                  -Lxy / 2 + (i + 0.5) * a,
                                  -Lxy / 2 + (j + 0.5) * a,
                                  z0 + 1.4 * layer))
                    n += 1
        return n

    n_bot = wall(-zw, 1, 1, 0.20)
    n_top = wall(+zw - 1.4 * (wall_layers - 1), 2, 2, 0.20)
    # (even nx*ny*wall_layers -> each wall is exactly neutral)

    sites, q, names = water_sites()
    type_of = {"O": 3, "H": 4, "M": 5}
    m = 2
    z_free = zw - 1.4 * wall_layers - 2.0   # stay clear of both walls
    for _ in range(n_water):
        c = np.array([rng.uniform(-Lxy / 2 + 1, Lxy / 2 - 1),
                      rng.uniform(-Lxy / 2 + 1, Lxy / 2 - 1),
                      rng.uniform(-z_free, z_free)])
        R = _random_rotation(rng)
        pos = c + sites @ R.T
        m += 1
        for aa in range(4):
            atoms.append((m, type_of[names[aa]], q[aa], *pos[aa]))
    masses = {1: MASS["F"], 2: MASS["F"], 3: MASS["O"], 4: MASS["H"],
              5: MASS["M"]}
    _write_data(f"{outdir}/topology.data", (Lxy, Lxy, Lz), atoms, masses, 5)
    residues = [
        dict(name="walb", active=False, types=[1], names=["WB"],
             nb_atoms=n_bot),
        dict(name="walt", active=False, types=[2], names=["WT"],
             nb_atoms=n_top),
        dict(name="wat", active=True, fugacity=deck_kw.pop("fugacity", 80.0),
             types=[3, 4, 5], names=["OW", "HW", "MW"], nb_atoms=4),
    ]
    deck_kw.setdefault("cutoff", 5.5)
    deck_kw.setdefault("tol", 1e-5)
    deck_kw.setdefault("probs", (0.3, 0.2, 0.5, 0.0))
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.30, 3.2), (2, 2, 0.20, 3.0),
                (3, 3, EPS_O, SIG_O), (4, 4, 0.0, 0.0), (5, 5, 0.0, 0.0)])
    return outdir

def co2_sites() -> tuple[np.ndarray, np.ndarray, list]:
    """Rigid linear CO2 (EPM2-like): O=C=O along z, 1.163 A bonds."""
    pos = np.array([[0.0, 0.0, -1.163], [0.0, 0.0, 0.0],
                    [0.0, 0.0, 1.163]])
    q = np.array([-0.3256, 0.6512, -0.3256])
    return pos, q, ["OC", "C", "OC"]


def make_co2_box(outdir, n_co2=8, L=30.0, seed=23, **deck_kw):
    """N rigid EPM2 CO2 molecules in a cubic box (no framework).

    EPM2 (Harris & Yung, J. Phys. Chem. 99, 12021 (1995)): the literature
    parameter set - eps_C/k = 28.129 K, sig_C = 2.757 A, eps_O/k =
    80.507 K, sig_O = 3.033 A, q_C = +0.6512 e, r_CO = 1.149 A in the
    original; this repo's rigid template uses r_CO = 1.163 A
    (experimental bond length, co2_sites). Used by the external B2
    validation anchor (tests/test_validation.py) and available as a pure
    molecular-gas GCMC workload. seed=None places molecule 1 at the box
    center aligned with z (deterministic single-molecule geometry)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed if seed is not None else 0)
    sites, q, names = co2_sites()
    per_axis = max(1, int(math.ceil(n_co2 ** (1 / 3))))
    spacing = L / per_axis
    centers = []
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                centers.append(-L / 2 + (np.array([i, j, k]) + 0.5) * spacing)
    centers = np.asarray(centers[:n_co2], dtype=float)
    if seed is None:
        centers = np.zeros((n_co2, 3))
    atoms = []
    for m, c in enumerate(centers, 1):
        R = (np.eye(3) if seed is None else _random_rotation(rng))
        pos = c + sites @ R.T
        for aa, typ in enumerate((1, 2, 1)):                # O C O
            atoms.append((m, typ, q[aa], *pos[aa]))
    masses = {1: MASS["O"], 2: 12.011}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 2)
    residues = [dict(name="co2", active=True,
                     fugacity=deck_kw.pop("fugacity", 10.0),
                     types=[1, 2, 1], names=["OC", "C", "OC"], nb_atoms=3)]
    deck_kw.setdefault("cutoff", 10.0)
    deck_kw.setdefault("tol", 1e-5)
    deck_kw.setdefault("probs", (0.3, 0.2, 0.5, 0.0))
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    # EPM2 eps in kcal/mol: 80.507 K * KB = 0.15998, 28.129 K * KB = 0.05590
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.15998, 3.033), (2, 2, 0.05590, 2.757)])
    return outdir


def make_mfi_co2(outdir, n_cells=4, a=6.0, n_co2=8, seed=31, **deck_kw):
    """MFI-CO2 analog (reference run.sh MFI-CO2 case): zeolite-like charged
    framework + rigid LINEAR 3-site CO2 guests. Exercises A=3 linear
    molecules (rotation moves on a linear rotor, 3 LJ rows, 3 charged
    rows, a repeated atom type inside one residue) through the whole
    engine.

    The framework is TWO inactive single-atom residue types (F+ / F-):
    both the reference and this engine store charges per (residue type,
    atom) - simulation_state.f90:110-114 - so alternating charges inside
    one residue type would be silently replaced by the template charge;
    and single-atom framework molecules make the absolute-energy oracle
    comparison convention-free (the reference computes the intramolecular
    Ewald correction over ACTIVE molecules only,
    src/energy_utils.f90:55-81)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = n_cells * a
    atoms = []
    base = np.array([[sx, sy, sz] for sx in (-1.2, 1.2)
                     for sy in (-1.2, 1.2) for sz in (-1.2, 1.2)])
    n_fw = 0
    fw_pos = []
    for i in range(n_cells):
        for j in range(n_cells):
            for k in range(n_cells):
                c = -L / 2 + (np.array([i, j, k]) + 0.5) * a
                for si, s in enumerate(base):
                    n_fw += 1
                    typ = 1 if si % 2 == 0 else 2
                    qf = 0.2 if si % 2 == 0 else -0.2
                    fw_pos.append((typ, qf, c + s))
    # type-1 molecules first, then type-2 (matches the sorted residue
    # layout; the parser orders residues by minimum atom-type id)
    mid = 0
    for want in (1, 2):
        for typ, qf, p in fw_pos:
            if typ == want:
                mid += 1
                atoms.append((mid, typ, qf, *p))
    sites, q, _ = co2_sites()
    corners = [(i, j, k) for i in range(n_cells) for j in range(n_cells)
               for k in range(n_cells)]
    rng.shuffle(corners)
    m = mid
    for cell in corners[:n_co2]:
        c = -L / 2 + np.asarray(cell, dtype=float) * a
        R = _random_rotation(rng)
        pos = c + sites @ R.T
        m += 1
        # O C O -> types 3 4 3
        for aa, typ in enumerate((3, 4, 3)):
            atoms.append((m, typ, q[aa], *pos[aa]))
    masses = {1: MASS["F"], 2: MASS["F"], 3: MASS["O"], 4: 12.011}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 4)
    residues = [
        dict(name="mfip", active=False, types=[1], names=["FP"],
             nb_atoms=1),
        dict(name="mfim", active=False, types=[2], names=["FM"],
             nb_atoms=1),
        dict(name="co2", active=True, fugacity=deck_kw.pop("fugacity", 40.0),
             types=[3, 4, 3], names=["OC", "C", "OC"], nb_atoms=3),
    ]
    deck_kw.setdefault("cutoff", 7.0)
    deck_kw.setdefault("tol", 1e-5)
    deck_kw.setdefault("probs", (0.3, 0.2, 0.5, 0.0))
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    # EPM2-ish LJ (eps kcal/mol, sigma A)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.22, 3.0), (2, 2, 0.22, 3.0),
                (3, 3, 0.1599, 3.033), (4, 4, 0.0559, 2.757)])
    return outdir


def make_fw_ch4o_h2o(outdir, n_cells=4, a=5.8, n_water=6, n_meoh=6,
                     seed=37, **deck_kw):
    """CH4O-H2O analog (reference run.sh CH4O-H2O / ZIF8-CH4O-H2O cases):
    framework + TWO active adsorbates - 4-site water and a 3-site rigid
    methanol (CH3-O-H, two LJ sites) - co-adsorbing with swap moves."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = n_cells * a
    atoms = []
    base = np.array([[sx, sy, sz] for sx in (-1.1, 1.1)
                     for sy in (-1.1, 1.1) for sz in (-1.1, 1.1)])
    qs = np.array([0.15 if i % 2 == 0 else -0.15 for i in range(len(base))])
    qs -= qs.mean()
    n_fw = 0
    for i in range(n_cells):
        for j in range(n_cells):
            for k in range(n_cells):
                c = -L / 2 + (np.array([i, j, k]) + 0.5) * a
                for s, qf in zip(base, qs):
                    n_fw += 1
                    atoms.append((1, 1, qf, *(c + s)))
    sites_w, q_w, names_w = water_sites()
    # rigid methanol: CH3 - O - H (united-atom CH3), OPLS-like charges
    sites_m = np.array([[0.0, 0.0, 0.0],          # CH3
                        [0.0, 0.0, 1.43],          # O
                        [0.9, 0.0, 1.72]])         # H
    q_m = np.array([0.265, -0.700, 0.435])
    type_of_w = {"O": 2, "H": 3, "M": 4}
    corners = [(i, j, k) for i in range(n_cells) for j in range(n_cells)
               for k in range(n_cells)]
    rng.shuffle(corners)
    m = 1
    for cell in corners[:n_water]:
        c = -L / 2 + np.asarray(cell, dtype=float) * a
        R = _random_rotation(rng)
        pos = c + sites_w @ R.T
        m += 1
        for aa in range(4):
            atoms.append((m, type_of_w[names_w[aa]], q_w[aa], *pos[aa]))
    for cell in corners[n_water:n_water + n_meoh]:
        c = -L / 2 + np.asarray(cell, dtype=float) * a
        R = _random_rotation(rng)
        pos = c + sites_m @ R.T
        m += 1
        for aa, typ in enumerate((5, 6, 7)):
            atoms.append((m, typ, q_m[aa], *pos[aa]))
    masses = {1: MASS["F"], 2: MASS["O"], 3: MASS["H"], 4: MASS["M"],
              5: 15.035, 6: MASS["O"], 7: MASS["H"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 7)
    residues = [
        dict(name="zif", active=False, types=[1], names=["F"], nb_atoms=n_fw),
        dict(name="wat", active=True, fugacity=deck_kw.pop("fug_w", 60.0),
             types=[2, 3, 4], names=["OW", "HW", "MW"], nb_atoms=4),
        dict(name="meoh", active=True, fugacity=deck_kw.pop("fug_m", 40.0),
             types=[5, 6, 7], names=["CM", "OM", "HM"], nb_atoms=3),
    ]
    deck_kw.setdefault("cutoff", 6.5)
    deck_kw.setdefault("tol", 1e-5)
    deck_kw.setdefault("probs", (0.25, 0.15, 0.4, 0.2))
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.22, 3.0), (2, 2, EPS_O, SIG_O),
                (3, 3, 0.0, 0.0), (4, 4, 0.0, 0.0),
                (5, 5, 0.195, 3.75), (6, 6, 0.17, 3.02), (7, 7, 0.0, 0.0)])
    return outdir


def zif8_cell_sites(a=16.991):
    """Real-material ZIF-8 unit cell, Zn12(mIm)24 (mIm = 2-methylimidazolate).

    What is taken from PUBLISHED crystallography (Park et al., PNAS 103,
    10186 (2006): ZIF-8, sodalite topology, space group I-43m, a = 16.991 A):
      - the cubic cell constant a = 16.991 A,
      - the Zn sublattice: the 12 tetrahedral T-sites of the sodalite net,
        Wyckoff 12d of I-43m (permutations of (1/4, 1/2, 0) plus body
        centering), giving the published Zn...Zn distance of ~6.0 A,
      - standard published bond lengths for the Zn/imidazolate coordination
        (Zn-N 1.987 A; imidazolate ring N-C2 1.34, N-C4/C5 1.38, C4-C5
        1.36, C2-CH3 1.49, ring C-H 1.08 A).

    What is IDEALIZED (documented divergence from the deposited structure,
    whose full fractional coordinates are not available offline): each
    2-methylimidazolate bridges a Zn...Zn edge with its two N atoms ON the
    edge axis and a planar ring in a deterministically chosen plane; the
    real structure tilts/swings the rings. Self-checks below guard the
    construction: every Zn gets exactly 4 equidistant Zn neighbors
    (~6.008 A), 24 edges = 24 linkers, and the crystal density evaluates
    to 0.9245 g/cm^3 - which IS the published crystallographic density,
    since it follows from the published cell constant and the Zn12(mIm)24
    cell formula alone (both exact here).

    Returns (positions (204, 3) in A, element labels). Elements: Zn, N,
    C (ring C2/C4/C5), E (united-atom methyl), H (ring H4/H5).
    """
    # Zn: sodalite T-sites (12d of I-43m)
    frac = []
    for p in ((0.25, 0.5, 0.0), (0.0, 0.25, 0.5), (0.5, 0.0, 0.25),
              (0.75, 0.5, 0.0), (0.0, 0.75, 0.5), (0.5, 0.0, 0.75)):
        frac.append(p)
        frac.append(tuple((c + 0.5) % 1.0 for c in p))
    zn = (np.asarray(frac) - 0.5) * a          # centered cell, (12, 3)

    def mimg(d):
        return d - a * np.round(d / a)

    # edges: nearest-neighbor Zn pairs (4 per Zn -> 24 edges)
    edges = []
    for i in range(12):
        for j in range(i + 1, 12):
            if np.linalg.norm(mimg(zn[j] - zn[i])) < 0.40 * a:
                edges.append((i, j))
    assert len(edges) == 24, f"expected 24 Zn-Zn edges, got {len(edges)}"

    r_znn, r_nc2, r_nc45, r_c45, r_cme, r_ch = (1.987, 1.34, 1.38, 1.36,
                                                1.49, 1.08)
    pos, elem = [list(zn), ["Zn"] * 12]
    for (i, j) in edges:
        d = mimg(zn[j] - zn[i])
        zz = np.linalg.norm(d)
        u = d / zz
        mid = zn[i] + 0.5 * d
        half_nn = 0.5 * (zz - 2.0 * r_znn)     # N on the Zn..Zn axis
        y2 = math.sqrt(r_nc2 ** 2 - half_nn ** 2)
        x45 = 0.5 * r_c45
        y45 = math.sqrt(r_nc45 ** 2 - (half_nn - x45) ** 2)
        # deterministic ring plane: the methyl (the linker's big
        # protrusion, at y2+r_cme along +v) lines the cage WALL, as in
        # the real structure - pick the in-plane angle whose methyl
        # position maximizes the min-image distance to the SOD cage
        # centers (bcc lattice points: (0,0,0) and (a/2,a/2,a/2) in
        # this centered cell). A coordinate-axis v (the previous rule)
        # pointed half the methyls INTO the pores, costing ~1/3 of the
        # measured micropore volume.
        w1 = np.zeros(3)
        w1[np.argmin(np.abs(u))] = 1.0
        w1 -= (w1 @ u) * u
        w1 /= np.linalg.norm(w1)
        w2 = np.cross(u, w1)
        cage_c = np.array([[0.0, 0.0, 0.0], [0.5 * a] * 3])
        best, v = -1.0, w1
        for th in np.linspace(0.0, 2.0 * np.pi, 48, endpoint=False):
            cand = np.cos(th) * w1 + np.sin(th) * w2
            me = mid + (y2 + r_cme) * cand
            dmin = min(np.linalg.norm(mimg(c - me)) for c in cage_c)
            if dmin > best + 1e-9:
                best, v = dmin, cand
        ring = [(-half_nn, 0.0, "N"), (half_nn, 0.0, "N"),
                (0.0, y2, "C"), (x45, -y45, "C"), (-x45, -y45, "C"),
                (0.0, y2 + r_cme, "E")]
        cen = np.array([0.0, (y2 - 2 * y45) / 5.0])      # ring centroid
        for (x45s, y45s) in ((x45, -y45), (-x45, -y45)):  # ring H on C4/C5
            out = np.array([x45s, y45s]) - cen
            out /= np.linalg.norm(out)
            ring.append((x45s + r_ch * out[0], y45s + r_ch * out[1], "H"))
        for (cu, cv, el) in ring:
            pos.append(mid + cu * u + cv * v)
            elem.append(el)
    return np.asarray(pos), elem


def make_zif8(outdir, n_cells=1, seed=23, n_guest=8, **deck_kw):
    """Real-material validation case: Ar GCMC in ZIF-8 at 87.3 K, 1 atm.

    Structure: zif8_cell_sites (published cell + Zn sublattice, idealized
    linkers - see its docstring). Framework LJ from UFF (Rappe et al.,
    JACS 114, 10024 (1992); eps kcal/mol, sigma = x_vdw/2^(1/6) A):
    C 0.105/3.431, N 0.069/3.261, H 0.044/2.571, Zn 0.124/2.462; the
    methyl group is a TraPPE-UA CH3 (Martin & Siepmann 1998: eps/k = 98 K,
    sigma = 3.75 A). Guest: LJ argon (eps/k = 119.8 K, sigma = 3.405 A).
    All charges zero: this is the standard neutral-framework LJ model
    class used for rare-gas adsorption; the validation target is a
    STRUCTURAL observable (micropore volume), not an electrostatic one.

    Published anchor (tests/test_validation.py, BASELINE.md): ZIF-8's
    micropore volume is very widely reported at ~0.6-0.7 cm^3/g (N2/Ar
    porosimetry, e.g. Park et al. PNAS 2006 and the ZIF-8 literature
    at large). Saturation Ar uptake at 87.3 K / 1 atm converted by the
    Gurvich rule (liquid Ar molar volume 28.7 cm^3/mol at 87 K) must
    land in that range.
    """
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    a = 16.991
    cell_pos, cell_elem = zif8_cell_sites(a)
    L = n_cells * a
    atoms = []
    type_of = {"Zn": 1, "N": 2, "C": 3, "E": 4, "H": 5}
    n_fw = 0
    for ci in range(n_cells):
        for cj in range(n_cells):
            for ck in range(n_cells):
                off = -L / 2 + a * (np.array([ci, cj, ck]) + 0.5)
                for p, el in zip(cell_pos, cell_elem):
                    n_fw += 1
                    atoms.append((1, type_of[el], 0.0, *(p + off)))
    # initial Ar guests near sodalite cage centers: the SOD cages sit at
    # the cell corners AND body centers; spread guests over them with
    # jitter, rejecting placements that clash with the framework or each
    # other (clean f32 starting energies)
    fw_xyz = np.asarray([at[3:] for at in atoms])
    cages = []
    for ci in range(n_cells):
        for cj in range(n_cells):
            for ck in range(n_cells):
                base = np.array([ci, cj, ck], dtype=float)
                cages.append(base)
                cages.append(base + 0.5)
    placed = []
    m = 1
    for t in range(200):
        if len(placed) >= n_guest:
            break
        c = (-L / 2 + a * cages[t % len(cages)]
             + rng.uniform(-2.0, 2.0, 3))
        c -= L * np.round(c / L)
        dfw = fw_xyz - c
        dfw -= L * np.round(dfw / L)
        if np.min(np.sum(dfw * dfw, axis=1)) < 3.2 ** 2:
            continue
        if placed:
            dg = np.asarray(placed) - c
            dg -= L * np.round(dg / L)
            if np.min(np.sum(dg * dg, axis=1)) < 3.4 ** 2:
                continue
        placed.append(c)
        m += 1
        atoms.append((m, 6, 0.0, *c))
    masses = {1: 65.38, 2: 14.007, 3: 12.011, 4: 15.035, 5: 1.008,
              6: MASS["LJ"]}
    _write_data(f"{outdir}/topology.data", L, atoms, masses, 6)
    residues = [
        dict(name="zif8", active=False, types=[1, 2, 3, 4, 5],
             names=["Zn", "N", "C", "E", "H"], nb_atoms=n_fw),
        dict(name="ar", active=True, fugacity=deck_kw.pop("fugacity", 1.0),
             types=[6], names=["Ar"], nb_atoms=1),
    ]
    deck_kw.setdefault("temp", 87.3)
    deck_kw.setdefault("cutoff", min(8.49, L / 2 - 0.01))
    deck_kw.setdefault("tol", 1e-4)
    deck_kw.setdefault("probs", (0.2, 0.0, 0.8, 0.0))
    deck_kw.setdefault("tstep", 0.5)
    _write_deck(f"{outdir}/input.maniac", residues, **deck_kw)
    _write_inc(f"{outdir}/parameters.inc",
               [(1, 1, 0.124, 2.462), (2, 2, 0.069, 3.261),
                (3, 3, 0.105, 3.431), (4, 4, 0.19475, 3.75),
                (5, 5, 0.044, 2.571), (6, 6, 0.23808, 3.405)])
    return outdir


def tiny_system(outdir, shape: str):
    """Tiny instance of each distinct execution regime the engine serves -
    used by the multi-chip dryrun (__graft_entry__.dryrun_multichip) and
    the sharded-program HLO tests: flagship (framework + single active
    species, fw-split eligible), mixed (framework + TWO active species
    incl. swap moves), resv (reservoir insertions), tricl (27-image
    triclinic min-image). Returns (deck, data, inc, reservoir-or-None)
    file paths."""
    res_file = None
    if shape == "flagship":
        make_zif_like(outdir, n_cells=2, a=5.66, atoms_per_cell=4,
                      n_water=4, cutoff=5.0, tol=1e-3)
    elif shape == "mixed":
        make_framework_mixed(outdir, n_cells=2, a=5.66, n_water=3,
                             n_dimer=2, cutoff=5.0, tol=1e-3,
                             probs=(0.25, 0.15, 0.4, 0.2))
    elif shape == "resv":
        make_water_box(outdir, n_water=4, L=12.0, cutoff=5.0, tol=1e-3,
                       probs=(0.3, 0.2, 0.5, 0.0), fugacity=2000.0)
        res_file = make_water_reservoir(outdir, n_water=8, L=12.0)
    elif shape == "tricl":
        make_triclinic_water(outdir, n_water=4, L=12.0, tilt=(1.2, 0.8, 0.5),
                             cutoff=4.5, tol=1e-3,
                             probs=(0.3, 0.2, 0.5, 0.0), fugacity=2000.0)
    else:
        raise ValueError(f"unknown tiny system shape: {shape}")
    return (f"{outdir}/input.maniac", f"{outdir}/topology.data",
            f"{outdir}/parameters.inc", res_file)
