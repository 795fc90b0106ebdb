"""Parser for LAMMPS ``.data`` topology files (atom_style full, units real).

Host-side numpy. Pipeline mirrors the reference data parser
(reference: src/data_parser.f90:69-185 ReadLMPData):

header counts -> box bounds/tilt -> masses -> atoms (sorted by original id)
-> bonds/angles/dihedrals/impropers -> residue pattern detection -> molecule
detection -> PBC repair of active molecules -> COM + site-offset transform
-> per-residue bonded templates (used only to write restart topology files).

Documented divergences from the reference:
* The reference computes the molecule "center of mass" with a scalar mass
  accidentally broadcast over all atoms (src/data_parser.f90:1424-1432), i.e.
  an unweighted centroid. We reproduce the *centroid* on purpose (it is a
  gauge choice - absolute atom positions, and hence all energies, are
  unaffected) and note it here.
* The reference rejects boxes whose bounds are numerically ~0 (e.g. "0 50
  xlo xhi", src/readers_utils.f90:220-230). We only reject boxes whose bound
  lines are genuinely absent.
* Masses are mapped to residue sites by atom-type lookup rather than by the
  reference's sequential-fill (src/data_parser.f90:267-278), which assumes
  atom types are contiguous per residue; the two agree on all valid inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry import Box, apply_pbc, build_box, min_image_delta
from ..io.deck import InputDeck
from ..utils.errors import ManiacError
from ..utils.logger import Logger, default_logger

_HEADER_KEYS = [
    # (substring, attr) - order matters: longer keys first so "atom types"
    # is not swallowed by "atoms" etc.
    ("atom types", "num_atomtypes"),
    ("bond types", "num_bondtypes"),
    ("angle types", "num_angletypes"),
    ("dihedral types", "num_dihedraltypes"),
    ("improper types", "num_impropertypes"),
    ("atoms", "num_atoms"),
    ("bonds", "num_bonds"),
    ("angles", "num_angles"),
    ("dihedrals", "num_dihedrals"),
    ("impropers", "num_impropers"),
]

_SECTION_NAMES = {
    "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
    "Impropers", "Pair Coeffs", "Bond Coeffs", "Angle Coeffs",
    "Dihedral Coeffs", "Improper Coeffs",
}


@dataclass
class ParsedSystem:
    """One parsed LAMMPS data file, grouped into rigid molecules."""

    box: Box
    num_atoms: int = 0
    num_atomtypes: int = 0
    num_bonds: int = 0
    num_bondtypes: int = 0
    num_angles: int = 0
    num_angletypes: int = 0
    num_dihedrals: int = 0
    num_dihedraltypes: int = 0
    num_impropers: int = 0
    num_impropertypes: int = 0
    masses_by_type: np.ndarray = None          # (num_atomtypes+1,), 1-based
    # per residue type r (ordering = deck.residues):
    n_mol: list[int] = field(default_factory=list)
    mol_com: list[np.ndarray] = field(default_factory=list)      # (n,3)
    site_offset: list[np.ndarray] = field(default_factory=list)  # (n,A,3)
    atom_types: list[np.ndarray] = field(default_factory=list)   # (A,)
    atom_charges: list[np.ndarray] = field(default_factory=list)  # (A,)
    atom_names: list[list[str]] = field(default_factory=list)
    atom_masses: list[np.ndarray] = field(default_factory=list)  # (A,)
    # bonded templates per residue: (count, 1+k) arrays [type, local ids...]
    bonds: list[np.ndarray] = field(default_factory=list)
    angles: list[np.ndarray] = field(default_factory=list)
    dihedrals: list[np.ndarray] = field(default_factory=list)
    impropers: list[np.ndarray] = field(default_factory=list)


def parse_lammps_data(path: str, deck: InputDeck,
                      logger: Logger | None = None,
                      is_primary: bool = True) -> ParsedSystem:
    logger = logger or default_logger()
    with open(path) as fh:
        lines = fh.read().splitlines()

    counts = _read_header(lines)
    box = _parse_box(lines, logger)
    sys = ParsedSystem(box=box, **counts)
    sys.masses_by_type = _read_masses(lines, sys, logger)

    atoms = _read_atoms(lines, sys, path, logger)
    bonds = _read_connectivity(lines, "Bonds", sys.num_bonds, 2, path, logger)
    angles = _read_connectivity(lines, "Angles", sys.num_angles, 3, path, logger)
    dihedrals = _read_connectivity(lines, "Dihedrals", sys.num_dihedrals, 4, path, logger)
    impropers = _read_connectivity(lines, "Impropers", sys.num_impropers, 4, path, logger)

    # sort by original atom id (stable)
    order = np.argsort(atoms["id"], kind="stable")
    for key in atoms:
        atoms[key] = atoms[key][order]

    patterns = _detect_patterns(deck, atoms["type"])
    molecules = _detect_molecules(deck, atoms, patterns, sys, logger)
    _repair_active(deck, atoms, molecules, box, logger)
    _transform_coordinates(deck, atoms, molecules, sys, logger, is_primary)
    _detect_bonded_templates(deck, sys, bonds, angles, dihedrals, impropers)
    _check_molecules(deck, sys, logger)
    return sys


# --------------------------------------------------------------------------
# header / box / masses
# --------------------------------------------------------------------------

def _read_header(lines) -> dict:
    counts = {attr: 0 for _, attr in _HEADER_KEYS}
    found = set()
    for line in lines:
        t = line.strip()
        if not t or t.startswith(("!", "#")):
            continue
        for key, attr in _HEADER_KEYS:
            if key in t and attr not in found:
                toks = t.split()
                try:
                    val = int(toks[0])
                except (ValueError, IndexError):
                    continue
                counts[attr] = val
                found.add(attr)
                break
    return counts


def _parse_box(lines, logger: Logger) -> Box:
    bounds = np.zeros((3, 2))
    tilt = np.zeros(3)
    seen = [False, False, False]
    triclinic = False
    axes = {("xlo", "xhi"): 0, ("ylo", "yhi"): 1, ("zlo", "zhi"): 2}
    for line in lines:
        toks = line.split()
        if len(toks) >= 4 and (toks[2], toks[3]) in axes:
            try:
                lo, hi = float(toks[0]), float(toks[1])
            except ValueError:
                continue
            dim = axes[(toks[2], toks[3])]
            bounds[dim] = (lo, hi)
            seen[dim] = True
        elif len(toks) >= 6 and toks[3:6] == ["xy", "xz", "yz"]:
            try:
                tilt[:] = [float(toks[0]), float(toks[1]), float(toks[2])]
            except ValueError:
                continue
            triclinic = True
    names = ["xlo xhi", "ylo yhi", "zlo zhi"]
    for dim in range(3):
        if not seen[dim]:
            logger.abort(f"ParseLAMMPSBox: {names[dim]} not found in input file!")
    return build_box(bounds, tilt if triclinic else None)


def _find_section(lines, name: str) -> int:
    for i, line in enumerate(lines):
        if line.strip().split("#")[0].strip() == name:
            return i
    return -1


def _read_masses(lines, sys: ParsedSystem, logger: Logger) -> np.ndarray:
    start = _find_section(lines, "Masses")
    masses = np.zeros(sys.num_atomtypes + 1)
    found = 0
    if start >= 0:
        for line in lines[start + 1:]:
            t = line.strip()
            if not t:
                if found:
                    break
                continue
            toks = t.split()
            try:
                tid = int(toks[0])
                mass = float(toks[1])
            except (ValueError, IndexError):
                break
            if not (1 <= tid <= sys.num_atomtypes):
                break
            masses[tid] = mass
            found += 1
    if found == 0:
        logger.abort("No masses found in data file", 12)
    if found != sys.num_atomtypes:
        logger.abort(
            "Number of masses found in data file differs from declared atom types", 13)
    return masses


# --------------------------------------------------------------------------
# atoms & connectivity sections
# --------------------------------------------------------------------------

def _read_atoms(lines, sys: ParsedSystem, path: str, logger: Logger) -> dict:
    start = -1
    for i, line in enumerate(lines):
        if line.lstrip().startswith("Atoms"):
            start = i
            break
    if start < 0:
        logger.abort(f"No atoms found in data file: {path}", 13)

    n = sys.num_atoms
    ids = np.zeros(n, dtype=np.int64)
    mols = np.zeros(n, dtype=np.int64)
    types = np.zeros(n, dtype=np.int64)
    charges = np.zeros(n)
    xyz = np.zeros((n, 3))

    k = 0
    i = start + 1
    while k < n:
        if i >= len(lines):
            logger.abort(
                f"Unexpected end of file at atom line {k + 1} in: {path}", 14)
        t = lines[i].strip()
        i += 1
        if not t:
            if k:
                logger.abort(
                    f"Unexpected end of file at atom line {k + 1} in: {path}", 14)
            continue
        toks = t.split()
        try:
            ids[k] = int(toks[0])
            mols[k] = int(toks[1])
            types[k] = int(toks[2])
            charges[k] = float(toks[3])
            xyz[k] = [float(toks[4]), float(toks[5]), float(toks[6])]
        except (ValueError, IndexError):
            logger.abort(f"Failed to parse atom line: '{t}' in: {path}", 15)
        if not (1 <= types[k] <= sys.num_atomtypes):
            logger.abort(
                f"Invalid atom type {types[k]} (max allowed: "
                f"{sys.num_atomtypes}) in: {path}", 16)
        k += 1
    return {"id": ids, "mol": mols, "type": types, "charge": charges, "xyz": xyz}


def _read_connectivity(lines, name: str, count: int, width: int,
                       path: str, logger: Logger) -> np.ndarray:
    """Read `count` entries of `id type a1..ak` from section `name`."""
    out = np.zeros((count, width + 2), dtype=np.int64)
    if count == 0:
        return out
    start = _find_section(lines, name)
    if start < 0:
        logger.abort(f"No {name.lower()} found in data file: {path}", 24)
    k = 0
    i = start + 1
    while k < count:
        if i >= len(lines):
            logger.abort(
                f"Unexpected end of file at {name.lower()} line {k + 1} in: {path}", 24)
        t = lines[i].strip()
        i += 1
        if not t:
            if k:
                logger.abort(
                    f"Unexpected end of file at {name.lower()} line {k + 1} in: {path}", 24)
            continue
        toks = t.split()
        try:
            out[k] = [int(x) for x in toks[: width + 2]]
        except (ValueError, IndexError):
            logger.abort(f"Failed to parse {name.lower()} line: '{t}' in: {path}", 25)
        k += 1
    return out


# --------------------------------------------------------------------------
# molecule detection & coordinate transform
# --------------------------------------------------------------------------

def _detect_patterns(deck: InputDeck, types: np.ndarray) -> list[np.ndarray]:
    """Per-residue atom-type signature, e.g. TIP4P = [1,2,3,3]
    (reference: DetectResiduePattern, src/data_parser.f90:1141-1181)."""
    type_owner = {}
    for r, res in enumerate(deck.residues):
        for t in res.types:
            type_owner[t] = r
    patterns = [np.zeros(res.nb_atoms, dtype=np.int64) for res in deck.residues]
    cursor = [0] * len(deck.residues)
    filled = [0] * len(deck.residues)
    for t in types:
        r = type_owner.get(int(t))
        if r is None:
            continue
        patterns[r][cursor[r]] = t
        filled[r] = max(filled[r], cursor[r] + 1)
        cursor[r] = (cursor[r] + 1) % deck.residues[r].nb_atoms
    return patterns


def _detect_molecules(deck, atoms, patterns, sys: ParsedSystem,
                      logger: Logger) -> list[list[np.ndarray]]:
    """Group the sorted atom stream into molecule instances per residue type
    (reference: DetectMolecules, src/data_parser.f90:1205-1287). Returns, per
    residue type, the list of atom-index arrays (into the sorted stream)."""
    n = len(atoms["type"])
    molecules: list[list[np.ndarray]] = []
    sys.__dict__["_template_ids"] = [None] * len(deck.residues)
    for r, res in enumerate(deck.residues):
        A = res.nb_atoms
        mols = []
        k = 0
        while k < n:
            if atoms["type"][k] == patterns[r][0]:
                if k + A > n:
                    logger.abort(
                        "Not enough atoms left in box to complete residue type "
                        + res.name)
                idx = np.arange(k, k + A)
                if res.active and not np.array_equal(atoms["type"][idx], patterns[r]):
                    logger.abort("Issue with atom order in data file")
                mols.append(idx)
                k += A
            else:
                k += 1
        molecules.append(mols)
        sys.n_mol.append(len(mols))
        if mols:
            last = mols[-1]
            sys.__dict__["_template_ids"][r] = atoms["id"][last].copy()
            sys.atom_types.append(atoms["type"][last].copy())
            sys.atom_charges.append(atoms["charge"][last].copy())
            sys.atom_names.append(_names_for(deck, r, atoms["type"][last]))
        else:
            # residue declared in the deck but absent from this data file
            sys.atom_types.append(np.asarray(
                _template_types(deck.residues[r], patterns[r]), dtype=np.int64))
            sys.atom_charges.append(np.zeros(A))
            sys.atom_names.append(_names_for(deck, r, sys.atom_types[-1]))
        sys.atom_masses.append(sys.masses_by_type[sys.atom_types[-1]])
    return molecules


def _template_types(res, pattern) -> np.ndarray:
    if np.any(pattern > 0):
        return pattern
    # fall back to declared types (cycled) when no atom of this residue exists
    reps = -(-res.nb_atoms // max(len(res.types), 1))
    return np.asarray((res.types * reps)[: res.nb_atoms], dtype=np.int64)


def _names_for(deck, r, types) -> list[str]:
    res = deck.residues[r]
    lut = {t: (res.names[i] if i < len(res.names) else "Unknown")
           for i, t in enumerate(res.types)}
    return [lut.get(int(t), "Unknown") for t in types]


def _repair_active(deck, atoms, molecules, box: Box, logger: Logger) -> None:
    """Unwrap active molecules split across periodic boundaries
    (reference: RepairMolecule, src/readers_utils.f90:258-315)."""
    xyz = atoms["xyz"]
    for r, res in enumerate(deck.residues):
        if not res.active:
            continue
        for idx in molecules[r]:
            pos = xyz[idx]
            for a in range(1, len(idx)):
                delta = min_image_delta(pos[a] - pos[a - 1], box)
                pos[a] = pos[a - 1] + delta
            d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
            iu = np.triu_indices(len(idx), k=1)
            if len(iu[0]):
                if np.any(d[iu] > 10.0):
                    logger.warn(
                        "Unusually large distance (> 1 nm) detected in active residue")
                if np.any(d[iu] < 1e-5):
                    logger.warn("Overlapping atoms detected in molecule")
            xyz[idx] = pos


def _transform_coordinates(deck, atoms, molecules, sys: ParsedSystem,
                           logger: Logger, is_primary: bool) -> None:
    """Store molecules as wrapped centroid + site offsets
    (reference: TransformCoordinate, src/data_parser.f90:1386-1511)."""
    box = sys.box
    for r, res in enumerate(deck.residues):
        coms = np.zeros((sys.n_mol[r], 3))
        offsets = np.zeros((sys.n_mol[r], res.nb_atoms, 3))
        for m, idx in enumerate(molecules[r]):
            pos = atoms["xyz"][idx]
            com = pos.mean(axis=0)  # centroid; see module docstring
            if not np.all(np.isfinite(com)):
                logger.abort("Invalid (NaN/Inf) CoM detected in residue")
            wrapped = apply_pbc(com, box)
            if np.any(wrapped < box.bounds[:, 0]) or np.any(wrapped > box.bounds[:, 1]):
                logger.warn("Molecule COM outside simulation box")
            if res.active and np.min(np.linalg.norm(pos - com, axis=1)) > 10.0:
                logger.warn("CoM unusually far from all atoms in residue type")
            coms[m] = wrapped
            offsets[m] = pos - com
        sys.mol_com.append(coms)
        sys.site_offset.append(offsets)
        if sys.n_mol[r] == 0 and not res.active and is_primary:
            logger.abort(
                f"Inactive residue '{res.name}' (ID={r + 1}) defined in input "
                "file but not present in data file.", 1)


def _detect_bonded_templates(deck, sys: ParsedSystem, bonds, angles,
                             dihedrals, impropers) -> None:
    """Map global connectivity onto per-residue local indices; used only to
    write restart topology files (reference: Detect*PerResidue,
    src/data_parser.f90:320-550)."""
    # reference uses the atom ids of the LAST detected molecule as template
    last_ids = sys.__dict__.get("_template_ids", [None] * len(deck.residues))
    for conn, out_list, k in ((bonds, sys.bonds, 2), (angles, sys.angles, 3),
                              (dihedrals, sys.dihedrals, 4), (impropers, sys.impropers, 4)):
        for r in range(len(deck.residues)):
            ids = last_ids[r]
            if ids is None:
                out_list.append(np.zeros((0, k + 1), dtype=np.int64))
                continue
            lut = {int(a): i + 1 for i, a in enumerate(ids)}
            rows = []
            for row in conn:
                locals_ = [lut.get(int(a)) for a in row[2: 2 + k]]
                if any(x is None for x in locals_):
                    continue
                if locals_[0] > locals_[-1]:
                    locals_ = locals_[::-1]
                rows.append([int(row[1])] + locals_)
            out_list.append(np.asarray(rows, dtype=np.int64).reshape(-1, k + 1))


def _check_molecules(deck, sys: ParsedSystem, logger: Logger) -> None:
    """Reference: CheckMolecule (src/check_utils.f90:10-49)."""
    for r, res in enumerate(deck.residues):
        if res.active and sys.n_mol[r] > 0:
            if np.any(np.abs(sys.site_offset[r]) > 10.0):
                logger.warn(
                    "One of the active molecules has an offset larger than 1 nanometer.")
                raise ManiacError("active molecule offset > 10 A", 3)
