"""Output writers: trajectory, energy/count/move series, restart topology.

Formats mirror the reference so downstream tooling and the black-box tests
keep working (reference: src/write_utils.f90):

* ``trajectory.lammpstrj`` - LAMMPS dump; one frame per block
* ``reservoir.lammpstrj`` - the reservoir's frames, with ``-r``
* ``energy.dat`` - 7 columns, kcal/mol
* ``number_<RES>.dat`` - per active species population series
* ``moves.dat`` - trial/accepted counts per move type
* ``topology.data`` - full restart-capable LAMMPS data file
* ``widom.dat`` - the Widom insertion factors and mu_ex, with ``--widom``

Counterpart of maniac_tpu/io/writers.py, line for line the same formats;
``snapshot`` reads one replica of a batched torch state to the host.

Documented divergences:
* The reference writes the current *input* nb_block as every frame's
  TIMESTEP (src/write_utils.f90:45-46) and box bounds as +-L/2 regardless of
  the actual bounds (:50-52). We write the actual block index and the actual
  bounds.
* The reference's moves.dat declares 11 columns but writes 9, with the
  Rotate_Moves column receiving the deletion counter
  (src/write_utils.f90:173-185). We write the full, correct 11 columns
  (swap replaces the never-implemented "BigMove").
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..constants import KB_KCALMOL, TYPE_CREATION, TYPE_DELETION, \
    TYPE_ROTATION, TYPE_SWAP, TYPE_TRANSLATION
from ..geometry import Box, wrap_centered
from ..io.deck import InputDeck
from ..io.lammps_data import ParsedSystem
from ..system import E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF, E_TOT
from ..utils.logger import Logger


@dataclass
class HostSnapshot:
    """Host-side numpy view of one replica's dynamic state."""

    n_mol: np.ndarray                 # (R,)
    com: list[np.ndarray]             # per type (n, 3)
    offset: list[np.ndarray]          # per type (n, A, 3)
    energy: np.ndarray                # (6,) Kelvin
    counters: np.ndarray              # (2,5)
    trans_step: float
    rot_step: float


def snapshot(spec, state, replica: int = 0,
             reservoir: bool = False) -> HostSnapshot:
    """Pull one replica of a batched state to the host, unpacked per
    residue type; ``reservoir=True`` unpacks the reservoir instead."""
    def get(x):
        return x[replica].detach().cpu().numpy()

    if reservoir:
        com_flat, off_flat = get(state.res_com), get(state.res_offset)
        n_mol = get(state.res_n)[: spec.R]
        caps = spec.res_cap_list
    else:
        com_flat, off_flat = get(state.com).T, get(state.pos).T
        n_mol = get(state.n_mol)[: spec.R]
        caps = spec.cap_list
    coms, offs = [], []
    mol_base = 0
    site_base = 0
    for r in range(spec.R):
        cap, A = caps[r], spec.A_list[r]
        n = int(n_mol[r])
        if not reservoir:
            # primary layout: per-type site bases are 128-aligned
            site_base = spec.site_base_list[r]
        coms.append(com_flat[mol_base:mol_base + n])
        rows = off_flat[site_base:site_base + n * A].reshape(n, A, 3)
        if not reservoir:   # the primary stores absolute site positions
            rows = rows - coms[-1][:, None, :]
        offs.append(rows)
        mol_base += cap
        site_base += cap * A
    return HostSnapshot(n_mol=n_mol, com=coms, offset=offs,
                        energy=get(state.energy),
                        counters=get(state.counters),
                        trans_step=float(get(state.trans_step)),
                        rot_step=float(get(state.rot_step)))


class OutputWriter:
    """Per-block file updates (reference: UpdateFiles,
    src/write_utils.f90:418-434)."""

    def __init__(self, outdir: str, deck: InputDeck, parsed: ParsedSystem,
                 logger: Logger):
        self.outdir = outdir
        self.deck = deck
        self.parsed = parsed
        self.logger = logger
        os.makedirs(outdir, exist_ok=True)

    # --- trajectory -------------------------------------------------------
    def write_trajectory(self, snap: HostSnapshot, block: int,
                         append: bool, filename: str = "trajectory.lammpstrj",
                         box: Box | None = None) -> None:
        box = box or self.parsed.box
        mode = "a" if append else "w"
        n_atoms = int(sum(snap.n_mol[r] * self.deck.residues[r].nb_atoms
                          for r in range(len(self.deck.residues))))
        with open(os.path.join(self.outdir, filename), mode) as f:
            f.write("ITEM: TIMESTEP\n")
            f.write(f"{block:10d}\n")
            f.write("ITEM: NUMBER OF ATOMS\n")
            f.write(f"{n_atoms:10d}\n")
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write(f"{box.bounds[d, 0]:15.8f} {box.bounds[d, 1]:15.8f}\n")
            f.write("ITEM: ATOMS id type x y z\n")
            atom_id = 0
            for r, res in enumerate(self.deck.residues):
                types = self.parsed.atom_types[r]
                for m in range(int(snap.n_mol[r])):
                    com = snap.com[r][m]
                    if res.active:
                        com = wrap_centered(com - _box_center(box), box) \
                            + _box_center(box)
                    for a in range(res.nb_atoms):
                        atom_id += 1
                        pos = com + snap.offset[r][m, a]
                        if not res.active:
                            pos = wrap_centered(pos - _box_center(box), box) \
                                + _box_center(box)
                        f.write(f"{atom_id:6d} {types[a]:4d} {pos[0]:12.7f} "
                                f"{pos[1]:12.7f} {pos[2]:12.7f}\n")

    # --- scalar series ----------------------------------------------------
    def write_energy_and_count(self, snap: HostSnapshot, block: int) -> None:
        e = snap.energy * KB_KCALMOL
        first = block == 0
        mode = "w" if first else "a"
        with open(os.path.join(self.outdir, "energy.dat"), mode) as f:
            if first:
                f.write("#    block        total        recipCoulomb"
                        "     non-coulomb      coulomb     ewald_self"
                        "    intramolecular-coulomb\n")
            f.write(f"{block:10d} {e[E_TOT]:16.6f} {e[E_RECIP]:16.6f} "
                    f"{e[E_LJ]:16.6f} {e[E_COUL]:16.6f} {e[E_SELF]:16.6f} "
                    f"{e[E_INTRA]:16.6f}\n")

        # every active species, every block, N=0 included: holes in the <N>
        # series would bias the adsorption observable exactly at low occupancy
        for r, res in enumerate(self.deck.residues):
            if not res.active:
                continue
            path = os.path.join(self.outdir, f"number_{res.name}.dat")
            with open(path, "w" if first else "a") as f:
                if first:
                    f.write("# Block   Active_Molecules\n")
                f.write(f"{block:10d} {int(snap.n_mol[r]):10d}\n")

        c = snap.counters
        with open(os.path.join(self.outdir, "moves.dat"), mode) as f:
            if first:
                f.write("# Block   Trial_Trans   Trans_Moves   Trial_Create"
                        "   Create_Moves   Trial_Delete   Delete_Moves"
                        "   Trial_Rotate   Rotate_Moves   Trial_Swap"
                        "   Swap_Moves\n")
            f.write(f"{block:12d} "
                    f"{c[0, TYPE_TRANSLATION]:12d} {c[1, TYPE_TRANSLATION]:12d} "
                    f"{c[0, TYPE_CREATION]:12d} {c[1, TYPE_CREATION]:12d} "
                    f"{c[0, TYPE_DELETION]:12d} {c[1, TYPE_DELETION]:12d} "
                    f"{c[0, TYPE_ROTATION]:12d} {c[1, TYPE_ROTATION]:12d} "
                    f"{c[0, TYPE_SWAP]:12d} {c[1, TYPE_SWAP]:12d}\n")

    # --- Widom insertion diagnostic (extension; no reference analog - see
    # mc/widom.py) -----------------------------------------------------------
    def write_widom(self, block: int, names, B_block, B_cum,
                    temp_K: float) -> None:
        """Append one widom.dat row: per active species the block's Widom
        factor <exp(-dU/T)>, the cumulative factor, and mu_ex (kcal/mol)
        from the cumulative factor."""
        from ..mc.widom import mu_excess_K
        path = os.path.join(self.outdir, "widom.dat")
        # a header when the file does not exist yet (also a resumed run into
        # a fresh outdir); resuming IN PLACE appends a marker row instead,
        # because the B_cum accumulator restarts from zero at the resume
        # point and the series would otherwise read as continuous
        first = block <= 1 or not os.path.exists(path)
        resumed_in_place = (not first
                            and not getattr(self, "_widom_started", False))
        self._widom_started = True
        with open(path, "w" if first else "a") as f:
            if first:
                cols = "".join(
                    f"   B_block({n})      B_cum({n})   mu_ex({n})[kcal/mol]"
                    for n in names)
                f.write(f"#    block{cols}\n")
            elif resumed_in_place:
                f.write(f"# resumed at block {block}: B_cum restarts here\n")
            row = f"{block:10d}"
            for j in range(len(names)):
                mu = mu_excess_K(B_cum[j], temp_K) * KB_KCALMOL
                row += (f" {float(B_block[j]):14.6e} {float(B_cum[j]):14.6e}"
                        f" {mu:14.6f}")
            f.write(row + "\n")

    def write_replicas(self, block: int, names, mean_n, std_n,
                       mean_e, std_e) -> None:
        """Append one replicas.dat row: cross-replica mean +- std occupancy
        per active species and of the running total energy (K). Written
        only for replicated runs (--replicas > 1); the per-species columns
        are the batched analog of number_<RES>.dat's single-chain series
        (reference: src/write_utils.f90:94-188)."""
        path = os.path.join(self.outdir, "replicas.dat")
        first = block <= 1 or not os.path.exists(path)
        with open(path, "w" if first else "a") as f:
            if first:
                cols = "".join(f"    <N({n})>    std(N({n}))" for n in names)
                f.write(f"#    block{cols}       <E_tot>[K]    std(E_tot)\n")
            row = f"{block:10d}"
            for j in range(len(names)):
                row += f" {float(mean_n[j]):12.5f} {float(std_n[j]):12.5f}"
            row += f" {float(mean_e):15.4f} {float(std_e):13.4f}"
            f.write(row + "\n")

    # --- isotherm sweep (extension; the reference needs one full run per
    # fugacity, run.sh:4-96 - here one batch carries every state point) -----
    def write_isotherm(self, block: int, names, fugacities, mean_n) -> None:
        """Append one row per active species to isotherm_<RES>.dat: the
        block's mean occupancy at each swept fugacity (columns follow the
        header's fugacity order; each point averages its replica chains)."""
        for j, name in enumerate(names):
            path = os.path.join(self.outdir, f"isotherm_{name}.dat")
            first = block <= 1 or not os.path.exists(path)
            with open(path, "w" if first else "a") as f:
                if first:
                    cols = "".join(f" {f_:14.6g}" for f_ in fugacities)
                    f.write(f"# fugacity [atm]:{cols}\n")
                    f.write("#    block    <N> per fugacity column\n")
                f.write(f"{block:10d}" + "".join(
                    f" {float(v):14.5f}" for v in mean_n[:, j]) + "\n")

    def write_isotherm_summary(self, names, fugacities, mean_n, std_n,
                               qst=None) -> None:
        """Write isotherm.dat: per (species, fugacity) the production-half
        mean +- std occupancy - the adsorption isotherm itself - plus the
        fluctuation isosteric heat q_st (kcal/mol; nan when N never
        fluctuated at that state point)."""
        path = os.path.join(self.outdir, "isotherm.dat")
        with open(path, "w") as f:
            f.write("# species    fugacity[atm]          <N>        std(N)"
                    "  qst[kcal/mol]\n")
            for j, name in enumerate(names):
                for i, f_ in enumerate(fugacities):
                    q = (f" {qst[i, j]:14.5f}" if qst is not None else "")
                    f.write(f"{name:>9s} {f_:16.6g} {mean_n[i, j]:12.5f} "
                            f"{std_n[i, j]:12.5f}{q}\n")

    # --- density profile (extension; no reference analog) --------
    def write_profile(self, snap: HostSnapshot, block: int, bins: int,
                      axis: str) -> None:
        """Append per-block COM histograms along one box axis (fractional
        coordinate, exact for any cell via H^-1) to profile_<RES>.dat -
        the density-profile observable for slit-pore/interface adsorption
        cases. Row: block index then `bins` integer counts (sum == N of
        that species that block)."""
        box = self.parsed.box
        lo = box.bounds[:, 0]
        ax = {"x": 0, "y": 1, "z": 2}[axis]
        first = block == 0
        for r, res in enumerate(self.deck.residues):
            if not res.active:
                continue
            com = snap.com[r][: int(snap.n_mol[r])]
            if com.size:
                frac = ((box.reciprocal @ (com - lo).T) % 1.0)[ax]
                hist = np.histogram(frac, bins=bins, range=(0.0, 1.0))[0]
            else:
                hist = np.zeros(bins, dtype=int)
            path = os.path.join(self.outdir, f"profile_{res.name}.dat")
            with open(path, "w" if first else "a") as f:
                if first:
                    f.write(f"# COM histogram along {axis} (fractional "
                            f"coordinate, {bins} bins)\n")
                f.write(f"{block:10d} "
                        + " ".join(f"{int(c):7d}" for c in hist) + "\n")

    # --- restart topology ---------------------------------------------------
    def write_topology(self, snap: HostSnapshot,
                       filename: str = "topology.data") -> None:
        deck, parsed = self.deck, self.parsed
        box = parsed.box
        R = len(deck.residues)
        n_atoms = int(sum(snap.n_mol[r] * deck.residues[r].nb_atoms
                          for r in range(R)))
        conn_counts = []
        for conn in (parsed.bonds, parsed.angles, parsed.dihedrals,
                     parsed.impropers):
            conn_counts.append(int(sum(snap.n_mol[r] * len(conn[r])
                                       for r in range(R))))
        with open(os.path.join(self.outdir, filename), "w") as f:
            f.write("! LAMMPS data file (atom_style full) - maniac-tpu\n")
            f.write(f" {n_atoms} atoms\n {parsed.num_atomtypes} atom types\n")
            f.write(f" {conn_counts[0]} bonds\n {parsed.num_bondtypes} bond types\n")
            f.write(f" {conn_counts[1]} angles\n {parsed.num_angletypes} angle types\n")
            f.write(f" {conn_counts[2]} dihedrals\n"
                    f" {parsed.num_dihedraltypes} dihedral types\n")
            f.write(f" {conn_counts[3]} impropers\n"
                    f" {parsed.num_impropertypes} improper types\n\n")
            for d, name in enumerate(("xlo xhi", "ylo yhi", "zlo zhi")):
                f.write(f"{box.bounds[d, 0]:15.8f} {box.bounds[d, 1]:15.8f} "
                        f"{name}\n")
            if box.is_triclinic:
                f.write(f"{box.tilt[0]:15.8f} {box.tilt[1]:15.8f} "
                        f"{box.tilt[2]:15.8f} xy xz yz\n")
            f.write("\n Masses\n\n")
            for t in range(1, parsed.num_atomtypes + 1):
                f.write(f"{t:5d} {parsed.masses_by_type[t]:12.6f}\n")
            f.write("\n Atoms\n\n")
            atom_id = 0
            mol_id = 0
            for r, res in enumerate(deck.residues):
                types = parsed.atom_types[r]
                charges = parsed.atom_charges[r]
                for m in range(int(snap.n_mol[r])):
                    mol_id += 1
                    for a in range(res.nb_atoms):
                        atom_id += 1
                        pos = snap.com[r][m] + snap.offset[r][m, a]
                        if not res.active:
                            pos = wrap_centered(pos - _box_center(box), box) \
                                + _box_center(box)
                        f.write(f"{atom_id:6d} {mol_id:6d} {types[a]:4d} "
                                f"{charges[a]:12.8f} {pos[0]:12.7f} "
                                f"{pos[1]:12.7f} {pos[2]:12.7f}\n")
            for conn, name in ((parsed.bonds, "Bonds"),
                               (parsed.angles, "Angles"),
                               (parsed.dihedrals, "Dihedrals"),
                               (parsed.impropers, "Impropers")):
                total = int(sum(snap.n_mol[r] * len(conn[r]) for r in range(R)))
                if total == 0:
                    continue
                f.write(f"\n {name}\n\n")
                cpt = 0
                atom_offset = 0
                for r, res in enumerate(deck.residues):
                    for m in range(int(snap.n_mol[r])):
                        for row in conn[r]:
                            cpt += 1
                            locals_ = " ".join(
                                str(atom_offset + int(x)) for x in row[1:])
                            f.write(f" {cpt} {int(row[0])} {locals_}\n")
                        atom_offset += res.nb_atoms

    def update_files(self, snap: HostSnapshot, block: int,
                     append: bool, reservoir_snap: HostSnapshot | None = None,
                     reservoir_box: Box | None = None) -> None:
        self.write_trajectory(snap, block, append)
        if reservoir_snap is not None:
            self.write_trajectory(reservoir_snap, block, append,
                                  filename="reservoir.lammpstrj",
                                  box=reservoir_box)
        self.write_energy_and_count(snap, block)
        self.write_topology(snap)

    # --- per-block status row (reference: PrintStatus,
    #     src/output_utils.f90:154-215) -----------------------------------
    def print_status(self, snap: HostSnapshot, block: int) -> None:
        log = self.logger.log
        log("")
        parts = []
        for r, res in enumerate(self.deck.residues):
            if res.active and snap.n_mol[r]:
                parts.append(f"{res.name}={int(snap.n_mol[r])}")
        log("  Energy report | Active molecules: " + " ".join(parts))
        e = snap.energy * KB_KCALMOL
        e_coul = e[E_COUL] + e[E_INTRA]
        e_long = e[E_RECIP] + e[E_SELF]
        c = snap.counters
        log(f"{'Step':>10} {'TotEng':>14} {'E_vdwl':>14} {'E_coul':>14} "
            f"{'E_long':>14}  {'TransStep':>10}  {'RotAngle':>10}  "
            f"{'MC (acc/trial)':>20}")
        log(f"{block:10d} {e[E_TOT]:14.4f} {e[E_LJ]:14.4f} {e_coul:14.4f} "
            f"{e_long:14.4f}  {snap.trans_step:10.4f}  {snap.rot_step:10.4f}  "
            f"T({c[1, TYPE_TRANSLATION]}/{c[0, TYPE_TRANSLATION]}) "
            f"R({c[1, TYPE_ROTATION]}/{c[0, TYPE_ROTATION]}) "
            f"C({c[1, TYPE_CREATION]}/{c[0, TYPE_CREATION]}) "
            f"D({c[1, TYPE_DELETION]}/{c[0, TYPE_DELETION]}) "
            f"S({c[1, TYPE_SWAP]}/{c[0, TYPE_SWAP]})")

    def final_report(self, snap: HostSnapshot, block: int) -> None:
        """Reference: FinalReport + PrintTerminationMessage
        (src/output_utils.f90:97-142, 220-275)."""
        log = self.logger
        e = snap.energy * KB_KCALMOL
        e_coul = e[E_COUL] + e[E_INTRA]
        e_long = e[E_RECIP] + e[E_SELF]
        log.log("")
        log.box_border()
        log.box_line("Final Energy Report")
        log.box_line("")
        log.box_line("  Step        TotEng        E_vdwl        E_coul        E_long")
        log.box_line(f"{block:10d} {e[E_TOT]:15.6f} {e[E_LJ]:15.6f} "
                     f"{e_coul:15.6f} {e_long:15.6f}")
        log.box_line("")
        log.box_border()
        log.log("")
        c = snap.counters
        log.log("")
        log.box_border()
        log.box_line("MANIAC-TPU Simulation Completed")
        log.box_line("")
        log.box_line(f"  Translations (Trial/Accepted): {c[0, TYPE_TRANSLATION]:8d} / "
                     f"{c[1, TYPE_TRANSLATION]:8d}")
        log.box_line(f"  Rotations    (Trial/Accepted): {c[0, TYPE_ROTATION]:8d} / "
                     f"{c[1, TYPE_ROTATION]:8d}")
        log.box_line(f"  Creations    (Trial/Accepted): {c[0, TYPE_CREATION]:8d} / "
                     f"{c[1, TYPE_CREATION]:8d}")
        log.box_line(f"  Deletions    (Trial/Accepted): {c[0, TYPE_DELETION]:8d} / "
                     f"{c[1, TYPE_DELETION]:8d}")
        log.box_line(f"  Swaps        (Trial/Accepted): {c[0, TYPE_SWAP]:8d} / "
                     f"{c[1, TYPE_SWAP]:8d}")
        log.box_line("")
        log.box_line("All output files have been written to:")
        log.box_line(self.outdir)
        log.box_border()
        log.log("")


def _box_center(box: Box) -> np.ndarray:
    return 0.5 * (box.bounds[:, 0] + box.bounds[:, 1])
