"""Parser for the ``.maniac`` input deck.

Host-side, pure Python -> frozen dataclasses. Behavior mirrors the reference
parser (reference: src/input_parser.f90:297-601 ParseInputFile, :89-118
ValidateAndRescaleMoveProbabilities, :603-672 SortResidues):

* keywords: nb_block, nb_step, temperature, seed, ewald_tolerance,
  real_space_cutoff, translation_step, rotation_step_angle,
  recalibrate_moves, translation_proba, rotation_proba,
  insertion_deletion_proba, swap_proba
* residue blocks: begin_residue .. end_residue with name, state
  (actif/inactif), fugacity, nb-atoms, types, names
* unknown keywords are silently ignored (e.g. big_move_proba)
* required: nb_block, nb_step, temperature, real_space_cutoff,
  ewald_tolerance, translation_step, rotation_step_angle
* probabilities default to 0 when absent; the set is rescaled to sum to 1
  (warning) and must not be all-zero
* active residues must declare a positive fugacity
* residues are sorted by their minimum atom-type id (stable)

Divergence from the reference (documented): a user-provided ``seed`` actually
seeds our PRNG; the reference reads it but only seeds from the system clock
when no seed is given (src/input_parser.f90:597, src/random_utils.f90:35-56).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..constants import SMALL
from ..utils.logger import Logger, default_logger


@dataclass
class ResidueDecl:
    name: str = ""
    active: bool = False
    fugacity: float = -1.0          # atm as given in the deck
    nb_atoms: int = 0
    types: list[int] = field(default_factory=list)
    names: list[str] = field(default_factory=list)


@dataclass
class MoveProbabilities:
    translation: float = 0.0
    rotation: float = 0.0
    insertion_deletion: float = 0.0
    swap: float = 0.0

    def total(self) -> float:
        return self.translation + self.rotation + self.insertion_deletion + self.swap


@dataclass
class InputDeck:
    nb_block: int = 0
    nb_step: int = 0
    temp_K: float = 0.0
    seed: int | None = None
    ewald_tolerance: float = 0.0
    # TPU-native extension: override the DL_POLY-derived alpha
    # (re-balances the real/reciprocal Ewald split; the converged
    # total is split-invariant). 0 = use the reference formula.
    ewald_alpha: float = 0.0
    # TPU-native extension: static-framework split of the guest<->framework
    # real-space Coulomb term (physics/fwsplit.py). "auto" enables it when
    # the system is eligible; "on"/"off" force it. fw_alpha2/fw_rcut2
    # override the automatic short-range split parameters (0 = auto).
    framework_split: str = "auto"
    fw_alpha2: float = 0.0
    fw_rcut2: float = 0.0
    # TPU-native extension: guest<->guest real-space Coulomb truncation at
    # the radius where erfc(alpha r) ~ 5e-10 (the reference sums the damped
    # term over ALL pairs with no cutoff, src/energy_utils.f90:374-442; the
    # tail beyond that radius is below 1e-6 kcal/mol - DIVERGENCES.md).
    # "auto" (default) enables it; "off" restores the exact reference
    # semantics; gg_rcut overrides the automatic radius (0 = auto).
    # Combined with `ewald_alpha` this re-balances the whole engine between
    # a short real-space pass and the k-grid - the guest-side analog of the
    # static-framework split. guest_slabs enables the slab-slotted guest
    # layout (spatial windows for the short pass; 0 = auto).
    guest_split: str = "auto"
    gg_rcut: float = 0.0
    guest_slabs: int = 0
    # Tabulated pair potentials (reference: src/tabulated_utils.f90, gated
    # off at compile time by use_table=.false., src/parameters.f90:41-42
    # with a "make it an input parameter" TODO - here it IS the input
    # parameter). Linear-interpolation tables for erfc(alpha r)/r, r^6 and
    # r^12 replace the direct pair math on the XLA path; see
    # DIVERGENCES.md (tabulated mode) for the semantics this inherits.
    use_table: bool = False
    tabulated_points: int = 5000
    real_space_cutoff: float = 0.0
    translation_step: float = 0.0
    rotation_step_angle: float = 0.0
    recalibrate_moves: bool = False
    proba: MoveProbabilities = field(default_factory=MoveProbabilities)
    residues: list[ResidueDecl] = field(default_factory=list)

    @property
    def n_residue_types(self) -> int:
        return len(self.residues)


def _strip_comment(line: str) -> str:
    """Drop an inline '#' comment (the reference's list-directed reads stop at
    the first non-parsing token, which in practice is the '#')."""
    idx = line.find("#")
    if idx >= 0:
        line = line[:idx]
    return line.strip()


def _parse_bool(tok: str) -> bool:
    t = tok.lower().lstrip(".")
    if t.startswith("t"):
        return True
    if t.startswith("f"):
        return False
    raise ValueError(f"not a logical: {tok!r}")


_SCALAR_KEYS = {
    "nb_block": ("nb_block", int),
    "nb_step": ("nb_step", int),
    "temperature": ("temp_K", float),
    "seed": ("seed", int),
    "ewald_tolerance": ("ewald_tolerance", float),
    "ewald_alpha": ("ewald_alpha", float),
    "framework_split": ("framework_split", str.lower),
    "fw_alpha2": ("fw_alpha2", float),
    "fw_rcut2": ("fw_rcut2", float),
    "guest_split": ("guest_split", str.lower),
    "gg_rcut": ("gg_rcut", float),
    "guest_slabs": ("guest_slabs", int),
    "use_table": ("use_table", _parse_bool),
    "tabulated_points": ("tabulated_points", int),
    "real_space_cutoff": ("real_space_cutoff", float),
    "translation_step": ("translation_step", float),
    "rotation_step_angle": ("rotation_step_angle", float),
    "recalibrate_moves": ("recalibrate_moves", _parse_bool),
}

_PROBA_KEYS = {
    "translation_proba": "translation",
    "rotation_proba": "rotation",
    "insertion_deletion_proba": "insertion_deletion",
    "swap_proba": "swap",
}

# keys whose value must be > 0 (reference: input_parser.f90:378-413)
_POSITIVE_KEYS = {"temperature", "ewald_tolerance", "real_space_cutoff",
                  "translation_step", "rotation_step_angle",
                  "tabulated_points"}


def parse_deck(path: str, logger: Logger | None = None) -> InputDeck:
    logger = logger or default_logger()
    deck = InputDeck()
    seen: set[str] = set()
    in_block = False
    current: ResidueDecl | None = None

    with open(path) as fh:
        for raw in fh:
            line = _strip_comment(raw)
            if not line:
                continue
            tokens = line.split()
            key = tokens[0]

            if key == "begin_residue":
                in_block = True
                current = ResidueDecl()
                continue
            if key == "end_residue":
                in_block = False
                if current is not None:
                    deck.residues.append(current)
                current = None
                continue

            if key in _SCALAR_KEYS:
                attr, conv = _SCALAR_KEYS[key]
                try:
                    val = conv(tokens[1])
                except (IndexError, ValueError):
                    logger.abort(f"Error reading {key}")
                if key in _POSITIVE_KEYS and val <= 0.0:
                    logger.abort(f"Invalid {key}: must be > 0")
                setattr(deck, attr, val)
                seen.add(key)
                continue

            if key in _PROBA_KEYS:
                try:
                    val = float(tokens[1])
                except (IndexError, ValueError):
                    logger.abort(f"Error reading {key}")
                if val < 0.0 or val > 1.0:
                    logger.abort(f"Invalid {key}: must be in [0,1]")
                setattr(deck.proba, _PROBA_KEYS[key], val)
                seen.add(key)
                continue

            if in_block and current is not None:
                if key == "name":
                    current.name = tokens[1]
                elif key == "state":
                    state = tokens[1]
                    if state == "actif":
                        current.active = True
                    elif state == "inactif":
                        current.active = False
                    else:
                        logger.abort(f"Unknown residue state: {state}")
                elif key == "fugacity":
                    current.fugacity = float(tokens[1])
                elif key == "nb-atoms":
                    current.nb_atoms = int(tokens[1])
                elif key == "types":
                    ids = []
                    for tok in tokens[1:]:
                        try:
                            ids.append(int(tok))
                        except ValueError:
                            break
                    current.types = ids
                elif key == "names":
                    current.names = list(tokens[1:])
                # unknown residue keys silently ignored
                continue
            # unknown top-level keyword: silently ignored (matches reference)

    _validate(deck, seen, logger)
    _sort_residues(deck)
    return deck


def _validate(deck: InputDeck, seen: set[str], logger: Logger) -> None:
    if deck.framework_split not in ("auto", "on", "off"):
        logger.abort("Invalid framework_split: must be auto, on or off")
    if deck.use_table and deck.framework_split == "on":
        logger.abort("use_table replaces the direct pair math and cannot "
                     "be combined with framework_split on")
    for res in deck.residues:
        if res.active and res.fugacity < 0.0:
            logger.abort(
                "Fugacity not provided or invalid for active residue: " + res.name)

    required = ["nb_block", "nb_step", "temperature", "real_space_cutoff",
                "ewald_tolerance", "translation_step", "rotation_step_angle"]
    for key in required:
        if key not in seen:
            logger.abort(f"Missing required parameter: {key}")

    # swap needs two active species. The reference's move dispatch never
    # reaches a swap branch at all (src/monte_carlo.f90:50-75: the trailing
    # `else` hands everything past translation+rotation to insert/delete),
    # so swap probability mass ALWAYS falls through to insertion/deletion
    # there. We implement real swaps (DIVERGENCES.md #3); with <2 active
    # species a swap draw is undefined, so fold the mass into
    # insertion/deletion — reproducing the reference's fall-through move
    # mix — and tell the user (DIVERGENCES.md #23).
    n_active = sum(1 for res in deck.residues if res.active)
    if deck.proba.swap > 0.0 and n_active < 2:
        logger.warn(
            f"swap_proba {deck.proba.swap:g} with {n_active} active "
            "species: swap needs two; folding the probability into "
            "insertion/deletion (the reference's dispatch does the same, "
            "src/monte_carlo.f90:60)")
        deck.proba.insertion_deletion += deck.proba.swap
        deck.proba.swap = 0.0

    total = deck.proba.total()
    if total < SMALL:
        logger.abort(
            "Invalid move probabilities: all enabled moves have zero probability")
    if abs(total - 1.0) > SMALL:
        scale = 1.0 / total
        deck.proba.translation *= scale
        deck.proba.rotation *= scale
        deck.proba.insertion_deletion *= scale
        deck.proba.swap *= scale
        logger.warn("Move probabilities rescaled to sum to 1.0")

    for res in deck.residues:
        if res.nb_atoms <= 0:
            logger.abort(f"Residue {res.name}: nb-atoms missing or invalid")
        if not res.types:
            logger.abort(f"Residue {res.name}: no atom types declared")


def _sort_residues(deck: InputDeck) -> None:
    """Stable sort by minimum atom type id (reference: SortResidues)."""
    deck.residues.sort(key=lambda r: min(r.types))
