"""Parser for LAMMPS-style ``.inc`` pair-coefficient include files.

Scans ``pair_coeff i j eps sigma`` lines, converts epsilon kcal/mol -> Kelvin,
scatters into 4-D per-(residue, site) tables and fills missing cross terms
with Lorentz-Berthelot mixing (reference: src/parameters_parser.f90:20-114
ReadParameters, :116-182 ApplyLorentzBerthelot).
"""

from __future__ import annotations

import numpy as np

from ..constants import KB_KCALMOL
from ..io.lammps_data import ParsedSystem
from ..utils.logger import Logger, default_logger


def parse_pair_coeffs(path: str, sys: ParsedSystem,
                      logger: Logger | None = None
                      ) -> tuple[list[list[np.ndarray]], list[list[np.ndarray]]]:
    """Returns (epsilon, sigma) as nested lists: eps[i][j] has shape
    (A_i, A_j), units Kelvin / Angstrom. Symmetric by construction."""
    logger = logger or default_logger()
    R = len(sys.atom_types)
    eps = [[np.zeros((len(sys.atom_types[i]), len(sys.atom_types[j])))
            for j in range(R)] for i in range(R)]
    sig = [[np.zeros((len(sys.atom_types[i]), len(sys.atom_types[j])))
            for j in range(R)] for i in range(R)]

    pairs = []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            toks = line.split()
            if toks[0] != "pair_coeff":
                continue
            try:
                t1, t2 = int(toks[1]), int(toks[2])
                e = float(toks[3]) / KB_KCALMOL  # kcal/mol -> K
                s = float(toks[4])
            except (ValueError, IndexError):
                logger.abort("Failed to read pair_coeff value", 1)
            pairs.append((t1, t2, e, s))

    for t1, t2, e, s in pairs:
        for i in range(R):
            ti = sys.atom_types[i]
            for j in range(R):
                tj = sys.atom_types[j]
                hit = (ti[:, None] == t1) & (tj[None, :] == t2)
                eps[i][j][hit] = e
                sig[i][j][hit] = s
                # symmetric entry (reference: parameters_parser.f90:96-98)
                eps[j][i][hit.T] = e
                sig[j][i][hit.T] = s

    _apply_lorentz_berthelot(eps, sig, sys, logger)
    return eps, sig


def _apply_lorentz_berthelot(eps, sig, sys: ParsedSystem, logger: Logger) -> None:
    # Vectorized over the (k, l) site grid. Fills only ever READ the
    # self-block diagonals eps[i][i][k,k] / sig[i][i][k,k], and a diagonal
    # entry can never be filled (its own mixing source would be the missing
    # value itself, failing the >1e-6 gate), so the element-order of the
    # original scalar loop is immaterial and this is exact.
    R = len(eps)
    warned = False
    diag_e = [np.diagonal(eps[i][i]).copy() for i in range(R)]
    diag_s = [np.diagonal(sig[i][i]).copy() for i in range(R)]
    for i in range(R):
        for j in range(R):
            missing = ((np.abs(eps[i][j]) < 1e-6)
                       & (np.abs(sig[i][j]) < 1e-6))
            s = 0.5 * (diag_s[i][:, None] + diag_s[j][None, :])
            e = np.sqrt(diag_e[i][:, None] * diag_e[j][None, :])
            fill = missing & (s > 1e-6) & (e > 1e-6)
            if fill.any():
                if not warned:
                    logger.info("Enforcing the Lorentz-Berthelot rule")
                    warned = True
                sig[i][j][fill] = s[fill]
                eps[i][j][fill] = e[fill]
