"""Physical constants and compile-time tunables.

Numeric values intentionally match the reference implementation
(reference: src/constants.f90:7-20, src/parameters.f90:8-42) so that energies
agree to machine precision. Internal energy unit is Kelvin; lengths are
Angstrom; charges are elementary charges.
"""

import math

# --- physical constants (src/constants.f90) ---
PI = math.pi
TWOPI = 2.0 * PI
SQRTPI = math.sqrt(PI)
KB_JK = 1.380658e-23          # Boltzmann constant (J/K)
KB_KCALMOL = 0.0019872041     # Boltzmann constant (kcal/mol/K)
EPS0_INV_EVA = 14.40198       # e^2 / (4 pi eps0)  (eV * Angstrom)
KB_EVK = 8.6173852e-5         # Boltzmann constant (eV/K)
SMALL = 1.0e-10               # generic small-number tolerance ("error")
# erfc(x) < 5e-10 beyond this: the truncation accuracy of every
# short-range split pass (fwsplit alpha2, guest-guest honest cutoff)
ERFC_DECAY = 4.4

# Coulomb prefactor converting (e^2/Angstrom) to Kelvin.
COULOMB_K = EPS0_INV_EVA / KB_EVK

# --- unit conversions (src/parameters.f90:28-29) ---
A3_TO_M3 = 1.0e-30
ATM_TO_PA = 1.01325e5

# --- Monte Carlo tunables (src/parameters.f90:15-22) ---
TARGET_ACCEPTANCE = 0.40
TOL_ACCEPTANCE = 0.05
MIN_TRANSLATION_STEP = 1.0e-3   # Angstrom
MAX_TRANSLATION_STEP = 3.0      # Angstrom
MIN_ROTATION_ANGLE = 1.0e-3     # rad
MAX_ROTATION_ANGLE = 0.78       # rad (~45 deg)
PROB_CREATE_DELETE = 0.5
MIN_TRIALS_FOR_RECALIBRATION = 500

# --- move type enum (src/parameters.f90:35-38, plus swap which the reference
# declares but never dispatches; we implement it for real) ---
TYPE_CREATION = 0
TYPE_DELETION = 1
TYPE_TRANSLATION = 2
TYPE_ROTATION = 3
TYPE_SWAP = 4

# --- output ---
BOX_WIDTH = 78
DATA_FILENAME = "topology.data"
