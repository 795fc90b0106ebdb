"""The dilute LJ gas against its virial expansion: an anchor of GCMC
sampling that lies outside the codebase (the counterpart of
tests/test_virial_anchor.py's system and estimators, shared by
tests/test_torch_virial_anchor.py on the CPU and tests/test_torch_gpu_runs.py
on the card).

    rho(z) = z - 2 B2(T) z^2 + O(z^3)
    beta mu_ex(rho) = 2 B2(T) rho + O(rho^2)

B2 is the second virial coefficient of the engine's exact pair potential
(LJ hard-truncated at rcut, unshifted, no tail: the reference's semantics,
src/energy_utils.f90:225-255) by quadrature; the quadrature of the full
potential reproduces the published LJ Boyle temperature T_B* = 3.4179. At
z* = 0.032, T* = 1.5 the B2 term shifts <N> by some 6% of the ideal value
while the z^3 term is some 0.4%, and 64 replicas resolve the shift. The
Widom factor <exp(-beta dU)> must equal exp(-2 B2 rho) to first order in
the density.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.integrate import quad

# reduced units: eps = 0.2 kcal/mol = 100.644 K, sigma = 3.4 A
EPS_KCAL = 0.2
SIG = 3.4
EPS_K = EPS_KCAL * 503.2189478
TSTAR = 1.5
TEMP_K = TSTAR * EPS_K
RCUT = 2.5 * SIG
L = 10.0 * SIG
ZSTAR = 0.032
Z_A3 = ZSTAR / SIG ** 3                  # activity in A^-3
BOYLE_TSTAR = 3.4179                     # published LJ Boyle temperature
REPLICAS = 64
CAPACITY = 96
STEPS = 150                              # steps a block
EQ_BLOCKS = 10
OCCUPANCY_BLOCKS = 30
WIDOM_BLOCKS = 12
WIDOM_TRIALS = 64
WIDOM_SEED = 17


def lj_gas_kwargs() -> dict:
    """systems.make_lj_gas's arguments for the anchor's gas (the deck's
    fugacity in atm gives the activity Z_A3)."""
    from .system import convert_fugacity
    return dict(n=32, L=L, cutoff=RCUT, temp=TEMP_K, tol=1e-4,
                probs=(0.35, 0.0, 0.65, 0.0),
                fugacity=Z_A3 / convert_fugacity(1.0, TEMP_K),
                eps=EPS_KCAL, sig=SIG)


def _b2(temp_K, r_hi, limit):
    beta = 1.0 / temp_K

    def integrand(r):
        sr6 = (SIG / r) ** 6
        u = 4.0 * EPS_K * (sr6 * sr6 - sr6)
        return (np.exp(-beta * u) - 1.0) * r * r

    # split at sigma: the integrand jumps from ~-r^2 to the well region
    val1, _ = quad(integrand, 1e-6, SIG, limit=200)
    val2, _ = quad(integrand, SIG, r_hi, limit=limit)
    return -2.0 * np.pi * (val1 + val2)


def b2_truncated(temp_K=TEMP_K, rcut=RCUT) -> float:
    """B2 (A^3) of the hard-truncated, unshifted LJ potential."""
    return _b2(temp_K, rcut, 200)


def b2_full(temp_K) -> float:
    """B2 (A^3) of the full LJ potential (integrated to 60 sigma)."""
    return _b2(temp_K, 60.0 * SIG, 400)


def equilibrate(spec, state, resync=False):
    """REPLICAS chains from ``state`` after EQ_BLOCKS blocks of STEPS
    steps."""
    from .parallel.replicas import replicate, run_block_replicated
    states = replicate(spec, state, REPLICAS)
    for _ in range(EQ_BLOCKS):
        states = run_block_replicated(spec, states, STEPS, False, resync)
    return states


def occupancy(spec, states, resync=False) -> dict:
    """OCCUPANCY_BLOCKS blocks from ``states``: <N> over the replica means
    and its standard error, against the virial and the ideal values, and
    the tests' verdicts: within 3 sem + 0.6% (the z^3 allowance) of the
    virial value, and more than 4 sem from the ideal value (the B2 shift
    resolved)."""
    from .parallel.replicas import run_block_replicated
    n_ideal = Z_A3 * float(spec.volume)
    n_th = n_ideal * (1.0 - 2.0 * b2_truncated() * Z_A3)
    samples = []
    for _ in range(OCCUPANCY_BLOCKS):
        states = run_block_replicated(spec, states, STEPS, False, resync)
        samples.append(states.n_mol[:, 0].double().cpu().numpy())
    per_rep = np.stack(samples).mean(axis=0)            # replica means
    n_meas = float(per_rep.mean())
    sem = float(per_rep.std(ddof=1) / np.sqrt(per_rep.size))
    return {"n": n_meas, "sem": sem, "n_virial": n_th, "n_ideal": n_ideal,
            "matches": abs(n_meas - n_th) < 3.0 * sem + 0.006 * n_th,
            "resolved": abs(n_meas - n_ideal) > 4.0 * sem}


def widom(spec, states, resync=False) -> dict:
    """WIDOM_BLOCKS blocks from ``states``, each followed by WIDOM_TRIALS
    ghost insertions into every replica (mc/widom.widom_block_replicated;
    block i's keys split(sub, REPLICAS) with (key, sub) = split(key) from
    prng_key(WIDOM_SEED), as the JAX test draws them): the Widom factor B
    over the replica means and its standard error against exp(-2 B2 rho),
    and the verdicts: within 3 sem + 1%, and more than 3 sem from 1 (mu_ex
    != 0 resolved)."""
    from .mc.widom import widom_block_replicated
    from .parallel.replicas import run_block_replicated
    from .utils.threefry import prng_key, split
    key = prng_key(WIDOM_SEED, device=spec.device)
    bs, ns = [], []
    for _ in range(WIDOM_BLOCKS):
        states = run_block_replicated(spec, states, STEPS, False, resync)
        key, sub = split(key)
        log_b = widom_block_replicated(spec, states, WIDOM_TRIALS,
                                       split(sub, states.B))
        bs.append(np.exp(log_b.double().cpu().numpy())[:, 0])
        ns.append(states.n_mol[:, 0].double().cpu().numpy())
    per_rep = np.stack(bs).mean(axis=0)
    b_meas = float(per_rep.mean())
    sem = float(per_rep.std(ddof=1) / np.sqrt(per_rep.size))
    rho = float(np.stack(ns).mean()) / float(spec.volume)
    b_th = float(np.exp(-2.0 * b2_truncated() * rho))
    return {"B": b_meas, "sem": sem, "B_virial": b_th,
            "matches": abs(b_meas - b_th) < 3.0 * sem + 0.01 * b_th,
            "resolved": abs(b_meas - 1.0) > 3.0 * sem}


def load(outdir, dtype=torch.float64, device="cuda"):
    """The gas written by make_lj_gas(outdir, **lj_gas_kwargs()), loaded at
    CAPACITY; (spec, state)."""
    from .api import load_system
    sysm = load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", dtype=dtype,
                       capacity=CAPACITY, device=device)
    return sysm.spec, sysm.state
