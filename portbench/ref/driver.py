"""The reference's entry points: load, draw, step, resync, refresh.

The same sequence as the program's set-up (src/main.f90:15-27 of the
Fortran reference): parse the deck, data and pair coefficients, set up
Ewald, build the system in float64 numpy, move it to the device in the
dtype asked for, and compute the energy from scratch. The steps are the
plain torch step (mc/moves.py::mc_step_u with the plain energy core), the
resync recomputes the structure factors and E_RECIP, the refresh the
whole energy, all from positions.
"""

from __future__ import annotations

import torch

from .ewald import setup_ewald
from .io.deck import parse_deck
from .io.lammps_data import parse_lammps_data
from .io.pair_coeffs import parse_pair_coeffs
from .mc.moves import N_UNIFORMS, _core_plain, mc_step_u
from .physics.energy import (active_site_mask, full_amplitudes, recip_energy,
                             site_positions, system_energy)
from .system import (E_RECIP, E_TOT, SimState, build_spec_and_state,
                     to_device)
from .utils.logger import NullLogger
from .utils.threefry import threefry2x32, uniform


def build(input_file: str, data_file: str, params_file: str, *,
          capacity: int, seed: int):
    """(spec, state at B = 1) from the three files, in float64 on the
    host, the energy not computed yet."""
    log = NullLogger()
    deck = parse_deck(input_file, log)
    deck.seed = seed
    parsed = parse_lammps_data(data_file, deck, log, is_primary=True)
    eps, sig = parse_pair_coeffs(params_file, parsed, log)
    ewald = setup_ewald(parsed.box, deck.real_space_cutoff,
                        deck.ewald_tolerance, log,
                        alpha_override=deck.ewald_alpha)
    return build_spec_and_state(deck, parsed, eps, sig, ewald,
                                capacity=capacity)


def load(input_file: str, data_file: str, params_file: str, *,
         capacity: int, dtype: torch.dtype, device, seed: int):
    """(spec, state at B = 1 with its energy) on ``device`` in ``dtype``."""
    spec, state = build(input_file, data_file, params_file,
                        capacity=capacity, seed=seed)
    spec = to_device(spec, device, dtype)
    return spec, refresh(spec, to_device(state, device, dtype))


def refresh(spec, state: SimState) -> SimState:
    """Energy components and structure factors from scratch."""
    e, amp_re, amp_im = system_energy(spec, state)
    return state.replace(amp_re=amp_re, amp_im=amp_im, energy=e)


def resync(spec, state: SimState) -> SimState:
    """Structure factors and E_RECIP from positions; the other energy
    components keep their running values."""
    pos = site_positions(spec, state)
    amp_re, amp_im = full_amplitudes(spec, pos,
                                     active_site_mask(spec, state.n_mol))
    e_recip = recip_energy(spec, amp_re, amp_im)
    e = state.energy.clone()
    e[:, E_TOT] += e_recip - e[:, E_RECIP]
    e[:, E_RECIP] = e_recip
    return state.replace(amp_re=amp_re, amp_im=amp_im, energy=e)


def draw(keys: torch.Tensor, n_steps: int, dtype: torch.dtype):
    """One block's stream: per replica (next, sub) = split(key) and
    uniform(sub, (n_steps, 21)). Returns (next keys (B, 2), uniforms
    (B, n_steps, 21))."""
    k0, k1 = keys[:, 0], keys[:, 1]
    zero = torch.zeros_like(k0)
    n0, n1 = threefry2x32(k0, k1, zero, zero)
    s0, s1 = threefry2x32(k0, k1, zero, zero + 1)
    u = uniform(torch.stack([s0, s1], dim=-1), (n_steps, N_UNIFORMS), dtype)
    return torch.stack([n0, n1], dim=-1), u


def steps(spec, state: SimState, u: torch.Tensor) -> SimState:
    """The plain MC steps on uniforms (B, n_steps, 21)."""
    for i in range(u.shape[1]):
        state = mc_step_u(spec, state, u[:, i], _core_plain)
    return state


def cast(obj, device, dtype: torch.dtype):
    """A spec or state on ``device`` with its floating tensors in
    ``dtype``."""
    return to_device(obj, device, dtype)


def rows(state: SimState, idx: torch.Tensor) -> SimState:
    """The replicas ``idx`` of a batched state."""
    return SimState(**{k: v[idx] for k, v in vars(state).items()})
