"""MC driver: step loops, per-block recalibration, amplitude resync, audits.

Counterpart of maniac_tpu/mc/driver.py (see there for the reference's
block loop and the documented recalibration divergence). Every function
works on a batched SimState (leading replica axis B). Uniforms come from an
explicit ``torch.Generator`` or are passed in, shaped (B, n_steps, 21).
"""

from __future__ import annotations

import torch

from ..constants import (MAX_ROTATION_ANGLE, MAX_TRANSLATION_STEP,
                         MIN_ROTATION_ANGLE, MIN_TRANSLATION_STEP,
                         MIN_TRIALS_FOR_RECALIBRATION, TARGET_ACCEPTANCE,
                         TOL_ACCEPTANCE, TYPE_ROTATION, TYPE_TRANSLATION)
from ..physics.energy import (active_site_mask, full_amplitudes, recip_energy,
                              site_positions, system_energy)
from ..system import E_RECIP, E_TOT, SimState, SystemSpec
from .moves import N_UNIFORMS, mc_step_u


def initialize_state(spec: SystemSpec, state: SimState) -> SimState:
    """Full energy and structure factors from scratch."""
    e, amp_re, amp_im = system_energy(spec, state)
    return state.replace(amp_re=amp_re, amp_im=amp_im, energy=e)


def _recalibrate(state: SimState, recalibrate: bool) -> SimState:
    """Symmetric step-size rule: grow 5% above target+tol, shrink 5% below
    target-tol, clamped to [min, max], once a move type has enough trials."""
    if not recalibrate:
        return state
    dtype = state.trans_step.dtype

    def adjust(step, trials, accepts, lo, hi):
        acc = accepts.to(dtype) / torch.clamp(trials, min=1).to(dtype)
        grown = torch.clamp(step * 1.05, max=hi)
        shrunk = torch.clamp(step * 0.95, min=lo)
        new = torch.where(acc - TARGET_ACCEPTANCE > TOL_ACCEPTANCE, grown,
                          torch.where(acc - TARGET_ACCEPTANCE < -TOL_ACCEPTANCE,
                                      shrunk, step))
        return torch.where(trials > MIN_TRIALS_FOR_RECALIBRATION, new, step)

    c = state.counters
    trans = adjust(state.trans_step, c[:, 0, TYPE_TRANSLATION],
                   c[:, 1, TYPE_TRANSLATION], MIN_TRANSLATION_STEP,
                   MAX_TRANSLATION_STEP)
    rot = adjust(state.rot_step, c[:, 0, TYPE_ROTATION],
                 c[:, 1, TYPE_ROTATION], MIN_ROTATION_ANGLE,
                 MAX_ROTATION_ANGLE)
    return state.replace(trans_step=trans, rot_step=rot)


def draw_uniforms(spec: SystemSpec, B: int, n_steps: int,
                  generator: torch.Generator) -> torch.Tensor:
    """(B, n_steps, 21) uniforms in the spec dtype on the spec device."""
    return torch.rand((B, n_steps, N_UNIFORMS), generator=generator,
                      device=spec.device, dtype=spec.dtype)


def run_steps_u(spec: SystemSpec, state: SimState, uniforms) -> SimState:
    """n_steps MC steps from explicit uniforms (B, n_steps, 21): a Python
    loop of mc_step_u (the plain path of the block)."""
    for i in range(uniforms.shape[1]):
        state = mc_step_u(spec, state, uniforms[:, i])
    return state


def run_steps(spec: SystemSpec, state: SimState, n_steps: int,
              generator: torch.Generator) -> SimState:
    """n_steps MC steps with uniforms drawn from ``generator``."""
    u = draw_uniforms(spec, state.B, n_steps, generator)
    return run_steps_u(spec, state, u)


def block_body(spec: SystemSpec, state: SimState, n_steps: int,
               recalibrate: bool, generator: torch.Generator) -> SimState:
    """One block on the plain path: n_steps MC steps + recalibration."""
    state = run_steps(spec, state, n_steps, generator)
    return _recalibrate(state, recalibrate)


def resync_amplitudes_body(spec: SystemSpec, state: SimState) -> SimState:
    """Re-synthesize the structure factors and E_RECIP from positions,
    leaving the other energy components running: the per-block f32 drift
    bound (DIVERGENCES.md #13). Plain path of kernels/resync.py."""
    pos = site_positions(spec, state)
    active = active_site_mask(spec, state.n_mol)
    amp_re, amp_im = full_amplitudes(spec, pos, active)
    e_recip = recip_energy(spec, amp_re, amp_im)
    e = state.energy.clone()
    e[:, E_TOT] += e_recip - e[:, E_RECIP]
    e[:, E_RECIP] = e_recip
    return state.replace(amp_re=amp_re, amp_im=amp_im, energy=e)


def refresh_reported_energy(spec: SystemSpec, states: SimState) -> SimState:
    """Exact energy components and amplitudes for the reported replica
    (row 0), recomputed from scratch; the other rows are untouched."""
    st0 = initialize_state(spec, _row(states, 0))
    energy, amp_re, amp_im = (states.energy.clone(), states.amp_re.clone(),
                              states.amp_im.clone())
    energy[0], amp_re[0], amp_im[0] = st0.energy[0], st0.amp_re[0], st0.amp_im[0]
    return states.replace(energy=energy, amp_re=amp_re, amp_im=amp_im)


def _row(states: SimState, b: int) -> SimState:
    return SimState(**{k: v[b:b + 1] for k, v in vars(states).items()})


def drift_report(spec: SystemSpec, state: SimState, replica: int = 0) -> dict:
    """Audit one replica: running energy/amplitudes vs full recompute."""
    st = _row(state, replica)
    e, amp_re, amp_im = system_energy(spec, st)
    return {
        "e_total_running": float(st.energy[0, E_TOT]),
        "e_total_fresh": float(e[0, E_TOT]),
        "drift_K": float(abs(st.energy[0, E_TOT] - e[0, E_TOT])),
        "amp_drift": float(torch.max(torch.abs(st.amp_re - amp_re)
                                     + torch.abs(st.amp_im - amp_im))),
        "recip_running": float(st.energy[0, E_RECIP]),
        "recip_fresh": float(recip_energy(spec, amp_re, amp_im)[0]),
    }
