"""MC driver: step loops, per-block recalibration, amplitude resync, audits.

Counterpart of maniac_tpu/mc/driver.py (see there for the reference's
block loop and the documented recalibration divergence). Every function
works on a batched SimState (leading replica axis B). Uniforms come from
each replica's threefry key (draw_uniforms, as the JAX package draws them)
or are passed in, shaped (B, n_steps, 21).
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
from .moves import _core_plain, mc_step_u


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


def draw_uniforms(spec: SystemSpec, state: SimState, n_steps: int):
    """One block's uniforms from the replicas' keys, as maniac_tpu/mc/
    driver.py::run_steps draws them: per replica (key, sub) = split(key)
    and uniform(sub, (n_steps, 21)) in the spec dtype. Returns (the state
    with the next keys, the (B, n_steps, 21) uniforms); on the card one
    launch of kernels/threefry.py's kernel."""
    from ..kernels.threefry import split_uniform
    key, u = split_uniform(state.key, n_steps, spec.dtype)
    return state.replace(key=key), u


def run_steps_u(spec: SystemSpec, state: SimState, uniforms,
                core=None) -> SimState:
    """n_steps MC steps from explicit uniforms (B, n_steps, 21): the
    per-step path of a block. ``core`` None dispatches: a spec inside
    kernels.step_gate_failure goes to kernels/stepg.py::run_steps_kernel
    (on the card one launch a step; on the CPU the loop below with
    _core_plain), any other runs the loop with _core_plain. A core passed
    (_core_plain) pins the torch loop of mc_step_u."""
    if core is None:
        from ..kernels import step_gate_failure
        if step_gate_failure(spec) is None:
            from ..kernels.stepg import run_steps_kernel
            return run_steps_kernel(spec, state, uniforms)
        core = _core_plain
    for i in range(uniforms.shape[1]):
        state = mc_step_u(spec, state, uniforms[:, i], core)
    return state


def steps_plain(spec: SystemSpec, state: SimState, uniforms) -> SimState:
    """The plain whole steps: run_steps_u pinned to the torch loop with the
    plain energy core, never a kernel. The plain version of both step
    kernels (kernels/blockg.py, kernels/stepg.py)."""
    return run_steps_u(spec, state, uniforms, core=_core_plain)


def block_body_u(spec: SystemSpec, state: SimState, uniforms,
                 recalibrate: bool, core=None) -> SimState:
    """One block on the per-step path from explicit uniforms (B, n_steps,
    21): the MC steps (``core`` as in mc_step_u) + recalibration."""
    return _recalibrate(run_steps_u(spec, state, uniforms, core), recalibrate)


def block_body(spec: SystemSpec, state: SimState, n_steps: int,
               recalibrate: bool) -> SimState:
    """One block on the per-step path: n_steps MC steps from the state's
    keys (draw_uniforms) + recalibration."""
    state, u = draw_uniforms(spec, state, n_steps)
    return block_body_u(spec, state, u, recalibrate)


def resync(spec: SystemSpec, state: SimState) -> SimState:
    """Recompute the energy and the structure factors from positions (the
    command line's per-block refresh of an f32 single chain)."""
    return initialize_state(spec, state)


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


def resync_amplitudes(spec: SystemSpec, state: SimState) -> SimState:
    """Re-synthesize the structure factors and E_RECIP of every replica:
    kernels/resync.py::resync_grouped for a spec inside its gate,
    resync_amplitudes_body otherwise. At B = 1 (a single chain) this is the
    counterpart of maniac_tpu/kernels/resync.py::_resync_kernel."""
    from ..kernels import resync_gate_failure
    if resync_gate_failure(spec) is not None:
        return resync_amplitudes_body(spec, state)
    from ..kernels.resync import resync_grouped
    return resync_grouped(spec, state)


def sentinel_check(spec: SystemSpec, state_pre: SimState,
                   state_post: SimState, uniforms, recalibrate: bool,
                   resync: bool = False) -> dict:
    """Cross-check one block of replica 0 against the plain path, on the
    states' device (the counterpart of maniac_tpu/mc/driver.py::
    sentinel_check; the command line's ``--sentinel N``).

    ``state_post`` is what the dispatched path (on the card: the
    whole-block kernel or the step kernel) made of ``state_pre`` with the
    block's uniforms (B, n_steps, 21). Replica 0 of ``state_pre`` is
    replayed on uniforms[:1] through the steps with the plain energy core
    (``_core_plain``, named so that the replay never takes the step
    kernel), the recalibration and, with ``resync``, the plain amplitude
    resynthesis, and compared with replica 0 of ``state_post``. Returns
    {"n_mol_mismatch", "counter_mismatch", "pos_max_diff",
    "energy_max_diff"}, reduced on the device and read in one transfer.

    Populations and counters must match exactly, positions and energies to
    f32 working precision. What differs between kernel and replay on the
    card: the f32 summation order of the pair, far-field and k-space sums,
    and libdevice erfcf in the kernels against torch.erfc in the replay; a
    Metropolis decision that close to its threshold flips the replay and
    the rest of the block diverges. An isolated divergence is that; one in
    every check, or a growing count, is a fault."""
    replay = block_body_u(spec, _row(state_pre, 0), uniforms[:1],
                          recalibrate, core=_core_plain)
    if resync:
        replay = resync_amplitudes_body(spec, replay)
    post = _row(state_post, 0)
    diffs = torch.stack([
        (replay.n_mol != post.n_mol).sum().double(),
        (replay.counters != post.counters).sum().double(),
        (replay.pos - post.pos).abs().max().double(),
        (replay.energy - post.energy).abs().max().double()]).cpu()
    return {"n_mol_mismatch": int(diffs[0]),
            "counter_mismatch": int(diffs[1]),
            "pos_max_diff": float(diffs[2]),
            "energy_max_diff": float(diffs[3])}


def sentinel_passed(report: dict) -> bool:
    """True when a sentinel_check report shows no divergence: populations
    and counters equal, positions within 1e-3 A (the JAX package's
    rule)."""
    return (report["n_mol_mismatch"] == 0 and report["counter_mismatch"] == 0
            and report["pos_max_diff"] < 1e-3)


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
