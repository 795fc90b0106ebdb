"""Whole MC steps for B replicas, one launch a step: CUDA kernel, and the
tables both step kernels take.

``run_steps_kernel`` replaces maniac_tpu/kernels/stepg.py::
mc_step_core_grouped (kernel ``_stepg_kernel``) together with the proposal
and the bookkeeping mc_step_u runs around it (kernels.step_gate_failure is
the gate); on a triclinic box it also takes the core the JAX package leaves
to XLA there. For a CUDA state it clones the state once and launches
csrc/stepg.cu once per step on the clone, in place; for a CPU state it runs
its plain version, mc/driver.py::steps_plain (the torch loop of
mc/moves.py::mc_step_u with the plain energy core). ``step_core_plain``
(mc/moves.py::_core_plain) is that core, which the parity tests hold to
the JAX package's Pallas step core.

``step_tables`` packs the tables csrc/step_body.cuh names (StepPtr,
StepInt, StepFloat), which the whole-block kernel (kernels/blockg.py) takes
too, each kernel with its own entries after them.
"""

from __future__ import annotations

import torch

from ..constants import COULOMB_K, PROB_CREATE_DELETE, SMALL, TWOPI
from ..mc.driver import steps_plain
from ..mc.moves import N_UNIFORMS, _core_plain
from ..system import SimState, SystemSpec
from . import build, step_gate_failure
from .resync import _check

step_core_plain = _core_plain

# the state a step writes, in csrc/step_body.cuh's pointer order (SP_POS ..
# SP_EXTRAS, then SP_RES_OFF .. SP_RES_N)
STATE_KEYS = ("pos", "com", "amp_re", "amp_im", "n_mol", "energy",
              "counters", "extras")
RES_KEYS = ("res_offset", "res_com", "res_n")


def step_tables(spec: SystemSpec, states: SimState, uniforms,
                work: SimState) -> tuple[list, list, list]:
    """Check a block's inputs (``states``, uniforms (B, n_steps, 21)) and
    pack the tables of csrc/step_body.cuh with ``work`` as the state the
    kernel writes (the block kernel's outputs, the step kernel's working
    copy): (pointers, ints, floats)."""
    dev = states.pos.device
    B, n_steps = states.B, uniforms.shape[1]
    M1 = spec.Mtot + 1
    JzP, JxyP = spec.amp_shape
    f32, i32 = torch.float32, torch.int32
    _check("uniforms", uniforms, (B, n_steps, N_UNIFORMS), f32, dev)
    _check("pos", states.pos, (B, 3, spec.S), f32, dev)
    _check("com", states.com, (B, 3, M1), f32, dev)
    _check("amp_re", states.amp_re, (B, JzP, JxyP), f32, dev)
    _check("amp_im", states.amp_im, (B, JzP, JxyP), f32, dev)
    _check("n_mol", states.n_mol, (B, spec.R + 1), i32, dev)
    _check("energy", states.energy, (B, 6), f32, dev)
    _check("counters", states.counters, (B, 2, 5), i32, dev)
    _check("extras", states.extras, (B, 4), i32, dev)
    _check("trans_step", states.trans_step, (B,), f32, dev)
    _check("rot_step", states.rot_step, (B,), f32, dev)
    Sres, Mres1 = states.res_offset.shape[1], states.res_com.shape[1]
    _check("res_offset", states.res_offset, (B, Sres, 3), f32, dev)
    _check("res_com", states.res_com, (B, Mres1, 3), f32, dev)
    _check("res_n", states.res_n, (B, spec.R + 1), i32, dev)
    tables = [spec.site_q, spec.site_type, spec.site_midx, spec.site_mol,
              spec.eps_site, spec.sig2_site, spec.type_A, spec.type_cap,
              spec.type_site_base, spec.type_mol_base, spec.type_activity,
              spec.type_self_energy, spec.type_template_off,
              spec.type_q_rows, spec.type_cls_rows, spec.mol_site_start,
              spec.p_cum, spec.bounds[:, 0].contiguous(), spec.box_diag,
              spec.H, spec.two_pi_Hinv, spec.k_weights, spec.k_col_jx,
              spec.k_col_jy, spec.far_coef, spec.far_rows, spec.far_units]
    res_tables = [spec.res_type_site_base, spec.res_type_mol_base,
                  spec.res_cap, spec.res_H]
    box_tables = [spec.active_type_ids, spec.Hinv, spec.image_shifts]
    for t in tables + res_tables + box_tables:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("spec tables must be contiguous on the state's "
                             "device")
    ptrs = [t.data_ptr() for t in (
        uniforms, *[getattr(work, k) for k in STATE_KEYS], work.trans_step,
        work.rot_step, *tables, *[getattr(work, k) for k in RES_KEYS],
        *res_tables, *box_tables)]
    # the framework split's arguments; without it no frozen prefix and an
    # empty far table, so every live site takes erfc(alpha r)/r
    if spec.fw_split:
        fw, kmax2 = [spec.S_frozen, spec.guest_base], spec.kmax2_xyz
        fw_d0, n_far_tiles = (spec.host_scalars["fw_d0"],
                              int(spec.far_units.shape[0]))
    else:
        fw, kmax2, fw_d0, n_far_tiles = [0, 0], (0, 0, 0), 0.0, 0
    sc = spec.host_scalars
    ints = [B, n_steps, spec.S, *fw, spec.R, spec.Mtot, spec.A_act,
            spec.n_active, JzP, JxyP, *spec.kmax_xyz, *kmax2, n_far_tiles,
            int(spec.gg_cut), int(spec.has_reservoir), Sres, Mres1,
            int(spec.is_triclinic)]
    floats = [sc["alpha"], sc["alpha2"], sc["cutoff"], sc["rcut2"],
              spec.gg_rcut * spec.gg_rcut, sc["temp_K"], sc["volume"],
              fw_d0, COULOMB_K, TWOPI, PROB_CREATE_DELETE, SMALL * SMALL]
    return ptrs, ints, floats


def run_steps_kernel(spec: SystemSpec, states: SimState,
                     uniforms) -> SimState:
    """Run uniforms.shape[1] MC steps for every replica; uniforms are
    replica-major (B, n_steps, 21) in the spec dtype. The caller's states
    are never written."""
    if states.pos.device.type == "cpu":
        return steps_plain(spec, states, uniforms)
    return _run(spec, states, uniforms)


def _run(spec: SystemSpec, states: SimState, uniforms) -> SimState:
    """Check the inputs once, clone the state once and launch csrc/stepg.cu
    once per step on the clone (the tables are the same for every step of
    the block but for the step index)."""
    failure = step_gate_failure(spec)
    if failure is not None:
        raise ValueError(f"the step kernel does not take this spec: "
                         f"{failure}")
    act = spec.type_activity
    act_stride = spec.R if act.dim() == 2 else 0
    if act_stride and tuple(act.shape) != (states.B, spec.R):
        raise ValueError(f"a per-replica activity must be ({states.B}, "
                         f"{spec.R}), got {tuple(act.shape)}")
    # the working copy the launches update in place (SimState.replace
    # shares tensors, so the caller's state must never reach the kernel);
    # without a reservoir the (tiny, unread) reservoir tensors pass through
    keys = STATE_KEYS + (RES_KEYS if spec.has_reservoir else ())
    work = states.replace(**{k: getattr(states, k).clone() for k in keys})
    ptrs, ints, floats = step_tables(spec, states, uniforms, work)
    # stepg.cu's own ints after the shared ones: SI_STEP, SI_ACT_STRIDE
    si_step = len(ints)
    ints += [0, act_stride]
    for step in range(uniforms.shape[1]):
        ints[si_step] = step
        build.launch("stepg_launch", ptrs, ints, floats, work.pos.device)
        run_steps_kernel.launches += 1
    return work


run_steps_kernel.launches = 0
