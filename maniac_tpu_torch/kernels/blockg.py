"""Whole-block MC kernel for B replicas: CUDA kernel and plain version.

``run_block_kernel`` replaces maniac_tpu/kernels/blockg.py::
run_block_grouped (kernel ``_blockg_kernel``) in its one-active-species,
framework-split, orthorhombic, no-reservoir form (kernels.block_gate_failure
is the gate). For a CUDA state it launches csrc/blockg.cu; for a CPU state
it runs ``block_plain``, a Python loop of mc/moves.py::mc_step_u over the
same uniforms. Step-size recalibration runs after it, in torch.
"""

from __future__ import annotations

import torch

from ..constants import COULOMB_K, PROB_CREATE_DELETE, SMALL, TWOPI
from ..mc.driver import run_steps_u
from ..mc.moves import N_UNIFORMS
from ..system import SimState, SystemSpec
from . import block_gate_failure, build
from .resync import _check


def block_plain(spec: SystemSpec, states: SimState, uniforms) -> SimState:
    """Plain torch version: n_steps of mc_step_u on uniforms (B, n, 21)."""
    return run_steps_u(spec, states, uniforms)


def run_block_kernel(spec: SystemSpec, states: SimState, uniforms) -> SimState:
    """Run uniforms.shape[1] MC steps for every replica; uniforms are
    replica-major (B, n_steps, 21) in the spec dtype."""
    if states.pos.device.type == "cpu":
        return block_plain(spec, states, uniforms)
    dev = states.pos.device
    failure = block_gate_failure(spec)
    if failure is not None:
        raise ValueError(f"the block kernel does not take this spec: "
                         f"{failure}")
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
    out = {k: torch.empty_like(getattr(states, k))
           for k in ("pos", "com", "amp_re", "amp_im", "n_mol", "energy",
                     "counters", "extras")}
    tables = [spec.site_q, spec.site_type, spec.site_midx, spec.site_mol,
              spec.eps_site, spec.sig2_site, spec.type_A, spec.type_cap,
              spec.type_site_base, spec.type_mol_base, spec.type_activity,
              spec.type_self_energy, spec.type_template_off,
              spec.type_q_rows, spec.type_cls_rows, spec.mol_site_start,
              spec.p_cum, spec.bounds[:, 0].contiguous(), spec.box_diag,
              spec.H, spec.two_pi_Hinv, spec.k_weights, spec.k_col_jx,
              spec.k_col_jy, spec.c2_re, spec.c2_im, spec.k2_col_jx,
              spec.k2_col_jy]
    for t in tables:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("spec tables must be contiguous on the state's "
                             "device")
    ins = [uniforms, states.pos, states.com, states.amp_re, states.amp_im,
           states.n_mol, states.energy, states.counters, states.extras,
           states.trans_step, states.rot_step]
    outs = [out[k] for k in ("pos", "com", "amp_re", "amp_im", "n_mol",
                             "energy", "counters", "extras")]
    ptrs = [t.data_ptr() for t in ins + outs + tables]
    kx, ky, kz = spec.kmax_xyz
    kx2, ky2, kz2 = spec.kmax2_xyz
    Jz2P, Jxy2P = spec.amp2_shape
    t_act = [r for r in range(spec.R) if spec.active_list[r]][0]
    ints = [B, n_steps, spec.S, spec.S_frozen, spec.guest_base, spec.R,
            spec.Mtot, spec.A_act, t_act, JzP, JxyP, kx, ky, kz, Jz2P,
            Jxy2P, kx2, ky2, kz2, int(spec.gg_cut)]
    sc = spec.host_scalars
    floats = [sc["alpha"], sc["alpha2"], sc["cutoff"], sc["rcut2"],
              spec.gg_rcut * spec.gg_rcut, sc["temp_K"], sc["volume"],
              sc["fw_d0"], COULOMB_K, TWOPI, PROB_CREATE_DELETE,
              SMALL * SMALL]
    build.launch("blockg_launch", ptrs, ints, floats)
    run_block_kernel.launches += 1
    return states.replace(**out)


run_block_kernel.launches = 0
