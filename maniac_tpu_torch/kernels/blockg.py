"""Whole-block MC kernel for B replicas: CUDA kernel and plain version.

``run_block_kernel`` replaces maniac_tpu/kernels/blockg.py::
run_block_grouped (kernel ``_blockg_kernel``) in all its f32 forms: one or
more active species (with the swap move), framework split or no split with
every type active, an orthorhombic or a triclinic box, each with or
without a reservoir (kernels.block_gate_failure is the gate).
For a CUDA state it launches csrc/blockg.cu; for a CPU state it runs
``block_plain``, a Python loop of mc/moves.py::mc_step_u with the plain
energy core (and the reservoir moves) over the same uniforms. Step-size
recalibration runs after it, in torch.
"""

from __future__ import annotations

import torch

from ..constants import COULOMB_K, PROB_CREATE_DELETE, SMALL, TWOPI
from ..mc.driver import run_steps_u
from ..mc.moves import N_UNIFORMS, _core_plain
from ..system import SimState, SystemSpec
from . import block_gate_failure, build, split_args
from .resync import _check


def block_plain(spec: SystemSpec, states: SimState, uniforms) -> SimState:
    """Plain torch version: n_steps of mc_step_u with the plain energy core
    on uniforms (B, n, 21)."""
    return run_steps_u(spec, states, uniforms, core=_core_plain)


def run_block_kernel(spec: SystemSpec, states: SimState, uniforms) -> SimState:
    """Run uniforms.shape[1] MC steps for every replica; uniforms are
    replica-major (B, n_steps, 21) in the spec dtype."""
    if states.pos.device.type == "cpu":
        return block_plain(spec, states, uniforms)
    out = _launch(spec, states, uniforms)
    run_block_kernel.launches += 1
    return out


def _launch(spec, states, uniforms):
    """Check the inputs, allocate the outputs and launch csrc/blockg.cu."""
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
    Sres, Mres1 = states.res_offset.shape[1], states.res_com.shape[1]
    _check("res_offset", states.res_offset, (B, Sres, 3), f32, dev)
    _check("res_com", states.res_com, (B, Mres1, 3), f32, dev)
    _check("res_n", states.res_n, (B, spec.R + 1), i32, dev)
    out = {k: torch.empty_like(getattr(states, k))
           for k in ("pos", "com", "amp_re", "amp_im", "n_mol", "energy",
                     "counters", "extras")}
    # the kernel writes the reservoir only when there is one; otherwise the
    # (tiny, unread) dummies pass through as they are
    res_keys = ("res_offset", "res_com", "res_n")
    res_out = {k: (torch.empty_like(getattr(states, k))
                   if spec.has_reservoir else getattr(states, k))
               for k in res_keys}
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
    ins = [uniforms, states.pos, states.com, states.amp_re, states.amp_im,
           states.n_mol, states.energy, states.counters, states.extras,
           states.trans_step, states.rot_step]
    outs = [out[k] for k in ("pos", "com", "amp_re", "amp_im", "n_mol",
                             "energy", "counters", "extras")]
    ptrs = [t.data_ptr() for t in ins + outs + tables
            + [getattr(states, k) for k in res_keys]
            + [res_out[k] for k in res_keys] + res_tables + box_tables]
    kx, ky, kz = spec.kmax_xyz
    sc = spec.host_scalars
    fw, (kx2, ky2, kz2), fw_d0, n_far_tiles = split_args(spec)
    ints = [B, n_steps, spec.S, *fw, spec.R, spec.Mtot, spec.A_act,
            spec.n_active, JzP, JxyP, kx, ky, kz, kx2, ky2, kz2, n_far_tiles,
            int(spec.gg_cut), int(spec.has_reservoir), Sres, Mres1,
            int(spec.is_triclinic)]
    floats = [sc["alpha"], sc["alpha2"], sc["cutoff"], sc["rcut2"],
              spec.gg_rcut * spec.gg_rcut, sc["temp_K"], sc["volume"],
              fw_d0, COULOMB_K, TWOPI, PROB_CREATE_DELETE, SMALL * SMALL]
    build.launch("blockg_launch", ptrs, ints, floats)
    return states.replace(**out, **res_out)


run_block_kernel.launches = 0
