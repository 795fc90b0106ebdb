"""Energy core of one MC step for B replicas: CUDA kernel and plain version.

``step_core`` replaces maniac_tpu/kernels/stepg.py::mc_step_core_grouped
(kernel ``_stepg_kernel``), which mc_step_u runs between the proposal and
the bookkeeping (kernels.step_gate_failure is the gate); on a triclinic box
it also takes the core the JAX package leaves to XLA there. For a CUDA state
it launches csrc/stepg.cu; for a CPU state it runs ``step_core_plain``,
mc/moves.py::_core_plain. Both take the proposal dict of
mc/moves.py::_propose and return the dict _bookkeep reads: positions and
amplitudes after the commit, and per replica acc, e_recip_new,
delta_e, e_lj (B, 2) and e_coul (B, 2).
"""

from __future__ import annotations

import torch

from ..constants import COULOMB_K, TWOPI
from ..mc.moves import _core_plain
from ..system import SimState, SystemSpec
from . import build, split_args, step_gate_failure
from .resync import _check

step_core_plain = _core_plain


def _spec_tables(spec: SystemSpec) -> list:
    """The spec tables the kernel reads, in its pointer order."""
    return [spec.site_q, spec.site_type, spec.site_midx, spec.site_mol,
            spec.eps_site, spec.sig2_site, spec.type_A, spec.type_site_base,
            spec.box_diag, spec.two_pi_Hinv, spec.k_weights, spec.k_col_jx,
            spec.k_col_jy, spec.far_coef, spec.far_rows, spec.far_units,
            spec.image_shifts]


def step_core(spec: SystemSpec, states: SimState, pre: dict) -> dict:
    """Pair, far-field and k-space energies of each replica's proposal,
    the Metropolis test and the commits."""
    if states.pos.device.type == "cpu":
        return step_core_plain(spec, states, pre)
    out = _launch(spec, states, pre)
    step_core.launches += 1
    return out


def _launch(spec: SystemSpec, states: SimState, pre: dict) -> dict:
    """Check the inputs, allocate the outputs and launch csrc/stepg.cu."""
    dev = states.pos.device
    failure = step_gate_failure(spec)
    if failure is not None:
        raise ValueError(f"the step kernel does not take this spec: "
                         f"{failure}")
    B, A = states.B, spec.A_act
    JzP, JxyP = spec.amp_shape
    f32, i32 = torch.float32, torch.int32
    _check("pos", states.pos, (B, 3, spec.S), f32, dev)
    _check("amp_re", states.amp_re, (B, JzP, JxyP), f32, dev)
    _check("amp_im", states.amp_im, (B, JzP, JxyP), f32, dev)
    _check("n_mol", states.n_mol, (B, spec.R + 1), i32, dev)
    P = torch.stack([pre["P_old"], pre["P_new"]], dim=1).contiguous()
    q = torch.stack([pre["q_old"], pre["q_new"]], dim=1).contiguous()
    cls = torch.stack([pre["cls_old"], pre["cls_new"]], dim=1).to(i32)
    m = pre["m2"].to(i32)
    last = pre["last_cols"].contiguous()
    iscal = torch.stack([pre[k].to(i32) for k in (
        "ex_a", "ex_b", "site_start_old", "site_start_new", "A_old", "A_new",
        "remove_like", "w_new", "gate")], dim=1)
    fscal = torch.stack([
        pre["s_old"], pre["i_old"], pre["s_new"], pre["i_new"],
        pre["e_recip_old"], pre["pref"], pre["u_acc"]], dim=1).contiguous()
    _check("P", P, (B, 2, A, 3), f32, dev)
    _check("q", q, (B, 2, A), f32, dev)
    _check("cls", cls, (B, 2, A), i32, dev)
    _check("m2", m, (B, 2, A), i32, dev)
    _check("last_cols", last, (B, 3, A), f32, dev)
    _check("iscal", iscal, (B, 9), i32, dev)
    _check("fscal", fscal, (B, 7), f32, dev)
    tables = _spec_tables(spec)
    for t in tables:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("spec tables must be contiguous on the state's "
                             "device")
    pos = torch.empty_like(states.pos)
    amp_re = torch.empty_like(states.amp_re)
    amp_im = torch.empty_like(states.amp_im)
    flags = torch.empty((B, 8), dtype=f32, device=dev)
    ins = [states.pos, states.amp_re, states.amp_im, states.n_mol, P, q,
           cls, m, last, iscal, fscal]
    ptrs = [t.data_ptr() for t in ins + [pos, amp_re, amp_im, flags]
            + tables]
    kx, ky, kz = spec.kmax_xyz
    sc = spec.host_scalars
    fw, (kx2, ky2, kz2), fw_d0, n_far_tiles = split_args(spec)
    ints = [B, spec.S, *fw, spec.R, A, JzP, JxyP, kx, ky, kz, kx2, ky2, kz2,
            n_far_tiles, int(spec.gg_cut), int(spec.is_triclinic)]
    floats = [sc["alpha"], sc["alpha2"], sc["cutoff"], sc["rcut2"],
              spec.gg_rcut * spec.gg_rcut, sc["temp_K"], sc["volume"],
              fw_d0, COULOMB_K, TWOPI]
    build.launch("stepg_launch", ptrs, ints, floats)
    acc = flags[:, 0] > 0.5
    return dict(pos=pos, amp_re=amp_re, amp_im=amp_im, acc=acc,
                e_recip_new=flags[:, 1],
                delta_e=flags[:, 2], e_lj=flags[:, 3:5],
                e_coul=flags[:, 5:7])


step_core.launches = 0
