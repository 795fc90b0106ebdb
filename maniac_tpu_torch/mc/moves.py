"""The Metropolis MC step over B replicas: (SimState, uniforms) -> SimState.

Counterpart of maniac_tpu/mc/moves.py (see its docstring for the unified
remove-footprint + insert-footprint design). Every move is one masked
computation; a rejected move keeps the old state. Replicas are the leading
axis of every tensor, and each step consumes one row of N_UNIFORMS = 21
uniforms per replica, laid out exactly as the JAX package draws them, so
both packages walk the same chain when fed the same uniforms.

Footprints are read with gathers (the JAX package's one-hot matmul reads
were a TPU layout workaround). With a reservoir (``-r``) an insertion takes
a random reservoir molecule's geometry as it is, and _update_reservoir pops
and pushes reservoir molecules after the bookkeeping. The energy core of a
step is ``_core_plain`` here. For a spec inside kernels.step_gate_failure,
mc_step_u and mc/driver.py::run_steps_u run whole steps through
kernels/stepg.py::run_steps_kernel, which launches kernels/csrc/stepg.cu
(the proposal, the core and the bookkeeping in one launch a step) for CUDA
tensors and runs this torch step for CPU tensors. On the card, a block
inside the whole-block kernel's gate runs in kernels/csrc/blockg.cu.
"""

from __future__ import annotations

import torch

from ..constants import (PROB_CREATE_DELETE, TWOPI, TYPE_CREATION,
                         TYPE_DELETION, TYPE_ROTATION, TYPE_SWAP,
                         TYPE_TRANSLATION)
from ..physics.energy import (active_site_mask, amp_delta, intra_energy,
                              pair_energy_footprint, recip_energy_delta,
                              site_positions)
from ..physics.pbc import wrap_into_box
from ..system import E_RECIP, N_MOVE_TYPES, SimState, SystemSpec
from ..utils.threefry import uniform

N_UNIFORMS = 21  # uniforms consumed per MC step (see mc_step_u)


def _axis_rotation(axis, theta):
    """(B, 3, 3) rotations about axis 0/1/2 (reference:
    src/helper_utils.f90:39-77); axis (B,) int, theta (B,)."""
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rx = torch.stack([one, zero, zero, zero, c, -s, zero, s, c], -1)
    ry = torch.stack([c, zero, s, zero, one, zero, -s, zero, c], -1)
    rz = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], -1)
    mats = torch.stack([rx, ry, rz], 1).reshape(-1, 3, 3, 3)   # (B,axis,3,3)
    return mats[torch.arange(mats.shape[0], device=c.device), axis.long()]


def _uniform_rotation(u):
    """(B, 3, 3) uniform SO(3) rotations (Shoemake quaternion from 3
    uniforms, u (B, 3)); see DIVERGENCES.md on template insertions."""
    a, b = torch.sqrt(1.0 - u[:, 0]), torch.sqrt(u[:, 0])
    t2, t3 = TWOPI * u[:, 1], TWOPI * u[:, 2]
    w, x = a * torch.sin(t2), a * torch.cos(t2)
    y, z = b * torch.sin(t3), b * torch.cos(t3)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def _uint(u, n):
    """floor(u * n) as a uniform int in [0, n), clamped against u*n rounding
    up to n in f32. u (B,) float, n (B,) int32 or a python int (kept on the
    host: no copy to the device per step)."""
    if isinstance(n, int):
        return torch.clamp((u * n).to(torch.int32), max=n - 1)
    return torch.minimum((u * n.to(u.dtype)).to(torch.int32), n - 1)


def _gather_cols(x, idx):
    """x (B, 3, N), idx (B, A) -> (B, 3, A): columns idx of each replica."""
    return torch.gather(x, 2, idx.long()[:, None, :].expand(-1, 3, -1))


def _gather_rows(x, idx):
    """x (B, N, 3), idx (B, A) -> (B, A, 3): rows idx of each replica."""
    return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, 3))


def _scatter_rows(x, idx, rows, mask):
    """Write rows (B, A, 3) into x (B, N, 3) at rows idx (B, A) where
    mask (B, A); returns a new tensor."""
    idx3 = idx.long()[:, :, None].expand(-1, -1, 3)
    cur = torch.gather(x, 1, idx3)
    return x.scatter(1, idx3, torch.where(mask[:, :, None], rows, cur))


def _scatter_cols(x, idx, cols, mask):
    """Write cols (B, 3, A) into x (B, 3, N) at columns idx (B, A) where
    mask (B, A); returns a new tensor."""
    idx3 = idx.long()[:, None, :].expand(-1, 3, -1)
    cur = torch.gather(x, 2, idx3)
    return x.scatter(2, idx3, torch.where(mask[:, None, :], cols, cur))


def mc_step(spec: SystemSpec, states: SimState, key) -> SimState:
    """One MC trial per replica from a threefry key: the single-step API
    of maniac_tpu/mc/moves.py::mc_step, which draws uniform(key,
    (N_UNIFORMS,)) in the spec dtype and runs mc_step_u. ``key`` is (2,)
    (every replica steps on its uniforms; one key walks JAX's chain at
    B = 1) or (B, 2), one key a replica. The step dispatches as mc_step_u
    does."""
    u = uniform(key, (N_UNIFORMS,), spec.dtype).reshape(-1, N_UNIFORMS)
    return mc_step_u(spec, states, u.expand(states.B, -1))


def mc_step_u(spec: SystemSpec, states: SimState, u, core=None) -> SimState:
    """One MC trial per replica from a row of uniforms u (B, 21):
    proposal, energy core, bookkeeping. ``core`` None dispatches as
    mc/driver.py::run_steps_u does for one step (a spec inside
    kernels.step_gate_failure: kernels/stepg.py::run_steps_kernel); pass a
    core (_core_plain) to pin the torch step."""
    if core is None:
        from .driver import run_steps_u
        return run_steps_u(spec, states, u[:, None].contiguous())
    pre = _propose(spec, states, u)
    core_out = core(spec, states, pre)
    new = _bookkeep(spec, states, pre, core_out)
    if spec.has_reservoir:
        new = _update_reservoir(spec, states, new, pre, core_out["acc"],
                                u[:, 18:21])
    return new


def _propose(spec: SystemSpec, st: SimState, u) -> dict:
    """Move/type/molecule draws, footprint reads, proposal geometry,
    intra/self terms and the acceptance prefactor (moves.py::_propose)."""
    dev = u.device
    B = u.shape[0]
    u_move, u_cd, u_acc = u[:, 0], u[:, 1], u[:, 2]
    u_disp = u[:, 3:6] - 0.5
    u_frac = u[:, 6:9]
    u_angle = u[:, 9]
    axis = _uint(u[:, 10], 3)

    # ---- move class (reference: src/monte_carlo.f90:50-75) ---------------
    is_trans = u_move <= spec.p_cum[0]
    is_rot = ~is_trans & (u_move <= spec.p_cum[1])
    is_indel = ~is_trans & ~is_rot & (u_move <= spec.p_cum[2])
    can_swap = spec.n_active >= 2
    is_swap = (~is_trans & ~is_rot & ~is_indel if can_swap
               else torch.zeros_like(is_trans))
    is_create = is_indel & (u_cd <= PROB_CREATE_DELETE)
    is_delete = is_indel & ~is_create
    move = torch.where(is_create, TYPE_CREATION,
           torch.where(is_delete, TYPE_DELETION,
           torch.where(is_trans, TYPE_TRANSLATION,
           torch.where(is_rot, TYPE_ROTATION, TYPE_SWAP))))
    insert_like = is_create | is_swap
    remove_like = is_delete | is_swap
    w_old = is_trans | is_rot | is_delete | is_swap
    w_new = is_trans | is_rot | is_create | is_swap

    # ---- residue types and molecule --------------------------------------
    i1 = _uint(u[:, 11], spec.n_active)
    if can_swap:
        di = 1 + _uint(u[:, 12], spec.n_active - 1)
        i2 = (i1 + di) % spec.n_active
    else:
        i2 = i1
    t_old = spec.active_type_ids[i1.long()].long()
    t_new = torch.where(is_swap, spec.active_type_ids[i2.long()].long(), t_old)
    rows = torch.arange(B, device=dev)
    n_old_count = st.n_mol[rows, t_old]
    n_new_count = st.n_mol[rows, t_new]
    m_old = _uint(u[:, 13], torch.clamp(n_old_count, min=1))
    A_old = spec.type_A[t_old]
    A_new = spec.type_A[t_new]

    # a swap draw with < 2 active species is dropped (DIVERGENCES.md #23)
    dead_draw = (torch.zeros_like(is_trans) if can_swap
                 else ~is_trans & ~is_rot & ~is_indel)
    valid = torch.where(is_create, True,
                        torch.where(is_rot, (n_old_count > 0) & (A_old > 1),
                                    n_old_count > 0)) & ~dead_draw
    if spec.has_reservoir:
        # an empty reservoir blocks insertions of that species
        res_n_new = st.res_n[rows, t_new]
        valid = valid & (~insert_like | (res_n_new > 0))
    cap_new = spec.type_cap[t_new]
    cap_blocked = insert_like & (n_new_count >= cap_new)

    # ---- footprints --------------------------------------------------------
    A_act = spec.A_act
    a_iota = torch.arange(A_act, device=dev, dtype=torch.int32)
    mol_slot_old = spec.type_mol_base[t_old] + m_old
    site_start_old = spec.type_site_base[t_old] + m_old * A_old
    slot_new = torch.where(
        insert_like,
        spec.type_mol_base[t_new] + torch.minimum(n_new_count, cap_new - 1),
        mol_slot_old)
    site_start_new = spec.mol_site_start[slot_new.long()]
    last_idx = torch.clamp(n_old_count - 1, min=0)
    start_last = spec.type_site_base[t_old] + last_idx * A_old
    P_old = _gather_cols(st.pos, site_start_old[:, None] + a_iota)
    P_old = P_old.transpose(1, 2)                                # (B, A, 3)
    last_cols = _gather_cols(st.pos, start_last[:, None] + a_iota)
    slot_last = spec.type_mol_base[t_old] + last_idx
    com_old = _gather_cols(st.com, mol_slot_old[:, None])[:, :, 0]
    com_last = _gather_cols(st.com, slot_last[:, None])[:, :, 0]
    off_old = P_old - com_old[:, None, :]

    q_old = spec.type_q_rows[t_old]
    cls_old = spec.type_cls_rows[t_old]
    mask_old = a_iota[None, :] < A_old[:, None]
    q_new = spec.type_q_rows[t_new]
    cls_new = spec.type_cls_rows[t_new]
    mask_new = a_iota[None, :] < A_new[:, None]

    # insertion geometry: a random reservoir molecule used as it is (-r),
    # else the type's rigid template with a uniform random orientation;
    # translation/rotation move the molecule's own offsets
    theta = torch.where(is_rot, (u_angle - 0.5) * st.rot_step, 0.0)
    if spec.has_reservoir:
        res_pick = _uint(u[:, 14], torch.clamp(res_n_new, min=1))
        res_src = spec.res_type_site_base[t_new] + res_pick * A_new
        res_rows = _gather_rows(st.res_offset, res_src[:, None] + a_iota)
        off_src = torch.where(insert_like[:, None, None], res_rows, off_old)
        Rm = _axis_rotation(axis, theta)
    else:
        res_pick = torch.zeros_like(m_old)
        off_src = torch.where(insert_like[:, None, None],
                              spec.type_template_off[t_new], off_old)
        Rm = torch.where(insert_like[:, None, None],
                         _uniform_rotation(u[:, 15:18]),
                         _axis_rotation(axis, theta))
    new_off = off_src @ Rm.transpose(1, 2)

    com_trans = wrap_into_box(com_old + u_disp * st.trans_step[:, None], spec)
    com_insert = spec.bounds[:, 0] + u_frac @ spec.H.T
    com_new = torch.where(is_trans[:, None], com_trans,
                          torch.where(is_create[:, None], com_insert, com_old))
    P_new = com_new[:, None, :] + new_off

    # ---- intra / self terms, acceptance prefactor --------------------------
    ex_a = torch.where(w_old, mol_slot_old, spec.Mtot + 1)
    ex_b = slot_new
    i_old = torch.where(remove_like & valid,
                        intra_energy(spec, P_old, q_old, mask_old), 0.0)
    i_new = torch.where(insert_like,
                        intra_energy(spec, P_new, q_new, mask_new), 0.0)
    s_old = torch.where(remove_like, spec.type_self_energy[t_old], 0.0)
    s_new = torch.where(insert_like, spec.type_self_energy[t_new], 0.0)

    V = spec.volume
    nf = n_new_count.to(u.dtype)
    no = n_old_count.to(u.dtype)
    act = spec.type_activity
    if act.dim() == 2:  # (B, R): one activity table per replica (a sweep)
        act_new, act_old = act[rows, t_new], act[rows, t_old]
    else:
        act_new, act_old = act[t_new], act[t_old]
    pref = torch.where(insert_like, act_new * V / (nf + 1.0), 1.0)
    pref = pref * torch.where(remove_like, no / (act_old * V), 1.0)
    gate = valid & ~cap_blocked
    m2 = torch.stack([mask_old & w_old[:, None], mask_new & w_new[:, None]],
                     dim=1)                                      # (B, 2, A)
    return dict(
        u_acc=u_acc, insert_like=insert_like, remove_like=remove_like,
        w_old=w_old, w_new=w_new, valid=valid, cap_blocked=cap_blocked,
        gate=gate, move=move, t_old=t_old, t_new=t_new, A_old=A_old,
        A_new=A_new, mol_slot_old=mol_slot_old, slot_new=slot_new,
        site_start_old=site_start_old, site_start_new=site_start_new,
        ex_a=ex_a, ex_b=ex_b, P_old=P_old, P_new=P_new, q_old=q_old,
        q_new=q_new, cls_old=cls_old, cls_new=cls_new, m2=m2,
        last_cols=last_cols, com_new=com_new, com_last=com_last,
        off_old=off_old, res_pick=res_pick, i_old=i_old, i_new=i_new,
        s_old=s_old, s_new=s_new,
        e_recip_old=st.energy[:, E_RECIP], pref=pref)


def _core_plain(spec: SystemSpec, st: SimState, pre: dict) -> dict:
    """Energy core, Metropolis test and position/amplitude commits
    (counterpart of moves.py::_core_xla)."""
    fdt = spec.dtype
    P = torch.stack([pre["P_old"], pre["P_new"]], dim=1)         # (B,2,A,3)
    q2 = torch.stack([pre["q_old"], pre["q_new"]], dim=1)
    cls2 = torch.stack([pre["cls_old"], pre["cls_new"]], dim=1)
    m2 = pre["m2"]
    e_lj, e_coul = pair_energy_footprint(
        spec, site_positions(spec, st), active_site_mask(spec, st.n_mol),
        P, q2, cls2, m2, pre["ex_a"], pre["ex_b"])

    signs = torch.stack([-pre["w_old"].to(fdt), pre["w_new"].to(fdt)], dim=1)
    d_re, d_im = amp_delta(spec, P, q2, m2, signs)
    e_recip_old = pre["e_recip_old"]
    e_other_old = e_lj[:, 0] + e_coul[:, 0] + pre["s_old"] + pre["i_old"]
    e_other_new = e_lj[:, 1] + e_coul[:, 1] + pre["s_new"] + pre["i_new"]
    e_recip_new = e_recip_old + recip_energy_delta(
        spec, st.amp_re, st.amp_im, d_re, d_im)
    delta_e = (e_other_new + e_recip_new) - (e_other_old + e_recip_old)
    # torch.minimum propagates NaN (a NaN p_acc rejects), as jnp.minimum
    p_acc = torch.minimum(pre["pref"] * torch.exp(-delta_e / spec.temp_K),
                          torch.ones_like(delta_e))
    # strict: a move whose acceptance probability is 0 (exp underflows)
    # is never accepted, as in the Fortran reference; u_acc is 0.0 for one
    # f32 draw in 2^23, where the JAX package's <= accepts (PERF.md, "Where
    # the port departs from the JAX package")
    acc = pre["gate"] & (pre["u_acc"] < p_acc)
    accf = acc.to(fdt)

    # compaction first (the type's last molecule moves into the removed
    # slot), then the written molecule; new rows win where both apply
    a_iota = torch.arange(spec.A_act, device=acc.device)
    in_old = (acc & pre["remove_like"])[:, None] & (
        a_iota[None, :] < pre["A_old"][:, None])
    in_new = (acc & pre["w_new"])[:, None] & (
        a_iota[None, :] < pre["A_new"][:, None])
    pos = _scatter_cols(st.pos, pre["site_start_old"][:, None] + a_iota,
                        pre["last_cols"], in_old)
    pos = _scatter_cols(pos, pre["site_start_new"][:, None] + a_iota,
                        pre["P_new"].transpose(1, 2), in_new)
    return dict(pos=pos,
                amp_re=st.amp_re + accf[:, None, None] * d_re,
                amp_im=st.amp_im + accf[:, None, None] * d_im,
                acc=acc, e_recip_new=e_recip_new,
                delta_e=delta_e, e_lj=e_lj, e_coul=e_coul)


def _bookkeep(spec: SystemSpec, st: SimState, pre: dict,
              core: dict) -> SimState:
    """COM, population, energy and counter updates (moves.py::_bookkeep)."""
    acc = core["acc"]
    e_lj, e_coul = core["e_lj"], core["e_coul"]
    insert_like, remove_like = pre["insert_like"], pre["remove_like"]
    B = acc.shape[0]
    rows = torch.arange(B, device=acc.device)

    com = _scatter_cols(st.com, pre["mol_slot_old"][:, None],
                        pre["com_last"][:, :, None],
                        (acc & remove_like)[:, None])
    com = _scatter_cols(com, pre["slot_new"][:, None],
                        pre["com_new"][:, :, None],
                        (acc & pre["w_new"])[:, None])

    n_mol = st.n_mol.clone()
    n_mol[rows, pre["t_new"]] += (acc & insert_like).to(torch.int32)
    n_mol[rows, pre["t_old"]] -= (acc & remove_like).to(torch.int32)

    # the deltas of accepted moves only, selected rather than multiplied by
    # 0/1: a rejected overlap's LJ is inf - inf = NaN (r2 at its floor), and
    # 0 x NaN would stay in the running energies (the JAX package
    # multiplies, moves.py:502-509; only its jitted step comes out finite)
    comp_delta = torch.stack([
        core["e_recip_new"] - st.energy[:, E_RECIP],
        e_lj[:, 1] - e_lj[:, 0],
        e_coul[:, 1] - e_coul[:, 0],
        pre["s_new"] - pre["s_old"],
        pre["i_new"] - pre["i_old"],
        core["delta_e"],
    ], dim=1)
    energy = st.energy + torch.where(acc[:, None], comp_delta, 0.0)

    oh_move = (torch.arange(N_MOVE_TYPES, device=acc.device)[None, :]
               == pre["move"][:, None])
    counters = st.counters + torch.stack([
        oh_move & pre["valid"][:, None], oh_move & acc[:, None]],
        dim=1).to(torch.int32)
    extras = st.extras.clone()
    extras[:, 0] += (pre["valid"] & pre["cap_blocked"]).to(torch.int32)
    return st.replace(com=com, pos=core["pos"], n_mol=n_mol,
                      amp_re=core["amp_re"], amp_im=core["amp_im"],
                      energy=energy, counters=counters, extras=extras)


def _update_reservoir(spec: SystemSpec, old: SimState, st: SimState,
                      pre: dict, acc, u3) -> SimState:
    """Reservoir bookkeeping on accepted insertions/deletions/swaps
    (moves.py::_update_reservoir; reference: src/create_molecule.f90:117-129
    pop-on-insert, src/delete_molecule.f90:148-166 push-on-delete).

    Pop: the sampled reservoir molecule is replaced by the reservoir's last
    molecule of its type. Push: the removed molecule's offsets are stored
    at a random centred position of the reservoir box, res_H (u3 - 0.5). A
    full reservoir drops the pushed molecule and counts it in extras[:, 1].
    Push rows are written first, then pop rows: pop wins where both write,
    and both read the reservoir as it was before the step."""
    B = acc.shape[0]
    rows = torch.arange(B, device=acc.device)
    a_iota = torch.arange(spec.A_act, device=acc.device, dtype=torch.int32)
    t_old, t_new = pre["t_old"], pre["t_new"]
    A_old, A_new = pre["A_old"], pre["A_new"]
    res_n = old.res_n

    do_pop = acc & pre["insert_like"]
    n_pop = res_n[rows, t_new]
    last = torch.clamp(n_pop - 1, min=0)
    pop_slot = spec.res_type_mol_base[t_new] + pre["res_pick"]
    last_slot = spec.res_type_mol_base[t_new] + last
    pop_start = spec.res_type_site_base[t_new] + pre["res_pick"] * A_new
    last_start = spec.res_type_site_base[t_new] + last * A_new
    last_rows = _gather_rows(old.res_offset, last_start[:, None] + a_iota)
    last_com = _gather_rows(old.res_com, last_slot[:, None])

    n_push = res_n[rows, t_old]
    cap_old = spec.res_cap[t_old]
    full = n_push >= cap_old
    do_push = acc & pre["remove_like"] & ~full
    push_idx = torch.minimum(n_push, cap_old - 1)
    push_slot = spec.res_type_mol_base[t_old] + push_idx
    push_start = spec.res_type_site_base[t_old] + push_idx * A_old
    res_pos = (u3 - 0.5) @ spec.res_H.T                          # (B, 3)

    in_push = do_push[:, None] & (a_iota[None, :] < A_old[:, None])
    in_pop = do_pop[:, None] & (a_iota[None, :] < A_new[:, None])
    res_off = _scatter_rows(old.res_offset, push_start[:, None] + a_iota,
                            pre["off_old"], in_push)
    res_off = _scatter_rows(res_off, pop_start[:, None] + a_iota, last_rows,
                            in_pop)
    res_com = _scatter_rows(old.res_com, push_slot[:, None],
                            res_pos[:, None, :], do_push[:, None])
    res_com = _scatter_rows(res_com, pop_slot[:, None], last_com,
                            do_pop[:, None])

    res_n = res_n.clone()
    res_n[rows, t_new] -= do_pop.to(torch.int32)
    res_n[rows, t_old] += do_push.to(torch.int32)
    extras = st.extras.clone()
    extras[:, 1] += (acc & pre["remove_like"] & full).to(torch.int32)
    return st.replace(res_com=res_com, res_offset=res_off, res_n=res_n,
                      extras=extras)
