"""The least time one H100 could take for a kernel call's work.

A frozen copy of maniac_tpu_torch/tools/bounds.py at commit
c8d5b755d87bdce149bdc4a95542cd5e6a434222, its counting unchanged, fed
from the benchmark's own side: the sizes come from the reference's spec
(ref/, built from the cell's files: sites, charged sites, the weighted
k-modes of its own Ewald set-up, the far table) and the state's bytes
from the reference's state at B = 1 times B; the trials and populations
from the counters, extras and populations that the chain's outputs hold
(the comparison checks them). The larger of the bytes the call must move
(each input read once, each output written once) over the card's memory
rate and its f32 operations over the card's f32 peak.
"""

from __future__ import annotations

import torch

from .ref.constants import (TYPE_CREATION, TYPE_DELETION, TYPE_ROTATION,
                            TYPE_SWAP, TYPE_TRANSLATION)

# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): f32 outside
# the tensor cores and HBM3
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# operations per item (see maniac_tpu_torch/tools/bounds.py at the commit
# above for each one's derivation)
OPS_ATOM_MODE = 16
OPS_MODE = 8
OPS_FAR_ATOM_MODE = 8
OPS_PAIR = 30
OPS_PROPOSAL = 200
N_UNIFORMS = 21
OPS_MIN_IMAGE = 9
OPS_IMAGE = 7
N_IMAGES = 27
F32_BYTES = 4
# the state's tensors a step kernel reads and writes
STATE_KEYS = ("pos", "com", "amp_re", "amp_im", "n_mol", "energy",
              "counters", "extras")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(nbytes, ops) -> float:
    """The larger of bytes over the memory rate and operations over the
    f32 peak, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def modes(spec):
    """(k-space modes with a weight, far-field modes with a coefficient)."""
    k2 = (int(((spec.c2_re != 0) | (spec.c2_im != 0)).sum())
          if spec.fw_split else 0)
    return int((spec.k_weights != 0).sum()), k2


def type_rows(spec, n_mol, charged):
    """(B,) sites (charged ones only, if asked) of the live molecules of
    the types a footprint is swept against and the resync synthesizes:
    those above the frozen framework prefix (every type without the
    split)."""
    lo = spec.guest_base if spec.fw_split else 0
    q = spec.site_q.cpu()
    out = torch.zeros(n_mol.shape[0], dtype=torch.float64)
    for r, base in enumerate(spec.site_base_list):
        if base >= lo:
            A = spec.A_list[r]
            per = int((q[base:base + A] != 0).sum()) if charged else A
            out = out + n_mol[:, r].double() * per
    return out


def step_ops(spec, atoms_q, atoms, sites, rows) -> float:
    k, k2 = modes(spec)
    pair = OPS_PAIR + (N_IMAGES * OPS_IMAGE - OPS_MIN_IMAGE
                       if spec.is_triclinic else 0)
    return float((OPS_ATOM_MODE * k + OPS_FAR_ATOM_MODE * k2) * atoms_q.sum()
                 + pair * (atoms * (sites + spec.S_frozen)).sum()
                 + OPS_MODE * (k + k2) * rows)


def trial_ops(spec, before, after):
    """Operations of the MC steps that took ``before`` to ``after``
    (objects with counters, extras and n_mol, on the host): each move
    class's valid trials set the footprint, both sides of a translation or
    rotation, one side of an insertion or deletion; live sites are the
    mean of the first and last populations."""
    ids = spec.active_type_ids.long()
    n = (after.counters[:, 0] - before.counters[:, 0]).double()
    blocked = (after.extras[:, 0] - before.extras[:, 0]).double()
    swaps = torch.clamp(n[:, TYPE_SWAP] - blocked, min=0)
    creates = n[:, TYPE_CREATION] - torch.clamp(
        blocked - n[:, TYPE_SWAP], min=0)
    one_side = 2 * (n[:, TYPE_TRANSLATION] + n[:, TYPE_ROTATION]) \
        + creates + n[:, TYPE_DELETION]

    def atoms(per_type):
        least = per_type[ids].double().sort().values
        second = least[1] if len(least) > 1 else least[0]
        return (one_side * least[0] + swaps * (least[0] + second))[:, None]
    sites = 0.5 * (type_rows(spec, before.n_mol, False)
                   + type_rows(spec, after.n_mol, False))[:, None]
    return step_ops(spec, atoms((spec.type_q_rows != 0).sum(1)),
                    atoms(spec.type_A), sites,
                    float(n.sum() - blocked.sum()))


def energy_tables(spec):
    """The spec tables the energies of a step read (of the LJ tables only
    the rows of the active types' classes)."""
    rows = spec.type_cls_rows[spec.active_type_ids.long()].long().unique()
    tables = [spec.site_q, spec.site_type, spec.site_midx, spec.site_mol,
              spec.eps_site[rows], spec.sig2_site[rows], spec.k_weights]
    if spec.fw_split:
        tables += [spec.far_coef, spec.far_rows, spec.far_units]
    return tables


def state_bytes(state1, keys=STATE_KEYS) -> int:
    """Bytes of one replica's ``keys`` of a B = 1 state in f32."""
    return sum(getattr(state1, k).numel() * (
        F32_BYTES if getattr(state1, k).is_floating_point()
        else getattr(state1, k).element_size()) for k in keys)


def block_bound(spec, state1, n_steps, before, after) -> float:
    """ms of one whole-block call (K2) over B = before.n_mol.shape[0]
    replicas: its inputs and outputs once, its valid trials' operations."""
    B = before.n_mol.shape[0]
    nbytes = (B * n_steps * N_UNIFORMS * F32_BYTES + 2 * B * F32_BYTES
              + tensor_bytes(*energy_tables(spec))
              + 2 * B * state_bytes(state1))
    return bound_ms(nbytes, trial_ops(spec, before, after))


def steps_bound(spec, n_steps, before, after) -> float:
    """ms of the n_steps whole-step calls (K3) that took ``before`` to
    ``after``: each step's amplitudes at the weighted modes read, its live
    positions and uniforms read, the tables, each accepted step's
    amplitudes written; the valid trials' operations and the proposals."""
    B = before.n_mol.shape[0]
    weighted = int((spec.k_weights != 0).sum())
    real = (2 * spec.kmax_xyz[2] + 1) * int((spec.k_col_jx >= 0).sum())
    live = 0.5 * (type_rows(spec, before.n_mol, False)
                  + type_rows(spec, after.n_mol, False)).sum() + B * (
                      spec.S_frozen if spec.fw_split else 0)
    accepted = float((after.counters[:, 1] - before.counters[:, 1]).sum())
    nbytes = (B * 8 * weighted + 12 * float(live) + B * N_UNIFORMS * 4
              + tensor_bytes(*energy_tables(spec))
              + accepted / n_steps * 8 * (2 * real - weighted))
    ops = trial_ops(spec, before, after) / n_steps + OPS_PROPOSAL * B
    return n_steps * bound_ms(nbytes, ops)


def resync_bound(spec, state1, n_mol) -> float:
    """ms of one resync call (K1): every charged live site at every
    weighted mode, then each mode's |A|^2 term."""
    B = n_mol.shape[0]
    k, _ = modes(spec)
    ops = float(OPS_ATOM_MODE * k * type_rows(spec, n_mol, True).sum()
                + OPS_MODE * k * B)
    tables = [spec.site_q, spec.k_weights]
    if spec.fw_split:
        tables += [spec.fw_amp_re, spec.fw_amp_im]
    nbytes = (B * state_bytes(state1, ("pos", "n_mol", "energy"))
              + tensor_bytes(*tables)
              + B * state_bytes(state1, ("amp_re", "amp_im", "energy")))
    return bound_ms(nbytes, ops)
