"""Bounds: the least time one H100 could take for a kernel call's work.

The larger of the bytes the call must move (each input read once, each
output written once) over the card's memory rate and its f32 operations
over the card's f32 peak, both counted from the call's own inputs and
outputs; where the work depends on the data (trials that need energies,
live sites), only what this call's data needs is counted.
``python -m maniac_tpu_torch.bench``'s layers line reads them.
"""

from __future__ import annotations

import torch

from ..constants import (TYPE_CREATION, TYPE_DELETION, TYPE_ROTATION,
                         TYPE_SWAP, TYPE_TRANSLATION)

# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): f32 outside
# the tensor cores (TF32 is off by design) and HBM3
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# operations per item, each transcendental (sincos, erfc, sqrt, rint, a
# division) counted as one: a footprint atom's phase at one k-mode from its
# three per-axis phase powers, weighted and accumulated (two complex
# products, a real scale, a complex add); one mode's energy term
# w (2 A.d + |d|^2), or the far-field c2 . d of both sides; one site pair's
# LJ and erfc(alpha r)/r with its minimum-image distance, of which the
# orthorhombic image (a division, a rint and a multiply-add per axis) is
# OPS_MIN_IMAGE; a triclinic box instead tries 27 image shifts at
# OPS_IMAGE each (three adds, a product and two multiply-adds, a min)
OPS_ATOM_MODE = 16
OPS_MODE = 8
# the far field contracted one axis at a time (csrc/common.cuh far_sweep):
# one complex multiply-add per nonzero coefficient and charged atom
OPS_FAR_ATOM_MODE = 8
OPS_PAIR = 30
# one replica's proposal (thread 0): its draws, the rotation, the new
# footprint's positions and COM wrap, the prefactor; the intra energies of
# an insertion or removal are left out (a lower bound)
OPS_PROPOSAL = 200
N_UNIFORMS = 21
OPS_MIN_IMAGE = 9
OPS_IMAGE = 7
N_IMAGES = 27


def tensor_bytes(*tensors) -> int:
    """The bytes the tensors hold."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the f32 peak."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / F32_OPS_PER_S * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                           "operations")


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
    out = torch.zeros(n_mol.shape[0], dtype=torch.float64,
                      device=n_mol.device)
    for r, base in enumerate(spec.site_base_list):
        if base >= lo:
            A = spec.A_list[r]
            per = int((q[base:base + A] != 0).sum()) if charged else A
            out = out + n_mol[:, r].double() * per
    return out


def step_ops(spec, atoms_q, atoms, sites, rows) -> float:
    """Operations of MC steps: the footprint's charged atoms at every
    k-space mode and every far-field mode with a coefficient (a complex
    multiply-add each), each mode's energy term once per proposal
    that needs energies (rows of them), and every footprint atom against
    the live sites (frozen prefix included) with the box's minimum image;
    atoms_q, atoms and sites (B, 1) per replica."""
    k, k2 = modes(spec)
    pair = OPS_PAIR + (N_IMAGES * OPS_IMAGE - OPS_MIN_IMAGE
                       if spec.is_triclinic else 0)
    return float((OPS_ATOM_MODE * k + OPS_FAR_ATOM_MODE * k2) * atoms_q.sum()
                 + pair * (atoms * (sites + spec.S_frozen)).sum()
                 + OPS_MODE * (k + k2) * rows)


def trial_ops(spec, states, out):
    """Operations of the MC steps that took ``states`` to ``out``. Only
    valid trials need energies: each move class's valid trials (the
    counters' growth) set the footprint, both sides of a translation or
    rotation, one side of an insertion or deletion, the old and the new
    type's molecule of a swap. The counters do not split trials by type, so
    each side takes the smallest active type's atoms (a swap the two
    smallest types'), and the bound stays a lower one; trials blocked by
    the capacity need no energies either and come off the swaps first,
    then the insertions. Live sites are the mean of the first and last
    populations."""
    ids = spec.active_type_ids.long()
    n = (out.counters[:, 0] - states.counters[:, 0]).double()
    blocked = (out.extras[:, 0] - states.extras[:, 0]).double()
    swaps = torch.clamp(n[:, TYPE_SWAP] - blocked, min=0)
    creates = n[:, TYPE_CREATION] - torch.clamp(
        blocked - n[:, TYPE_SWAP], min=0)
    one_side = 2 * (n[:, TYPE_TRANSLATION] + n[:, TYPE_ROTATION]) \
        + creates + n[:, TYPE_DELETION]

    def atoms(per_type):
        least = per_type[ids].double().sort().values
        second = least[1] if len(least) > 1 else least[0]
        return (one_side * least[0] + swaps * (least[0] + second))[:, None]
    sites = 0.5 * (type_rows(spec, states.n_mol, False)
                   + type_rows(spec, out.n_mol, False))[:, None]
    return step_ops(spec, atoms((spec.type_q_rows != 0).sum(1)),
                     atoms(spec.type_A), sites,
                     float(n.sum() - blocked.sum()))


def energy_tables(spec):
    """The spec tables the energies of a step read; of the LJ tables
    (eps_site, sig2_site: one row per LJ class, 2165 x 3072 on the
    flagship) only the rows of the active types' classes, which are all a
    footprint reads."""
    rows = spec.type_cls_rows[spec.active_type_ids.long()].long().unique()
    tables = [spec.site_q, spec.site_type, spec.site_midx, spec.site_mol,
              spec.eps_site[rows], spec.sig2_site[rows], spec.k_weights]
    if spec.fw_split:
        tables += [spec.far_coef, spec.far_rows, spec.far_units]
    return tables


def block_bound(spec, states, out, u):
    """Bound of one whole-block call: its inputs and outputs once, the
    operations of its valid trials (trial_ops)."""
    keys = ["pos", "com", "amp_re", "amp_im", "n_mol", "energy", "counters",
            "extras"]
    if spec.has_reservoir:
        keys += ["res_offset", "res_com", "res_n"]
    nbytes = tensor_bytes(u, states.trans_step, states.rot_step,
                     *energy_tables(spec),
                     *[getattr(states, k) for k in keys],
                     *[getattr(out, k) for k in keys])
    return bound(nbytes, trial_ops(spec, states, out))


def steps_bound(spec, states, out, n_steps):
    """Bound of one whole step (K3's launch), the mean over the n_steps
    steps that took ``states`` to ``out``: the same work whatever
    implements it. Bytes: each replica's amplitudes at the modes with a
    nonzero k weight read once (all the k-space delta needs), its live
    positions (frozen prefix and live guests) and its uniform row read, the
    spec tables the energies read, and for each accepted step the
    amplitudes at the grid's real (non-pad) modes written, with the ones
    not read yet (zero weight) read, since the new value is the old one
    plus the delta. Operations: the valid trials' (trial_ops) and
    OPS_PROPOSAL a replica."""
    B = states.B
    weighted = int((spec.k_weights != 0).sum())
    real = (2 * spec.kmax_xyz[2] + 1) * int((spec.k_col_jx >= 0).sum())
    live = 0.5 * (type_rows(spec, states.n_mol, False)
                  + type_rows(spec, out.n_mol, False)).sum() + B * (
                      spec.S_frozen if spec.fw_split else 0)
    accepted = float((out.counters[:, 1] - states.counters[:, 1]).sum())
    nbytes = (B * 8 * weighted + 12 * float(live) + B * N_UNIFORMS * 4
              + tensor_bytes(*energy_tables(spec))
              + accepted / n_steps * 8 * (2 * real - weighted))
    ops = trial_ops(spec, states, out) / n_steps + OPS_PROPOSAL * B
    return bound(nbytes, ops)


def resync_bound(spec, states, out):
    """Bound of one resync call: every charged live site at every weighted
    mode, then each mode's |A|^2 term."""
    k, _ = modes(spec)
    ops = float(OPS_ATOM_MODE * k * type_rows(spec, states.n_mol,
                                                True).sum()
                + OPS_MODE * k * states.B)
    tables = [spec.site_q, spec.k_weights]
    if spec.fw_split:
        tables += [spec.fw_amp_re, spec.fw_amp_im]
    nbytes = tensor_bytes(states.pos, states.n_mol, states.energy, *tables,
                     out.amp_re, out.amp_im, out.energy)
    return bound(nbytes, ops)

