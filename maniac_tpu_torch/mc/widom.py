"""Widom test-particle insertion: excess chemical potential diagnostic.

Counterpart of maniac_tpu/mc/widom.py (its docstring has the physics and
the reference citations). Each trial is a GHOST insertion - the new side of
the engine's insertion move at a uniform position and orientation - whose
energy is evaluated without touching the chain state:

    dU = E_pair(ghost) + E_recip(A+dA) - E_recip(A) + E_self + E_intra

and the per-species Widom factor over n trials is

    B  = < exp(-dU / T) >            (1 for an ideal gas)
    mu_ex = -kB T ln B               (excess chemical potential)

The trials of all active species run as one batch through the plain torch
energy path (the JAX package runs Widom on XLA; there is no kernel to
port), on the caller's device. Their uniforms come from a key of their
own (``widom_key``: the reported replica's key folded with WIDOM_TAG and
the block, as maniac_tpu/cli.py folds it, so the chain's key never
advances and a resumed run draws the same ghosts) or are passed in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics.energy import (active_site_mask, amp_delta, intra_energy,
                              pair_energy_footprint, recip_energy_delta,
                              site_positions)
from ..system import SimState, SystemSpec
from ..utils.threefry import fold_in, uniform
from .moves import _uniform_rotation

N_WIDOM_UNIFORMS = 6       # fractional COM (3), the rotation draw (3)
# the JAX command line's fold-in tag for its Widom key ("WIDO")
WIDOM_TAG = 0x5749444F


def widom_delta_u(spec: SystemSpec, state: SimState, u, t_ins):
    """dU (Kelvin) of ghost insertions into replica 0 of ``state``.

    u (n, 6) uniforms: u[:, 0:3] fractional COM coordinates, u[:, 3:6] the
    uniform-rotation draw; t_ins the residue type of each trial ((n,) or
    one int). The trial geometry is the rigid template with a uniform
    random orientation, as the engine's templated insertion (DIVERGENCES.md
    #4). The ghost excludes no molecule (the sentinel Mtot + 1): unlike a
    real insertion it takes no slot, so every live molecule interacts.
    Returns (n,)."""
    dev, fdt = spec.device, spec.dtype
    u = torch.as_tensor(u, dtype=fdt, device=dev).reshape(-1,
                                                          N_WIDOM_UNIFORMS)
    n = u.shape[0]
    t = torch.as_tensor(t_ins, dtype=torch.long, device=dev).expand(n)
    rot = _uniform_rotation(u[:, 3:6])                          # (n, 3, 3)
    off = spec.type_template_off[t] @ rot.transpose(1, 2)       # (n, A, 3)
    com = spec.bounds[:, 0] + u[:, 0:3] @ spec.H.T              # (n, 3)
    P = (com[:, None, :] + off)[:, None]                        # (n,1,A,3)
    mask = (torch.arange(spec.A_act, device=dev)
            < spec.type_A[t][:, None])[:, None]                 # (n, 1, A)
    q = spec.type_q_rows[t][:, None]
    cls = spec.type_cls_rows[t][:, None]
    no_mol = torch.full((n,), spec.Mtot + 1, dtype=torch.int32, device=dev)
    others = site_positions(spec, state)[:1].expand(n, -1, -1)
    others_mask = active_site_mask(spec, state.n_mol[:1]).expand(n, -1)
    e_lj, e_coul = pair_energy_footprint(spec, others, others_mask, P, q,
                                         cls, mask, no_mol, no_mol)
    d_re, d_im = amp_delta(spec, P, q, mask,
                           torch.ones((n, 1), dtype=fdt, device=dev))
    e_recip = recip_energy_delta(spec, state.amp_re[:1], state.amp_im[:1],
                                 d_re, d_im)
    return (e_lj[:, 0] + e_coul[:, 0] + e_recip
            + spec.type_self_energy[t]
            + intra_energy(spec, P[:, 0], q[:, 0], mask[:, 0]))


def widom_key(state: SimState, block: int) -> torch.Tensor:
    """The key of block ``block``'s ghosts, on the state's device:
    fold_in(fold_in(key of replica 0, WIDOM_TAG), block), as
    maniac_tpu/cli.py derives it. The tag keeps the draws apart from the
    chain's split() stream."""
    return fold_in(fold_in(state.key[0], WIDOM_TAG), block)


def widom_block(spec: SystemSpec, state: SimState, n_trials: int,
                key: torch.Tensor | None = None, uniforms=None):
    """Per-active-species LOG Widom factor ln< exp(-dU/T) > over n_trials
    ghost insertions into replica 0 of ``state``. Returns (n_active,).

    The uniforms, (n_trials, n_active, 6), are uniform(key, ...) as
    maniac_tpu/mc/widom.py::widom_block draws them (a few thousand values,
    drawn where the key lies), or are passed as ``uniforms``. Max-shifted
    (log-sum-exp), so that one deeply attractive trial (exp(-dU/T)
    overflows f32 past -dU/T = 88) degrades the estimate instead of
    poisoning it with inf; hosts convert to B in f64 (widom_factor)."""
    shape = (n_trials, spec.n_active, N_WIDOM_UNIFORMS)
    if uniforms is None:
        uniforms = uniform(key, shape, spec.dtype)
    u = torch.as_tensor(uniforms, dtype=spec.dtype, device=spec.device)
    types = spec.active_type_ids.long().expand(n_trials, -1)
    du = widom_delta_u(spec, state, u.reshape(-1, N_WIDOM_UNIFORMS),
                       types.reshape(-1)).reshape(n_trials, spec.n_active)
    x = -du / spec.temp_K
    m = x.max(dim=0).values
    return m + torch.log(torch.exp(x - m).mean(dim=0))


def widom_factor(log_B):
    """Widom factor B from widom_block's log estimate (host-side, f64)."""
    if isinstance(log_B, torch.Tensor):
        log_B = log_B.detach().cpu().numpy()
    return np.exp(np.asarray(log_B, dtype=np.float64))


def mu_excess_K(B_mean, temp_K):
    """mu_ex in Kelvin from a Widom factor (host-side; inf if B == 0)."""
    B_mean = np.asarray(B_mean, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return -float(temp_K) * np.log(B_mean)
