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
port), on the caller's device; widom_block_replicated runs every
replica's trials in the same batch, the counterpart of
jax.vmap(widom_block). Their uniforms come from a key of their
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
# (ghost site, site) pairs a pass of widom_delta_u_replicated takes over all
# replicas: some 1 GB of f32 intermediates (SPC/E's 64 replicas x 256 trials
# take 4 passes)
WIDOM_PAIRS_PER_PASS = 2 ** 24


def widom_delta_u(spec: SystemSpec, state: SimState, u, t_ins):
    """dU (Kelvin) of ghost insertions into replica 0 of ``state``.

    u (n, 6) uniforms: u[:, 0:3] fractional COM coordinates, u[:, 3:6] the
    uniform-rotation draw; t_ins the residue type of each trial ((n,) or
    one int). The trial geometry is the rigid template with a uniform
    random orientation, as the engine's templated insertion (DIVERGENCES.md
    #4). The ghost excludes no molecule (the sentinel Mtot + 1): unlike a
    real insertion it takes no slot, so every live molecule interacts.
    Returns (n,)."""
    first = SimState(**{k: v[:1] for k, v in vars(state).items()})
    u = torch.as_tensor(u, dtype=spec.dtype, device=spec.device)
    return widom_delta_u_replicated(
        spec, first, u.reshape(1, -1, N_WIDOM_UNIFORMS), t_ins)[0]


def widom_delta_u_replicated(spec: SystemSpec, states: SimState, u, t_ins):
    """dU (Kelvin) of ghost insertions into every replica of ``states``:
    u (B, n, 6) each replica's uniforms, t_ins (n,) or one int, the types
    of the n trials (the same in every replica). The trials are footprints
    of one pair pass per replica and their structure-factor updates one
    batch, in passes of at most WIDOM_PAIRS_PER_PASS (ghost site, site)
    pairs over all replicas. Returns (B, n)."""
    dev = spec.device
    u = torch.as_tensor(u, dtype=spec.dtype, device=dev)
    B, n = u.shape[:2]
    t = torch.as_tensor(t_ins, dtype=torch.long, device=dev).expand(n)
    per_pass = max(1, WIDOM_PAIRS_PER_PASS // (B * spec.A_act * spec.S))
    return torch.cat([_ghost_du(spec, states, u[:, i:i + per_pass],
                                t[i:i + per_pass])
                      for i in range(0, n, per_pass)], dim=1)


def _ghost_du(spec: SystemSpec, states: SimState, u, t):
    """widom_delta_u_replicated for one pass: u (B, n, 6), t (n,)."""
    dev, fdt = spec.device, spec.dtype
    B, n = u.shape[:2]
    rot = _uniform_rotation(u[..., 3:6].reshape(-1, 3))        # (Bn, 3, 3)
    off = spec.type_template_off[t].repeat(B, 1, 1) @ rot.transpose(1, 2)
    com = spec.bounds[:, 0] + u[..., 0:3].reshape(-1, 3) @ spec.H.T
    P = (com[:, None, :] + off).reshape(B, n, spec.A_act, 3)
    mask = (torch.arange(spec.A_act, device=dev)
            < spec.type_A[t][:, None]).expand(B, n, -1)         # (B, n, A)
    q = spec.type_q_rows[t].expand(B, n, -1)
    cls = spec.type_cls_rows[t].expand(B, n, -1)
    no_mol = torch.full((B,), spec.Mtot + 1, dtype=torch.int32, device=dev)
    e_lj, e_coul = pair_energy_footprint(
        spec, site_positions(spec, states),
        active_site_mask(spec, states.n_mol), P, q, cls, mask, no_mol,
        no_mol)                                                 # (B, n)
    d_re, d_im = amp_delta(spec, P.reshape(B * n, 1, spec.A_act, 3),
                           q.reshape(B * n, 1, -1), mask.reshape(B * n, 1, -1),
                           torch.ones((B * n, 1), dtype=fdt, device=dev))
    e_recip = recip_energy_delta(
        spec, states.amp_re[:, None], states.amp_im[:, None],
        d_re.reshape(B, n, *d_re.shape[1:]),
        d_im.reshape(B, n, *d_im.shape[1:]))                    # (B, n)
    return (e_lj + e_coul + e_recip + spec.type_self_energy[t]
            + intra_energy(spec, P, q, mask))


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
    return _log_mean_exp(-du / spec.temp_K)


def widom_block_replicated(spec: SystemSpec, states: SimState,
                           n_trials: int, keys) -> torch.Tensor:
    """widom_block for every replica at once, the counterpart of
    jax.vmap(widom_block) over (states, keys): replica b draws
    uniform(keys[b], (n_trials, n_active, 6)) and its ghosts go into its
    own configuration. keys (B, 2). Returns the log factors (B,
    n_active)."""
    u = uniform(torch.as_tensor(keys, device=spec.device),
                (n_trials, spec.n_active, N_WIDOM_UNIFORMS), spec.dtype)
    B = states.B
    types = spec.active_type_ids.long().expand(n_trials, -1).reshape(-1)
    du = widom_delta_u_replicated(
        spec, states, u.reshape(B, -1, N_WIDOM_UNIFORMS), types)
    return _log_mean_exp(-du.reshape(B, n_trials, spec.n_active)
                         / spec.temp_K)


def _log_mean_exp(x):
    """ln mean(exp(x)) over the trial axis (-2), max-shifted."""
    m = x.max(dim=-2).values
    return m + torch.log(torch.exp(x - m.unsqueeze(-2)).mean(dim=-2))


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
