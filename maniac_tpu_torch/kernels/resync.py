"""Amplitude resynthesis for B replicas: CUDA kernel and plain version.

``resync_grouped`` replaces maniac_tpu/kernels/resync.py::
resync_pallas_grouped (kernel ``_resyncg_kernel``). For a CUDA state it
launches csrc/resync.cu; for a CPU state it runs ``resync_plain``, the
torch synthesis of mc/driver.py::resync_amplitudes_body. Both return the
state with fresh amplitudes, E_RECIP recomputed and E_TOT adjusted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import COULOMB_K, TWOPI
from ..mc.driver import resync_amplitudes_body
from ..system import SimState, SystemSpec
from . import build, resync_gate_failure


def resync_plain(spec: SystemSpec, states: SimState) -> SimState:
    """Plain torch version (full_amplitudes + recip_energy per replica)."""
    return resync_amplitudes_body(spec, states)


def _regions(spec: SystemSpec) -> np.ndarray:
    """(nreg, 3) int32 rows (site base, atoms per molecule, type) of the
    type regions the resynthesis covers: those at or above guest_base with
    the framework split, all of them without."""
    lo = spec.guest_base if spec.fw_split else 0
    rows = [(b, spec.A_list[r], r) for r, b in enumerate(spec.site_base_list)
            if b >= lo]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


def _check(name, t, shape, dtype, device):
    """Raise unless t has this dtype, shape and device and is contiguous
    (one test for a tensor that passes; the message only on failure)."""
    if (t.dtype == dtype and t.shape == shape and t.is_contiguous()
            and t.device == device):
        return
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    raise ValueError(f"{name} must be contiguous")


def resync_grouped(spec: SystemSpec, states: SimState) -> SimState:
    """Re-synthesize amplitudes and E_RECIP for every replica."""
    if states.pos.device.type == "cpu":
        return resync_plain(spec, states)
    dev = states.pos.device
    failure = resync_gate_failure(spec)
    if failure is not None:
        raise ValueError(f"the resync kernel does not take this spec: "
                         f"{failure}")
    B = states.B
    JzP, JxyP = spec.amp_shape
    kx, ky, kz = spec.kmax_xyz
    f32, i32 = torch.float32, torch.int32
    _check("pos", states.pos, (B, 3, spec.S), f32, dev)
    _check("n_mol", states.n_mol, (B, spec.R + 1), i32, dev)
    _check("energy", states.energy, (B, 6), f32, dev)
    regions = torch.from_numpy(_regions(spec)).to(dev)
    amp_re = torch.empty((B, JzP, JxyP), dtype=f32, device=dev)
    amp_im = torch.empty_like(amp_re)
    energy = torch.empty_like(states.energy)
    ins = [states.pos, states.n_mol, states.energy, spec.site_q,
           spec.two_pi_Hinv.contiguous(), spec.k_weights, spec.fw_amp_re,
           spec.fw_amp_im, spec.k_col_jx, spec.k_col_jy, regions]
    for t in ins:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("spec tables must be contiguous on the state's "
                             "device")
    ptrs = [t.data_ptr() for t in ins + [amp_re, amp_im, energy]]
    ints = [B, spec.S, spec.R + 1, JzP, JxyP, kx, ky, kz, regions.shape[0]]
    floats = [COULOMB_K, TWOPI, spec.host_scalars["volume"]]
    build.launch("resync_launch", ptrs, ints, floats)
    resync_grouped.launches += 1
    return states.replace(amp_re=amp_re, amp_im=amp_im, energy=energy)


resync_grouped.launches = 0
