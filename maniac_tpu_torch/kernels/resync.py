"""Amplitude resynthesis for B replicas: CUDA kernel and plain version.

``resync_grouped`` replaces maniac_tpu/kernels/resync.py::
resync_pallas_grouped (kernel ``_resyncg_kernel``) and, at B = 1,
resync_pallas (``_resync_kernel``). For a CUDA state it launches
csrc/resync.cu; for a CPU state it runs ``resync_plain``, the torch
synthesis of mc/driver.py::resync_amplitudes_body. Both return the state
with fresh amplitudes, E_RECIP recomputed and E_TOT adjusted.

The kernel synthesizes the charged live sites only, read off the spec's
charge table (``q_regions``, ``q_offsets``: system.py ``_charge_table``),
and tiles each replica's grid as ``resync_tiling`` says.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import COULOMB_K, TWOPI
from ..mc.driver import resync_amplitudes_body
from ..system import SimState, SystemSpec
from . import build, resync_gate_failure

# csrc/resync.cu: columns a CTA (COLS, 16 threads of 4 columns), rows a
# thread (TZ) and the most row groups a CTA holds (MAX_ZGROUPS: 256
# threads)
COLS = 64
COL_GROUPS = 16
TZ = 3
MAX_ZGROUPS = 16
# threads a CTA has at the least (and a multiple of COLS): those past its
# tile's help build the chunk's tables
MIN_THREADS = 128
# CTAs a small batch is spread over: two on each of the H100's 132 SMs
FILL_CTAS = 264


class Tiling(NamedTuple):
    """How csrc/resync.cu cuts one replica's (JzP, JxyP) grid: each CTA
    covers ``TZ * zgroups`` rows (its first 16 * zgroups threads hold TZ
    rows by 4 columns each) and COLS columns; ``row_tiles`` x
    ``col_tiles`` CTAs a replica of ``threads`` threads (at least
    MIN_THREADS, a multiple of COLS)."""
    zgroups: int
    row_tiles: int
    col_tiles: int
    threads: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles


def resync_tiling(spec: SystemSpec, B: int) -> Tiling:
    """The kernel's tiling for B replicas of ``spec``: a CTA takes every
    row group (TZ rows) unless that needs more than MAX_ZGROUPS of them
    (then the groups are split evenly) or B is too small to give the card
    FILL_CTAS CTAs (then into as many row tiles as that needs, one group a
    CTA at the least)."""
    Jz = 2 * spec.kmax_xyz[2] + 1
    groups = -(-Jz // TZ)
    col_tiles = -(-spec.amp_shape[1] // COLS)
    need = math.ceil(FILL_CTAS / (B * col_tiles))   # row tiles wanted
    zgroups = min(-(-groups // -(-groups // MAX_ZGROUPS)),
                  max(1, groups // need))
    threads = -(-max(COL_GROUPS * zgroups, MIN_THREADS) // COLS) * COLS
    return Tiling(zgroups, -(-groups // zgroups), col_tiles, threads)


def resync_plain(spec: SystemSpec, states: SimState) -> SimState:
    """Plain torch version (full_amplitudes + recip_energy per replica)."""
    return resync_amplitudes_body(spec, states)


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


def _launch(spec: SystemSpec, states: SimState) -> SimState:
    """Check the tables and launch csrc/resync.cu on the states' device."""
    failure = resync_gate_failure(spec)
    if failure is not None:
        raise ValueError(f"the resync kernel does not take this spec: "
                         f"{failure}")
    if spec.q_mixed_types:
        raise ValueError(f"the resync kernel takes one charge template a "
                         f"type: the molecules of type "
                         f"{spec.q_mixed_types[0]} differ in their charges")
    dev = states.pos.device
    B = states.B
    JzP, JxyP = spec.amp_shape
    kx, ky, kz = spec.kmax_xyz
    f32, i32 = torch.float32, torch.int32
    _check("pos", states.pos, (B, 3, spec.S), f32, dev)
    _check("n_mol", states.n_mol, (B, spec.R + 1), i32, dev)
    _check("energy", states.energy, (B, 6), f32, dev)
    tiling = resync_tiling(spec, B)
    amp_re = torch.empty((B, JzP, JxyP), dtype=f32, device=dev)
    amp_im = torch.empty_like(amp_re)
    energy = torch.empty_like(states.energy)
    partial = torch.empty((B, tiling.tiles), dtype=f32, device=dev)
    ins = [states.pos, states.n_mol, states.energy, spec.site_q,
           spec.two_pi_Hinv.contiguous(), spec.k_weights, spec.fw_amp_re,
           spec.fw_amp_im, spec.k_col_jx, spec.k_col_jy, spec.q_regions,
           spec.q_offsets]
    for t in ins:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("spec tables must be contiguous on the state's "
                             "device")
    ptrs = [t.data_ptr() for t in ins + [amp_re, amp_im, energy, partial]]
    ints = [B, spec.S, spec.R + 1, JzP, JxyP, kx, ky, kz,
            spec.q_regions.shape[0], *tiling]
    floats = [COULOMB_K, TWOPI, spec.host_scalars["volume"]]
    build.launch("resync_launch", ptrs, ints, floats, states.pos.device)
    return states.replace(amp_re=amp_re, amp_im=amp_im, energy=energy)


def resync_grouped(spec: SystemSpec, states: SimState) -> SimState:
    """Re-synthesize amplitudes and E_RECIP for every replica."""
    if states.pos.device.type == "cpu":
        return resync_plain(spec, states)
    out = _launch(spec, states)
    resync_grouped.launches += 1
    return out


resync_grouped.launches = 0
