"""The resync kernel's host side on the CPU (csrc/resync.cu cannot run
here): the spec's charge table against site_q, the skip of uncharged sites
(bit-identical), the kernel's tiling (every mode written once, every real
mode contracted once), a numpy transcription of the kernel's algorithm
against the plain synthesis on its edge replicas, and the launch tables
against the kernel's enums with a stub in place of the kernel library.

The fixtures are loaded with the JAX package and carried over
(torch_parity.load_both), so the charge table is derived from the JAX
package's leaves. The kernel itself is held to resync_plain on the card by
chip_smoke.py and tests/test_torch_gpu.py."""

import ctypes
import dataclasses
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from maniac_tpu_torch import replicate
from maniac_tpu_torch.constants import COULOMB_K, TWOPI
from maniac_tpu_torch.kernels import build, resync
from maniac_tpu_torch.kernels.resync import (COL_GROUPS, COLS, FILL_CTAS,
                                             MAX_ZGROUPS, TZ, resync_plain,
                                             resync_tiling)
from maniac_tpu_torch.physics.energy import (active_site_mask,
                                             full_amplitudes, recip_energy,
                                             site_positions)
from maniac_tpu_torch.system import E_RECIP, _charge_table
from maniac_tpu_torch.systems import (make_framework_mixed, make_water_box,
                                      make_water_reservoir, make_zif_like)
from maniac_tpu_torch.tools.resync_times import CHUNK, edge_replicas

from torch_parity import load_both

torch.set_num_threads(1)

CSRC = Path(build.__file__).resolve().parent / "csrc" / "resync.cu"
SMEM_LIMIT = 232448   # shared memory a CTA can have on the H100


def _zif(d):
    # the tests/test_torch_kernels.py framework fixture (the split on)
    make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


def _mixed(d):
    # framework + waters + dimers, the split on (tests/test_torch_stepg)
    make_framework_mixed(d, n_cells=3, a=5.66, n_water=3, n_dimer=3,
                         cutoff=5.0, tol=1e-4)


def _resv(d):
    # a water box with its reservoir: every type active, no split
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.2, 0.2, 0.6, 0.0), fugacity=2000.0)
    return make_water_reservoir(d, n_water=12)


SYSTEMS = {"zif": _zif, "mixed": _mixed, "resv": _resv}


def _load(name, tmp_path, f32=True):
    """(spec, state) of a fixture, loaded by the JAX package and carried
    over; capacity 12."""
    res = SYSTEMS[name](str(tmp_path))
    _, spec, state = load_both(str(tmp_path), capacity=12, f32=f32,
                               reservoir=res)
    return spec, state


def _charged_live(spec, n_mol) -> torch.Tensor:
    """(B, S) bool: the sites the kernel synthesizes, enumerated as
    csrc/resync.cu does from the charge table (n_mol[b, type] molecules
    times the type's charged atoms, region by region)."""
    offsets = spec.q_offsets.tolist()
    mask = torch.zeros((n_mol.shape[0], spec.S), dtype=torch.bool)
    for b in range(n_mol.shape[0]):
        for base, A, nq, first, r in spec.q_regions.tolist():
            for m in range(int(n_mol[b, r])):
                for s in offsets[first:first + nq]:
                    mask[b, base + m * A + s] = True
    return mask


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_charge_table_matches_site_q(tmp_path, name):
    """The charge table has one row for each type the resync covers (the
    regions from guest_base with the split, all without), in type order,
    and each row's offsets are its first molecule's nonzero site_q; every
    molecule slot carries the same charges."""
    spec, _ = _load(name, tmp_path)
    q = spec.site_q.numpy()
    assert spec.q_mixed_types == ()
    lo = spec.guest_base if spec.fw_split else 0
    cover = [r for r, b in enumerate(spec.site_base_list) if b >= lo]
    assert len(cover) == (spec.n_active if spec.fw_split else spec.R)
    assert spec.q_regions.shape == (len(cover), 5)
    assert spec.q_regions[:, 4].tolist() == cover
    for base, A, nq, first, r in spec.q_regions.tolist():
        assert (base, A) == (spec.site_base_list[r], spec.A_list[r])
        want = np.flatnonzero(q[base:base + A] != 0)
        np.testing.assert_array_equal(
            spec.q_offsets[first:first + nq].numpy(), want)
        slots = q[base:base + spec.cap_list[r] * A].reshape(-1, A)
        assert (slots == slots[0]).all()
    if name == "zif":   # a water's oxygen carries no charge
        assert spec.q_regions[0, 2] == 3


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["zif", "mixed"])
def test_charged_sites_only_is_bit_identical(tmp_path, name, f32):
    """full_amplitudes over the charged live sites the kernel enumerates
    gives resync_plain's amplitudes and E_RECIP bit for bit: an uncharged
    site adds exact zeros. The enumeration is the live mask less exactly
    the uncharged sites (and the frozen prefix)."""
    spec, state = _load(name, tmp_path, f32=f32)
    states = edge_replicas(spec, replicate(spec, state, 4), seed=3)
    mask = _charged_live(spec, states.n_mol)
    live = active_site_mask(spec, states.n_mol).clone()
    live[:, :spec.guest_base if spec.fw_split else 0] = False
    assert torch.equal(mask, live & (spec.site_q != 0))
    assert int((live & (spec.site_q == 0)).sum()) > 0
    ref = resync_plain(spec, states)
    re_, im_ = full_amplitudes(spec, site_positions(spec, states), mask)
    assert torch.equal(re_, ref.amp_re) and torch.equal(im_, ref.amp_im)
    assert torch.equal(recip_energy(spec, re_, im_),
                       ref.energy[:, E_RECIP])


def _grid(k, real=None):
    """A stand-in spec of k-order k on each axis: the grid shape and the
    column table of the Ewald builder's layout (real columns first)."""
    Jz, n_real = 2 * k + 1, real or (k + 1) * (2 * k + 1)
    JzP, JxyP = -(-Jz // 8) * 8, -(-n_real // 128) * 128
    col_jx = np.where(np.arange(JxyP) < n_real, 0, -1)
    return types.SimpleNamespace(kmax_xyz=(k, k, k), amp_shape=(JzP, JxyP),
                                 k_col_jx=torch.from_numpy(col_jx))


@pytest.mark.parametrize("B", [1, 7, 64, 1024])
@pytest.mark.parametrize("k", [0, 8, 11, 31])
def test_tiling_covers_every_mode_once(k, B):
    """resync_tiling's CTAs and threads, with csrc/resync.cu's index
    rules, write every mode of the grid once and contract every real mode
    (row < Jz, col_jx >= 0) once and no pad mode; a CTA has at most 256
    threads and fits its shared memory; a small batch is spread over at
    least FILL_CTAS CTAs where the rows allow it. k = 8 and 11 are the
    water boxes' and the frameworks' grids, 31 the kernels' largest."""
    spec = _grid(k)
    t = resync_tiling(spec, B)
    Jz, (JzP, JxyP) = 2 * k + 1, spec.amp_shape
    col_jx = spec.k_col_jx.numpy()
    rows, threads = TZ * t.zgroups, COL_GROUPS * t.zgroups
    assert 1 <= t.zgroups <= MAX_ZGROUPS
    assert COLS == COL_GROUPS * 4 and threads <= t.threads <= 256
    assert t.threads % COLS == 0
    assert 8 * CHUNK * (2 * k + 2 + rows + COLS) + 20 * 8 <= SMEM_LIMIT
    groups = -(-Jz // TZ)
    if B * t.col_tiles < FILL_CTAS:
        assert (t.row_tiles == groups
                or B * t.tiles >= FILL_CTAS)
    written = np.zeros((JzP, JxyP), dtype=int)
    contracted = np.zeros((JzP, JxyP), dtype=int)
    zg, cg = np.divmod(np.arange(threads), COL_GROUPS)
    zl = (zg[:, None] * TZ + np.arange(TZ)).ravel()            # thread rows
    cl = (cg[:, None] + COL_GROUPS * np.arange(4)).ravel()      # its columns
    for rt in range(t.row_tiles):
        for ct in range(t.col_tiles):
            z0, c0 = rt * rows, ct * COLS
            cols = c0 + np.arange(COLS)
            live = ((cols < JxyP) & (col_jx[np.minimum(cols, JxyP - 1)]
                                     >= 0)).any() and z0 < Jz
            for z in z0 + np.unique(zl):
                for c in c0 + np.unique(cl):
                    if z >= JzP or c >= JxyP:
                        continue
                    written[z, c] += 1
                    if z < Jz and col_jx[c] >= 0:
                        assert live
                        contracted[z, c] += 1
            if rt == t.row_tiles - 1:
                written[z0 + rows:, c0:c0 + COLS] += 1
    # every (row, column) pair of a tile is one thread's: rows x columns
    assert len(np.unique(zl)) == rows and len(np.unique(cl)) == COLS
    real = (np.arange(JzP)[:, None] < Jz) & (col_jx[None, :] >= 0)
    assert (written == 1).all()
    assert (contracted == real).all()


def _powers(theta, k):
    """Phase powers e^{i j theta}, j = 0..k, by repeated f32 complex
    multiply from one sin and cos (common.cuh phase_powers)."""
    c, s = np.cos(theta), np.sin(theta)
    out = np.empty(theta.shape + (k + 1,), dtype=np.complex64)
    out[..., 0] = 1
    for j in range(1, k + 1):
        out[..., j] = out[..., j - 1] * (c + 1j * s).astype(np.complex64)
    return out


def _signed(p, j):
    v = p[:, np.abs(j)]
    return np.where(j < 0, np.conj(v), v)


def _transcription(spec, states, t):
    """csrc/resync.cu's algorithm in numpy f32 on tiling t: the charged
    live sites from the charge table, CHUNK sites at a time, per CTA the
    contraction of its Pz rows and T columns, one write of fw + acc at
    real modes and fw at pad modes, each CTA's sum of w |A|^2, then each
    replica's sum over its tiles in order. Returns (amp (B, JzP, JxyP)
    complex64, E_RECIP (B,) f32)."""
    f32 = np.float32
    kx, ky, kz = spec.kmax_xyz
    Jz, (JzP, JxyP) = 2 * kz + 1, spec.amp_shape
    pos, q = states.pos.numpy(), spec.site_q.numpy()
    h = spec.two_pi_Hinv.numpy()
    fw = (spec.fw_amp_re.numpy() + 1j * spec.fw_amp_im.numpy()).astype(
        np.complex64)
    kw = spec.k_weights.numpy()
    col_jx, col_jy = spec.k_col_jx.numpy(), spec.k_col_jy.numpy()
    rows = TZ * t.zgroups
    B = states.B
    amp = np.empty((B, JzP, JxyP), dtype=np.complex64)
    e_recip = np.empty(B, dtype=f32)
    mask = _charged_live(spec, states.n_mol)
    for b in range(B):
        sites = np.flatnonzero(mask[b].numpy())
        # the kernel's order: region by region, molecule by molecule
        theta = [(h[ax, 0] * pos[b, 0, sites] + h[ax, 1] * pos[b, 1, sites]
                  + h[ax, 2] * pos[b, 2, sites]).astype(f32)
                 for ax in range(3)]
        px = _powers(theta[0], kx) * q[sites][:, None].astype(f32)
        py, pz = _powers(theta[1], ky), _powers(theta[2], kz)
        parts = []
        for rt in range(t.row_tiles):
            for ct in range(t.col_tiles):
                z = rt * rows + np.arange(rows)
                col = ct * COLS + np.arange(COLS)
                jx = np.where(col < JxyP, col_jx[np.minimum(col, JxyP - 1)],
                              -1)
                jy = col_jy[np.minimum(col, JxyP - 1)]
                acc = np.zeros((rows, COLS), dtype=np.complex64)
                if (jx >= 0).any() and z[0] < Jz:
                    Pz = np.where(z < Jz, _signed(pz, np.minimum(z, Jz - 1) - kz),
                                  0)
                    T = np.where(jx >= 0, px[:, np.maximum(jx, 0)]
                                 * _signed(py, jy), 0)
                    for c in range(0, len(sites), CHUNK):
                        acc += (Pz[c:c + CHUNK].T
                                @ T[c:c + CHUNK]).astype(np.complex64)
                if rt == t.row_tiles - 1:   # the grid's rows below the tile
                    z = np.arange(z[0], max(JzP, z[0] + rows))
                    acc = np.concatenate([acc, np.zeros(
                        (len(z) - rows, COLS), np.complex64)])
                zr, cr = z < JzP, col < JxyP
                zv, cv = z[zr], col[cr]
                real = (zv[:, None] < Jz) & (jx[cr][None, :] >= 0)
                val = fw[np.ix_(zv, cv)] + np.where(real, acc[zr][:, cr], 0)
                amp[b][np.ix_(zv, cv)] = val
                parts.append(f32((kw[np.ix_(zv, cv)]
                                  * (val.real ** 2 + val.imag ** 2)).sum()))
        e_recip[b] = f32(np.sum(np.asarray(parts, f32), dtype=f32)
                         * f32(COULOMB_K) * f32(TWOPI)
                         / f32(spec.host_scalars["volume"]))
    return amp, e_recip


@pytest.mark.parametrize("tiling_B", [4, 1024], ids=["rows_split",
                                                     "whole_rows"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_kernel_transcription_matches_plain(tmp_path, name, tiling_B):
    """The transcription of the kernel against resync_plain on its edge
    replicas (no guests, capacity, a charged-site count that is not a
    multiple of the chunk) and the loaded state, with chip_smoke.py's
    phase-1 bounds (max|dA| <= 1e-4 max(1, max|A|), E_RECIP within 1e-5
    relative); the replica without guests holds fw_amp exactly."""
    spec, state = _load(name, tmp_path)
    states = edge_replicas(spec, replicate(spec, state, 4), seed=5)
    n_q = (_charged_live(spec, states.n_mol).sum(1)).tolist()
    assert n_q[0] == 0 and n_q[2] % CHUNK != 0 and n_q[1] > n_q[3]
    amp, e = _transcription(spec, states, resync_tiling(spec, tiling_B))
    ref = resync_plain(spec, states)
    ref_amp = ref.amp_re.numpy() + 1j * ref.amp_im.numpy()
    scale = max(1.0, float(ref.amp_re.abs().max()),
                float(ref.amp_im.abs().max()))
    err = max(np.abs(amp.real - ref_amp.real).max(),
              np.abs(amp.imag - ref_amp.imag).max())
    assert err <= 1e-4 * scale
    ref_e = ref.energy[:, E_RECIP].numpy()
    np.testing.assert_allclose(e, ref_e, rtol=1e-5, atol=0)
    assert np.array_equal(amp[0].real, spec.fw_amp_re.numpy())
    assert np.array_equal(amp[0].imag, spec.fw_amp_im.numpy())


def _enum(name):
    """{entry: value} of ``enum name { ... }`` in csrc/resync.cu."""
    body = re.search(r"enum %s \{(.*?)\};" % name, CSRC.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return {e: k for k, e in enumerate(
        e.strip() for e in body.split(",") if e.strip())}


class _StubLib:
    """Records each launch's tables in place of the kernel library."""

    def __init__(self):
        self.calls = []

    def resync_launch(self, p, n_p, i, n_i, f, n_f, stream):
        self.calls.append((list((ctypes.c_uint64 * n_p).from_address(p)),
                           list((ctypes.c_int * n_i).from_address(i)),
                           list((ctypes.c_float * n_f).from_address(f))))
        return 0


def test_launch_tables_match_the_kernel(tmp_path, monkeypatch):
    """resync._launch's tables (on CPU tensors, with a stub library)
    against csrc/resync.cu's enums and constants: lengths, the charge
    table's and outputs' pointers, the covered types and the tiling; a
    spec whose molecules of one covered type differ in their charges is
    refused, naming the type, and _charge_table finds such a type among
    the covered ones only."""
    spec, state = _load("zif", tmp_path)
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);",
                             CSRC.read_text()))
    assert (int(consts["COL_GROUPS"]), int(consts["TZ"]),
            int(consts["MAX_ZGROUPS"]), int(consts["CH"])) == (
                COL_GROUPS, TZ, MAX_ZGROUPS, CHUNK)
    lib = _StubLib()
    monkeypatch.setattr(build, "library", lambda defines=(): lib)
    monkeypatch.setattr(build, "_launchers", {})
    monkeypatch.setattr(build, "current_stream", lambda device: 0)
    states = replicate(spec, state, 5)
    out = resync._launch(spec, states)
    ptrs, ints, floats = lib.calls[-1]
    rp, ri, rf = _enum("ResyncPtr"), _enum("ResyncInt"), _enum("ResyncFloat")
    assert (len(ptrs), len(ints), len(floats)) == (
        rp["RP_COUNT"], ri["RI_COUNT"], rf["RF_COUNT"])
    for key, t in (("RP_POS", states.pos), ("RP_Q_REGIONS", spec.q_regions),
                   ("RP_Q_OFFSETS", spec.q_offsets),
                   ("RP_AMP_RE", out.amp_re), ("RP_ENERGY_OUT", out.energy)):
        assert ptrs[rp[key]] == t.data_ptr(), key
    assert ints[ri["RI_NREG"]] == spec.R - 1   # all but the framework
    tiling = resync_tiling(spec, 5)
    assert ints[ri["RI_ZGROUPS"]:ri["RI_THREADS"] + 1] == list(tiling)
    assert floats[rf["RF_VOLUME"]] == pytest.approx(
        spec.host_scalars["volume"], rel=1e-6)
    with pytest.raises(ValueError, match="type 1 differ"):
        resync._launch(dataclasses.replace(spec, q_mixed_types=(1,)), states)
    q = spec.site_q.numpy().copy()
    args = (spec.site_base_list, spec.A_list, spec.cap_list)
    base, A = spec.site_base_list[1], spec.A_list[1]
    q[base + 2 * A + 1] *= 0.5
    assert _charge_table(q, *args, spec.guest_base)[2] == (1,)
    # the frozen framework's charges are not the resync's: with the split
    # its one molecule is outside the table, without it the table's first
    q = spec.site_q.numpy()
    assert _charge_table(q, *args, spec.guest_base)[0][:, 4].tolist() \
        == list(range(1, spec.R))
    assert _charge_table(q, *args, 0)[0][:, 4].tolist() == list(range(spec.R))
