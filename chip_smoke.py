#!/usr/bin/env python3
"""On-card smoke check of the maniac_tpu_torch main path (one NVIDIA GPU).

    python3 chip_smoke.py    # some two and a half minutes on an H100

Builds the CUDA kernels from maniac_tpu_torch/kernels/csrc with nvcc, then:

  0. device, power limit, versions, TF32 off (asserted), kernel build time;
  1. resync kernel vs its plain torch version on the flagship system
     (make_zif_like(n_cells=6, a=5.66, n_water=32, fugacity=30), capacity
     192, f32) at B=64 after 50 plain steps: max|dA| <= 1e-4 max(1, max|A|),
     relative |dE_RECIP| <= 1e-5; then on its edge replicas
     (tools/resync_times.edge_replicas: no guests, where A must be fw_amp
     exactly; every guest type at capacity; a charged-site count that is
     not a multiple of the kernel's chunk, each guest type at a different
     count), and two launches on one input must give the same bits (every
     resync check below adds the same); timed device-paced;
  2. whole-block kernel vs its plain version, B=64, 50 steps on the same
     uniforms: n_mol and counters identical in all but at most one replica
     (a Metropolis decision at its threshold may flip under f32 summation
     order), and on the matching replicas positions within 1e-4 A and
     energy components within 5 K;
  3. the main path: load_system -> replicate(B=1024) ->
     run_block_replicated(400 steps, resync=True), one warm-up block and
     three timed blocks; both kernels must have launched, the state must be
     finite and within capacity, and replica 0's amplitudes and E_RECIP
     must match a fresh synthesis (phase-1 bounds); one block kernel call
     of 400 steps is timed beside its bound; the far table's size is
     printed (rows, live modes, tiles, bytes). Then both kernels
     are held against their plain versions at the main path's batch (10
     block steps, at most B/64 replicas diverged; the resync of the result
     and its edge replicas) and timed (the resync device-paced);
  4. the whole-step kernel (run_steps_kernel: one launch a step, the
     proposal, energies, decision and commits in place on a clone of the
     caller's state) against the plain steps (steps_plain: the torch step
     with the plain energy core) at B=64 on three systems (the flagship;
     bench.py's `mixed`, two active species with swaps and the split;
     bench.py's `resv` water box without its reservoir, no split): one
     step, then 50-step chains on the same uniforms, with phase 2's bounds
     and, on the matching replicas, the committed amplitudes and E_RECIP
     within phase 1's bounds; the kernel must launch once a step and leave
     its input state as it was; the flagship also at B=1, the single
     chain's shape, with no divergence allowed, and at B=1024 (phase 3's
     states) under its own spec and under the isotherm's (8 fugacities x
     128 replicas, one activity table a replica: the kernel line's time),
     at most B/64 replicas diverged. Each timed per step over 20-step
     calls: device-paced (tools/kernel_times.device_ms: queued behind a
     spin kernel, so the host's pace drops out) and host-paced, the plain
     steps, the device activities a step launches (torch.profiler), beside
     the whole step's bound;
  4b. the resync kernel at B=1 (K4), driven once through
     mc/driver.resync_amplitudes (the resync every replicated block calls)
     with its count set to 0 just before, against its plain version and on
     the edge replicas each alone (phase 1's bounds), timed device-paced
     and host-paced beside its bound;
  5. the command line's isotherm sweep on the flagship deck (3 blocks of
     400 steps, 8 fugacities x 128 replicas = 1024 chains, f32 on the card):
     exit 0, 8 finite isotherm rows, populations within [0, capacity], more
     water at 3000 atm than at 1 atm, the step kernel launched once per
     step (1200 times) and the block kernel never;
  6. the command line's single chain on the same deck (2 blocks of 400
     steps): exit 0, the completion banner, 3 rows of energy.dat, the step
     kernel launched 800 times;
  7. reservoir GCMC, bench.py's `resv` (make_water_box(n_water=48, L=24,
     cutoff=8, tol=1e-5, probs=(0.3, 0.2, 0.5, 0), fugacity=4000) with
     make_water_reservoir(n_water=96, L=24), capacity 192, f32; no
     framework split, every type active): the dispatch must name all three
     kernels; (b) the block kernel's no-split reservoir form against the
     plain block, B=64 x 50 steps, phase 2's bounds with identical res_n
     and extras and reservoir rows within 1e-4 A; (c) box + reservoir +
     dropped molecules conserved exactly on every replica; (d) the resync
     kernel on that state and its edge replicas (phase 1's bounds), and K4
     on resv as phase 4b; (e) the step kernel against
     the plain steps at B=64 (phase 4's bounds) and timed at B=1; (f) the
     no-split form alone on the same water box without its reservoir,
     B=64 x 50; (g) the main path, B=1024, one warm-up and three timed
     blocks of 400 steps with the resync, both kernels' launch counts
     nonzero, then both kernels held and timed at B=1024; (h) the command
     line's single chain with -r (2 blocks of 400 steps): exit 0, the
     banner, reservoir.lammpstrj with 3 frames, 800 step-kernel launches.
  8. bench.py's `mixed` (make_framework_mixed(n_cells=6, a=5.66,
     n_water=24, n_dimer=12, cutoff=8.5, tol=1e-5, probs=(0.25, 0.15, 0.4,
     0.2)), capacity 192, f32: a framework with the split and two active
     species with swaps): (a) the dispatch must name the whole-block
     kernel, and its far table's size; (b) the block kernel's two-species
     form against the plain block, B=64 x 50 steps, phase 2's bounds, swaps
     tried; (c) the main path as phase 3 (B=1024, one warm-up and three
     timed blocks of 400 steps with the resync); (d)
     both kernels held and timed at B=1024;
  9. bench.py's `tricl` (make_triclinic_water(n_water=24, L=22, tilt=(2.0,
     1.2, 0.8), cutoff=7, tol=1e-5, probs=(0.3, 0.2, 0.5, 0),
     fugacity=4000), capacity 192, f32: a triclinic box, no framework):
     (a)-(d) as phase 8 for the block kernel's triclinic form, and K4 on
     tricl as phase 4b; (e) the step
     kernel against the plain steps at B=64 (one step, then 50 steps) and
     at B=1 with no divergence allowed, timed at B=1; (f) the command line's
     single chain on a tricl deck (2 blocks of 400 steps): exit 0, the
     banner, 3 rows of energy.dat, 800 step-kernel launches.
 10. hardware precision and the sentinel: (a) the one-hot kernel K5 against
     numpy on the probe's (8, 256) x (256, 8) operands, exactly, timed
     beside torch.matmul (its library time) by tools/kernel_times.k5_times
     (100 calls each, K5, plain, torch.matmul; and 2 x 1000 calls in
     turns), and the launch path's host cost per call (tools/launch_cost:
     10,000 launches of the empty kernel with K5's, K3's and K2's table
     lengths through build.launch); (b) the main path of K5,
     utils/hwprobe.hw_precision_check(blocks=4), returns "pass" and
     launches K5 and the block kernel; (c) sentinel_check on the flagship
     (B=64, 50 steps): 0 mismatches against the block's own result and
     counter mismatches against a state one block further on; (d) the
     command line with --sentinel 1 on the flagship deck (2 blocks of 400
     steps), with --replicas 64 (K2 + K1) and as a single chain (K3): exit
     0 and "sentinel: 2 cross-checked blocks, 0 divergences"; (e) python
     -m maniac_tpu_torch.tools.precision_probe --blocks 4 prints RESULT:
     PASS;
 11. the micro-benchmarks at the JAX tools' default shapes, each driven
     through its tool's entry point (main) with the launch counts set to 0
     just before, then held against its plain version and timed
     device-paced (the kernels line; the smallest of three passes) and
     host-paced: K6
     (tools/gpass_bench: cur, noerfc, nowrap, read; G 64, NC 47, FL 2, FQ
     6, 100 steps; its Coulomb rows alone, FL 0; its LJ rows alone, FQ 0,
     on gpass_bench.check_inputs: eps and sigma^2 per row, no site within
     2 A of the footprint; all three also at G 61, S 1000, 10 steps, off
     a CTA's 128 pairs and 128 sites) within 1e-5 of the plain
     version's sum of |terms|, and two calls on the same inputs with the
     same bits; K7
     (tools/vpu_bench: the nine ops on a (128, 1280) plane, n 512) within
     1e-4 relative per element; K8 (cpass, cpassT, n 512; also n 1, 6, 7
     and 13, and a (7, 1001) plane at n 512) within 5e-5 relative per
     element. K6's cur, noerfc and nowrap and K8's two forms must take at
     least 1.8 times as long, device-paced, at twice the steps or
     iterations (tools/micro_times.growth): a kernel that hoisted a term
     out of its loop would not.

Prints one JSON line with, per kernel and system, the launch count on the
main path that runs it (phase 3 for the flagship's block and resync
kernels, phase 5 for the step kernel, phase 7g and 7h on resv, phases 8c
and 9c, 9f on mixed and tricl; K4, the resync at B=1, phases 4b, 7d and
9d), the largest error against the plain version, the times of kernel and
plain version (the step kernel's per step, device-paced: the isotherm's
spec at B=1024, resv and tricl at B=1; the resync's and K6-K8's
device-paced), and the
bound: the least time the card could take for the same
work, the larger of the bytes the call must move (each input read once,
each output written once; a whole step reads each replica's amplitudes
at the weighted modes, its live positions and uniform row, and writes the
accepted steps' amplitudes at the real modes) over 3.35 TB/s and its f32 operations, counted from this
run's inputs (_trial_ops, _steps_bound, _resync_bound), over 67 TFLOP/s
(one H100 SXM at 700 W; TF32 is off by design). The far field counts one complex multiply-add per
nonzero coefficient and charged footprint atom, the work the separable
contraction needs. No single PyTorch call computes any of these
functions but K5's (torch.matmul), so library_ms is null on every other
row. Then the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Any failure raises:
the exit code is then non-zero and no result line is printed. It needs no
network and only the files of this repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

from maniac_tpu_torch.tools import card_label
from maniac_tpu_torch.tools import cuda_ms as _cuda_ms
from maniac_tpu_torch.tools.kernel_times import (ISOTHERM_FUGACITIES,
                                                 ISOTHERM_REPLICAS,
                                                 STEPS_TIMED, device_ms,
                                                 isotherm_spec, profile_steps)

RESYNC_SRC = "maniac_tpu_torch/kernels/csrc/resync.cu"
BLOCKG_SRC = "maniac_tpu_torch/kernels/csrc/blockg.cu"
STEPG_SRC = "maniac_tpu_torch/kernels/csrc/stepg.cu"
HWPROBE_SRC = "maniac_tpu_torch/kernels/csrc/hwprobe.cu"
GPASS_SRC = "maniac_tpu_torch/kernels/csrc/gpass.cu"
VPU_SRC = "maniac_tpu_torch/kernels/csrc/vpu.cu"
# phases 1-2, 4: replicas and MC steps of the kernel-vs-plain comparisons
CHECK_REPLICAS, CHECK_STEPS = 64, 50
# phase 3: the flagship main path
MAIN_REPLICAS, MAIN_STEPS, MAIN_BLOCKS = 1024, 400, 3
# phases 5-6: the command line on the flagship deck
CAPACITY = 192
ISOTHERM = ",".join(f"{f:g}" for f in ISOTHERM_FUGACITIES)
ISO_REPLICAS, ISO_BLOCKS, CHAIN_BLOCKS = ISOTHERM_REPLICAS, 3, 2
SEED = 1234
# phase 7: bench.py's resv water box and its reservoir
RESV_BOX = dict(n_water=48, L=24.0, cutoff=8.0, tol=1e-5,
                probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0)
RESV_RESERVOIR = dict(n_water=96, L=24.0)
# phases 8-9: bench.py's mixed and tricl systems
MIXED_SYSTEM = dict(n_cells=6, a=5.66, n_water=24, n_dimer=12, cutoff=8.5,
                    tol=1e-5, probs=(0.25, 0.15, 0.4, 0.2))
TRICL_BOX = dict(n_water=24, L=22.0, tilt=(2.0, 1.2, 0.8), cutoff=7.0,
                 tol=1e-5, probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0)
# phase 10: the command line's sentinel runs
SENTINEL_REPLICAS = 64
# phase 11: the micro-benchmarks' bounds against their plain versions are
# the kernel modules' GPASS_RTOL, VPU_RTOL and CPASS_RTOL; the edge shapes:
# K6 (G, S) with S and G S not multiples of a CTA's 128 pairs, and its
# steps; K8's n under and across the seven offsets, and an (R, C) plane
# whose rows and R C are not multiples of a CTA's 256 elements
GPASS_CHECKED = ("cur", "noerfc", "nowrap", "read")
GPASS_EDGE, GPASS_EDGE_STEPS = (61, 1000), 10
CPASS_EDGE_N = (1, 6, 7, 13)
CPASS_EDGE = (7, 1001)

# ---- bounds: the least time the card could take for a call's work --------
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
# the micro-benchmarks, by the same count: K7 per element and application
# (the negation of exp's argument is free); one K8 element per pass: three
# differences, two wraps (multiply, rint, multiply-add), r2 and its floor,
# rsqrt, alpha r, the erfc probe (13), three products, the select and the
# sum; one K6 pair: three differences, the wrap (not with nowrap), r2 and
# its floor, then LJ (1/r2, sr2, sr6, sr12, difference, 4 eps, select,
# sum) or Coulomb (rsqrt, alpha r, A&S erfc (15), three products, select,
# sum; noerfc: rsqrt, two products, select, sum); read: three sums and the
# accumulation per element and step
OPS_VPU = dict(fma=2, mul2=2, div=2, rsqrt=2, sqrt=2, exp=1, round=3,
               cmpsel=3, erfc=14)
OPS_CPASS = 38
OPS_GPASS_PAIR, OPS_GPASS_WRAP = 9, 12
OPS_GPASS_LJ, OPS_GPASS_COUL, OPS_GPASS_NOERFC = 10, 23, 5
OPS_GPASS_READ = 4


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the f32 peak."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / F32_OPS_PER_S * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                           "operations")


def _modes(spec):
    """(k-space modes with a weight, far-field modes with a coefficient)."""
    k2 = (int(((spec.c2_re != 0) | (spec.c2_im != 0)).sum())
          if spec.fw_split else 0)
    return int((spec.k_weights != 0).sum()), k2


def _type_rows(spec, n_mol, charged):
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


def _step_ops(spec, atoms_q, atoms, sites, rows) -> float:
    """Operations of MC steps: the footprint's charged atoms at every
    k-space mode and every far-field mode with a coefficient (a complex
    multiply-add each), each mode's energy term once per proposal
    that needs energies (rows of them), and every footprint atom against
    the live sites (frozen prefix included) with the box's minimum image;
    atoms_q, atoms and sites (B, 1) per replica."""
    k, k2 = _modes(spec)
    pair = OPS_PAIR + (N_IMAGES * OPS_IMAGE - OPS_MIN_IMAGE
                       if spec.is_triclinic else 0)
    return float((OPS_ATOM_MODE * k + OPS_FAR_ATOM_MODE * k2) * atoms_q.sum()
                 + pair * (atoms * (sites + spec.S_frozen)).sum()
                 + OPS_MODE * (k + k2) * rows)


def _trial_ops(spec, states, out):
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
    from maniac_tpu_torch.constants import (TYPE_CREATION, TYPE_DELETION,
                                            TYPE_ROTATION, TYPE_SWAP,
                                            TYPE_TRANSLATION)
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
    sites = 0.5 * (_type_rows(spec, states.n_mol, False)
                   + _type_rows(spec, out.n_mol, False))[:, None]
    return _step_ops(spec, atoms((spec.type_q_rows != 0).sum(1)),
                     atoms(spec.type_A), sites,
                     float(n.sum() - blocked.sum()))


def _energy_tables(spec):
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


def _block_bound(spec, states, out, u):
    """Bound of one whole-block call: its inputs and outputs once, the
    operations of its valid trials (_trial_ops)."""
    keys = ["pos", "com", "amp_re", "amp_im", "n_mol", "energy", "counters",
            "extras"]
    if spec.has_reservoir:
        keys += ["res_offset", "res_com", "res_n"]
    nbytes = _nbytes(u, states.trans_step, states.rot_step,
                     *_energy_tables(spec),
                     *[getattr(states, k) for k in keys],
                     *[getattr(out, k) for k in keys])
    return _bound(nbytes, _trial_ops(spec, states, out))


def _steps_bound(spec, states, out, n_steps):
    """Bound of one whole step (K3's launch), the mean over the n_steps
    steps that took ``states`` to ``out``: the same work whatever
    implements it. Bytes: each replica's amplitudes at the modes with a
    nonzero k weight read once (all the k-space delta needs), its live
    positions (frozen prefix and live guests) and its uniform row read, the
    spec tables the energies read, and for each accepted step the
    amplitudes at the grid's real (non-pad) modes written, with the ones
    not read yet (zero weight) read, since the new value is the old one
    plus the delta. Operations: the valid trials' (_trial_ops) and
    OPS_PROPOSAL a replica."""
    B = states.B
    weighted = int((spec.k_weights != 0).sum())
    real = (2 * spec.kmax_xyz[2] + 1) * int((spec.k_col_jx >= 0).sum())
    live = 0.5 * (_type_rows(spec, states.n_mol, False)
                  + _type_rows(spec, out.n_mol, False)).sum() + B * (
                      spec.S_frozen if spec.fw_split else 0)
    accepted = float((out.counters[:, 1] - states.counters[:, 1]).sum())
    nbytes = (B * 8 * weighted + 12 * float(live) + B * N_UNIFORMS * 4
              + _nbytes(*_energy_tables(spec))
              + accepted / n_steps * 8 * (2 * real - weighted))
    ops = _trial_ops(spec, states, out) / n_steps + OPS_PROPOSAL * B
    return _bound(nbytes, ops)


def _far_table_line(spec) -> str:
    """The far table's size: rows, live modes (nonzero coefficients),
    tiles, bytes."""
    rows = int((spec.far_rows[:, 3] > 0).sum())
    live = int((spec.far_coef != 0).any(-1).sum())
    return (f"far table {rows} rows in {spec.far_rows.shape[0] // 32} "
            f"groups, {live} live modes, {spec.far_units.shape[0]} tiles, "
            f"{_nbytes(spec.far_coef, spec.far_rows, spec.far_units)} bytes")


def _main_block(spec, states, gen):
    """One block kernel call at the main path's shape (MAIN_STEPS steps for
    every replica of ``states``): (ms, bound)."""
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.mc.driver import draw_uniforms
    u = draw_uniforms(spec, states.B, MAIN_STEPS, gen)
    out = run_block_kernel(spec, states, u)
    ms = _cuda_ms(lambda: run_block_kernel(spec, states, u), 2)
    return ms, _block_bound(spec, states, out, u)


def _main_path(tag, spec, state, gen, label):
    """The main path on one system: replicate(B=1024) ->
    run_block_replicated(400 steps, resync=True), one warm-up and
    MAIN_BLOCKS timed blocks, with the launch counts set to 0 just before;
    both kernels must have launched, the state must be finite, every
    population within [0, capacity], box + reservoir + drops conserved (with
    a reservoir), and replica 0's amplitudes and E_RECIP must match a fresh
    synthesis (phase 1's bounds); one block kernel call of 400 steps is
    timed beside its bound. Then both kernels are held against their plain
    versions at the main path's batch (10 block steps, at most B/64
    replicas diverged; the resync of the result) and timed. Returns (the
    states, the numbers of the kernels line)."""
    from maniac_tpu_torch import replicate, run_block_replicated
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain
    from maniac_tpu_torch.physics.energy import (active_site_mask,
                                                 full_amplitudes,
                                                 recip_energy,
                                                 site_positions)
    from maniac_tpu_torch.system import E_RECIP
    Bm, n_steps = MAIN_REPLICAS, MAIN_STEPS
    states = replicate(spec, state, Bm)
    total0 = _conserved(states)
    run_block_kernel.launches = 0
    resync_grouped.launches = 0
    states = run_block_replicated(spec, states, n_steps, False, True, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MAIN_BLOCKS):
        states = run_block_replicated(spec, states, n_steps, False, True,
                                      gen)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"blockg": run_block_kernel.launches,
                "resync": resync_grouped.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"{tag}: a kernel never launched: {launches}")
    for k, v in vars(states).items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: non-finite values in {k}")
    n = states.n_mol[:, :spec.R]
    caps = torch.tensor(spec.cap_list, device=n.device)
    if int(n.min()) < 0 or bool((n > caps).any()):
        raise AssertionError(f"{tag}: population outside [0, capacity]")
    if spec.has_reservoir and not torch.equal(_conserved(states), total0):
        raise AssertionError(f"{tag}: box + reservoir + drops not conserved")
    ref_re, ref_im = full_amplitudes(
        spec, site_positions(spec, states)[:1],
        active_site_mask(spec, states.n_mol[:1]))
    _amp_check(f"{tag}: replica 0 vs fresh synthesis", states.amp_re[:1],
               states.amp_im[:1], states.energy[:1, E_RECIP], ref_re, ref_im,
               recip_energy(spec, ref_re, ref_im))
    rate = Bm * n_steps * MAIN_BLOCKS / elapsed
    ms_main, bound_main = _main_block(spec, states, gen)
    ms_main_resync = device_ms(lambda: resync_grouped(spec, states), 20)
    mean_n = {r: round(float(n[:, r].float().mean()), 2)
              for r in range(spec.R) if spec.active_list[r]}
    extra = (f", mean reservoir "
             f"{float(states.res_n[:, :spec.R].sum(1).float().mean()):.2f}"
             if spec.has_reservoir else "")
    print(f"{tag}: B={Bm} x {n_steps} steps x {MAIN_BLOCKS} blocks in "
          f"{elapsed:.3f} s: {rate:.0f} MC steps/s ({label}); mean N by "
          f"type {mean_n}{extra}; launches {launches}; one block "
          f"kernel call ({n_steps} steps) {ms_main:.3f} ms, bound "
          f"{bound_main[0]:.3f} ms by {bound_main[1]}; resync "
          f"{ms_main_resync:.4f} ms device-paced")
    # both kernels against their plain versions at the main path's batch
    u = draw_uniforms(spec, Bm, 10, gen)
    k_blk = run_block_kernel(spec, states, u)
    err_block, _ = _block_check(f"{tag}: block B={Bm} x 10 steps", k_blk,
                                steps_plain(spec, states, u),
                                max(1, Bm // 64))
    ms_block = _cuda_ms(lambda: run_block_kernel(spec, states, u), 3)
    ms_block_plain = _cuda_ms(lambda: steps_plain(spec, states, u), 1)
    bound_block = _block_bound(spec, states, k_blk, u)
    k_rs = resync_grouped(spec, k_blk)
    err_resync = max(
        _amp_check(f"{tag}: resync B={Bm} kernel vs plain",
                   *_resync_pair(k_rs, resync_plain(spec, k_blk), E_RECIP)),
        _resync_edges(f"{tag}: resync B={Bm}", spec, k_blk))
    ms_resync = device_ms(lambda: resync_grouped(spec, k_blk), 20)
    ms_resync_host = _cuda_ms(lambda: resync_grouped(spec, k_blk), 10)
    ms_resync_plain = _cuda_ms(lambda: resync_plain(spec, k_blk), 3)
    bound_resync = _resync_bound(spec, k_blk, k_rs)
    print(f"{tag}: B={Bm}: block kernel {ms_block:.3f} ms, plain "
          f"{ms_block_plain:.3f} ms, bound {bound_block[0]:.4f} ms by "
          f"{bound_block[1]} (10 steps); resync kernel {ms_resync:.4f} ms "
          f"device-paced, {ms_resync_host:.4f} ms host-paced, plain "
          f"{ms_resync_plain:.3f} ms, bound {bound_resync[0]:.4f} ms by "
          f"{bound_resync[1]} ({label})")
    return states, dict(
        launches=launches, err_block=err_block, ms_block=ms_block,
        ms_block_plain=ms_block_plain, bound_block=bound_block,
        err_resync=err_resync, ms_resync=ms_resync,
        ms_resync_plain=ms_resync_plain, bound_resync=bound_resync)


def _resync_bound(spec, states, out):
    """Bound of one resync call: every charged live site at every weighted
    mode, then each mode's |A|^2 term."""
    k, _ = _modes(spec)
    ops = float(OPS_ATOM_MODE * k * _type_rows(spec, states.n_mol,
                                                True).sum()
                + OPS_MODE * k * states.B)
    tables = [spec.site_q, spec.k_weights]
    if spec.fw_split:
        tables += [spec.fw_amp_re, spec.fw_amp_im]
    nbytes = _nbytes(states.pos, states.n_mol, states.energy, *tables,
                     out.amp_re, out.amp_im, out.energy)
    return _bound(nbytes, ops)


def _row(name, src, replaces, launches, err, ms, plain_ms, bound,
         library_ms=None):
    """One kernel's entry of the kernels line; library_ms is the time of
    the one PyTorch call that computes the same function, where there is
    one."""
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _conserved(st):
    """Box + reservoir + dropped molecules per replica."""
    return (st.n_mol[:, :-1].sum(1) + st.res_n[:, :-1].sum(1)
            + st.extras[:, 1])


def _amp_check(name, amp_re, amp_im, e_recip, ref_re, ref_im, ref_e):
    """Phase-1 bounds; returns max |dA|."""
    scale = max(1.0, float(torch.max(torch.maximum(ref_re.abs(),
                                                   ref_im.abs()))))
    err = float(torch.max(torch.maximum((amp_re - ref_re).abs(),
                                        (amp_im - ref_im).abs())))
    # an exact match is no error, also where E_RECIP is 0 (no charges)
    d_e = (e_recip - ref_e).abs()
    rel_e = float(torch.max(torch.where(d_e == 0, 0.0, d_e / ref_e.abs())))
    print(f"{name}: max|dA| {err:.3e} (bound {1e-4 * scale:.3e}), "
          f"max rel dE_RECIP {rel_e:.3e} (bound 1e-05)")
    if not err <= 1e-4 * scale or not rel_e <= 1e-5:
        raise AssertionError(f"{name}: amplitudes or E_RECIP out of bounds")
    return err


def _resync_pair(k, p, e_recip):
    """_amp_check arguments for kernel (k) vs plain (p) resync outputs."""
    return (k.amp_re, k.amp_im, k.energy[:, e_recip], p.amp_re, p.amp_im,
            p.energy[:, e_recip])


def _resync_edges(name, spec, states):
    """The resync kernel on the edge replicas of ``states``
    (tools/resync_times.edge_replicas: no guests, every covered type at
    capacity, a charged-site count that is not a multiple of the kernel's
    chunk with each covered type at a different count; at B = 1 each
    alone) against its plain version, phase 1's bounds; the replica
    without guests must hold fw_amp exactly, and two launches on the same
    input must give the same bits. Returns max |dA|."""
    from maniac_tpu_torch import replicate
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.system import E_RECIP
    from maniac_tpu_torch.tools.resync_times import edge_replicas, replica
    single = states.B < 3
    edges = edge_replicas(spec, replicate(spec, states, 3) if single
                          else states, seed=states.B)
    batches = [replica(edges, i) for i in range(3)] if single else [edges]
    err = 0.0
    for i, st in enumerate(batches):
        k, again = resync_grouped(spec, st), resync_grouped(spec, st)
        if not all(torch.equal(getattr(k, f), getattr(again, f))
                   for f in ("amp_re", "amp_im", "energy")):
            raise AssertionError(f"{name}: two launches on one input differ")
        if i == 0 and not (torch.equal(k.amp_re[0], spec.fw_amp_re)
                           and torch.equal(k.amp_im[0], spec.fw_amp_im)):
            raise AssertionError(f"{name}: no guests, but A != fw_amp")
        err = max(err, _amp_check(
            f"{name}: edge replicas{f' {i}' if single else ''}",
            *_resync_pair(k, resync_plain(spec, st), E_RECIP)))
    return err


def _k4_phase(tag, system, spec, state, gen, label):
    """K4, the resync kernel at B = 1 (a single chain's replicated block):
    driven once through mc/driver.resync_amplitudes after CHECK_STEPS plain
    steps, with the count set to 0 just before (it must launch once), held
    against its plain version (phase 1's bounds) with the edge replicas
    alone, then timed device-paced (tools/kernel_times.device_ms) and
    host-paced beside its bound. Returns its kernels line row (the
    flagship's, system None, named resync_grouped/B1)."""
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.mc.driver import (draw_uniforms, resync_amplitudes,
                                            steps_plain)
    from maniac_tpu_torch.system import E_RECIP
    st1 = steps_plain(spec, state, draw_uniforms(spec, 1, CHECK_STEPS, gen))
    resync_grouped.launches = 0
    k_one = resync_amplitudes(spec, st1)
    launches = resync_grouped.launches
    if launches != 1:
        raise AssertionError(f"{tag}: resync_amplitudes launched the kernel "
                             f"{launches} times")
    err = max(_amp_check(f"{tag}: resync B=1 kernel vs plain",
                         *_resync_pair(k_one, resync_plain(spec, st1),
                                       E_RECIP)),
              _resync_edges(f"{tag}: resync B=1", spec, st1))
    ms = device_ms(lambda: resync_amplitudes(spec, st1), 100)
    ms_host = _cuda_ms(lambda: resync_amplitudes(spec, st1), 20)
    ms_plain = _cuda_ms(lambda: resync_plain(spec, st1), 5)
    bound = _resync_bound(spec, st1, k_one)
    print(f"{tag}: resync B=1: kernel {ms:.4f} ms device-paced, "
          f"{ms_host:.4f} ms host-paced; plain {ms_plain:.3f} ms; bound "
          f"{bound[0]:.6f} ms by {bound[1]} ({label})")
    return _row(f"resync_grouped{f'/{system}' if system else ''}/B1",
                RESYNC_SRC,
                "maniac_tpu/kernels/resync.py:44", launches, err, ms,
                ms_plain, bound)


def _block_check(name, k, p, max_diverged):
    """Phase-2 bounds on kernel (k) vs plain (p) block outputs: decisions
    (populations, counters, extras, reservoir counts) identical on all but
    max_diverged replicas; on the rest positions and reservoir rows within
    1e-4 A, energies within 5 K. Returns (the largest position or
    reservoir-row difference there, the matching replicas' mask)."""
    same = ((k.n_mol == p.n_mol).all(dim=1)
            & (k.counters == p.counters).flatten(1).all(dim=1)
            & (k.extras == p.extras).all(dim=1)
            & (k.res_n == p.res_n).all(dim=1))
    n_div = int((~same).sum())
    if n_div > max_diverged:
        raise AssertionError(f"{name}: {n_div} of {same.numel()} replica(s) "
                             f"diverged (allowed {max_diverged})")
    pos_err = max(float((getattr(k, f) - getattr(p, f))[same].abs().max())
                  for f in ("pos", "com", "res_offset", "res_com"))
    e_err = float((k.energy - p.energy)[same].abs().max())
    print(f"{name}: {n_div} of {same.numel()} replica(s) diverged (allowed "
          f"{max_diverged}); matching replicas max|dpos| {pos_err:.3e} A "
          f"(bound 1e-4; positions, COMs, reservoir rows), max|dE| "
          f"{e_err:.3e} K (bound 5); accepts {int(k.counters[:, 1].sum())}")
    if n_div > max_diverged or not pos_err <= 1e-4 or not e_err <= 5.0:
        raise AssertionError(f"{name}: block kernel disagrees with plain")
    return pos_err, same


def _load(make, dev, reservoir=None, **kw):
    """load_system on a fixture written by ``make`` into a temp dir (f32,
    capacity 192, on ``dev``), with a make_water_reservoir(**reservoir)
    reservoir when given."""
    from maniac_tpu_torch import load_system
    from maniac_tpu_torch.systems import make_water_reservoir
    with tempfile.TemporaryDirectory() as tmp:
        make(tmp, **kw)
        res = (make_water_reservoir(tmp, **reservoir) if reservoir
               else None)
        return load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", reservoir_file=res,
                           capacity=CAPACITY, dtype=torch.float32,
                           device=dev)


def _step_check(name, k, p, max_diverged):
    """Phase-2 bounds on step-kernel (k) vs plain-core (p) chains, then the
    amplitudes the kernel committed and E_RECIP of the matching replicas
    against the plain steps', with phase 1's bounds; returns max |dA|."""
    from maniac_tpu_torch.system import E_RECIP
    _, same = _block_check(name, k, p, max_diverged)
    return _amp_check(f"{name}: amplitudes", k.amp_re[same], k.amp_im[same],
                      k.energy[same, E_RECIP], p.amp_re[same],
                      p.amp_im[same], p.energy[same, E_RECIP])


def _step_phase(name, spec, states, gen, max_diverged, n_steps, label):
    """Phase 4 on one system: the whole-step kernel (run_steps_kernel)
    against the plain steps (steps_plain) on the same uniforms, one step,
    then an n_steps chain, with phase 2's bounds and, on the matching
    replicas, the committed amplitudes and E_RECIP within phase 1's; the
    kernel must launch once a step and leave its input state as it was.
    Then STEPS_TIMED steps, per step: the kernel device-paced
    (tools/kernel_times.device_ms: queued behind a spin kernel, so the
    host's pace drops out) and host-paced, the plain steps, the device
    activities a step launches and their device time (torch.profiler), and
    the whole step's bound (_steps_bound). Returns (max |dA|, kernel ms,
    plain ms, (bound ms, what bounds it))."""
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain
    B = states.B
    before = {k: v.clone() for k, v in vars(states).items()}
    err = 0.0
    for n in (1, n_steps) if n_steps else (1,):
        u = draw_uniforms(spec, B, n, gen)
        n0 = run_steps_kernel.launches
        k = run_steps_kernel(spec, states, u)
        if run_steps_kernel.launches != n0 + n:
            raise AssertionError(f"{name}: {run_steps_kernel.launches - n0} "
                                 f"launches for {n} steps")
        err = max(err, _step_check(f"{name}: B={B} x {n} steps", k,
                                   steps_plain(spec, states, u),
                                   max_diverged))
    if not all(torch.equal(v, before[k]) for k, v in vars(states).items()):
        raise AssertionError(f"{name}: the step kernel wrote its input")
    u = draw_uniforms(spec, B, STEPS_TIMED, gen)

    def kernel():
        return run_steps_kernel(spec, states, u)
    bound = _steps_bound(spec, states, kernel(), STEPS_TIMED)
    ms = device_ms(kernel, 3) / STEPS_TIMED
    ms_host = _cuda_ms(kernel, 3) / STEPS_TIMED
    ms_plain = _cuda_ms(lambda: steps_plain(spec, states, u),
                        1) / STEPS_TIMED
    n_act, busy = profile_steps(kernel, STEPS_TIMED)
    print(f"{name}: B={B} per step ({STEPS_TIMED} steps a call): whole-step "
          f"kernel {ms:.4f} ms device-paced, {ms_host:.4f} ms host-paced; "
          f"plain {ms_plain:.3f} ms; {n_act:.2f} device activities a step "
          f"({busy:.4f} ms, torch.profiler); bound {bound[0]:.4f} ms by "
          f"{bound[1]} ({label})")
    return err, ms, ms_plain, bound


def _cli(argv, outdir):
    """maniac_tpu_torch.cli.main with its log on stdout sent to a file;
    returns (exit code, seconds, log text)."""
    from maniac_tpu_torch.cli import main as cli_main
    with open(f"{outdir}.stdout", "w") as f, contextlib.redirect_stdout(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_main(argv + ["-o", outdir])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    with open(f"{outdir}/log.maniac") as f:
        log = f.read()
    return rc, sec, log


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f if not line.startswith("#")]


def _resv_phase(dev, gen, label):
    """Phase 7: reservoir GCMC on bench.py's resv. Returns the kernels
    line's rows of the block, resync and step kernels on this system."""
    from maniac_tpu_torch import replicate
    from maniac_tpu_torch.kernels import dispatch_report
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain
    from maniac_tpu_torch.system import E_RECIP
    from maniac_tpu_torch.systems import make_water_box, make_water_reservoir

    # a. the configuration and its dispatch
    t0 = time.perf_counter()
    rv = _load(make_water_box, dev, reservoir=RESV_RESERVOIR, **RESV_BOX)
    spec = rv.spec
    report = dispatch_report(spec, dev)
    print(f"phase 7a: resv S={spec.S} K={spec.K} kmax={spec.kmax_xyz} "
          f"fw_split={spec.fw_split} N={int(rv.state.n_mol[0, 0])} "
          f"reservoir {int(rv.state.res_n[0, 0])} of "
          f"{spec.res_cap_list[0]}; load {time.perf_counter() - t0:.1f} s; "
          f"{report}")
    if ("block: CUDA whole-block kernel; step: CUDA per-step kernel; "
            "resync: CUDA resync kernel") not in report:
        raise AssertionError("phase 7a: resv is not dispatched to the "
                             "three kernels")

    # b-c. the reservoir form against the plain block; conservation
    B, n_check = CHECK_REPLICAS, CHECK_STEPS
    st = replicate(spec, rv.state, B)
    u = draw_uniforms(spec, B, n_check, gen)
    k_blk = run_block_kernel(spec, st, u)
    p_blk = steps_plain(spec, st, u)
    err_block, _ = _block_check(f"phase 7b: reservoir block B={B} x "
                                f"{n_check} steps", k_blk, p_blk, 1)
    for what, out in (("kernel", k_blk), ("plain", p_blk)):
        if not torch.equal(_conserved(out), _conserved(st)):
            raise AssertionError(f"phase 7c: the {what} block does not "
                                 f"conserve box + reservoir + drops")
    c = k_blk.counters
    print(f"phase 7c: box + reservoir + drops conserved on all {B} "
          f"replicas (kernel and plain): {int(_conserved(st)[0])} each; "
          f"pops {int(c[:, 1, 0].sum())}, pushes {int(c[:, 1, 1].sum())}, "
          f"drops {int(k_blk.extras[:, 1].sum())}")

    # d. the resync kernel on that state, its edge replicas, and K4 (B = 1)
    err_resync = max(
        _amp_check(f"phase 7d: resync B={B} kernel vs plain",
                   *_resync_pair(resync_grouped(spec, k_blk),
                                 resync_plain(spec, k_blk), E_RECIP)),
        _resync_edges(f"phase 7d: resync B={B}", spec, k_blk))
    k4 = _k4_phase("phase 7d", "resv", spec, rv.state, gen, label)

    # e. the step kernel against the plain steps; timed at B = 1 (the single
    # chain's shape, phase 7h)
    err_step, _, _, _ = _step_phase("phase 7e: resv", spec, st, gen, 1,
                                    n_check, label)
    _, ms_step, ms_step_plain, bound_step = _step_phase(
        "phase 7e: resv", spec, replicate(spec, rv.state, 1), gen, 0, 0,
        label)

    # f. the no-split form alone: the same water box without its reservoir
    wb = _load(make_water_box, dev, **RESV_BOX)
    stw = replicate(wb.spec, wb.state, B)
    uw = draw_uniforms(wb.spec, B, n_check, gen)
    err_nosplit, _ = _block_check(
        f"phase 7f: no-split block (no reservoir) B={B} x {n_check} steps",
        run_block_kernel(wb.spec, stw, uw), steps_plain(wb.spec, stw, uw), 1)

    # g. the main path, then both kernels held and timed at its batch
    _, main = _main_path("phase 7g: resv", spec, rv.state, gen, label)

    # h. the command line's single chain with -r
    with tempfile.TemporaryDirectory() as tmp:
        deck = f"{tmp}/resv"
        make_water_box(deck, nb_block=CHAIN_BLOCKS, nb_step=MAIN_STEPS,
                       **RESV_BOX)
        res = make_water_reservoir(deck, **RESV_RESERVOIR)
        run_steps_kernel.launches = 0
        rc, sec, log = _cli(
            ["-i", f"{deck}/input.maniac", "-d", f"{deck}/topology.data",
             "-p", f"{deck}/parameters.inc", "-r", res, "--capacity",
             str(CAPACITY)], f"{tmp}/out")
        chain_launches = run_steps_kernel.launches
        n_chain = CHAIN_BLOCKS * MAIN_STEPS
        with open(f"{tmp}/out/reservoir.lammpstrj") as f:
            frames = f.read().count("ITEM: TIMESTEP")
        print(f"phase 7h: single chain with -r exit {rc}, {n_chain} steps "
              f"in {sec:.2f} s (load included): {n_chain / sec:.0f} MC "
              f"steps/s ({label}); step kernel launches {chain_launches}; "
              f"reservoir.lammpstrj frames {frames}")
        for line in log.splitlines():
            if "kernel dispatch" in line:
                print(f"phase 7h: log: {line.strip()}")
        if (rc != 0 or "Simulation Completed" not in log
                or frames != CHAIN_BLOCKS + 1 or chain_launches != n_chain):
            raise AssertionError("phase 7h: the single chain with -r failed "
                                 "its checks")

    return [
        *_main_rows("resv", main, max(err_block, err_nosplit), err_resync),
        _row("run_steps_kernel/resv", STEPG_SRC,
             "maniac_tpu/kernels/stepg.py:65", chain_launches, err_step,
             ms_step, ms_step_plain, bound_step),
        k4,
    ]


def _main_rows(system, main, err_block, err_resync):
    """The kernels line's rows of the block and resync kernels from a
    _main_path result (errors: the largest of its own and those given);
    the flagship's rows (system None) keep the kernels' bare names."""
    tag = f"/{system}" if system else ""
    return [
        _row(f"resync_grouped{tag}", RESYNC_SRC,
            "maniac_tpu/kernels/resync.py:178", main["launches"]["resync"],
            max(err_resync, main["err_resync"]), main["ms_resync"],
            main["ms_resync_plain"], main["bound_resync"]),
        _row(f"run_block_kernel{tag}", BLOCKG_SRC,
            "maniac_tpu/kernels/blockg.py:128", main["launches"]["blockg"],
            max(err_block, main["err_block"]), main["ms_block"],
            main["ms_block_plain"], main["bound_block"]),
    ]


def _form_phase(tag, system, make, kw, dev, gen, label):
    """Phases 8 and 9 (a)-(d) on one of bench.py's systems: the dispatch
    names the whole-block kernel; the block kernel's form for it against
    the plain block at B=64 x 50 steps (phase 2's bounds; with two active
    species swaps must have been tried); the main path and both kernels
    held and timed at its batch (_main_path). Returns (the loaded system,
    its kernels line rows)."""
    from maniac_tpu_torch import replicate
    from maniac_tpu_torch.kernels import dispatch_report
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain

    t0 = time.perf_counter()
    sysm = _load(make, dev, **kw)
    spec = sysm.spec
    report = dispatch_report(spec, dev)
    print(f"{tag}a: {system} S={spec.S} S_frozen={spec.S_frozen} "
          f"K={spec.K} kmax={spec.kmax_xyz} active species {spec.n_active} "
          f"triclinic={spec.is_triclinic} fw_split={spec.fw_split} N="
          f"{sysm.state.n_mol[0, :spec.R].tolist()}; load "
          f"{time.perf_counter() - t0:.1f} s; {report}")
    if "block: CUDA whole-block kernel" not in report:
        raise AssertionError(f"{tag}a: {system} is not dispatched to the "
                             f"whole-block kernel")
    print(f"{tag}a: {system} {_far_table_line(spec)}")

    B, n_check = CHECK_REPLICAS, CHECK_STEPS
    st = replicate(spec, sysm.state, B)
    u = draw_uniforms(spec, B, n_check, gen)
    k_blk = run_block_kernel(spec, st, u)
    err_block, _ = _block_check(f"{tag}b: {system} block B={B} x {n_check} "
                                f"steps", k_blk, steps_plain(spec, st, u), 1)
    swaps = k_blk.counters[:, :, 4].sum(0).tolist()
    print(f"{tag}b: swap trials {swaps[0]}, accepted {swaps[1]}")
    if spec.n_active > 1 and swaps[0] < 1:
        raise AssertionError(f"{tag}b: no swap was tried")

    _, main = _main_path(f"{tag}c-d: {system}", spec, sysm.state, gen, label)
    return sysm, _main_rows(system, main, err_block, 0.0)


def _tricl_step_phase(sysm, dev, gen, label):
    """Phase 9 (e)-(f): the step kernel on tricl against the plain steps at
    B=64 and, timed, at B=1 with no divergence allowed; the command line's
    single chain on a tricl deck. Returns its kernels line row."""
    from maniac_tpu_torch import replicate
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.systems import make_triclinic_water

    spec = sysm.spec
    err, _, _, _ = _step_phase("phase 9e: tricl", spec,
                               replicate(spec, sysm.state, CHECK_REPLICAS),
                               gen, 1, CHECK_STEPS, label)
    err1, ms, ms_plain, bound = _step_phase(
        "phase 9e: tricl", spec, replicate(spec, sysm.state, 1), gen, 0,
        CHECK_STEPS, label)
    with tempfile.TemporaryDirectory() as tmp:
        deck = f"{tmp}/tricl"
        make_triclinic_water(deck, nb_block=CHAIN_BLOCKS, nb_step=MAIN_STEPS,
                             **TRICL_BOX)
        run_steps_kernel.launches = 0
        rc, sec, log = _cli(
            ["-i", f"{deck}/input.maniac", "-d", f"{deck}/topology.data",
             "-p", f"{deck}/parameters.inc", "--capacity", str(CAPACITY)],
            f"{tmp}/out")
        launches = run_steps_kernel.launches
        n_chain = CHAIN_BLOCKS * MAIN_STEPS
        energy_rows = _rows(f"{tmp}/out/energy.dat")
    print(f"phase 9f: tricl single chain exit {rc}, {n_chain} steps in "
          f"{sec:.2f} s (load included): {n_chain / sec:.0f} MC steps/s "
          f"({label}); step kernel launches {launches}")
    for line in log.splitlines():
        if "kernel dispatch" in line:
            print(f"phase 9f: log: {line.strip()}")
    if (rc != 0 or "Simulation Completed" not in log
            or len(energy_rows) != CHAIN_BLOCKS + 1 or launches != n_chain):
        raise AssertionError("phase 9f: the tricl single chain failed its "
                             "checks")
    return _row("run_steps_kernel/tricl", STEPG_SRC,
                "maniac_tpu/kernels/stepg.py:65", launches, max(err, err1),
                ms, ms_plain, bound)


def _tool_main(main, argv):
    """A tool's entry point with its stdout captured: (exit code, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _last(text):
    lines = text.strip().splitlines()
    return lines[-1].strip() if lines else "(no output)"


def _precision_phase(spec, state, dev, gen, label):
    """Phase 10: K5, the hardware-precision check, the sentinel on the
    flagship (spec, state), its command line and the probe tool. Returns
    K5's row."""
    import numpy as np
    from maniac_tpu_torch import replicate, run_block_uniforms
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.hwprobe import onehot_product
    from maniac_tpu_torch.kernels.resync import resync_grouped
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.mc.driver import (draw_uniforms, sentinel_check,
                                            sentinel_passed)
    from maniac_tpu_torch.systems import make_zif_like
    from maniac_tpu_torch.tools.kernel_times import k5_times
    from maniac_tpu_torch.utils.hwprobe import (hw_precision_check,
                                                onehot_operands)

    # a. K5 against numpy, exactly; timed beside torch.matmul, 100 calls
    # each (the row's times), and 2 x 1000 calls in turns
    x, oh, want = onehot_operands()
    xt, oht = torch.from_numpy(x).to(dev), torch.from_numpy(oh).to(dev)
    err = float(np.abs(onehot_product(xt, oht).cpu().numpy() - want).max())
    k5 = k5_times()
    ms, ms_plain, ms_lib = k5["100 calls"]
    turns = k5["2 x 1000 in turns"]
    ms_turns, ms_lib_turns = (min(t) for t in zip(*turns))
    M, K = x.shape
    bound = _bound(_nbytes(xt, oht) + M * oh.shape[1] * 4,
                   2.0 * M * K * oh.shape[1])
    print(f"phase 10a: one-hot kernel max|err| {err:.3e} (bound 0, exact); "
          f"kernel {ms:.4f} ms, plain {ms_plain:.4f} ms, torch.matmul "
          f"{ms_lib:.4f} ms, bound {bound[0]:.6f} ms by {bound[1]} "
          f"({label})")
    if err != 0.0:
        raise AssertionError("phase 10a: the one-hot kernel is not exact")
    from maniac_tpu_torch.tools.launch_cost import measure
    for table, (us, us_host) in measure(10000).items():
        print(f"phase 10a: launch cost, {table}'s table: {us:.2f} us per "
              f"call, enqueue {us_host:.2f} us (10000 calls; {label})")
    print(f"phase 10a: K5 / torch.matmul = {ms / ms_lib:.3f} (CUDA events, "
          f"100 calls each); in turns, 2 x 1000 calls: "
          f"{ms_turns / ms_lib_turns:.3f} (ms: "
          + ", ".join(f"K5 {k:.4f}, torch.matmul {m:.4f}" for k, m in turns)
          + f"; {label})")

    # b. the main path of K5: the hardware-precision check
    onehot_product.launches = 0
    run_block_kernel.launches = 0
    t0 = time.perf_counter()
    verdict, detail = hw_precision_check(blocks=4)
    sec = time.perf_counter() - t0
    launches = onehot_product.launches
    print(f"phase 10b: hw_precision_check(blocks=4): {verdict} in "
          f"{sec:.1f} s; {detail}; launches onehot {launches}, blockg "
          f"{run_block_kernel.launches}; K5 {ms:.4f} ms a call beside "
          f"torch.matmul {ms_lib:.4f} ms (10a)")
    if verdict != "pass" or launches < 1 or run_block_kernel.launches < 1:
        raise AssertionError("phase 10b: the hardware-precision check "
                             "failed")

    # c. the sentinel on the flagship: its own block matches, a block
    # further on is flagged
    st = replicate(spec, state, CHECK_REPLICAS)
    u1 = draw_uniforms(spec, CHECK_REPLICAS, CHECK_STEPS, gen)
    u2 = draw_uniforms(spec, CHECK_REPLICAS, CHECK_STEPS, gen)
    post = run_block_uniforms(spec, st, u1, False, True)
    post2 = run_block_uniforms(spec, post, u2, False, True)
    same = sentinel_check(spec, st, post, u1, False, resync=True)
    other = sentinel_check(spec, st, post2, u1, False, resync=True)
    print(f"phase 10c: sentinel on the flagship block: {same}; against a "
          f"block further on: {other}")
    if not sentinel_passed(same) or not other["counter_mismatch"] > 0:
        raise AssertionError("phase 10c: the sentinel's checks failed")

    # d. the command line with --sentinel 1: replicas (K2 + K1), then a
    # single chain (K3)
    with tempfile.TemporaryDirectory() as tmp:
        deck = f"{tmp}/deck"
        make_zif_like(deck, n_cells=6, a=5.66, n_water=32, fugacity=30.0,
                      nb_block=CHAIN_BLOCKS, nb_step=MAIN_STEPS)
        files = ["-i", f"{deck}/input.maniac", "-d", f"{deck}/topology.data",
                 "-p", f"{deck}/parameters.inc", "--capacity", str(CAPACITY),
                 "--sentinel", "1"]
        for tag, extra in (("replicas", ["--replicas",
                                         str(SENTINEL_REPLICAS)]),
                           ("single chain", [])):
            run_block_kernel.launches = 0
            resync_grouped.launches = 0
            run_steps_kernel.launches = 0
            rc, sec, log = _cli(files + extra, f"{tmp}/out_{len(extra)}")
            counts = {"blockg": run_block_kernel.launches,
                      "resync": resync_grouped.launches,
                      "stepg": run_steps_kernel.launches}
            lines = [ln.strip() for ln in log.splitlines()
                     if "sentinel" in ln.lower()]
            print(f"phase 10d: --sentinel 1, {tag}: exit {rc} in {sec:.1f} "
                  f"s; launches {counts}; " + "; ".join(lines))
            if extra:
                kernels_ok = (counts["blockg"] >= CHAIN_BLOCKS
                              and counts["resync"] >= CHAIN_BLOCKS)
            else:
                kernels_ok = counts["stepg"] == CHAIN_BLOCKS * MAIN_STEPS
            if (rc != 0 or not kernels_ok
                    or f"sentinel: {CHAIN_BLOCKS} cross-checked blocks, 0 "
                       f"divergences" not in log):
                raise AssertionError(f"phase 10d: --sentinel 1 ({tag}) "
                                     f"failed its checks")

    # e. the probe's command line
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "maniac_tpu_torch.tools.precision_probe",
         "--blocks", "4"], cwd=root, capture_output=True, text=True,
        timeout=600)
    print(f"phase 10e: precision_probe --blocks 4: exit {proc.returncode} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.splitlines():
        print(f"phase 10e: {line}")
    if proc.returncode != 0 or "RESULT: PASS" not in proc.stdout:
        raise AssertionError(f"phase 10e: the probe failed:\n{proc.stderr}")
    return _row("onehot_product", HWPROBE_SRC, "maniac_tpu/utils/hwprobe.py:58",
                launches, err, ms, ms_plain, bound, ms_lib)


def _gpass_ops(variant, G, S, fl, fq, n_steps):
    """Operations of one K6 call (OPS_GPASS_*); ``read``'s function, the
    inputs' sum times n_steps (FL + FQ), needs one sum of each element."""
    if variant == "read":
        return float(G * S * OPS_GPASS_READ)
    pair = OPS_GPASS_PAIR + (0 if variant == "nowrap" else OPS_GPASS_WRAP)
    coul = OPS_GPASS_NOERFC if variant == "noerfc" else OPS_GPASS_COUL
    return float(n_steps * G * S * (fl * (pair + OPS_GPASS_LJ)
                                    + fq * (pair + coul)))


def _elementwise(name, k, p, rtol):
    """max |k - p|, after checking |k - p| <= rtol |p| on every element."""
    diff = (k - p).abs()
    worst = float((diff / p.abs().clamp(min=1e-30)).max())
    if not bool((diff <= rtol * p.abs()).all()):
        raise AssertionError(f"{name}: kernel and plain differ by "
                             f"{worst:.3e} relative (bound {rtol:g})")
    return float(diff.max()), worst


def _gpass_check(tag, v, args, n_steps, fq):
    """K6 of variant v on args against plain within GPASS_RTOL of the sum
    of |terms|: |kernel - plain|."""
    from maniac_tpu_torch.kernels.gpass import (GPASS_RTOL, gpass,
                                                gpass_plain, gpass_scale)
    G, S = args[0].shape
    k = float(gpass(*args, n_steps, fq, v))
    p = float(gpass_plain(*args, n_steps, fq, v))
    scale = gpass_scale(*args, n_steps, fq, v)
    print(f"phase 11: gpass {v} {tag} (G {G}, S {S}, FL "
          f"{args[4].shape[0]}, FQ {fq}, {n_steps} steps): kernel "
          f"{k:.9e}, plain {p:.9e}, |diff| {abs(k - p):.3e} (bound "
          f"{GPASS_RTOL:g} x sum|terms| {scale:.3e})")
    if not (math.isfinite(k) and abs(k - p) <= GPASS_RTOL * scale):
        raise AssertionError(f"phase 11: gpass {v} {tag} disagrees with "
                             f"plain")
    return abs(k - p)


def _growth_check(name, fn, reps):
    """fn(1) and fn(2) (twice the steps or iterations) device-paced: raise
    unless the time grows GROWTH_MIN-fold (a kernel that computes every
    term takes twice as long)."""
    from maniac_tpu_torch.tools.micro_times import GROWTH_MIN, growth
    a, b, ratio = growth(fn, reps)
    print(f"phase 11: {name}: {a:.4f} ms, twice the work {b:.4f} ms, "
          f"x{ratio:.3f} (at least x{GROWTH_MIN:g})")
    if ratio < GROWTH_MIN:
        raise AssertionError(f"phase 11: {name} grew only x{ratio:.3f} "
                             f"at twice the work: terms are not computed")


def _microbench_phase(dev, label):
    """Phase 11: K6, K7 and K8 through their tools, then against their
    plain versions at the tools' default shapes and at edge shapes, K6
    twice on the same inputs (the same bits), each timed device-paced
    (the row's time) and host-paced, and K6 and K8 at twice the work.
    Returns their rows."""
    from maniac_tpu_torch.kernels.gpass import gpass, gpass_plain
    from maniac_tpu_torch.kernels.vpu import (CPASS_RTOL, VPU_OPS, VPU_RTOL,
                                              cpass, cpass_plain, vpu_chain,
                                              vpu_chain_plain)
    from maniac_tpu_torch.tools import gpass_bench, vpu_bench
    from maniac_tpu_torch.tools.micro_times import device_min_ms

    rows = []
    # K6
    G, S, n_steps = gpass_bench.G, gpass_bench.NC * 128, gpass_bench.NSTEP
    fl, fq = gpass_bench.FL, gpass_bench.FQ
    ins = gpass_bench.inputs(G, S, fl, dev)
    # the full pass on the tool's inputs, whose closest pairs' LJ terms
    # (some 1e15 in all) hide every other term in its bound; so also the
    # Coulomb rows alone (FL 0), and the LJ rows alone (FQ 0) on inputs
    # with eps and sigma^2 per row and no site within 2 A of the footprint;
    # each also at the edge shape (S and G S not multiples of 128)
    checks = []
    for (g, s), steps in (((G, S), n_steps), (GPASS_EDGE, GPASS_EDGE_STEPS)):
        full = gpass_bench.inputs(g, s, fl, dev) if g != G else ins
        checks += [("full", full, steps, fq),
                   ("coulomb", (*full[:4], full[4][:0], full[5][:0]), steps,
                    fq),
                   ("lj", gpass_bench.check_inputs(g, s, fl, 0, steps, dev),
                    steps, 0)]
    for v in GPASS_CHECKED:
        gpass.launches = 0
        rc, out = _tool_main(gpass_bench.main, [v])
        launches = gpass.launches
        diffs = [_gpass_check(tag, v, args, steps, nq)
                 for tag, args, steps, nq in checks]
        one, two = (gpass(*ins, n_steps, fq, v) for _ in range(2))
        if not torch.equal(one, two):
            raise AssertionError(f"phase 11: gpass {v}: two calls differ "
                                 f"({float(one)!r}, {float(two)!r})")
        ms = device_min_ms(lambda: gpass(*ins, n_steps, fq, v), 20)
        ms_host = _cuda_ms(lambda: gpass(*ins, n_steps, fq, v), 20)
        ms_plain = _cuda_ms(lambda: gpass_plain(*ins, n_steps, fq, v), 1)
        if v != "read":   # read's time is its one read, not its steps
            _growth_check(f"gpass {v} at {n_steps} and {2 * n_steps} steps",
                          lambda k: gpass(*ins, k * n_steps, fq, v), 20)
        bound = _bound(_nbytes(*ins) + 8,
                       _gpass_ops(v, G, S, fl, fq, n_steps))
        print(f"phase 11: gpass {v}: tool exit {rc}, {_last(out)}; "
              f"launches {launches}; two calls the same bits; kernel "
              f"{ms:.4f} ms device-paced, {ms_host:.4f} ms host-paced, "
              f"plain {ms_plain:.3f} ms, bound {bound[0]:.4f} ms by "
              f"{bound[1]} ({label})")
        if rc != 0 or launches < 1:
            raise AssertionError(f"phase 11: gpass {v} failed its checks")
        rows.append(_row(f"gpass/{v}", GPASS_SRC, "tools/gpass_bench.py:60",
                         launches, max(diffs), ms, ms_plain, bound))
    # K7
    R, C, n = vpu_bench.ROWS, vpu_bench.COLS, vpu_bench.N
    x = vpu_bench.plane(R, C, dev)
    for op in VPU_OPS:
        vpu_chain.launches = 0
        rc, out = _tool_main(vpu_bench.main, [op])
        launches = vpu_chain.launches
        err, rel = _elementwise(f"phase 11: vpu {op}", vpu_chain(x, op, n),
                                vpu_chain_plain(x, op, n), VPU_RTOL)
        ms = device_min_ms(lambda: vpu_chain(x, op, n), 20)
        ms_host = _cuda_ms(lambda: vpu_chain(x, op, n), 20)
        ms_plain = _cuda_ms(lambda: vpu_chain_plain(x, op, n), 2)
        bound = _bound(2 * _nbytes(x), float(n * R * C * OPS_VPU[op]))
        print(f"phase 11: vpu {op}: tool exit {rc}, {_last(out)}; "
              f"launches {launches}; max|dx| {err:.3e}, max rel {rel:.3e} "
              f"(bound {VPU_RTOL:g}); kernel {ms:.4f} ms device-paced, "
              f"{ms_host:.4f} ms host-paced, plain {ms_plain:.3f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({label})")
        if rc != 0 or launches < 1:
            raise AssertionError(f"phase 11: vpu {op} failed its checks")
        rows.append(_row(f"vpu/{op}", VPU_SRC, "tools/vpu_bench.py:57",
                         launches, err, ms, ms_plain, bound))
    # K8
    cins = vpu_bench.cpass_inputs(R, C, dev)
    edge = vpu_bench.cpass_inputs(*CPASS_EDGE, dev)
    for name in ("cpass", "cpassT"):
        tr = name == "cpassT"
        cpass.launches = 0
        rc, out = _tool_main(vpu_bench.main, [name])
        launches = cpass.launches
        err, rel = _elementwise(f"phase 11: {name}", cpass(*cins, n, tr),
                                cpass_plain(*cins, n, tr), CPASS_RTOL)
        # n not a multiple of the seven offsets, or under one group; a row
        # not a multiple of a CTA's elements
        for args, nn in [(cins, k) for k in CPASS_EDGE_N] + [(edge, n)]:
            e, r = _elementwise(f"phase 11: {name} {tuple(args[0].shape)} "
                                f"n {nn}", cpass(*args, nn, tr),
                                cpass_plain(*args, nn, tr), CPASS_RTOL)
            print(f"phase 11: {name} {tuple(args[0].shape)} n {nn}: max|d| "
                  f"{e:.3e}, max rel {r:.3e} (bound {CPASS_RTOL:g})")
            err, rel = max(err, e), max(rel, r)
        ms = device_min_ms(lambda: cpass(*cins, n, tr), 20)
        ms_host = _cuda_ms(lambda: cpass(*cins, n, tr), 20)
        ms_plain = _cuda_ms(lambda: cpass_plain(*cins, n, tr), 2)
        _growth_check(f"{name} at n {n} and {2 * n}",
                      lambda k: cpass(*cins, k * n, tr), 20)
        bound = _bound(_nbytes(*cins) + _nbytes(cins[0]),
                       float(n * R * C * OPS_CPASS))
        print(f"phase 11: {name}: tool exit {rc}, {_last(out)}; "
              f"launches {launches}; max|d| {err:.3e}, max rel {rel:.3e} "
              f"(bound {CPASS_RTOL:g}); kernel {ms:.4f} ms device-paced, "
              f"{ms_host:.4f} ms host-paced, plain {ms_plain:.3f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({label})")
        if rc != 0 or launches < 1:
            raise AssertionError(f"phase 11: {name} failed its checks")
        rows.append(_row(name, VPU_SRC, "tools/vpu_bench.py:108", launches,
                         err, ms, ms_plain, bound))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from maniac_tpu_torch import load_system, replicate
    from maniac_tpu_torch.kernels import build, dispatch_report
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.mc.driver import (draw_uniforms, resync_amplitudes,
                                            steps_plain)
    from maniac_tpu_torch.system import E_RECIP
    from maniac_tpu_torch.systems import (make_framework_mixed,
                                          make_triclinic_water,
                                          make_water_box, make_zif_like)

    # ---- phase 0: device and build ---------------------------------------
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = card_label()
    print(f"phase 0: device {name}; nvidia-smi: {smi}")
    print(f"phase 0: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.library()
    print(f"phase 0: kernel build {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        if any(w in line for w in ("entry function", "registers",
                                   "spill")):
            print(f"phase 0: ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        make_zif_like(tmp, n_cells=6, a=5.66, n_water=32, fugacity=30.0)
        t0 = time.perf_counter()
        sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", capacity=192,
                           dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    spec = sysm.spec
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    print(f"phase 0: TF32 off (matmul and cuDNN); flagship S={spec.S} "
          f"S_frozen={spec.S_frozen} K={spec.K} kmax={spec.kmax_xyz} "
          f"far grid {spec.amp2_shape}; load {t_load:.1f} s")
    print(f"phase 0: {dispatch_report(spec, dev)}")
    print(f"phase 3: flagship {_far_table_line(spec)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # ---- phase 1: resync kernel vs plain -----------------------------------
    B, n_check = CHECK_REPLICAS, CHECK_STEPS
    states = replicate(spec, sysm.state, B)
    u = draw_uniforms(spec, B, n_check, gen)
    states = steps_plain(spec, states, u)
    n = states.n_mol[:, 1]
    print(f"phase 1: B={B} after {n_check} plain steps, N in "
          f"[{int(n.min())}, {int(n.max())}]")
    k_out = resync_grouped(spec, states)
    p_out = resync_plain(spec, states)
    err_rs1 = max(_amp_check("phase 1: resync kernel vs plain",
                             *_resync_pair(k_out, p_out, E_RECIP)),
                  _resync_edges("phase 1: resync", spec, states))
    ms_rs = device_ms(lambda: resync_grouped(spec, states), 20)
    ms_rs_plain = _cuda_ms(lambda: resync_plain(spec, states), 3)
    print(f"phase 1: resync B={B}: kernel {ms_rs:.4f} ms device-paced, "
          f"plain {ms_rs_plain:.3f} ms ({name}, {smi})")

    # ---- phase 2: block kernel vs plain ------------------------------------
    st0 = p_out
    u = draw_uniforms(spec, B, n_check, gen)
    k_blk = run_block_kernel(spec, st0, u)
    p_blk = steps_plain(spec, st0, u)
    err_blk2, _ = _block_check(f"phase 2: block B={B} x {n_check} steps",
                               k_blk, p_blk, 1)
    ms_blk = _cuda_ms(lambda: run_block_kernel(spec, st0, u), 3)
    ms_blk_plain = _cuda_ms(lambda: steps_plain(spec, st0, u), 1)
    print(f"phase 2: block kernel {ms_blk:.3f} ms, plain "
          f"{ms_blk_plain:.3f} ms ({name}, {smi})")

    # ---- phase 3: the main path ------------------------------------------
    states, main = _main_path("phase 3: flagship", spec, sysm.state, gen,
                              f"{name}, {smi}")

    # ---- phase 4: the whole-step kernel vs the plain steps -----------------
    label = f"{name}, {smi}"
    systems = [("flagship", spec, sysm.state)]
    for sname, make, kw in (
            ("mixed", make_framework_mixed,
             dict(n_cells=6, a=5.66, n_water=24, n_dimer=12, cutoff=8.5,
                  tol=1e-5, probs=(0.25, 0.15, 0.4, 0.2))),
            ("resv water box", make_water_box,
             dict(n_water=48, L=24.0, cutoff=8.0, tol=1e-5,
                  probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0))):
        other = _load(make, dev, **kw)
        systems.append((sname, other.spec, other.state))
    err_step = 0.0
    for sname, sp, st in systems:
        print(f"phase 4: {sname}: {dispatch_report(sp, dev)}")
        st = replicate(sp, st, B)
        err, _, _, _ = _step_phase(f"phase 4: {sname}", sp, st, gen, 1,
                                   n_check, label)
        err_step = max(err_step, err)
    # the single chain's shape (phase 6): B = 1, no divergence allowed
    err, _, _, _ = _step_phase("phase 4: flagship", spec,
                               replicate(spec, sysm.state, 1), gen, 0,
                               n_check, label)
    err_step = max(err_step, err)
    # the main path's batch (phase 3's states): the flagship's spec, then
    # the isotherm's (phase 5: 8 fugacities x 128 replicas, one activity
    # table a replica), whose time is the kernels line's
    err, _, _, _ = _step_phase("phase 4: flagship", spec, states, gen,
                               max(1, MAIN_REPLICAS // 64), 0, label)
    err_step = max(err_step, err)
    sweep = isotherm_spec(spec)
    print(f"phase 4: isotherm spec: {dispatch_report(sweep, dev)}")
    err, ms_step, ms_step_plain, bound_step = _step_phase(
        f"phase 4: isotherm {len(ISOTHERM.split(','))} x {ISO_REPLICAS}",
        sweep, states, gen, max(1, MAIN_REPLICAS // 64), n_check, label)
    err_step = max(err_step, err)

    # ---- phase 4b: the resync kernel at B = 1 (K4) --------------------------
    k4 = _k4_phase("phase 4b", None, spec, sysm.state, gen, label)

    # ---- phases 5-6: the command line -------------------------------------
    fugs = [float(f) for f in ISOTHERM.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        iso_deck, chain_deck = f"{tmp}/iso", f"{tmp}/chain"
        make_zif_like(iso_deck, n_cells=6, a=5.66, n_water=32,
                      fugacity=30.0, nb_block=ISO_BLOCKS, nb_step=MAIN_STEPS)
        make_zif_like(chain_deck, n_cells=6, a=5.66, n_water=32,
                      fugacity=30.0, nb_block=CHAIN_BLOCKS,
                      nb_step=MAIN_STEPS)

        def files(d):
            return ["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                    "-p", f"{d}/parameters.inc", "--capacity",
                    str(CAPACITY)]

        run_steps_kernel.launches = 0
        resync_grouped.launches = 0
        run_block_kernel.launches = 0
        rc, sec, log = _cli(files(iso_deck) + [
            "--isotherm", ISOTHERM, "--replicas", str(ISO_REPLICAS)],
            f"{tmp}/iso_out")
        iso_launches = {"stepg": run_steps_kernel.launches,
                        "resync": resync_grouped.launches,
                        "blockg": run_block_kernel.launches}
        n_iso = len(fugs) * ISO_REPLICAS * ISO_BLOCKS * MAIN_STEPS
        print(f"phase 5: isotherm exit {rc}, {len(fugs)} x {ISO_REPLICAS} "
              f"chains x {ISO_BLOCKS * MAIN_STEPS} steps in {sec:.2f} s "
              f"(load included): {n_iso / sec:.0f} MC steps/s ({label}); "
              f"launches {iso_launches}")
        for line in log.splitlines():
            if "kernel dispatch" in line or "throughput" in line:
                print(f"phase 5: log: {line.strip()}")
        rows = _rows(f"{tmp}/iso_out/isotherm.dat")
        series = _rows(f"{tmp}/iso_out/isotherm_wat.dat")
        iso_n = [float(r[2]) for r in rows]
        print(f"phase 5: <N> per fugacity {dict(zip(fugs, iso_n))}")
        vals = iso_n + [float(v) for r in series for v in r[1:]]
        if (rc != 0 or len(rows) != len(fugs)
                or not all(math.isfinite(float(v)) for r in rows
                           for v in r[1:4])
                or not all(0.0 <= v <= CAPACITY for v in vals)
                or not iso_n[-1] > iso_n[0]
                or iso_launches["stepg"] != ISO_BLOCKS * MAIN_STEPS
                or iso_launches["blockg"] != 0
                or iso_launches["resync"] < 1):
            raise AssertionError("phase 5: the isotherm sweep failed its "
                                 "checks")

        run_steps_kernel.launches = 0
        rc, sec, log = _cli(files(chain_deck), f"{tmp}/chain_out")
        chain_launches = run_steps_kernel.launches
        n_chain = CHAIN_BLOCKS * MAIN_STEPS
        print(f"phase 6: single chain exit {rc}, {n_chain} steps in "
              f"{sec:.2f} s (load included): {n_chain / sec:.0f} MC "
              f"steps/s ({label}); step kernel launches {chain_launches}")
        energy_rows = _rows(f"{tmp}/chain_out/energy.dat")
        if (rc != 0 or "Simulation Completed" not in log
                or len(energy_rows) != CHAIN_BLOCKS + 1
                or chain_launches != n_chain):
            raise AssertionError("phase 6: the single chain failed its "
                                 "checks")

    resv = _resv_phase(dev, gen, label)

    # ---- phases 8-9: bench.py's mixed and tricl ---------------------------
    _, mixed = _form_phase("phase 8", "mixed", make_framework_mixed,
                           MIXED_SYSTEM, dev, gen, label)
    tricl_sys, tricl = _form_phase("phase 9", "tricl", make_triclinic_water,
                                   TRICL_BOX, dev, gen, label)
    tricl_step = _tricl_step_phase(tricl_sys, dev, gen, label)
    tricl_k4 = _k4_phase("phase 9d", "tricl", tricl_sys.spec,
                         tricl_sys.state, gen, label)

    # ---- phases 10-11: hardware precision, the sentinel, the tools -------
    onehot = _precision_phase(spec, sysm.state, dev, gen, label)
    micro = _microbench_phase(dev, label)

    print(json.dumps({"kernels": [
        *_main_rows(None, main, err_blk2, err_rs1), k4,
        _row("run_steps_kernel", STEPG_SRC,
             "maniac_tpu/kernels/stepg.py:65", iso_launches["stepg"],
             err_step, ms_step, ms_step_plain, bound_step),
        *resv, *mixed, *tricl, tricl_step, tricl_k4, onehot, *micro,
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
