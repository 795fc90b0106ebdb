#!/usr/bin/env python3
"""On-card smoke check of the maniac_tpu_torch main path (one NVIDIA GPU).

    python3 chip_smoke.py    # some eight minutes on an H100

Builds the CUDA kernels from maniac_tpu_torch/kernels/csrc with nvcc, then
runs the phases below. Every system is loaded with the seed SEED, and every
block draws its uniforms from its replicas' threefry keys (the JAX
package's stream; on the card the threefry kernel, csrc/threefry.cu):

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
     three timed blocks; the threefry, block and resync kernels must have
     launched, the state must be
     finite and within capacity, and replica 0's amplitudes and E_RECIP
     must match a fresh synthesis (phase-1 bounds); one block kernel call
     of 400 steps is timed beside its bound; the three blocks are run
     again from the same state in turns, drawing their uniforms or on
     them drawn ahead (DRAW_TURNS; the same decisions each time), so that
     the difference in time, the order cancelled, is what the draw costs
     the path; the far table's size is
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
     out of its loop would not. Then K7 and csrc/prims.cuh's branch-free
     primitives through tools/micro_times (--kernels K7 --prims: K7's nine
     ops device- and host-paced, each primitive's exhaustive check over its
     domain and over every positive finite float), and each primitive's
     exhaustive check (kernels/vpu.prim_check: every f32 bit pattern of
     its domain through the primitive and the expression it replaces, the
     reciprocal, root and reciprocal root as nvcc builds them) with its
     count set to 0 just before: 0 mismatches, every value of the domain
     checked, the same count as its plain version (the correctly rounded
     value from f64 against torch's f32 expression), timed beside it;
 12. the command line's single chain on the flagship deck with Widom and
     checkpoints (2 blocks of 400 steps, the step kernel): with --widom 256
     energy.dat is the same text as without it and widom.dat holds 2
     finite rows (factors >= 0, a positive cumulative factor at the end);
     a 1-block run with --checkpoint,
     then --resume on the 2-block deck, writes block 2's energy.dat row as
     the uninterrupted run does; each run launches the step kernel once a
     step it runs;
 13. the threefry stream and tabulated potentials: (a) the threefry kernel
     (kernels/threefry.split_uniform: split each replica's key, draw its
     (400, 21) uniforms) against its plain version on phase 3's 1024 keys
     (rows 0-2 edge keys of all-zero and all-one words) in f32, and on 64
     of them in f64: every new key and uniform with the same bits, 0
     mismatches; (b) its device-paced time at the main path's shape beside
     torch.rand of that shape on the card (another function, the stream
     the port drew from before: a reference) and its bound; (c)
     tests/test_tabulated.py's GCMC water box with use_table on the card,
     f64, B=16, two blocks of 100 steps: dispatch_report names the
     tabulated potentials (the plain torch step, as the JAX package runs
     XLA), every replica's drift_report within 1e-6 K, and the energies
     within 1e-9 relative of the same seed's run on the CPU.
 14. the mesh on the card (parallel/mesh.py, one process a GPU, the
     replica axis split; the flagship at B=1024, MESH_BLOCKS blocks of 400
     steps with the recalibration, the first a warm-up): (a) the launcher
     (tools/launch_multihost) at a world of 1 over NCCL, in a subprocess,
     whose block lines must be the same text as a single-process
     run_block_replicated + gather_replica_stats on the same seed here,
     its rate beside the single process's and the launcher's without a
     process group (no collective at all) in turns (P S N N S P), K2 and
     T launched once a block; (b) two gloo ranks sharing cuda:0 (this script
     run as ``--mesh-rank``; NCCL refuses two ranks on one card, which two
     NCCL launcher ranks beside them show), 512 replicas each: every
     rank's final n_mol, counters, energy, key and positions bit for bit
     its replicas of (a)'s single-process run, its block lines the same
     text, K2 and T launched once a block (the counts set to 0 just
     before) and named by dispatch_report; (c) rank 0 holds K2 against
     its plain version on 8 of its replicas for 50 steps (phase 2's
     bounds), then runs one run_block_sharded(..., resync=True) block,
     which must launch K1 once, held against a fresh plain synthesis
     (phase 1's bounds). A rank's non-zero exit or timeout fails the
     phase.
 15. the validation layer on the card: (a) the f32 per-move dE envelope
     (tools/delta_e_report.measure: make_zif_like(n_cells=4, a=5.66,
     n_water=16, fugacity=50), capacity 64, 64 replicas from seed 3, 200
     steps) through the step kernel (one launch a step), the block kernel
     (200 one-step blocks) and the plain f32 step, each accepted move's
     running dE against an f64 recompute on the card (TF32 stays off):
     max, mean and p99 printed, max < 5e-4 and mean < 1e-4 kcal/mol,
     more than 20 moves, the dispatch naming both kernels; (b) the virial
     anchor (maniac_tpu_torch/virial.py: the LJ gas at z* = 0.032, T* =
     1.5, 64 replicas, capacity 96, 10 + 30 blocks of 150 steps) on the
     block kernel in f32 with the resync: <N> within 3 sem + 0.6% of the
     virial value and more than 4 sem from the ideal one, then 12 blocks
     of Widom (widom_block_replicated, 64 ghosts a replica) within 3 sem
     + 1% of exp(-2 B2 rho) and more than 3 sem from 1; the block,
     resync and threefry kernels once a block; (c) every case of
     tools/run_examples.py through the command line with --sentinel 1
     (exit 0, "Simulation Completed", the kernel that took its steps
     named and its launches counted: the step kernel once a step where
     the dispatch names it, no block kernel), the isotherm (the step
     kernel once a step), then the flagship deck with --replicas 1024
     --sentinel 1 for FLAGSHIP_SENTINEL_BLOCKS blocks; the total of
     checked blocks and divergences under the command line's rule
     (cli.py: more than max(2, 4 x checked / 500) fails).
 16. the bench's systems (maniac_tpu_torch/bench.py): (a) bench.py's bigS
     (make_water_box(n_water=2000, L=40, cutoff=8.5, tol=1e-5, probs=(0.3,
     0.2, 0.5, 0), fugacity=4000), f32, no framework split) loaded on the
     card at capacity 2500 (the bench's) and 5000 (the reference's cap a
     type, src/parameters.f90:8), timed, with its S, K and dispatch, which
     must name the block and resync kernels; (b) the block kernel against
     the plain steps at B=8 x 50 steps on the same uniforms
     (bench.kernel_check: at most 1 replica diverged, positions within 1e-4
     A) and the resync kernel on its result and edge replicas (phase 1's
     bounds); (c) the main path as phase 3 without its reruns (B=1024, one
     warm-up and three timed blocks of 400 steps with the resync), both
     kernels held and timed at B=1024: bigS's rows of the kernels line.
     bigS's energy bound (16b, 16c): its Coulomb components are some 1.2e8
     K at load, where one f32 ulp is 8 K, and the running energies add
     every accepted delta to them, so the kernel's and the plain sums may
     round one ulp apart at every accepted step, which phase 2's fixed 5 K
     cannot hold: energies within 5 K plus one f32 ulp of the component's
     load-time magnitude per accepted step of the compared chain
     (bench.energy_bound); (d) the f64 canary through bench.run (zif, B=64
     x 50 steps x 1 block, every kernel gate refuses f64): the dispatch
     names the plain path, and the timed block launches the threefry kernel
     once and no other kernel; (e) python -m maniac_tpu_torch.bench at its
     defaults (zif) in a subprocess: its last line parses, its checks pass,
     and its rate lies within 5% of phase 3's (one program at one size).

Prints one JSON line with, per kernel and system, the launch count on the
main path that runs it (phase 3 for the flagship's block, resync and
threefry kernels, phase 5 for the step kernel, phase 7g and 7h on resv,
phases 8c and 9c, 9f on mixed and tricl, 16c on bigS at capacity 2500 and
5000; K4, the resync at B=1, phases 4b,
7d and 9d; K6-K8 and the primitive check, a checking kernel whose error is
its mismatch count against the plain version's, phase 11), the largest
error against the plain version, the times of kernel and plain version
(the step kernel's per step, device-paced: the isotherm's spec at B=1024,
resv and tricl at B=1; the resync's and K6-K8's device-paced), and the
bound: the least time the card could take for the same work, the larger of
the bytes the call must move (each input read once, each output written
once; a whole step reads each replica's amplitudes at the weighted modes,
its live positions and uniform row, and writes the accepted steps'
amplitudes at the real modes) over 3.35 TB/s and its f32 operations,
counted from this run's inputs (maniac_tpu_torch/tools/bounds.py:
trial_ops, steps_bound, resync_bound), over 67 TFLOP/s (one H100 SXM at
700 W; TF32 is off by design; the threefry kernel's shifts and logic over
a quarter of that rate, the ALU's, or all its operations over half of it,
the issue rate: _threefry_bound).
The far field counts one complex multiply-add per nonzero coefficient and
charged footprint atom, the work the separable contraction needs. No
single PyTorch call computes any of these functions but K5's
(torch.matmul), so library_ms is null on every other row (torch.rand,
printed beside the threefry kernel, draws another stream).
Then the card's name and power limit,
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
import re
import subprocess
import sys
import tempfile
import time

import torch

from maniac_tpu_torch.bench import (block_errors, conserved, energy_bound,
                                    same_decisions)
from maniac_tpu_torch.tools import bounds, card_label
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
THREEFRY_SRC = "maniac_tpu_torch/kernels/csrc/threefry.cu"
# phases 1-2, 4: replicas and MC steps of the kernel-vs-plain comparisons
CHECK_REPLICAS, CHECK_STEPS = 64, 50
# phase 3: the flagship main path
MAIN_REPLICAS, MAIN_STEPS, MAIN_BLOCKS = 1024, 400, 3
# the reruns after the main path's (drawing) run: True on uniforms drawn
# ahead, False drawing them
DRAW_TURNS = (True, True, False, True, False, False, True)
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
# phase 12: Widom trials a block and species on the flagship chain (most
# ghosts there overlap a framework site: a block of 8 can find B = 0)
WIDOM_TRIALS = 256
# phase 13: the f64 check of the threefry kernel and the tabulated water box
# (tests/test_tabulated.py's GCMC box): replicas, blocks of steps, bounds
THREEFRY_F64_REPLICAS = 64
TABLE_BOX = dict(n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                 probs=(0.3, 0.2, 0.5, 0.0), fugacity=5000.0,
                 use_table="true")
TABLE_REPLICAS, TABLE_BLOCKS, TABLE_STEPS = 16, 2, 100
TABLE_DRIFT_K = 1e-6
TABLE_RTOL = 1e-9
# phase 14: the mesh on the card: blocks of the flagship's B =
# MAIN_REPLICAS (the first a warm-up, as the launcher times them), the gloo
# world sharing cuda:0, the seconds a phase-14 world may take, the replicas
# rank 0 holds K2 on, and the state fields each rank must give bit for bit
MESH_BLOCKS, MESH_WARMUP, MESH_RANKS = 4, 1, 2
MESH_TIMEOUT = 240
MESH_CHECK_REPLICAS = 8
MESH_FIELDS = ("n_mol", "counters", "energy", "key", "pos")
# phase 15: the validation layer. (a) the f32 per-move dE envelope
# (tools/delta_e_report's system) through K3, K2 and the plain step, with
# tests/test_precision.py's bounds (kcal/mol); (b) the virial anchor's
# sizes are maniac_tpu_torch/virial.py's; (c) blocks of the flagship
# deck's --replicas 1024 --sentinel 1 run
ENVELOPE_REPLICAS, ENVELOPE_STEPS, ENVELOPE_SEED = 64, 200, 3
ENVELOPE_PATHS = ("step", "block", "plain")
ENVELOPE_MAX, ENVELOPE_MEAN = 5e-4, 1e-4
FLAGSHIP_SENTINEL_BLOCKS = 4
# phase 16: bench.py's bigS (maniac_tpu_torch/bench.py SYSTEMS) at the
# bench's capacity and at the reference's cap of 5000 a type; replicas of
# its kernel check; the f64 canary's replicas, steps and blocks; how far the
# bench's rate in a subprocess may lie from phase 3's (one program at one
# size), and the seconds the subprocess may take
BIGS_CAPACITIES = (2500, 5000)
BIGS_CHECK_REPLICAS = 8
CANARY_REPLICAS, CANARY_STEPS, CANARY_BLOCKS = 64, 50, 1
BENCH_RATE_RTOL = 0.05
BENCH_TIMEOUT = 600

# ---- bounds (the rates and the main paths' counts: tools/bounds.py) -------
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
# the primitive check, per value: the branch-free form (rcp: MUFU and two
# FMA; sqrt: MUFU, two products, two FMA; rsqrt: MUFU), the expression it
# replaces (one operation), the compare and the tally
OPS_PRIM_CHECK = dict(rcp=6, sqrt=8, rsqrt=4)


# the integer issue of one H100 SXM SM: four partitions, each one warp
# instruction a clock, so 128 lanes of issue, half of F32_OPS_PER_S
# (which counts an FMA as two on 128 lanes); shifts and logic run only on the
# integer ALU, 64 lanes, a quarter of it, while an add may also issue as
# an IMAD on the FMA pipe
DISPATCH_OPS_PER_S = bounds.F32_OPS_PER_S / 2
ALU_OPS_PER_S = bounds.F32_OPS_PER_S / 4
# one threefry2x32 (csrc/threefry.cu) at its fewest 32-bit operations: 20
# funnel shifts and 20 xors (ALU only) and 27 adds: 20 rounds, 5 key
# injections into x1 (key word plus group number, one constant a key),
# x1's initial add and x0's last injection; x0's initial add and other
# injections ride on the next round's three-input add, and the key
# schedule's xors are one a key. The f32 uniform: the words' xor and a
# shift-or (LEA.HI; ALU only), then a subtract and a max in floats
THREEFRY_ALU_OPS, THREEFRY_ADDS = 40, 27
TO_UNIFORM_F32_ALU_OPS, TO_UNIFORM_F32_FLOAT_OPS = 2, 2


def _far_table_line(spec) -> str:
    """The far table's size: rows, live modes (nonzero coefficients),
    tiles, bytes."""
    rows = int((spec.far_rows[:, 3] > 0).sum())
    live = int((spec.far_coef != 0).any(-1).sum())
    return (f"far table {rows} rows in {spec.far_rows.shape[0] // 32} "
            f"groups, {live} live modes, {spec.far_units.shape[0]} tiles, "
            f"{bounds.tensor_bytes(spec.far_coef, spec.far_rows,
                                   spec.far_units)} bytes")


def _main_block(spec, states):
    """One block kernel call at the main path's shape (MAIN_STEPS steps for
    every replica of ``states``): (ms, bound)."""
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.mc.driver import draw_uniforms
    _, u = draw_uniforms(spec, states, MAIN_STEPS)
    out = run_block_kernel(spec, states, u)
    ms = _cuda_ms(lambda: run_block_kernel(spec, states, u), 2)
    return ms, bounds.block_bound(spec, states, out, u)


def _main_path(tag, spec, state, label, turns=DRAW_TURNS, e_load=None):
    """The main path on one system: replicate(B=1024) ->
    run_block_replicated(400 steps, resync=True), one warm-up and
    MAIN_BLOCKS timed blocks, with the launch counts set to 0 just before;
    both kernels must have launched, the state must be finite, every
    population within [0, capacity], box + reservoir + drops conserved (with
    a reservoir), and replica 0's amplitudes and E_RECIP must match a fresh
    synthesis (phase 1's bounds); one block kernel call of 400 steps is
    timed beside its bound; the timed blocks are run again in ``turns``
    (DRAW_TURNS; none for bigS). Then both kernels are held against their
    plain versions at the main path's batch (10 block steps, at most B/64
    replicas diverged, energies within 5 K or, given the load-time energy
    row e_load, bench.energy_bound; the resync of the result) and timed.
    Returns (the states, the numbers of the kernels line and the rate)."""
    from maniac_tpu_torch import replicate, run_block_replicated
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.parallel.replicas import run_block_uniforms
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.kernels.threefry import split_uniform
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain
    from maniac_tpu_torch.physics.energy import (active_site_mask,
                                                 full_amplitudes,
                                                 recip_energy,
                                                 site_positions)
    from maniac_tpu_torch.system import E_RECIP
    Bm, n_steps = MAIN_REPLICAS, MAIN_STEPS
    states = replicate(spec, state, Bm)
    total0 = conserved(states)
    run_block_kernel.launches = 0
    resync_grouped.launches = 0
    split_uniform.launches = 0
    start = states = run_block_replicated(spec, states, n_steps, False,
                                          True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MAIN_BLOCKS):
        states = run_block_replicated(spec, states, n_steps, False, True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"blockg": run_block_kernel.launches,
                "resync": resync_grouped.launches,
                "threefry": split_uniform.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"{tag}: a kernel never launched: {launches}")

    def rerun(ahead):
        """The timed blocks again from ``start``, drawing their uniforms or
        on them drawn ahead: the same decisions; returns the seconds."""
        s, us = start, []
        for _ in range(MAIN_BLOCKS if ahead else 0):
            s, u = draw_uniforms(spec, s, n_steps)
            us.append(u)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(MAIN_BLOCKS):
            s = (run_block_uniforms(spec, s, us[i], False, True) if ahead
                 else run_block_replicated(spec, s, n_steps, False, True))
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        if not (torch.equal(s.n_mol, states.n_mol)
                and torch.equal(s.counters, states.counters)):
            raise AssertionError(f"{tag}: the same blocks walked another "
                                 "chain")
        return t
    # in turns D A A D A D D A (D the main path's run), so that the order
    # and its trends cancel: the difference is what the draw costs the path
    times = {True: [], False: [elapsed]}
    for ahead in turns:
        times[ahead].append(rerun(ahead))
    for k, v in vars(states).items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: non-finite values in {k}")
    n = states.n_mol[:, :spec.R]
    caps = torch.tensor(spec.cap_list, device=n.device)
    if int(n.min()) < 0 or bool((n > caps).any()):
        raise AssertionError(f"{tag}: population outside [0, capacity]")
    if spec.has_reservoir and not torch.equal(conserved(states), total0):
        raise AssertionError(f"{tag}: box + reservoir + drops not conserved")
    ref_re, ref_im = full_amplitudes(
        spec, site_positions(spec, states)[:1],
        active_site_mask(spec, states.n_mol[:1]))
    _amp_check(f"{tag}: replica 0 vs fresh synthesis", states.amp_re[:1],
               states.amp_im[:1], states.energy[:1, E_RECIP], ref_re, ref_im,
               recip_energy(spec, ref_re, ref_im))
    rate = Bm * n_steps * MAIN_BLOCKS / elapsed
    ms_main, bound_main = _main_block(spec, states)
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
    if turns:
        draw_ms = ((sum(times[False]) - sum(times[True])) / len(times[True])
                   / MAIN_BLOCKS * 1e3)
        print(f"{tag}: the same {MAIN_BLOCKS} blocks from the same state in "
              f"turns, drawing their uniforms (D) or on them drawn ahead "
              f"(A), D A A D A D D A, the same decisions: D "
              + ", ".join(f"{t:.4f}" for t in times[False]) + " s; A "
              + ", ".join(f"{t:.4f}" for t in times[True])
              + f" s; the draw costs the path {draw_ms:.3f} ms a block "
                f"({draw_ms * 1e-3 * MAIN_BLOCKS / elapsed:.3%})")
    # both kernels against their plain versions at the main path's batch
    states, u = draw_uniforms(spec, states, 10)
    k_blk = run_block_kernel(spec, states, u)
    err_block, _ = _block_check(
        f"{tag}: block B={Bm} x 10 steps", k_blk,
        steps_plain(spec, states, u), max(1, Bm // 64),
        None if e_load is None else energy_bound(
            e_load, (k_blk.counters[:, 1] - states.counters[:, 1]).sum(1)))
    ms_block = _cuda_ms(lambda: run_block_kernel(spec, states, u), 3)
    ms_block_plain = _cuda_ms(lambda: steps_plain(spec, states, u), 1)
    bound_block = bounds.block_bound(spec, states, k_blk, u)
    k_rs = resync_grouped(spec, k_blk)
    err_resync = max(
        _amp_check(f"{tag}: resync B={Bm} kernel vs plain",
                   *_resync_pair(k_rs, resync_plain(spec, k_blk), E_RECIP)),
        _resync_edges(f"{tag}: resync B={Bm}", spec, k_blk))
    ms_resync = device_ms(lambda: resync_grouped(spec, k_blk), 20)
    ms_resync_host = _cuda_ms(lambda: resync_grouped(spec, k_blk), 10)
    ms_resync_plain = _cuda_ms(lambda: resync_plain(spec, k_blk), 3)
    bound_resync = bounds.resync_bound(spec, k_blk, k_rs)
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
        ms_resync_plain=ms_resync_plain, bound_resync=bound_resync,
        rate=rate, ms_main=ms_main, bound_main=bound_main)



def _row(name, src, replaces, launches, err, ms, plain_ms, bound,
         library_ms=None):
    """One kernel's entry of the kernels line; library_ms is the time of
    the one PyTorch call that computes the same function, where there is
    one."""
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


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


def _k4_phase(tag, system, spec, state, label):
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
    state, u = draw_uniforms(spec, state, CHECK_STEPS)
    st1 = steps_plain(spec, state, u)
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
    bound = bounds.resync_bound(spec, st1, k_one)
    print(f"{tag}: resync B=1: kernel {ms:.4f} ms device-paced, "
          f"{ms_host:.4f} ms host-paced; plain {ms_plain:.3f} ms; bound "
          f"{bound[0]:.6f} ms by {bound[1]} ({label})")
    return _row(f"resync_grouped{f'/{system}' if system else ''}/B1",
                RESYNC_SRC,
                "maniac_tpu/kernels/resync.py:44", launches, err, ms,
                ms_plain, bound)


def _block_check(name, k, p, max_diverged, e_bound=None):
    """Phase-2 bounds on kernel (k) vs plain (p) block outputs: decisions
    (populations, counters, extras, reservoir counts) identical on all but
    max_diverged replicas; on the rest positions and reservoir rows within
    1e-4 A, energies within 5 K, or within e_bound (B, 6) where given (bigS,
    phase 16: bench.energy_bound). Returns (the largest position or
    reservoir-row difference there, the matching replicas' mask)."""
    same = same_decisions(k, p)
    n_div = int((~same).sum())
    if n_div > max_diverged:
        raise AssertionError(f"{name}: {n_div} of {same.numel()} replica(s) "
                             f"diverged (allowed {max_diverged})")
    pos_err, e_err, e_ok = block_errors(k, p, same, e_bound)
    said = ("5" if e_bound is None else
            f"5 + one f32 ulp of the load-time component an accepted step, "
            f"at most {float(e_bound[same].max()):.1f}")
    print(f"{name}: {n_div} of {same.numel()} replica(s) diverged (allowed "
          f"{max_diverged}); matching replicas max|dpos| {pos_err:.3e} A "
          f"(bound 1e-4; positions, COMs, reservoir rows), max|dE| "
          f"{e_err:.3e} K (bound {said}); accepts "
          f"{int(k.counters[:, 1].sum())}")
    if n_div > max_diverged or not pos_err <= 1e-4 or not e_ok:
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
                           device=dev, seed=SEED)


def _step_check(name, k, p, max_diverged):
    """Phase-2 bounds on step-kernel (k) vs plain-core (p) chains, then the
    amplitudes the kernel committed and E_RECIP of the matching replicas
    against the plain steps', with phase 1's bounds; returns max |dA|."""
    from maniac_tpu_torch.system import E_RECIP
    _, same = _block_check(name, k, p, max_diverged)
    return _amp_check(f"{name}: amplitudes", k.amp_re[same], k.amp_im[same],
                      k.energy[same, E_RECIP], p.amp_re[same],
                      p.amp_im[same], p.energy[same, E_RECIP])


def _step_phase(name, spec, states, max_diverged, n_steps, label):
    """Phase 4 on one system: the whole-step kernel (run_steps_kernel)
    against the plain steps (steps_plain) on the same uniforms, one step,
    then an n_steps chain, with phase 2's bounds and, on the matching
    replicas, the committed amplitudes and E_RECIP within phase 1's; the
    kernel must launch once a step and leave its input state as it was.
    Then STEPS_TIMED steps, per step: the kernel device-paced
    (tools/kernel_times.device_ms: queued behind a spin kernel, so the
    host's pace drops out) and host-paced, the plain steps, the device
    activities a step launches and their device time (torch.profiler), and
    the whole step's bound (bounds.steps_bound). Returns (max |dA|, kernel
    ms, plain ms, (bound ms, what bounds it))."""
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain
    B = states.B
    before = {k: v.clone() for k, v in vars(states).items()}
    err = 0.0
    keyed = states    # the uniforms' keys advance here, not in states
    for n in (1, n_steps) if n_steps else (1,):
        keyed, u = draw_uniforms(spec, keyed, n)
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
    _, u = draw_uniforms(spec, keyed, STEPS_TIMED)

    def kernel():
        return run_steps_kernel(spec, states, u)
    bound = bounds.steps_bound(spec, states, kernel(), STEPS_TIMED)
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


def _resv_phase(dev, label):
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
    st, u = draw_uniforms(spec, replicate(spec, rv.state, B), n_check)
    k_blk = run_block_kernel(spec, st, u)
    p_blk = steps_plain(spec, st, u)
    err_block, _ = _block_check(f"phase 7b: reservoir block B={B} x "
                                f"{n_check} steps", k_blk, p_blk, 1)
    for what, out in (("kernel", k_blk), ("plain", p_blk)):
        if not torch.equal(conserved(out), conserved(st)):
            raise AssertionError(f"phase 7c: the {what} block does not "
                                 f"conserve box + reservoir + drops")
    c = k_blk.counters
    print(f"phase 7c: box + reservoir + drops conserved on all {B} "
          f"replicas (kernel and plain): {int(conserved(st)[0])} each; "
          f"pops {int(c[:, 1, 0].sum())}, pushes {int(c[:, 1, 1].sum())}, "
          f"drops {int(k_blk.extras[:, 1].sum())}")

    # d. the resync kernel on that state, its edge replicas, and K4 (B = 1)
    err_resync = max(
        _amp_check(f"phase 7d: resync B={B} kernel vs plain",
                   *_resync_pair(resync_grouped(spec, k_blk),
                                 resync_plain(spec, k_blk), E_RECIP)),
        _resync_edges(f"phase 7d: resync B={B}", spec, k_blk))
    k4 = _k4_phase("phase 7d", "resv", spec, rv.state, label)

    # e. the step kernel against the plain steps; timed at B = 1 (the single
    # chain's shape, phase 7h)
    err_step, _, _, _ = _step_phase("phase 7e: resv", spec, st, 1, n_check,
                                    label)
    _, ms_step, ms_step_plain, bound_step = _step_phase(
        "phase 7e: resv", spec, replicate(spec, rv.state, 1), 0, 0, label)

    # f. the no-split form alone: the same water box without its reservoir
    wb = _load(make_water_box, dev, **RESV_BOX)
    stw, uw = draw_uniforms(wb.spec, replicate(wb.spec, wb.state, B),
                            n_check)
    err_nosplit, _ = _block_check(
        f"phase 7f: no-split block (no reservoir) B={B} x {n_check} steps",
        run_block_kernel(wb.spec, stw, uw), steps_plain(wb.spec, stw, uw), 1)

    # g. the main path, then both kernels held and timed at its batch
    _, main = _main_path("phase 7g: resv", spec, rv.state, label)

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


def _form_phase(tag, system, make, kw, dev, label):
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
    st, u = draw_uniforms(spec, replicate(spec, sysm.state, B), n_check)
    k_blk = run_block_kernel(spec, st, u)
    err_block, _ = _block_check(f"{tag}b: {system} block B={B} x {n_check} "
                                f"steps", k_blk, steps_plain(spec, st, u), 1)
    swaps = k_blk.counters[:, :, 4].sum(0).tolist()
    print(f"{tag}b: swap trials {swaps[0]}, accepted {swaps[1]}")
    if spec.n_active > 1 and swaps[0] < 1:
        raise AssertionError(f"{tag}b: no swap was tried")

    _, main = _main_path(f"{tag}c-d: {system}", spec, sysm.state, label)
    return sysm, _main_rows(system, main, err_block, 0.0)


def _tricl_step_phase(sysm, dev, label):
    """Phase 9 (e)-(f): the step kernel on tricl against the plain steps at
    B=64 and, timed, at B=1 with no divergence allowed; the command line's
    single chain on a tricl deck. Returns its kernels line row."""
    from maniac_tpu_torch import replicate
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.systems import make_triclinic_water

    spec = sysm.spec
    err, _, _, _ = _step_phase("phase 9e: tricl", spec,
                               replicate(spec, sysm.state, CHECK_REPLICAS),
                               1, CHECK_STEPS, label)
    err1, ms, ms_plain, bound = _step_phase(
        "phase 9e: tricl", spec, replicate(spec, sysm.state, 1), 0,
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


def _precision_phase(spec, state, dev, label):
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
    bound = bounds.bound(bounds.tensor_bytes(xt, oht) + M * oh.shape[1] * 4,
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
    st, u1 = draw_uniforms(spec, replicate(spec, state, CHECK_REPLICAS),
                           CHECK_STEPS)
    _, u2 = draw_uniforms(spec, st, CHECK_STEPS)
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
    (the row's time) and host-paced, and K6 and K8 at twice the work; K7
    and the primitives through tools/micro_times, and each primitive's
    exhaustive check against its plain version. Returns their rows."""
    from maniac_tpu_torch.kernels.gpass import gpass, gpass_plain
    from maniac_tpu_torch.kernels.vpu import (CPASS_RTOL, PRIM_DOMAINS,
                                              PRIMS, VPU_OPS, VPU_RTOL,
                                              cpass, cpass_plain, f32_bits,
                                              prim_check, prim_check_plain,
                                              vpu_chain, vpu_chain_plain)
    from maniac_tpu_torch.tools import gpass_bench, micro_times, vpu_bench
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
        bound = bounds.bound(bounds.tensor_bytes(*ins) + 8,
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
        bound = bounds.bound(2 * bounds.tensor_bytes(x),
                             float(n * R * C * OPS_VPU[op]))
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
        bound = bounds.bound(bounds.tensor_bytes(*cins)
                             + bounds.tensor_bytes(cins[0]),
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
    # K7 and the primitives through tools/micro_times
    vpu_chain.launches = prim_check.launches = 0
    rc, out = _tool_main(micro_times.main, ["--kernels", "K7", "--prims"])
    for line in out.splitlines():
        if line.startswith(("K7 ", "prims ")):
            print(f"phase 11: micro_times: {line}")
    if rc != 0 or vpu_chain.launches < 1 or prim_check.launches < 1:
        raise AssertionError("phase 11: micro_times --kernels K7 --prims "
                             "failed")
    # the primitives' exhaustive check
    for name in PRIMS:
        lo, hi = PRIM_DOMAINS[name]
        values = f32_bits(hi) - f32_bits(lo) + 1
        prim_check.launches = 0
        k = prim_check(name, dev)
        launches = prim_check.launches
        p = prim_check_plain(name, device=dev)
        ms = _cuda_ms(lambda: prim_check(name, dev), 3)
        ms_plain = _cuda_ms(lambda: prim_check_plain(name, device=dev), 1)
        bound = bounds.bound(4 * 8, float(values * OPS_PRIM_CHECK[name]))
        print(f"phase 11: prim_check {name} on [{lo.hex()}, {hi.hex()}]: "
              f"{k['mismatches']} mismatches of {k['checked']} values "
              f"(plain: {p['mismatches']} of {p['checked']}); launches "
              f"{launches}; kernel {ms:.3f} ms, plain {ms_plain:.1f} ms, "
              f"bound {bound[0]:.4f} ms by {bound[1]} ({label})")
        if (k["mismatches"] != 0 or k["checked"] != values
                or p["checked"] != values or p["mismatches"] != 0
                or launches != 1):
            raise AssertionError(f"phase 11: prim_check {name} failed")
        rows.append(_row(f"prim_check/{name}", VPU_SRC,
                         "tools/vpu_bench.py:57", launches,
                         float(abs(k["mismatches"] - p["mismatches"])), ms,
                         ms_plain, bound))
    return rows


def _threefry_bound(keys, u):
    """(bound ms, "bytes" or "operations") of one split_uniform call in
    f32: the keys read and written and the uniforms written over the
    memory rate, against its operations (two threefry a replica for the
    split, one a uniform and its conversion): the shifts and logic over
    the ALU's rate, or all of them over the issue rate, the larger."""
    B, n = keys.shape[0], u[0].numel()
    assert u.dtype == torch.float32
    fry, vals = 2 * B + B * n, B * n
    alu = fry * THREEFRY_ALU_OPS + vals * TO_UNIFORM_F32_ALU_OPS
    issued = (fry * (THREEFRY_ALU_OPS + THREEFRY_ADDS)
              + vals * (TO_UNIFORM_F32_ALU_OPS + TO_UNIFORM_F32_FLOAT_OPS))
    ms_bytes = (bounds.tensor_bytes(keys, keys, u) / bounds.HBM_BYTES_PER_S
                * 1e3)
    ms_ops = max(alu / ALU_OPS_PER_S, issued / DISPATCH_OPS_PER_S) * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                           "operations")


def _threefry_phase(keys, label, tags=("phase 13a", "phase 13b")):
    """Phase 13 (a)-(b): the threefry kernel against its plain version on
    the main path's keys (``keys``, B = 1024, with edge keys of all-zero
    and all-one words in rows 0-2) at (B, 400, 21) f32 and on their first
    64 at (64, 400, 21) f64: the next keys and every uniform with the same
    bits (0 mismatches); then timed device-paced beside torch.rand of the
    same shape on the card (another function: the stream the main path
    drew from before, a reference only) and the bound. Returns (max |d|,
    kernel ms, plain ms, bound). ``tags`` head the check's and the time's
    lines."""
    from maniac_tpu_torch.kernels.threefry import (split_uniform,
                                                   split_uniform_plain)
    keys = keys.clone()
    keys[0] = 0
    keys[1] = 0xFFFFFFFF
    keys[2, 0] = 0xFFFFFFFF
    err = 0.0
    for dtype, k in ((torch.float32, keys),
                     (torch.float64, keys[:THREEFRY_F64_REPLICAS])):
        new, u = split_uniform(k, MAIN_STEPS, dtype)
        want_new, want_u = split_uniform_plain(k, MAIN_STEPS, dtype)
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        mismatches = (int((new != want_new).sum())
                      + int((u.view(bits) != want_u.view(bits)).sum()))
        err = max(err, float((u - want_u).abs().max()))
        print(f"{tags[0]}: threefry {tuple(u.shape)} {dtype}: {mismatches} "
              f"mismatches of {new.numel() + u.numel()} keys and uniforms "
              f"against the plain version (bound 0)")
        if mismatches or tuple(u.shape) != (k.shape[0], MAIN_STEPS,
                                            bounds.N_UNIFORMS):
            raise AssertionError(f"{tags[0]}: the threefry kernel disagrees "
                                 "with its plain version")
    shape = (keys.shape[0], MAIN_STEPS, bounds.N_UNIFORMS)
    ms = device_ms(lambda: split_uniform(keys, MAIN_STEPS, torch.float32),
                   50)
    ms_rand = device_ms(lambda: torch.rand(shape, device=keys.device), 50)
    ms_plain = _cuda_ms(lambda: split_uniform_plain(keys, MAIN_STEPS,
                                                    torch.float32), 3)
    bound = _threefry_bound(keys, split_uniform(keys, MAIN_STEPS,
                                                torch.float32)[1])
    print(f"{tags[1]}: threefry {shape} f32: kernel {ms:.4f} ms "
          f"device-paced; torch.rand of the same shape {ms_rand:.4f} ms "
          f"device-paced (a reference: another function); plain "
          f"{ms_plain:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
          f"({label})")
    return err, ms, ms_plain, bound


def _table_phase(dev, label):
    """Phase 13 (c): tests/test_tabulated.py's GCMC water box with
    use_table on the card, f64, B = TABLE_REPLICAS, TABLE_BLOCKS blocks of
    TABLE_STEPS steps from the keys of SEED: dispatch_report names the
    tabulated potentials, every replica's bookkeeping is within
    TABLE_DRIFT_K of a recompute, and the energies equal the same seed's
    run on the CPU within TABLE_RTOL relative (decisions equal)."""
    from maniac_tpu_torch import load_system, replicate, run_block_replicated
    from maniac_tpu_torch.kernels import dispatch_report
    from maniac_tpu_torch.mc.driver import drift_report
    from maniac_tpu_torch.systems import make_water_box
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_water_box(tmp, **TABLE_BOX)
        for where in (dev, "cpu"):
            sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                               f"{tmp}/parameters.inc", dtype=torch.float64,
                               device=where, seed=SEED)
            spec = sysm.spec
            states = replicate(spec, sysm.state, TABLE_REPLICAS)
            t0 = time.perf_counter()
            for _ in range(TABLE_BLOCKS):
                states = run_block_replicated(spec, states, TABLE_STEPS, True)
            sec = time.perf_counter() - t0
            runs[torch.device(where).type] = (spec, states, sec)
    spec, card, sec = runs["cuda"]
    _, cpu, sec_cpu = runs["cpu"]
    report = dispatch_report(spec, dev)
    drift = max(drift_report(spec, card, b)["drift_K"]
                for b in range(TABLE_REPLICAS))
    e_card, e_cpu = card.energy.cpu(), cpu.energy
    rel = float(((e_card - e_cpu).abs()
                 / e_cpu.abs().clamp(min=1.0)).max())
    same = (torch.equal(card.n_mol.cpu(), cpu.n_mol)
            and torch.equal(card.counters.cpu(), cpu.counters))
    print(f"phase 13c: tabulated water box f64 B={TABLE_REPLICAS} x "
          f"{TABLE_BLOCKS} blocks of {TABLE_STEPS} steps: {sec:.2f} s on "
          f"the card, {sec_cpu:.2f} s on the CPU; {report}; max drift "
          f"{drift:.3e} K (bound {TABLE_DRIFT_K}); energies against the "
          f"CPU's max relative {rel:.3e} (bound {TABLE_RTOL}); decisions "
          f"the same: {same}; accepts {int(card.counters[:, 1].sum())} "
          f"({label})")
    if ("tabulated potentials" not in report or not drift <= TABLE_DRIFT_K
            or not rel <= TABLE_RTOL or not same):
        raise AssertionError("phase 13c: the tabulated run failed its "
                             "checks")


def _chain_options_phase(label):
    """Phase 12: the command line's single chain on the flagship deck with
    --widom, and with --checkpoint then --resume; each run's step-kernel
    launches."""
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.systems import make_zif_like
    with tempfile.TemporaryDirectory() as tmp:
        d = f"{tmp}/chain"
        make_zif_like(d, n_cells=6, a=5.66, n_water=32, fugacity=30.0,
                      nb_block=CHAIN_BLOCKS, nb_step=MAIN_STEPS)
        deck, one = f"{d}/input.maniac", f"{tmp}/one.maniac"
        with open(deck) as f:
            text = f.read()
        with open(one, "w") as f:
            f.write(text.replace(f"nb_block {CHAIN_BLOCKS}\n",
                                 "nb_block 1\n"))
        ck = f"{tmp}/ck.npz"
        base = ["-d", f"{d}/topology.data", "-p", f"{d}/parameters.inc",
                "--capacity", str(CAPACITY), "--seed", str(SEED)]
        energy = {}
        for tag, dk, extra, blocks in (
                ("plain", deck, [], CHAIN_BLOCKS),
                ("widom", deck, ["--widom", str(WIDOM_TRIALS)], CHAIN_BLOCKS),
                ("checkpoint", one, ["--checkpoint", ck], 1),
                ("resume", deck, ["--resume", ck], CHAIN_BLOCKS - 1)):
            run_steps_kernel.launches = 0
            rc, sec, log = _cli(["-i", dk] + base + extra, f"{tmp}/{tag}")
            launches = run_steps_kernel.launches
            with open(f"{tmp}/{tag}/energy.dat") as f:
                energy[tag] = f.read()
            print(f"phase 12: {tag}: exit {rc} in {sec:.2f} s, step kernel "
                  f"launches {launches} ({label})")
            if (rc != 0 or "Simulation Completed" not in log
                    or launches != blocks * MAIN_STEPS
                    or (tag == "resume" and "Resumed" not in log)):
                raise AssertionError(f"phase 12: the {tag} run failed")
        widom = _rows(f"{tmp}/widom/widom.dat")
        print(f"phase 12: widom.dat rows {widom}")
        plain, resumed = ([r for r in energy[t].splitlines()
                           if not r.startswith("#")]
                          for t in ("plain", "resume"))
        print(f"phase 12: energy.dat with --widom the same text: "
              f"{energy['widom'] == energy['plain']}; resumed rows "
              f"{resumed[1:]} against {plain[CHAIN_BLOCKS:]}")
        if (energy["widom"] != energy["plain"] or len(widom) != CHAIN_BLOCKS
                or not all(math.isfinite(float(v)) for r in widom
                           for v in r[1:])
                or not all(float(r[1]) >= 0 for r in widom)
                or not float(widom[-1][2]) > 0):
            raise AssertionError("phase 12: --widom perturbed the chain or "
                                 "wrote no finite factors")
        if ([r.split()[0] for r in resumed] != ["0", str(CHAIN_BLOCKS)]
                or resumed[1:] != plain[CHAIN_BLOCKS:]):
            raise AssertionError("phase 12: the resumed block differs from "
                                 "the uninterrupted run's")


def _deck_files(deck):
    """The three files of a deck directory."""
    return (f"{deck}/input.maniac", f"{deck}/topology.data",
            f"{deck}/parameters.inc")


def _load_flagship(files, dev):
    """load_system on the flagship files as the launcher loads them (f32,
    capacity CAPACITY, seed SEED, quiet)."""
    from maniac_tpu_torch import load_system
    from maniac_tpu_torch.utils.logger import NullLogger
    return load_system(*files, capacity=CAPACITY, dtype=torch.float32,
                       device=dev, logger=NullLogger(), seed=SEED)


def _mesh_kernel_checks(mesh, spec, states):
    """Phase 14c, in rank 0: K2 against its plain version on
    MESH_CHECK_REPLICAS of the rank's replicas for CHECK_STEPS steps
    (phase 2's bounds), then one run_block_sharded(..., resync=True) block,
    which must launch K1 once, held against a fresh plain synthesis of
    its positions (phase 1's bounds). Returns the lines to print."""
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain
    from maniac_tpu_torch.parallel.mesh import run_block_sharded
    from maniac_tpu_torch.system import E_RECIP, SimState
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        few = SimState(**{k: v[:MESH_CHECK_REPLICAS]
                          for k, v in vars(states).items()})
        few, u = draw_uniforms(spec, few, CHECK_STEPS)
        _block_check(f"phase 14c: rank 0 block B={MESH_CHECK_REPLICAS} x "
                     f"{CHECK_STEPS} steps", run_block_kernel(spec, few, u),
                     steps_plain(spec, few, u), 1)
        n_rs = resync_grouped.launches
        rs = run_block_sharded(mesh, spec, states, MAIN_STEPS, True,
                               resync=True)
        if resync_grouped.launches != n_rs + 1:
            raise AssertionError("phase 14c: the resync block launched K1 "
                                 f"{resync_grouped.launches - n_rs} times")
        _amp_check(f"phase 14c: rank 0 resync block B={rs.B}, K1 vs a "
                   f"fresh plain synthesis",
                   *_resync_pair(rs, resync_plain(spec, rs), E_RECIP))
    return out.getvalue().splitlines()


def _mesh_rank(rank, world, init, deck, out) -> int:
    """One rank of phase 14b (``chip_smoke.py --mesh-rank``): gloo on
    cuda:0, the flagship at MAIN_REPLICAS global replicas, MESH_BLOCKS
    blocks of MAIN_STEPS steps through the mesh with the launch counts set
    to 0 just before, each block's statistics line; then rank 0's kernel
    checks (phase 14c). Saves the lines, the launches, the dispatch and
    the final state to out/rank<rank>.pt."""
    import torch.distributed as dist
    from maniac_tpu_torch.kernels import dispatch_report
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped
    from maniac_tpu_torch.kernels.threefry import split_uniform
    from maniac_tpu_torch.parallel.mesh import (INIT_TIMEOUT,
                                                gather_replica_stats,
                                                make_mesh, replicate_spec,
                                                run_block_sharded,
                                                shard_replicas)
    from maniac_tpu_torch.system import E_TOT
    from maniac_tpu_torch.tools.launch_multihost import block_line
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=INIT_TIMEOUT)
    try:
        mesh = make_mesh(world, device="cuda:0")
        sysm = _load_flagship(_deck_files(deck), mesh.device)
        spec = replicate_spec(mesh, sysm.spec)
        states = shard_replicas(mesh, spec, sysm.state, MAIN_REPLICAS)
        for fn in (run_block_kernel, split_uniform, resync_grouped):
            fn.launches = 0
        lines = []
        for b in range(1, MESH_BLOCKS + 1):
            states = run_block_sharded(mesh, spec, states, MAIN_STEPS, True)
            lines.append(block_line(b, *gather_replica_stats(
                states, spec.R, E_TOT, mesh=mesh)))
        torch.cuda.synchronize()
        result = {
            "lines": lines, "span": mesh.span(MAIN_REPLICAS),
            "dispatch": dispatch_report(spec, mesh.device),
            "launches": {"blockg": run_block_kernel.launches,
                         "threefry": split_uniform.launches,
                         "resync": resync_grouped.launches},
            "state": {f: getattr(states, f).cpu() for f in MESH_FIELDS}}
        if rank == 0:
            result["checks"] = _mesh_kernel_checks(mesh, spec, states)
        torch.save(result, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def _mesh_phase(label):
    """Phase 14, the mesh on the card. (a) The launcher at a world of 1
    over NCCL (a subprocess: this process keeps no process group), the
    flagship at B = MAIN_REPLICAS, MESH_BLOCKS blocks of MAIN_STEPS steps:
    its block lines the same text as a single-process run_block_replicated
    + gather_replica_stats here, its rate beside the single process's in
    turns (P S S P). (b) Two gloo ranks sharing cuda:0 (_mesh_rank), while
    two NCCL ranks on the one card show that NCCL refuses them: each gloo
    rank's final state bit for bit its replicas of (a)'s single-process
    run, its block lines the same text. (c) Rank 0's kernel checks. (d) K2
    and T launched in every rank; a rank's failure or timeout fails the
    phase."""
    from concurrent.futures import ThreadPoolExecutor

    from maniac_tpu_torch import replicate, run_block_replicated
    from maniac_tpu_torch.parallel.mesh import gather_replica_stats, run_ranks
    from maniac_tpu_torch.system import E_TOT
    from maniac_tpu_torch.systems import make_zif_like
    from maniac_tpu_torch.tools.launch_multihost import block_line
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + ([path] if path else [])))
    launcher = [sys.executable, "-m",
                "maniac_tpu_torch.tools.launch_multihost"]
    with tempfile.TemporaryDirectory() as tmp:
        deck = f"{tmp}/deck"
        make_zif_like(deck, n_cells=6, a=5.66, n_water=32, fugacity=30.0)
        files = _deck_files(deck)
        run = ["-i", files[0], "-d", files[1], "-p", files[2], "--blocks",
               str(MESH_BLOCKS), "--steps", str(MAIN_STEPS), "--capacity", str(CAPACITY),
               "--seed", str(SEED)]

        def single():
            """The single process: (final states, block lines, rate)."""
            sysm = _load_flagship(files, torch.device("cuda", 0))
            spec = sysm.spec
            states = replicate(spec, sysm.state, MAIN_REPLICAS)
            lines = []
            for b in range(1, MESH_BLOCKS + 1):
                if b == MESH_WARMUP + 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                states = run_block_replicated(spec, states, MAIN_STEPS, True)
                lines.append(block_line(b, *gather_replica_stats(
                    states, spec.R, E_TOT)))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return (states, lines, (MESH_BLOCKS - MESH_WARMUP) * MAIN_STEPS
                    * MAIN_REPLICAS / dt)

        def launched(i, group):
            """The launcher on one card: at a world of 1 over NCCL (group)
            or with no process group (no collective at all). Returns (block
            lines, rate, its output)."""
            argv = launcher + (["--coordinator", f"file://{tmp}/a{i}",
                                "--process-id", "0"] if group else []) + [
                "--num-processes", "1", "--replicas-per-device",
                str(MAIN_REPLICAS), *run]
            [(rc, out)] = run_ranks([argv], MESH_TIMEOUT, env=env, cwd=root)
            if rc != 0:
                raise AssertionError(f"phase 14a: the launcher exit {rc}:\n"
                                     f"{out}")
            rate = float(re.search(r"# ([0-9.]+) M aggregate", out)[1])
            return ([ln for ln in out.splitlines()
                     if ln.startswith("block")], rate * 1e6, out)

        # in turns P S N N S P: the single process (P), the launcher over
        # NCCL (S) and without a process group (N)
        t_phase = time.perf_counter()
        ref, ref_lines, p1 = single()
        s1_lines, s1, s1_out = launched(1, True)
        n1_lines, n1, _ = launched(2, False)
        n2_lines, n2, _ = launched(3, False)
        s2_lines, s2, _ = launched(4, True)
        _, p2_lines, p2 = single()
        for line in s1_out.splitlines():
            if line.startswith("#"):
                print(f"phase 14a: launcher: {line}")
        for line in ref_lines:
            print(f"phase 14a: single process: {line}")
        same = (s1_lines == s2_lines == n1_lines == n2_lines == p2_lines
                == ref_lines)
        print(f"phase 14a: NCCL world of 1, the launcher's block lines the "
              f"same text as the single process's (and without a group): "
              f"{same}")
        print(f"phase 14a: in turns P S N N S P, B={MAIN_REPLICAS} x "
              f"{MAIN_STEPS} steps x {MESH_BLOCKS - MESH_WARMUP} blocks: "
              f"single process {p1 / 1e6:.4f}, {p2 / 1e6:.4f}; launcher "
              f"over NCCL (world 1) {s1 / 1e6:.3f}, {s2 / 1e6:.3f}; "
              f"launcher without a group {n1 / 1e6:.3f}, {n2 / 1e6:.3f} M MC "
              f"steps/s ({label})")
        launches = re.search(r"launches: blockg (\d+), threefry (\d+)",
                             s1_out).groups()
        if not same or launches != (str(MESH_BLOCKS),) * 2:
            raise AssertionError(f"phase 14a: the launcher's lines differ "
                                 f"or its kernels did not launch "
                                 f"({launches})")

        # (b)-(d): two gloo ranks on cuda:0; two NCCL ranks on it beside
        gloo = [[sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 str(r), str(MESH_RANKS), f"file://{tmp}/b", deck, tmp]
                for r in range(MESH_RANKS)]
        nccl = [launcher + ["--coordinator", f"file://{tmp}/nccl",
                            "--num-processes", str(MESH_RANKS),
                            "--process-id", str(r), "--replicas-per-device",
                            str(MAIN_REPLICAS // MESH_RANKS), *run[:6],
                            "--blocks", "1", "--steps", "10"]
                for r in range(MESH_RANKS)]
        with ThreadPoolExecutor(2) as pool:
            refused = pool.submit(run_ranks, nccl, MESH_TIMEOUT,
                                  dict(env, NCCL_DEBUG="WARN"), root)
            ranks = pool.submit(run_ranks, gloo, MESH_TIMEOUT, env,
                                root).result()
            refused = refused.result()
        said = ([ln.strip() for _, out in refused
                 for ln in out.splitlines()
                 if "Duplicate GPU" in ln]
                + [ln.strip() for _, out in refused
                   for ln in out.splitlines() if "NCCL" in ln]
                + [out.strip().splitlines()[-1] for _, out in refused
                   if out.strip()] + ["no output"])
        print(f"phase 14b: NCCL with {MESH_RANKS} ranks on one card: exit "
              f"codes {[rc for rc, _ in refused]}; {said[0][:300]}")
        for r, (rc, out) in enumerate(ranks):
            if rc != 0:
                raise AssertionError(f"phase 14b: gloo rank {r} exit {rc}:"
                                     f"\n{out}")
        for r in range(MESH_RANKS):
            got = torch.load(f"{tmp}/rank{r}.pt")
            lo, hi = got["span"]
            equal = {f: torch.equal(got["state"][f],
                                    getattr(ref, f)[lo:hi].cpu())
                     for f in MESH_FIELDS}
            print(f"phase 14b: gloo rank {r} of {MESH_RANKS} on cuda:0, "
                  f"replicas [{lo}, {hi}): bit-equal to the single "
                  f"process's {equal}; block lines the same text: "
                  f"{got['lines'] == ref_lines}; launches "
                  f"{got['launches']}; {got['dispatch']}")
            for line in got.get("checks", []):
                print(line)
            if (not all(equal.values()) or got["lines"] != ref_lines
                    or got["launches"]["blockg"] != MESH_BLOCKS
                    or got["launches"]["threefry"] != MESH_BLOCKS
                    or "CUDA whole-block kernel" not in got["dispatch"]):
                raise AssertionError(f"phase 14b: rank {r} differs from "
                                     "the single process or skipped a "
                                     "kernel")
        print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


def _envelope_phase(label):
    """Phase 15a: the f32 per-move dE envelope on the card, three ways
    (ENVELOPE_PATHS: K3 one launch a step, K2 as one-step blocks, the plain
    f32 step), each accepted move's dE against an f64 recompute on the
    card. Returns {path: report}."""
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.tools.delta_e_report import measure
    reports = {}
    for path in ENVELOPE_PATHS:
        run_steps_kernel.launches = 0
        run_block_kernel.launches = 0
        t0 = time.perf_counter()
        rep = measure(ENVELOPE_STEPS, ENVELOPE_SEED, False, "cuda",
                      ENVELOPE_REPLICAS, path)
        sec = time.perf_counter() - t0
        launches = {"stepg": run_steps_kernel.launches,
                    "blockg": run_block_kernel.launches}
        print(f"phase 15a: {path}: {rep['accepted_moves']} accepted moves of "
              f"{ENVELOPE_REPLICAS} x {ENVELOPE_STEPS}, |dE_f32 - dE_f64| "
              f"max {rep['max_abs_dE_err_kcalmol']:.3e} mean "
              f"{rep['mean_abs_dE_err_kcalmol']:.3e} p99 "
              f"{rep['p99_abs_dE_err_kcalmol']:.3e} kcal/mol in {sec:.1f} s; "
              f"launches {launches} ({label})")
        want = {"step": {"stepg": ENVELOPE_STEPS, "blockg": 0},
                "block": {"stepg": 0, "blockg": ENVELOPE_STEPS},
                "plain": {"stepg": 0, "blockg": 0}}[path]
        if (launches != want or rep["accepted_moves"] <= 20
                or not rep["max_abs_dE_err_kcalmol"] < ENVELOPE_MAX
                or not rep["mean_abs_dE_err_kcalmol"] < ENVELOPE_MEAN):
            raise AssertionError(f"phase 15a: the {path} envelope failed "
                                 f"its checks: {rep}, launches {launches}")
        reports[path] = rep
    print(f"phase 15a: {rep['dispatch']}")
    if ("block: CUDA whole-block kernel" not in rep["dispatch"]
            or "step: CUDA per-step kernel" not in rep["dispatch"]
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("phase 15a: the dispatch does not name K2 and "
                             "K3, or TF32 is on beside the f64 spec")
    return reports


def _virial_phase(label):
    """Phase 15b: the virial anchor (maniac_tpu_torch/virial.py) on K2 in
    f32 with the resync (K1): the occupancy, then Widom
    (widom_block_replicated on the card) from the same equilibrated
    state."""
    from maniac_tpu_torch import virial
    from maniac_tpu_torch.kernels import use_block_kernel
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped
    from maniac_tpu_torch.kernels.threefry import split_uniform
    from maniac_tpu_torch.systems import make_lj_gas
    with tempfile.TemporaryDirectory() as tmp:
        make_lj_gas(tmp, **virial.lj_gas_kwargs())
        spec, state = virial.load(tmp, torch.float32, "cuda")
    if not use_block_kernel(spec, "cuda"):
        raise AssertionError("phase 15b: the LJ gas is not on the block "
                             "kernel")
    for k in (run_block_kernel, resync_grouped, split_uniform):
        k.launches = 0
    t0 = time.perf_counter()
    eq = virial.equilibrate(spec, state, resync=True)
    occ = virial.occupancy(spec, eq, resync=True)
    wid = virial.widom(spec, eq, resync=True)
    torch.cuda.synchronize()
    blocks = (virial.EQ_BLOCKS + virial.OCCUPANCY_BLOCKS
              + virial.WIDOM_BLOCKS)
    launches = {"blockg": run_block_kernel.launches,
                "resync": resync_grouped.launches,
                "threefry": split_uniform.launches}
    print(f"phase 15b: virial anchor B={virial.REPLICAS}, {blocks} blocks "
          f"of {virial.STEPS} steps in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches} ({label})")
    print(f"phase 15b: <N> = {occ['n']:.3f} +- {occ['sem']:.3f}, virial "
          f"{occ['n_virial']:.3f}, ideal {occ['n_ideal']:.3f}: matches "
          f"{occ['matches']}, B2 shift resolved {occ['resolved']}")
    print(f"phase 15b: Widom B = {wid['B']:.4f} +- {wid['sem']:.4f}, virial "
          f"{wid['B_virial']:.4f}: matches {wid['matches']}, mu_ex != 0 "
          f"resolved {wid['resolved']}")
    if (not (occ["matches"] and occ["resolved"] and wid["matches"]
             and wid["resolved"])
            or launches != {"blockg": blocks, "resync": blocks,
                            "threefry": blocks}):
        raise AssertionError("phase 15b: the virial anchor failed on the "
                             "card")
    return occ, wid


def _sentinel_tally(log):
    """(checked blocks, divergences) from a log's sentinel summary."""
    m = re.search(r"sentinel: (\d+) cross-checked blocks, (\d+) "
                  r"divergences", log)
    if m is None:
        raise AssertionError("no sentinel summary in the log")
    return int(m.group(1)), int(m.group(2))


def _examples_phase(label):
    """Phase 15c: every case of tools/run_examples.py through the command
    line on the card with --sentinel 1, the isotherm, then the flagship
    deck with --replicas 1024 --sentinel 1; the sentinel's tally under the
    command line's rule. Returns (checked, divergences)."""
    from maniac_tpu_torch.cli import SENTINEL_BENIGN_RATE
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped
    from maniac_tpu_torch.kernels.stepg import run_steps_kernel
    from maniac_tpu_torch.systems import make_zif_like
    from maniac_tpu_torch.tools import run_examples
    checked = diverged = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, (_, kw, _) in run_examples.CASES.items():
            d = f"{tmp}/{name}"
            argv = run_examples.case_argv(name, d, ["--sentinel", "1"])
            run_steps_kernel.launches = 0
            run_block_kernel.launches = 0
            rc, sec, log = _cli(argv, f"{d}/outputs")
            steps = kw["nb_block"] * kw["nb_step"]
            on_k3 = "step: CUDA per-step kernel" in log
            n, k = _sentinel_tally(log)
            checked, diverged = checked + n, diverged + k
            took = ("K3 (csrc/stepg.cu)" if on_k3 else "the plain torch "
                    "step")
            print(f"phase 15c: {name}: exit {rc} in {sec:.1f} s, {steps} "
                  f"steps on {took}, step kernel launches "
                  f"{run_steps_kernel.launches}; sentinel {n} blocks, {k} "
                  f"divergences ({label})")
            print(f"phase 15c: {name}: "
                  f"{run_examples.dispatch_line(d)}")
            if (not run_examples.case_passed(rc, d)
                    or run_steps_kernel.launches != (steps if on_k3 else 0)
                    or run_block_kernel.launches != 0
                    or n != kw["nb_block"] or "SENTINEL:" in log):
                raise AssertionError(f"phase 15c: the {name} case failed "
                                     f"its checks")
        run_steps_kernel.launches = 0
        t0 = time.perf_counter()
        means = run_examples.isotherm("cuda")
        print(f"phase 15c: isotherm <N> {means} in "
              f"{time.perf_counter() - t0:.1f} s, step kernel launches "
              f"{run_steps_kernel.launches} ({label})")
        if (run_steps_kernel.launches != 2000 + 10 * 200
                or not all(0.0 <= m <= 64.0 for m in means)):
            raise AssertionError("phase 15c: the isotherm failed its checks")

        d = f"{tmp}/flagship"
        make_zif_like(d, n_cells=6, a=5.66, n_water=32, fugacity=30.0,
                      nb_block=FLAGSHIP_SENTINEL_BLOCKS, nb_step=MAIN_STEPS)
        run_block_kernel.launches = 0
        resync_grouped.launches = 0
        rc, sec, log = _cli([
            "-i", f"{d}/input.maniac", "-d", f"{d}/topology.data", "-p",
            f"{d}/parameters.inc", "--capacity", str(CAPACITY), "--replicas", str(MAIN_REPLICAS),
            "--sentinel", "1", "--seed", str(SEED)], f"{d}/outputs")
        n, k = _sentinel_tally(log)
        checked, diverged = checked + n, diverged + k
        print(f"phase 15c: flagship --replicas {MAIN_REPLICAS} --sentinel 1: "
              f"exit {rc} in {sec:.1f} s, launches blockg "
              f"{run_block_kernel.launches} resync "
              f"{resync_grouped.launches}; sentinel {n} blocks, {k} "
              f"divergences ({label})")
        if (rc != 0 or "Simulation Completed" not in log
                or n != FLAGSHIP_SENTINEL_BLOCKS or "SENTINEL:" in log
                or run_block_kernel.launches != FLAGSHIP_SENTINEL_BLOCKS
                or resync_grouped.launches < FLAGSHIP_SENTINEL_BLOCKS):
            raise AssertionError("phase 15c: the flagship sentinel run "
                                 "failed its checks")
    expected = checked * SENTINEL_BENIGN_RATE
    print(f"phase 15c: sentinel total {checked} cross-checked blocks, "
          f"{diverged} divergences (rate {diverged / checked:.4f}; the "
          f"command line's rule allows {max(2.0, 4.0 * expected):.2f}) "
          f"({label})")
    if diverged > max(2.0, 4.0 * expected):
        raise AssertionError("phase 15c: systematic kernel/plain "
                             "divergence under the sentinel")
    return checked, diverged



def _bigs_phase(dev, label):
    """Phase 16 (a)-(c): bench.py's bigS at each of BIGS_CAPACITIES on the
    card: the load timed and its dispatch (the block and resync kernels);
    the block kernel against the plain steps (bench.kernel_check:
    BIGS_CHECK_REPLICAS replicas x CHECK_STEPS steps, at most one diverged,
    positions within 1e-4 A, energies within bench.energy_bound) and the
    resync kernel on its result and edge replicas (phase 1's bounds); the
    main path (_main_path, with bench.energy_bound, no reruns). Returns the
    kernels line's rows (bigS at the bench's capacity, bigS/cap5000)."""
    from maniac_tpu_torch import bench, replicate
    from maniac_tpu_torch.kernels import dispatch_report
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.system import E_RECIP
    rows = []
    for cap in BIGS_CAPACITIES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sysm = bench.load("bigS", dev, cap)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        spec, e_load = sysm.spec, sysm.state.energy[0]
        report = dispatch_report(spec, dev)
        tag = f"bigS capacity {cap}"
        print(f"phase 16a: {tag}: S={spec.S} K={spec.K} kmax="
              f"{spec.kmax_xyz} fw_split={spec.fw_split} far table rows "
              f"{spec.far_rows.shape[0]} N={int(sysm.state.n_mol[0, 0])}; "
              f"load {sec:.1f} s; load-time energy {e_load.tolist()}; "
              f"{report}")
        if ("block: CUDA whole-block kernel" not in report
                or "resync: CUDA resync kernel" not in report):
            raise AssertionError(f"phase 16a: {tag} is not dispatched to the "
                                 f"block and resync kernels")
        detail, err_block, k = bench.kernel_check(
            spec, replicate(spec, sysm.state, BIGS_CHECK_REPLICAS), e_load)
        print(f"phase 16b: {tag}: block kernel vs plain {detail}")
        err_resync = max(
            _amp_check(f"phase 16b: {tag}: resync B={k.B} kernel vs plain",
                       *_resync_pair(resync_grouped(spec, k),
                                     resync_plain(spec, k), E_RECIP)),
            _resync_edges(f"phase 16b: {tag}: resync B={k.B}", spec, k))
        states, main = _main_path(f"phase 16c: {tag}", spec, sysm.state,
                                  label, turns=(), e_load=e_load)
        if cap != bench.default_capacity("bigS"):
            rows += _main_rows(f"bigS/cap{cap}", main, err_block, err_resync)
            continue
        rows += _main_rows("bigS", main, err_block, err_resync)
        # the threefry kernel on bigS's main-path keys (its work does not
        # depend on the system: one row, at the bench's capacity)
        err_tf, ms_tf, ms_tf_plain, bound_tf = _threefry_phase(
            states.key, label, (f"phase 16c: {tag}",) * 2)
        rows.append(_row("threefry/bigS", THREEFRY_SRC,
                         "none: jax.random threefry, an XLA op "
                         "(maniac_tpu/mc/driver.py:69)",
                         main["launches"]["threefry"], err_tf, ms_tf,
                         ms_tf_plain, bound_tf))
    return rows


def _canary_phase(label):
    """Phase 16d: the f64 canary through bench.run (zif, CANARY_REPLICAS x
    CANARY_STEPS steps x CANARY_BLOCKS blocks, no hardware-precision
    check): the dispatch names the plain path for the block, the steps and
    the resync, and the timed blocks launch the threefry kernel once a block
    and no other kernel."""
    from maniac_tpu_torch import bench
    log = io.StringIO()
    r = bench.run("zif", "cuda", CANARY_REPLICAS, CANARY_STEPS, CANARY_BLOCKS,
                  dtype="f64", hwcheck=False, log=log)
    for line in log.getvalue().splitlines():
        print(f"phase 16d: {line}")
    print(f"phase 16d: f64 canary B={CANARY_REPLICAS} x {CANARY_STEPS} steps "
          f"x {CANARY_BLOCKS} block: {r['value']:.1f} MC steps/s; launches "
          f"{r['launches']}; {r['dispatch']} ({label})")
    want = {"threefry": CANARY_BLOCKS, "blockg": 0, "resync": 0, "stepg": 0}
    if ("CUDA" in r["dispatch"] or "plain torch path" not in r["dispatch"]
            or r["launches"] != want or r["state_check"] != "pass"):
        raise AssertionError("phase 16d: the f64 canary left the plain path "
                             "or skipped the threefry kernel")


def _bench_phase(rate3, label):
    """Phase 16e: python -m maniac_tpu_torch.bench at its defaults (zif) in
    a subprocess: exit 0, its last line a JSON object with the metric, its
    checks passed, its rate within BENCH_RATE_RTOL of phase 3's (rate3)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MANIAC_BENCH_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "maniac_tpu_torch.bench"],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    sec = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("#"):
            print(f"phase 16e: bench: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 16e: the bench exit {proc.returncode}:"
                             f"\n{proc.stderr[-4000:]}")
    r = json.loads(_last(proc.stdout))
    ratio = r["value"] / rate3
    print(f"phase 16e: python -m maniac_tpu_torch.bench exit 0 in {sec:.1f} "
          f"s: {r['metric']} {r['value']:.0f} {r['unit']} (phase 3 "
          f"{rate3:.0f}: ratio {ratio:.4f}, within {BENCH_RATE_RTOL:g}); "
          f"hw_precision {r['hw_precision']}, kernel_check "
          f"{r['kernel_check']}; device {r['device']} ({label})")
    if (r["metric"] != "port_mc_steps_per_sec_zif8_h2o"
            or r["hw_precision"] != "pass" or r["kernel_check"] != "pass"
            or not abs(ratio - 1.0) <= BENCH_RATE_RTOL):
        raise AssertionError("phase 16e: the bench's line failed its checks")


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
                           dtype=torch.float32, device=dev, seed=SEED)
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

    # ---- phase 1: resync kernel vs plain -----------------------------------
    B, n_check = CHECK_REPLICAS, CHECK_STEPS
    states, u = draw_uniforms(spec, replicate(spec, sysm.state, B), n_check)
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
    st0, u = draw_uniforms(spec, p_out, n_check)
    k_blk = run_block_kernel(spec, st0, u)
    p_blk = steps_plain(spec, st0, u)
    err_blk2, _ = _block_check(f"phase 2: block B={B} x {n_check} steps",
                               k_blk, p_blk, 1)
    ms_blk = _cuda_ms(lambda: run_block_kernel(spec, st0, u), 3)
    ms_blk_plain = _cuda_ms(lambda: steps_plain(spec, st0, u), 1)
    print(f"phase 2: block kernel {ms_blk:.3f} ms, plain "
          f"{ms_blk_plain:.3f} ms ({name}, {smi})")

    # ---- phase 3: the main path ------------------------------------------
    states, main = _main_path("phase 3: flagship", spec, sysm.state,
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
        err, _, _, _ = _step_phase(f"phase 4: {sname}", sp, st, 1,
                                   n_check, label)
        err_step = max(err_step, err)
    # the single chain's shape (phase 6): B = 1, no divergence allowed
    err, _, _, _ = _step_phase("phase 4: flagship", spec,
                               replicate(spec, sysm.state, 1), 0,
                               n_check, label)
    err_step = max(err_step, err)
    # the main path's batch (phase 3's states): the flagship's spec, then
    # the isotherm's (phase 5: 8 fugacities x 128 replicas, one activity
    # table a replica), whose time is the kernels line's
    err, _, _, _ = _step_phase("phase 4: flagship", spec, states,
                               max(1, MAIN_REPLICAS // 64), 0, label)
    err_step = max(err_step, err)
    sweep = isotherm_spec(spec)
    print(f"phase 4: isotherm spec: {dispatch_report(sweep, dev)}")
    err, ms_step, ms_step_plain, bound_step = _step_phase(
        f"phase 4: isotherm {len(ISOTHERM.split(','))} x {ISO_REPLICAS}",
        sweep, states, max(1, MAIN_REPLICAS // 64), n_check, label)
    err_step = max(err_step, err)

    # ---- phase 4b: the resync kernel at B = 1 (K4) --------------------------
    k4 = _k4_phase("phase 4b", None, spec, sysm.state, label)

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

    resv = _resv_phase(dev, label)

    # ---- phases 8-9: bench.py's mixed and tricl ---------------------------
    _, mixed = _form_phase("phase 8", "mixed", make_framework_mixed,
                           MIXED_SYSTEM, dev, label)
    tricl_sys, tricl = _form_phase("phase 9", "tricl", make_triclinic_water,
                                   TRICL_BOX, dev, label)
    tricl_step = _tricl_step_phase(tricl_sys, dev, label)
    tricl_k4 = _k4_phase("phase 9d", "tricl", tricl_sys.spec,
                         tricl_sys.state, label)

    # ---- phases 10-11: hardware precision, the sentinel, the tools -------
    onehot = _precision_phase(spec, sysm.state, dev, label)
    micro = _microbench_phase(dev, label)

    # ---- phase 12: the command line with --widom, --checkpoint, --resume --
    _chain_options_phase(label)

    # ---- phase 13: the threefry kernel; tabulated potentials on the card -
    err_tf, ms_tf, ms_tf_plain, bound_tf = _threefry_phase(
        replicate(spec, sysm.state, MAIN_REPLICAS).key, label)
    _table_phase(dev, label)

    # ---- phase 14: the mesh on the card --------------------------------
    _mesh_phase(label)

    # ---- phase 15: the validation layer on the card --------------------
    _envelope_phase(label)
    _virial_phase(label)
    _examples_phase(label)

    # ---- phase 16: the bench's systems: bigS, the f64 canary, the bench --
    bigs = _bigs_phase(dev, label)
    _canary_phase(label)
    _bench_phase(main["rate"], label)

    print(json.dumps({"kernels": [
        *_main_rows(None, main, err_blk2, err_rs1), k4,
        _row("run_steps_kernel", STEPG_SRC,
             "maniac_tpu/kernels/stepg.py:65", iso_launches["stepg"],
             err_step, ms_step, ms_step_plain, bound_step),
        *resv, *mixed, *tricl, tricl_step, tricl_k4, onehot, *micro, *bigs,
        _row("threefry", THREEFRY_SRC,
             "none: jax.random threefry, an XLA op "
             "(maniac_tpu/mc/driver.py:69)", main["launches"]["threefry"],
             err_tf, ms_tf, ms_tf_plain, bound_tf),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(_mesh_rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7]))
    sys.exit(main())
