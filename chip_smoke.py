#!/usr/bin/env python3
"""On-card smoke check of the maniac_tpu_torch main path (one NVIDIA GPU).

    python3 chip_smoke.py    # the flagship check; under a minute on an H100

Builds the CUDA kernels from maniac_tpu_torch/kernels/csrc with nvcc, then:

  0. device, power limit, versions, TF32 off (asserted), kernel build time;
  1. resync kernel vs its plain torch version on the flagship system
     (make_zif_like(n_cells=6, a=5.66, n_water=32, fugacity=30), capacity
     192, f32) at B=64 after 50 plain steps: max|dA| <= 1e-4 max(1, max|A|),
     relative |dE_RECIP| <= 1e-5;
  2. whole-block kernel vs its plain version, B=64, 50 steps on the same
     uniforms: n_mol and counters identical in all but at most one replica
     (a Metropolis decision at its threshold may flip under f32 summation
     order), and on the matching replicas positions within 1e-4 A and
     energy components within 5 K;
  3. the main path: load_system -> replicate(B=1024) ->
     run_block_replicated(400 steps, resync=True), one warm-up block and
     three timed blocks; both kernels must have launched, the state must be
     finite and within capacity, and replica 0's amplitudes and E_RECIP
     must match a fresh synthesis (phase-1 bounds). Then both kernels are
     held against their plain versions at the main path's batch (10 block
     steps, at most B/64 replicas diverged; the resync of the result) and
     timed.

Prints one JSON line with the kernels' launch counts on the main path and
their errors and times (kernel and plain) at the main path's batch, then the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
non-zero and no result line is printed. It needs no network and only the
files of this repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import torch

RESYNC_SRC = "maniac_tpu_torch/kernels/csrc/resync.cu"
BLOCKG_SRC = "maniac_tpu_torch/kernels/csrc/blockg.cu"
# phases 1-2: replicas and MC steps of the kernel-vs-plain comparisons
CHECK_REPLICAS, CHECK_STEPS = 64, 50
# phase 3: the flagship main path
MAIN_REPLICAS, MAIN_STEPS, MAIN_BLOCKS = 1024, 400, 3
SEED = 1234


def _cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() in ms over reps calls after one warm-up call, by
    CUDA events (for the launch-bound plain versions this includes the
    device waiting on the host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _amp_check(name, amp_re, amp_im, e_recip, ref_re, ref_im, ref_e):
    """Phase-1 bounds; returns max |dA|."""
    scale = max(1.0, float(torch.max(torch.maximum(ref_re.abs(),
                                                   ref_im.abs()))))
    err = float(torch.max(torch.maximum((amp_re - ref_re).abs(),
                                        (amp_im - ref_im).abs())))
    rel_e = float(torch.max((e_recip - ref_e).abs() / ref_e.abs()))
    print(f"{name}: max|dA| {err:.3e} (bound {1e-4 * scale:.3e}), "
          f"max rel dE_RECIP {rel_e:.3e} (bound 1e-05)")
    if not err <= 1e-4 * scale or not rel_e <= 1e-5:
        raise AssertionError(f"{name}: amplitudes or E_RECIP out of bounds")
    return err


def _resync_pair(k, p, e_recip):
    """_amp_check arguments for kernel (k) vs plain (p) resync outputs."""
    return (k.amp_re, k.amp_im, k.energy[:, e_recip], p.amp_re, p.amp_im,
            p.energy[:, e_recip])


def _block_check(name, k, p, max_diverged):
    """Phase-2 bounds on kernel (k) vs plain (p) block outputs; returns
    max |dpos| over the replicas whose decisions match."""
    same = ((k.n_mol == p.n_mol).all(dim=1)
            & (k.counters == p.counters).flatten(1).all(dim=1))
    n_div = int((~same).sum())
    pos_err = float((k.pos - p.pos)[same].abs().max())
    e_err = float((k.energy - p.energy)[same].abs().max())
    print(f"{name}: {n_div} of {same.numel()} replica(s) diverged (allowed "
          f"{max_diverged}); matching replicas max|dpos| {pos_err:.3e} A "
          f"(bound 1e-4), max|dE| {e_err:.3e} K (bound 5); accepts "
          f"{int(k.counters[:, 1].sum())}")
    if n_div > max_diverged or not pos_err <= 1e-4 or not e_err <= 5.0:
        raise AssertionError(f"{name}: block kernel disagrees with plain")
    return pos_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from maniac_tpu_torch import (load_system, replicate,
                                  run_block_replicated)
    from maniac_tpu_torch.kernels import build, dispatch_report
    from maniac_tpu_torch.kernels.blockg import block_plain, run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
    from maniac_tpu_torch.mc.driver import draw_uniforms
    from maniac_tpu_torch.physics.energy import (active_site_mask,
                                                 full_amplitudes,
                                                 recip_energy,
                                                 site_positions)
    from maniac_tpu_torch.system import E_RECIP
    from maniac_tpu_torch.systems import make_zif_like

    # ---- phase 0: device and build ---------------------------------------
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"phase 0: device {name}; nvidia-smi: {smi}")
    print(f"phase 0: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.library()
    print(f"phase 0: kernel build {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # ---- phase 1: resync kernel vs plain -----------------------------------
    B, n_check = CHECK_REPLICAS, CHECK_STEPS
    states = replicate(spec, sysm.state, B)
    u = draw_uniforms(spec, B, n_check, gen)
    states = block_plain(spec, states, u)
    n = states.n_mol[:, 1]
    print(f"phase 1: B={B} after {n_check} plain steps, N in "
          f"[{int(n.min())}, {int(n.max())}]")
    k_out = resync_grouped(spec, states)
    p_out = resync_plain(spec, states)
    _amp_check("phase 1: resync kernel vs plain",
               *_resync_pair(k_out, p_out, E_RECIP))
    ms_rs = _cuda_ms(lambda: resync_grouped(spec, states), 10)
    ms_rs_plain = _cuda_ms(lambda: resync_plain(spec, states), 3)
    print(f"phase 1: resync B={B}: kernel {ms_rs:.3f} ms, plain "
          f"{ms_rs_plain:.3f} ms ({name}, {smi})")

    # ---- phase 2: block kernel vs plain ------------------------------------
    st0 = p_out
    u = draw_uniforms(spec, B, n_check, gen)
    k_blk = run_block_kernel(spec, st0, u)
    p_blk = block_plain(spec, st0, u)
    _block_check(f"phase 2: block B={B} x {n_check} steps", k_blk, p_blk,
                 1)
    ms_blk = _cuda_ms(lambda: run_block_kernel(spec, st0, u), 3)
    ms_blk_plain = _cuda_ms(lambda: block_plain(spec, st0, u), 1)
    print(f"phase 2: block kernel {ms_blk:.3f} ms, plain "
          f"{ms_blk_plain:.3f} ms ({name}, {smi})")

    # ---- phase 3: the main path ------------------------------------------
    Bm, n_steps = MAIN_REPLICAS, MAIN_STEPS
    states = replicate(spec, sysm.state, Bm)
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
        raise AssertionError(f"phase 3: a kernel never launched: {launches}")
    for k, v in vars(states).items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"phase 3: non-finite values in {k}")
    n = states.n_mol[:, 1]
    if int(n.min()) < 0 or int(n.max()) > spec.cap_list[1]:
        raise AssertionError("phase 3: population outside [0, capacity]")
    pos = site_positions(spec, states)[:1]
    ref_re, ref_im = full_amplitudes(
        spec, pos, active_site_mask(spec, states.n_mol[:1]))
    _amp_check("phase 3: replica 0 vs fresh synthesis", states.amp_re[:1],
               states.amp_im[:1], states.energy[:1, E_RECIP], ref_re, ref_im,
               recip_energy(spec, ref_re, ref_im))
    rate = Bm * n_steps * MAIN_BLOCKS / elapsed
    print(f"phase 3: B={Bm} x {n_steps} steps x {MAIN_BLOCKS} blocks in "
          f"{elapsed:.3f} s: {rate:.0f} MC steps/s ({name}, {smi}); "
          f"mean N {float(n.float().mean()):.2f}; launches {launches}")
    # both kernels against their plain versions at the main path's batch
    u = draw_uniforms(spec, Bm, 10, gen)
    k_blk = run_block_kernel(spec, states, u)
    p_blk = block_plain(spec, states, u)
    err_block = _block_check(f"phase 3: block B={Bm} x 10 steps", k_blk,
                             p_blk, max(1, Bm // 64))
    ms_block = _cuda_ms(lambda: run_block_kernel(spec, states, u), 3)
    ms_block_plain = _cuda_ms(lambda: block_plain(spec, states, u), 1)
    k_rs = resync_grouped(spec, k_blk)
    p_rs = resync_plain(spec, k_blk)
    err_resync = _amp_check(f"phase 3: resync B={Bm} kernel vs plain",
                            *_resync_pair(k_rs, p_rs, E_RECIP))
    ms_resync = _cuda_ms(lambda: resync_grouped(spec, k_blk), 10)
    ms_resync_plain = _cuda_ms(lambda: resync_plain(spec, k_blk), 3)
    print(f"phase 3: B={Bm}: block kernel {ms_block:.3f} ms, plain "
          f"{ms_block_plain:.3f} ms (10 steps); resync kernel "
          f"{ms_resync:.3f} ms, plain {ms_resync_plain:.3f} ms "
          f"({name}, {smi})")

    print(json.dumps({"kernels": [
        {"name": "resync_grouped", "route": "cuda", "source": RESYNC_SRC,
         "replaces": "maniac_tpu/kernels/resync.py:178",
         "launches": launches["resync"], "max_abs_err": err_resync,
         "ms": ms_resync, "plain_ms": ms_resync_plain},
        {"name": "run_block_kernel", "route": "cuda", "source": BLOCKG_SRC,
         "replaces": "maniac_tpu/kernels/blockg.py:128",
         "launches": launches["blockg"], "max_abs_err": err_block,
         "ms": ms_block, "plain_ms": ms_block_plain},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
