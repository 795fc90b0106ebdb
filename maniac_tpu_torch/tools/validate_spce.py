"""External validation anchor: SPC/E water's Widom excess chemical
potential at 298 K on the port (the counterpart of
scripts/validate_spce.py).

    python -m maniac_tpu_torch.tools.validate_spce [--replicas 64]
        [--blocks 30] [--eq-blocks 150] [--steps 2000] [--trials 256]
        [--waters 128] [--dtype f32] [--platform cuda|cpu]

Literature-parameter SPC/E water (systems.make_spce_box) in NVT
(translations and rotations) at 0.997 g/cm^3: ``--eq-blocks`` blocks with
the step-size recalibration, then ``--blocks`` blocks each followed by
``--trials`` Widom ghost insertions into every replica
(mc/widom.widom_block_replicated, keys split(sub, replicas) of
prng_key(2024)'s stream, as the JAX script draws them). In f32 every block
ends with the amplitude resync, as the command line's replicated f32 runs
do (DIVERGENCES.md #13). Published SPC/E values with Ewald sums lie at
-28..-30.5 kJ/mol = -6.7..-7.3 kcal/mol (Hermans, Pathiaseril and Anderson,
JACS 110 (1988) 5982; Quintana and Haymet, CPL 189 (1992)); the reference
semantics' missing LJ tail adds some +0.2 kcal/mol. PASS band: -7.5 ..
-6.3 kcal/mol. Prints the card, the kernel dispatch, the running mu_ex, the
wall time and ``RESULT: PASS`` (exit 0) or ``RESULT: FAIL`` (exit 1). The
card is the default; without one the tool exits 1 unless ``--platform
cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

MU_BAND = (-7.5, -6.3)       # kcal/mol, the PASS band
WIDOM_SEED = 2024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.validate_spce",
        description="SPC/E Widom mu_ex at 298 K against published values")
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=30)
    ap.add_argument("--eq-blocks", type=int, default=150)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--trials", type=int, default=256)
    ap.add_argument("--waters", type=int, default=128)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    label = args.platform
    if args.platform == "cuda":
        from . import card_label, require_cuda
        if not require_cuda("validate_spce"):
            return 1
        label = card_label()

    from ..api import load_system
    from ..constants import KB_KCALMOL
    from ..kernels import dispatch_report
    from ..mc.widom import mu_excess_K, widom_block_replicated
    from ..parallel.replicas import replicate, run_block_replicated
    from ..system import E_TOT
    from ..systems import make_spce_box
    from ..utils.threefry import prng_key, split

    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        make_spce_box(tmp, n_water=args.waters, density=0.997, temp=298.0,
                      cutoff=9.0 if args.waters >= 200 else 7.0, tol=1e-5,
                      probs=(0.5, 0.5, 0.0, 0.0), tstep=0.25, rstep=0.4,
                      recal=True)
        sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", dtype=dtype,
                           device=args.platform)
    spec, state = sysm.spec, sysm.state
    resync = dtype == torch.float32
    print(f"# SPC/E N={args.waters} L={float(spec.box_diag[0]):.3f} A "
          f"rho=0.997 g/cm3 T=298 K {args.dtype} on {label}")
    print(f"# {dispatch_report(spec, spec.device)}")

    states = replicate(spec, state, args.replicas)
    t0 = time.perf_counter()
    for b in range(args.eq_blocks):
        states = run_block_replicated(spec, states, args.steps, True, resync)
        if (b + 1) % max(1, args.eq_blocks // 10) == 0:
            # U/N convergence: liquid SPC/E sits near -11 kcal/mol
            u_n = (states.energy[:, E_TOT].double().mean().item()
                   * KB_KCALMOL / args.waters)
            print(f"# eq block {b + 1:4d}: U/N = {u_n:7.3f} kcal/mol",
                  flush=True)
    print(f"# equilibrated {args.eq_blocks}x{args.steps} steps x "
          f"{args.replicas} replicas in {time.perf_counter() - t0:.1f} s")

    key = prng_key(WIDOM_SEED, device=spec.device)
    temp_K = float(spec.temp_K)
    b_rep = []
    for b in range(args.blocks):
        states = run_block_replicated(spec, states, args.steps, False,
                                      resync)
        key, sub = split(key)
        # widom_block_replicated returns ln B (overflow-safe); B in f64
        log_b = widom_block_replicated(spec, states, args.trials,
                                       split(sub, args.replicas))
        b_rep.append(np.exp(log_b.double().cpu().numpy())[:, 0])
        mu_run = mu_excess_K(np.mean(b_rep), temp_K) * KB_KCALMOL
        print(f"block {b + 1:3d}: running mu_ex = {mu_run:8.3f} kcal/mol",
              flush=True)
    per_rep = np.stack(b_rep).mean(axis=0)              # (replicas,)
    B = per_rep.mean()
    sem = per_rep.std(ddof=1) / np.sqrt(per_rep.size)
    mu = mu_excess_K(B, temp_K) * KB_KCALMOL
    dmu = KB_KCALMOL * temp_K * sem / B
    ok = MU_BAND[0] <= mu <= MU_BAND[1]
    print(f"mu_ex = {mu:.3f} +- {dmu:.3f} kcal/mol (published SPC/E band "
          f"-7.3..-6.7; PASS band {MU_BAND[0]}..{MU_BAND[1]})")
    print(f"wall time {time.perf_counter() - t_start:.1f} s on {label}")
    print(f"RESULT: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
