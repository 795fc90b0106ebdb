"""Command-line entry point, flag-compatible with the reference binary.

Usage (reference: src/cli_utils.f90:10-27):

    python -m maniac_tpu_torch.cli -i input.maniac -d topology.data
           -p parameters.inc [-r reservoir.data] [-o outputs/]
           [--platform cpu|cuda]

Counterpart of maniac_tpu/cli.py with the same flags and output files:

    --replicas N     independent chains (replica 0's series are written;
                     cross-replica statistics go to replicas.dat)
    --dtype f32|f64  engine precision (f32 default on cuda, f64 on cpu)
    --capacity N     per-active-type molecule capacity override
    --platform P     torch device: cuda (default) or cpu; a missing CUDA
                     device is an error, never a run on the CPU
    --seed S         the seed of the chains' threefry keys (default: the
                     deck's seed): one seed walks the JAX CLI's chain
    --audit          per-block energy-drift audit (full recompute)
    --profile BINS   per-block COM density histogram -> profile_<RES>.dat
    --isotherm F,..  adsorption-isotherm sweep: every fugacity a batch of
                     --replicas chains -> isotherm_<RES>.dat, isotherm.dat
    --sentinel N     every N blocks, replay replica 0's block on the plain
                     path and compare (mc/driver.py::sentinel_check)
    --widom N        N Widom ghost insertions per block per active species
                     into replica 0 -> widom.dat (mc/widom.py; their own
                     key, replica 0's folded with a tag and the block)
    --checkpoint F   write a full checkpoint (.npz, io/checkpoint.py) every
                     block, the chains' keys included
    --resume F       continue from such a checkpoint (the JAX CLI's too)

With -r, insertions take their geometry from the reservoir and deletions
push back into it; reservoir.lammpstrj is written beside the trajectory.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .utils.errors import ManiacError
from .utils.logger import Logger

# the JAX package's benign rate of sentinel divergences (one per ~500
# checked blocks, maniac_tpu/cli.py); not a rate measured on this card
SENTINEL_BENIGN_RATE = 1 / 500


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="maniac-tpu-torch",
        description="GCMC molecular simulation (PyTorch, CUDA)")
    p.add_argument("-i", dest="input", required=True, help=".maniac input deck")
    p.add_argument("-d", dest="data", required=True, help="LAMMPS data file")
    p.add_argument("-p", dest="params", required=True,
                   help="pair-coeff include file")
    p.add_argument("-r", dest="reservoir", default=None,
                   help="reservoir data file")
    p.add_argument("-o", dest="outdir", default="outputs/",
                   help="output directory")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--dtype", choices=["f32", "f64"], default=None)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    p.add_argument("--audit", action="store_true")
    p.add_argument("--widom", type=int, default=0, metavar="N",
                   help="N Widom ghost insertions per block per active "
                        "species (excess chemical potential -> widom.dat)")
    p.add_argument("--profile", type=int, default=0, metavar="BINS",
                   help="per-block COM density histogram with BINS bins "
                        "per active species -> profile_<RES>.dat")
    p.add_argument("--profile-axis", choices=["x", "y", "z"], default="z")
    p.add_argument("--sentinel", type=int, default=0, metavar="N",
                   help="every N blocks, replay replica 0's block on the "
                        "plain path and compare with the kernels' result")
    p.add_argument("--isotherm", default=None, metavar="F1,F2,...",
                   help="adsorption-isotherm sweep: run every listed "
                        "fugacity (atm, applied to each active species "
                        "scaled from its deck fugacity) as parallel state "
                        "points, --replicas chains per point -> "
                        "isotherm_<RES>.dat series + isotherm.dat summary")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="write a full checkpoint (.npz) every block")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint written by --checkpoint")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    outdir = args.outdir if args.outdir.endswith("/") else args.outdir + "/"
    os.makedirs(outdir, exist_ok=True)
    logger = Logger(os.path.join(outdir, "log.maniac"))
    try:
        return _run(args, outdir, logger)
    except ManiacError as e:
        return e.exit_code
    except FileNotFoundError as e:
        logger.log("-" * 50)
        logger.log("FATAL ERROR:")
        logger.log(f"File not found: {e.filename}")
        logger.log("Simulation will now terminate.")
        logger.log("-" * 50)
        return 1
    finally:
        logger.close()


def _device(args, logger) -> torch.device:
    if args.platform == "cuda" and not torch.cuda.is_available():
        logger.abort("--platform cuda: no CUDA device is available (use "
                     "--platform cpu to run on the CPU)", 1)
    return torch.device(args.platform)


def _run(args, outdir: str, logger) -> int:
    from .api import load_system
    from .io.writers import OutputWriter, snapshot
    from .kernels import dispatch_report
    from .mc.driver import (block_body_u, draw_uniforms, drift_report,
                            refresh_reported_energy, resync, sentinel_check,
                            sentinel_passed)
    from .parallel.mesh import gather_replica_stats
    from .parallel.replicas import replicate, run_block_uniforms
    from .system import E_TOT

    device = _device(args, logger)
    dtype_name = args.dtype or ("f32" if device.type == "cuda" else "f64")
    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    logger.banner("MANIAC-TPU (torch)",
                  f"device: {device.type} | dtype: {dtype_name} | "
                  f"replicas: {args.replicas}")
    for path, label in ((args.input, "Input"), (args.data, "Data"),
                        (args.params, "Parameter")):
        if not os.path.exists(path):
            logger.abort(f"{label} file not found: {path}", 1)
    if args.reservoir and not os.path.exists(args.reservoir):
        logger.abort(f"Reservoir file not found: {args.reservoir}", 1)

    t0 = time.time()
    sysm = load_system(args.input, args.data, args.params,
                       reservoir_file=args.reservoir,
                       capacity=args.capacity, dtype=dtype, device=device,
                       logger=logger, seed=args.seed)
    deck, spec, state = sysm.deck, sysm.spec, sysm.state
    logger.log(dispatch_report(spec, device))

    if args.isotherm:
        return _run_isotherm(args, outdir, logger, sysm, t0)

    start_block = 0
    if args.resume:
        from .io.checkpoint import load_checkpoint
        try:
            state, start_block = load_checkpoint(args.resume, spec)
        except ValueError as e:
            logger.abort(f"--resume: {e}", 1)
        logger.info(f"Resumed from {args.resume} at block {start_block}")

    replicated = args.replicas > 1
    if replicated and state.B == 1:
        state = replicate(spec, state, args.replicas)
    if args.resume and state.B != max(args.replicas, 1):
        logger.abort(f"--resume: the checkpoint holds {state.B} replicas "
                     f"and --replicas asks for {args.replicas}", 1)
    writer = OutputWriter(outdir, deck, sysm.parsed, logger)

    def res_snap():
        return (snapshot(spec, state, reservoir=True) if spec.has_reservoir
                else None)

    res_box = sysm.reservoir.box if sysm.reservoir else None
    logger.banner("Started Monte Carlo Loop")
    snap0 = snapshot(spec, state)
    writer.update_files(snap0, 0, append=False, reservoir_snap=res_snap(),
                        reservoir_box=res_box)
    if args.profile > 0:
        writer.write_profile(snap0, 0, args.profile, args.profile_axis)

    act_ids = [r for r, res in enumerate(deck.residues) if res.active]
    act_names = [deck.residues[r].name for r in act_ids]
    f32 = spec.dtype == torch.float32
    total_steps = 0
    sentinel_fail = 0
    if args.widom > 0:
        from .mc.widom import widom_block, widom_factor, widom_key
        widom_sum = np.zeros(len(act_names))
        widom_blocks = 0
    for block in range(start_block + 1, deck.nb_block + 1):
        # the block's uniforms are drawn here, as run_block_replicated and
        # block_body draw them, so that --sentinel can replay them
        state, u = draw_uniforms(spec, state, deck.nb_step)
        state_pre = state
        if replicated:
            # f32: the amplitude resync bounds the incremental A(k) drift
            # at block granularity (DIVERGENCES #13)
            state = run_block_uniforms(spec, state, u,
                                       deck.recalibrate_moves, f32)
        else:
            state = block_body_u(spec, state, u, deck.recalibrate_moves)
        if args.sentinel > 0 and block % args.sentinel == 0:
            # before the f32 energy refresh: the block's own output against
            # the plain replay of replica 0 from the same state and uniforms
            rep = sentinel_check(spec, state_pre, state, u,
                                 deck.recalibrate_moves,
                                 resync=f32 and replicated)
            if sentinel_passed(rep):
                logger.log(f"  sentinel block {block}: kernel == plain "
                           f"(pos diff {rep['pos_max_diff']:.2e}, energy "
                           f"diff {rep['energy_max_diff']:.2e} K)")
            else:
                sentinel_fail += 1
                logger.log(
                    f"  sentinel block {block}: kernel/plain divergence "
                    f"(n_mol_mismatch={rep['n_mol_mismatch']} "
                    f"counter_mismatch={rep['counter_mismatch']} "
                    f"pos_max_diff={rep['pos_max_diff']:.3e}) - an isolated "
                    f"flip at a Metropolis threshold is benign")
        if f32:
            # the reported energy rows are fresh values every block, as the
            # reference's energy.dat (src/write_utils.f90:94-188)
            state = (refresh_reported_energy(spec, state) if replicated
                     else resync(spec, state))
        total_steps += deck.nb_step * args.replicas
        snap = snapshot(spec, state)
        writer.print_status(snap, block)
        writer.update_files(snap, block, append=True,
                            reservoir_snap=res_snap(), reservoir_box=res_box)
        if replicated:
            mean_n, std_n, mean_e, std_e = gather_replica_stats(
                state, spec.R, E_TOT)
            writer.write_replicas(
                block, act_names, mean_n.cpu().numpy()[act_ids],
                std_n.cpu().numpy()[act_ids], float(mean_e), float(std_e))
        if args.profile > 0:
            writer.write_profile(snap, block, args.profile,
                                 args.profile_axis)
        if args.widom > 0:
            # ghosts in replica 0's current (refreshed) configuration, drawn
            # from a key folded off the chain's: the chain's key is not
            # advanced, so the diagnostic never perturbs the trajectory
            B_blk = widom_factor(widom_block(
                spec, state, args.widom, key=widom_key(state, block)))
            widom_sum += B_blk
            widom_blocks += 1
            writer.write_widom(block, act_names, B_blk,
                               widom_sum / widom_blocks, float(spec.temp_K))
        if args.audit and not replicated:
            rep = drift_report(spec, state)
            logger.log(f"  audit: |E_running - E_fresh| = "
                       f"{rep['drift_K']:.3e} K")
        if args.checkpoint:
            from .io.checkpoint import save_checkpoint
            save_checkpoint(args.checkpoint, spec, state, block,
                            single_chain=not replicated)

    elapsed = time.time() - t0
    snap = snapshot(spec, state)
    if int(state.extras[:, 0].sum()) > 0:
        logger.warn("Some insertions were rejected because the molecule "
                    "capacity was reached; consider --capacity.")
    if replicated:
        n = state.n_mol[:, :spec.R].cpu().numpy()
        for r, name in zip(act_ids, act_names):
            logger.log(f"  replica <N({name})> = {n[:, r].mean():.3f}"
                       f" +- {n[:, r].std():.3f}")
    if args.sentinel > 0:
        # multiples of N in (start_block, nb_block]
        checked = (deck.nb_block // args.sentinel
                   - start_block // args.sentinel)
        expected = checked * SENTINEL_BENIGN_RATE
        logger.log(f"  sentinel: {checked} cross-checked blocks, "
                   f"{sentinel_fail} divergences (~{expected:.2f} benign "
                   f"expected at the JAX package's 1/500)")
        if sentinel_fail > max(2.0, 4.0 * expected):
            logger.warn(
                f"SENTINEL: systematic kernel/plain divergence "
                f"({sentinel_fail}/{checked} checked blocks, far above the "
                f"JAX package's benign 1/500) - investigate with python -m "
                f"maniac_tpu_torch.tools.precision_probe")
    if deck.nb_block * deck.nb_step > 0:
        rate = total_steps / max(elapsed, 1e-9)
        logger.log(f"  throughput: {rate:,.0f} MC steps/s "
                   f"({total_steps:,} steps in {elapsed:.2f} s)")
    writer.final_report(snap, deck.nb_block)
    return 0


def _run_isotherm(args, outdir: str, logger, sysm, t0: float) -> int:
    """Adsorption-isotherm sweep: every listed fugacity is a batch of
    replica chains with its own per-replica activity
    (parallel/replicas.run_block_sweep). The reference produces an isotherm
    by one full serial run per fugacity (run.sh:4-96)."""
    from .constants import KB_KCALMOL
    from .io.writers import OutputWriter
    from .parallel.replicas import (perturb_activity, replicate,
                                    run_block_sweep)
    from .system import E_TOT

    deck, spec, state = sysm.deck, sysm.spec, sysm.state
    try:
        fugs = [float(t) for t in args.isotherm.split(",") if t]
    except ValueError:
        logger.abort(f"--isotherm expects comma-separated fugacities "
                     f"(atm), got: {args.isotherm}", 1)
    if not fugs or any(f <= 0 for f in fugs):
        logger.abort("--isotherm fugacities must be positive", 1)
    act_ids = [r for r, res in enumerate(deck.residues) if res.active]
    act_names = [deck.residues[r].name for r in act_ids]
    if not act_ids:
        logger.abort("--isotherm needs at least one active species", 1)
    for r in act_ids:
        if not deck.residues[r].fugacity > 0:
            logger.abort(f"--isotherm scales each active species' deck "
                         f"fugacity, and {deck.residues[r].name} has "
                         f"fugacity {deck.residues[r].fugacity} in the deck",
                         1)
    for flag, name in ((args.resume, "--resume"),
                       (args.checkpoint, "--checkpoint"),
                       (args.widom, "--widom"), (args.sentinel, "--sentinel"),
                       (args.audit, "--audit"), (args.profile, "--profile")):
        if flag:
            logger.warn(f"{name} is ignored in --isotherm mode (the sweep "
                        f"is a self-contained batched run)")

    reps = max(1, args.replicas)
    npts = len(fugs)
    B = npts * reps
    # per-point activities: scale each active species' deck-derived
    # activity by f_point / f_deck (activity is proportional to fugacity)
    base = spec.type_activity.cpu().numpy().astype(np.float64)
    acts = np.broadcast_to(base, (B, base.shape[0])).copy()
    for i, f_ in enumerate(fugs):
        for r in act_ids:
            scale = f_ / deck.residues[r].fugacity
            acts[i * reps:(i + 1) * reps, r] = base[r] * scale
    spec_sweep = perturb_activity(spec, acts)
    states = replicate(spec, state, B)

    writer = OutputWriter(outdir, deck, sysm.parsed, logger)
    logger.banner("Started Monte Carlo Loop (isotherm sweep)",
                  f"{npts} fugacity points x {reps} replicas = {B} chains")
    f32 = spec.dtype == torch.float32
    half = deck.nb_block // 2
    prod_n = []                       # per-block (npts, reps, n_active)
    prod_e = []                       # per-block (npts, reps) total energy
    for block in range(1, deck.nb_block + 1):
        states = run_block_sweep(spec_sweep, states, deck.nb_step,
                                 deck.recalibrate_moves, f32)
        n = states.n_mol[:, act_ids].cpu().numpy().reshape(npts, reps,
                                                           len(act_ids))
        mean_n = n.mean(axis=1)       # (npts, n_active)
        writer.write_isotherm(block, act_names, fugs, mean_n)
        if block > half:
            prod_n.append(n)
            prod_e.append(states.energy[:, E_TOT].cpu().numpy()
                          .astype(np.float64).reshape(npts, reps))
        logger.log("  block {:5d}: ".format(block) + "  ".join(
            f"{name}@{f_:g}atm <N>={mean_n[i, j]:.2f}"
            for j, name in enumerate(act_names)
            for i, f_ in enumerate(fugs)))
    if not prod_n:
        logger.abort("--isotherm needs at least one block (nb_block >= 1)",
                     1)
    prod = np.concatenate(prod_n, axis=1)  # (npts, blocks*reps, n_active)
    e_s = np.concatenate(prod_e, axis=1)   # (npts, blocks*reps)
    # isosteric heat from cross-chain fluctuations (Nicholson & Parsonage):
    # q_st = k_B T - cov(E, N)/var(N), engine energies in Kelvin. For an
    # ideal gas cov = 0 -> q_st = RT exactly. Multi-species rows use the
    # same formula per species' N (partial-q_st approximation).
    temp_K = float(spec.temp_K)
    qst = np.full((npts, len(act_ids)), np.nan)
    for j in range(len(act_ids)):
        for i in range(npts):
            var = prod[i, :, j].var()
            if var > 1e-12:
                cov = np.cov(e_s[i], prod[i, :, j], bias=True)[0, 1]
                qst[i, j] = (temp_K - cov / var) * KB_KCALMOL
    writer.write_isotherm_summary(act_names, fugs, prod.mean(axis=1),
                                  prod.std(axis=1), qst)
    logger.banner("Isotherm summary (production half)")
    for j, name in enumerate(act_names):
        for i, f_ in enumerate(fugs):
            logger.log(f"  {name} @ {f_:g} atm: <N> = "
                       f"{prod[i, :, j].mean():.3f} "
                       f"+- {prod[i, :, j].std():.3f}"
                       f"  qst = {qst[i, j]:.3f} kcal/mol")
    elapsed = time.time() - t0
    total = deck.nb_block * deck.nb_step * B
    logger.log(f"  throughput: {total / max(elapsed, 1e-9):,.0f} MC steps/s "
               f"({total:,} steps in {elapsed:.2f} s)")
    logger.banner("Simulation Completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
