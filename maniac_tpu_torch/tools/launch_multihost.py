"""Multi-process launcher: one process per GPU, the replica axis split over
all of them.

Counterpart of tools/launch_multihost.py. Independent Metropolis chains
need no communication, so every process loads the same (spec, state) from
the same files and seed, builds only its own slice of the global replicas
(parallel/mesh.shard_replicas) on its card and runs each block there with
no collective; the only traffic is the per-block diagnostic gather (one
all-gather of every replica's populations and total energy), whose
statistics equal a single process's bit for bit.

Run one process per GPU, on every host (process ids 0 .. P-1, each host's
processes on its cards in turn: card process_id % the host's card count):

    python -m maniac_tpu_torch.tools.launch_multihost \\
        --coordinator <host0>:29500 --num-processes <P> --process-id <i> \\
        -i input.maniac -d topology.data -p parameters.inc \\
        [--replicas-per-device 64] [--blocks 10] [--steps 1000]

The ranks meet over NCCL at tcp://<coordinator> (a full URL such as
file:///shared/path is taken as it is), with a 60 s timeout. Without a
CUDA device the launcher exits 1; ``--platform cpu`` runs the ranks on the
host over gloo (tests/test_torch_mesh.py). Without --coordinator a single
process runs with no process group. Only process 0 prints: a header, the
kernel dispatch, one ``block`` line a block, the aggregate rate over the
blocks after the first (which loads the kernels and, over NCCL, sets up
the communicator; a single block is timed as it is) and its kernel
launches. The run is f32
with the step-size recalibration, and without the resync, as the JAX
launcher runs it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from ..parallel.mesh import INIT_TIMEOUT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.launch_multihost")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (or an init URL such as "
                         "file:///path); required if --num-processes > 1")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("-i", dest="deck", required=True)
    ap.add_argument("-d", dest="data", required=True)
    ap.add_argument("-p", dest="params", required=True)
    ap.add_argument("-r", dest="reservoir", default=None)
    ap.add_argument("--replicas-per-device", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--platform", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default: NCCL, one card a process) or cpu "
                         "(gloo on the host)")
    args = ap.parse_args(argv)
    if args.num_processes > 1 and not args.coordinator:
        ap.error("--coordinator is required for multi-process runs")
    return args


def init_url(coordinator: str) -> str:
    """The init method of ``coordinator``: host:port over TCP, or a URL
    given whole."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def block_line(b: int, mean_n, std_n, mean_e, std_e) -> str:
    """One block's line, as the JAX launcher prints it."""
    return (f"block {b:4d}: <N>={[f'{float(v):.3f}' for v in mean_n]} "
            f"+- {[f'{float(v):.3f}' for v in std_n]}  "
            f"<E>={float(mean_e):.2f} K +- {float(std_e):.2f}")


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        print("launch_multihost: no CUDA device is available (use "
              "--platform cpu for ranks on the host)", file=sys.stderr)
        return 1
    if args.platform == "cuda":
        from ..kernels import build
        device = torch.device("cuda",
                              args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # every rank builds (or finds) the kernels before the rendezvous,
        # so that a cold build does not count against the timeout
        build.library()
    else:
        device = torch.device("cpu")
    try:
        if args.coordinator:
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method=init_url(args.coordinator),
                world_size=args.num_processes, rank=args.process_id,
                timeout=INIT_TIMEOUT)
        return _run(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device) -> int:
    from .. import load_system
    from ..kernels import dispatch_report
    from ..kernels.blockg import run_block_kernel
    from ..kernels.resync import resync_grouped
    from ..kernels.threefry import split_uniform
    from ..parallel.mesh import (gather_replica_stats, make_mesh,
                                 replicate_spec, run_block_sharded,
                                 shard_replicas)
    from ..system import E_TOT
    from ..utils.logger import NullLogger

    mesh = make_mesh(device=device)
    B = args.replicas_per_device * mesh.world
    lead = mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    say(f"# {args.num_processes} process(es), {mesh.world} global devices, "
        f"B={B} replicas")
    # the same on every process (deterministic from the files and the seed)
    sysm = load_system(args.deck, args.data, args.params,
                       reservoir_file=args.reservoir, capacity=args.capacity,
                       dtype=torch.float32, device=device,
                       logger=NullLogger(), seed=args.seed)
    spec = replicate_spec(mesh, sysm.spec)
    states = shard_replicas(mesh, spec, sysm.state, B)
    say(f"# {dispatch_report(spec, device)}")
    for fn in (run_block_kernel, split_uniform, resync_grouped):
        fn.launches = 0
    warmup = 1 if args.blocks > 1 else 0
    for b in range(1, args.blocks + 1):
        if b == warmup + 1:
            sync()
            t0 = time.perf_counter()
        states = run_block_sharded(mesh, spec, states, args.steps, True)
        # the only collective: every replica's N and E, gathered to each
        # rank, reduced there
        say(block_line(b, *gather_replica_stats(states, spec.R, E_TOT,
                                                mesh=mesh)))
    sync()
    dt = time.perf_counter() - t0
    timed = args.blocks - warmup
    say(f"# {timed * args.steps * B / dt / 1e6:.3f} M aggregate "
        f"steps/s over {dt:.1f} s")
    say(f"# rank 0 kernel launches: blockg {run_block_kernel.launches}, "
        f"threefry {split_uniform.launches}, resync "
        f"{resync_grouped.launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
