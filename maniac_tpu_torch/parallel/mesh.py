"""Replica sharding over one process per device, and the cross-replica
diagnostics.

Counterpart of maniac_tpu/parallel/mesh.py. Independent Metropolis chains
need no communication while they run, so the mesh is one process per GPU
(torch.distributed), each owning a contiguous slice [lo, hi) of the global
replica axis and running the single-device path on it
(run_block_replicated: the threefry and whole-block kernels, and the
resync kernel with resync=True) with no collective. A replica's chain is
fixed by the seed and its global index (its key is row b of split(key0,
B), as replicate draws it), so a rank's chains are those replicas of the
single-process run, bit for bit. The only collective is the per-block
diagnostic gather (gather_replica_stats, gather_mean_population): one
all-gather of every replica's populations and total energy, in global
replica order, then the single-device reductions on the rank's device, so
that the statistics do not depend on the world size either. (An
all-reduce of partial sums would add in another order for every world
size.) run_ranks starts the processes of a world on one host and waits
for them, as the dry run (entry.dryrun_multichip), the tests and
chip_smoke.py do.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..system import SimState, SystemSpec, to_device
from ..utils.threefry import split
from .replicas import run_block_replicated

# the timeout of every process group's rendezvous and collectives: a rank
# that dies before it joins fails the others within a minute, not the
# default half hour
INIT_TIMEOUT = datetime.timedelta(seconds=60)


@dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: the process group (None for a
    world of 1 without torch.distributed), its rank, the world size and
    the device its replicas live on."""
    group: object
    rank: int
    world: int
    device: torch.device

    def span(self, n_replicas: int) -> tuple:
        """[lo, hi): the global replicas this rank owns, a contiguous
        slice of n_replicas / world (which must divide, as under JAX's
        sharding)."""
        if n_replicas % self.world:
            raise ValueError(f"{n_replicas} replicas do not split evenly "
                             f"over a world of {self.world}")
        n = n_replicas // self.world
        return self.rank * n, (self.rank + 1) * n


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the initialized torch.distributed group, one process a
    device (a world of 1 without a group); ``n_devices``, when given, must
    be the world size. ``device`` is this rank's device: by default the
    card rank % (the cards of this host), and without a card it raises
    (pass device="cpu" for ranks on the host). A CUDA device is made the
    current device here, before anything is loaded on it: the kernels
    launch on the current device (kernels/build.current_stream)."""
    if dist.is_available() and dist.is_initialized():
        group, rank, world = (dist.group.WORLD, dist.get_rank(),
                              dist.get_world_size())
    else:
        group, rank, world = None, 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, but "
                         f"the world has {world} processes (one a device)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available "
                               "(pass device='cpu' for ranks on the host)")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return Mesh(group, rank, world, device)


def shard_replicas(mesh: Mesh, spec: SystemSpec, state: SimState,
                   n_replicas: int) -> SimState:
    """This rank's slice of replicate(spec, state, n_replicas), built on
    the rank's device: replica 0 of ``state`` copied into hi - lo chains,
    whose keys are rows [lo, hi) of split(replica 0's key, n_replicas),
    computed on the host for the global n_replicas. No rank builds another
    rank's replicas. This is both shard_replicas and shard_replicas_global
    of the JAX package: with one process a device, every rank's replicas
    are addressable by it alone, on one host or many."""
    lo, hi = mesh.span(n_replicas)
    out = SimState(**{
        k: v[:1].to(mesh.device).expand(hi - lo, *v.shape[1:]).contiguous()
        for k, v in vars(state).items()})
    keys = split(state.key[0].cpu(), n_replicas)[lo:hi]
    return out.replace(key=keys.to(mesh.device))


def replicate_spec(mesh: Mesh, spec: SystemSpec) -> SystemSpec:
    """The spec on the rank's device (every rank holds all of it; on a
    card TF32 is turned off, system.to_device)."""
    return to_device(spec, mesh.device)


def run_block_sharded(mesh: Mesh, spec: SystemSpec, states: SimState,
                      n_steps: int, recalibrate: bool,
                      resync: bool = False) -> SimState:
    """One block of this rank's replicas: run_block_replicated on the
    local slice, with no collective (the chains are independent)."""
    if states.pos.device != mesh.device or spec.device != mesh.device:
        raise ValueError(f"run_block_sharded: the states ({states.pos.device})"
                         f" and the spec ({spec.device}) must be on the "
                         f"rank's device {mesh.device}")
    return run_block_replicated(spec, states, n_steps, recalibrate, resync)


def _gather_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """Every rank's (B_local, C) rows stacked in rank order, which is the
    global replica order: one all_gather (gloo gathers on the host), the
    result on the rank's device."""
    if mesh.group is None:
        return rows
    on_host = dist.get_backend(mesh.group) == "gloo"
    local = rows.cpu() if on_host else rows.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts).to(mesh.device)


def _replica_stats(n: torch.Tensor, e: torch.Tensor):
    n, e = n.contiguous(), e.contiguous()
    return (n.mean(dim=0), n.std(dim=0, unbiased=False), e.mean(),
            e.std(unbiased=False))


def gather_replica_stats(states: SimState, R: int, e_tot: int,
                         mesh: Mesh | None = None):
    """Per-block cross-replica observables, reduced on the device so only
    2R+2 numbers reach the host: mean and population std of N per residue
    type, and of the running total energy (f64 accumulation). With a
    ``mesh`` the states are this rank's slice, and the statistics are
    those of every rank's replicas: the populations and energies are
    gathered in global order (_gather_rows) and reduced as one device
    reduces them, so they equal the single-process statistics bit for
    bit."""
    n = states.n_mol[:, :R].to(torch.float64)
    e = states.energy[:, e_tot].to(torch.float64)
    if mesh is not None:
        rows = _gather_rows(mesh, torch.cat([n, e[:, None]], dim=1))
        n, e = rows[:, :R], rows[:, R]
    return _replica_stats(n, e)


def gather_mean_population(mesh: Mesh, states: SimState,
                           R: int) -> torch.Tensor:
    """The mean occupancy per residue type over every rank's replicas (one
    all-gather, in f64), on the rank's device."""
    n = _gather_rows(mesh, states.n_mol[:, :R].to(torch.float64))
    return n.contiguous().mean(dim=0)


def run_ranks(argvs, timeout: float, env=None, cwd=None) -> list:
    """Run one process a rank (argvs[r] is rank r's command line) and wait
    for all of them, ``timeout`` seconds at most in all. Returns [(exit
    code, output)] in rank order; the output is stdout and stderr, through
    files, so that no rank blocks on a full pipe. When a rank fails, or the
    time runs out, the ranks still running are killed (at the timeout
    their exit code is None); none outlives the call."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(len(argvs))]
        procs, late = [], set()
        try:
            for argv, log in zip(argvs, logs):
                procs.append(subprocess.Popen(
                    argv, stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=cwd))
            deadline = time.monotonic() + timeout
            while True:
                rcs = [p.poll() for p in procs]
                if None not in rcs or any(rcs):
                    break
                if time.monotonic() > deadline:
                    late = {r for r, rc in enumerate(rcs) if rc is None}
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            out = []
            for log in logs:
                log.seek(0)
                out.append(log.read())
                log.close()
        return [(None if r in late else p.returncode, text)
                for r, (p, text) in enumerate(zip(procs, out))]
