"""Integration hooks of the port: counterpart of __graft_entry__.py.

* entry()               -> (fn, example_args): one MC step on the flagship
                           ZIF-8-scale GCMC system, on the card.
* dryrun_multichip(n)   -> n processes over gloo on the host, the replica
                           axis split over them, one real block of every
                           execution regime's tiny shape.

The dry run's ranks are this module run as a program:

    python -m maniac_tpu_torch.entry <rank> <world> <init URL>
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

# the execution regimes of the dry run (systems.tiny_system)
DRYRUN_SHAPES = ("flagship", "mixed", "resv", "tricl")
# seconds the dry run's ranks may take in all
DRYRUN_TIMEOUT = 300
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_flagship(dtype, device, capacity: int):
    from . import load_system
    from .systems import make_zif_like
    from .utils.logger import NullLogger

    with tempfile.TemporaryDirectory() as tmp:
        make_zif_like(tmp, n_cells=6, a=5.66, n_water=32)
        return load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", capacity=capacity,
                           dtype=dtype, device=device, logger=NullLogger())


def entry(device="cuda"):
    """(fn, (state, key)): fn(state, key) is one MC trial move on the
    flagship system (f32, capacity 128): the step's uniforms drawn from
    ``key`` (mc/driver.draw_uniforms), then mc_step_u (energies, the
    Metropolis test, the state update); it returns the new state. The
    system lives on the card unless ``device`` says otherwise."""
    from .mc.driver import draw_uniforms
    from .mc.moves import mc_step_u
    from .utils.threefry import prng_key

    sysm = _load_flagship(torch.float32, device, capacity=128)
    spec, state = sysm.spec, sysm.state

    def fn(state, key):
        state, u = draw_uniforms(spec, state.replace(key=key), 1)
        return mc_step_u(spec, state, u[:, 0])

    return fn, (state, prng_key(0, state.key.device)[None])


def dryrun_multichip(n_devices: int) -> None:
    """The sharded block on an n-process world, the way the JAX package
    validates its mesh on n virtual CPU devices: n ranks over gloo on the
    host, each running every execution regime of DRYRUN_SHAPES
    (systems.tiny_system: the flagship, the mixed-species swap, the
    reservoir, the triclinic box), sharded at 2n replicas, for one block of
    4 steps with the recalibration, then gather_mean_population. Raises if
    any rank fails or the ranks take more than DRYRUN_TIMEOUT seconds."""
    from .parallel.mesh import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        argvs = [[sys.executable, "-m", "maniac_tpu_torch.entry", str(r),
                  str(n_devices), init] for r in range(n_devices)]
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [PACKAGE_PARENT] + ([path] if path else [])))
        ranks = run_ranks(argvs, DRYRUN_TIMEOUT, env=env)
    for r, (rc, out) in enumerate(ranks):
        if rc != 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} "
                               f"exit {rc}:\n{out}")


def _dryrun_rank(rank: int, world: int, init: str) -> int:
    """One rank of dryrun_multichip."""
    import torch.distributed as dist

    from . import load_system
    from .parallel.mesh import (INIT_TIMEOUT, gather_mean_population,
                                make_mesh, replicate_spec,
                                run_block_sharded, shard_replicas)
    from .systems import tiny_system
    from .utils.logger import NullLogger

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=INIT_TIMEOUT)
    try:
        mesh = make_mesh(world, device="cpu")
        for shape in DRYRUN_SHAPES:
            with tempfile.TemporaryDirectory() as tmp:
                deck, data, inc, res = tiny_system(tmp, shape)
                sysm = load_system(deck, data, inc, reservoir_file=res,
                                   capacity=16, dtype=torch.float32,
                                   device="cpu", logger=NullLogger())
            spec = replicate_spec(mesh, sysm.spec)
            states = shard_replicas(mesh, spec, sysm.state, 2 * world)
            states = run_block_sharded(mesh, spec, states, 4, True)
            mean_n = gather_mean_population(mesh, states, spec.R)
            if (states.B != 2 or tuple(mean_n.shape) != (spec.R,)
                    or not bool(torch.isfinite(states.energy).all())):
                raise RuntimeError(f"dry run {shape}: B {states.B}, mean N "
                                   f"{mean_n.tolist()}")
            if rank == 0:
                print(f"dry run {shape}: {world} ranks x {states.B} "
                      f"replicas, mean N {mean_n.tolist()}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
