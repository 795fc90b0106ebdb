"""The port's mesh (maniac_tpu_torch/parallel/mesh.py), its launcher
(tools/launch_multihost.py) and its dry run (entry.py), on the CPU over
gloo: one process a rank, the replica axis split over the ranks.

The ranks of every world size are spawned once, all at a time, in a
module-scoped fixture (this file run as a program is one rank: ``python
tests/test_torch_mesh.py <rank> <world> <init URL> <decks> <out>
[device [replicas]]``, the device cpu, or cuda:0 for
tests/test_torch_gpu_runs.py's ranks sharing a card); the parametrised
cases assert on what they saved.
Every multi-process case has its own timeout. JAX is imported only by the
case that runs it, so that a rank imports torch alone.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from maniac_tpu_torch import load_system, replicate, run_block_replicated
from maniac_tpu_torch.kernels import build, dispatch_report, use_block_kernel
from maniac_tpu_torch.parallel.mesh import (INIT_TIMEOUT, Mesh,
                                            gather_mean_population,
                                            gather_replica_stats, make_mesh,
                                            replicate_spec,
                                            run_block_sharded, run_ranks,
                                            shard_replicas)
from maniac_tpu_torch.system import E_TOT
from maniac_tpu_torch.systems import make_lj_gas, tiny_system
from maniac_tpu_torch.utils import trace
from maniac_tpu_torch.utils.logger import NullLogger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("lj", "flagship", "mixed", "resv", "tricl")
WORLDS = (1, 2, 4)
# tests/test_cli_and_parallel.py::test_mesh_sharded_replicas's block
N_REPLICAS, N_STEPS = 16, 60
# steps of rank 0's K2 check on a card
CHECK_STEPS = 50
FIELDS = ("n_mol", "counters", "energy", "pos", "com", "key", "amp_re",
          "amp_im", "res_n", "extras", "trans_step", "rot_step")
# seconds all the ranks of the fixture (or of one launcher run) may take
RANKS_TIMEOUT = 240
# the public collectives of torch.distributed, counted in the ranks
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_gather_object",
               "all_reduce", "all_to_all", "all_to_all_single", "barrier",
               "broadcast", "broadcast_object_list", "gather",
               "gather_object", "irecv", "isend", "recv", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "scatter",
               "scatter_object_list", "send")


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


def _write_decks(root):
    """The five shapes' files under root/<shape>: the LJ gas of
    test_cli_and_parallel.py's lj_system and systems.tiny_system's four."""
    os.makedirs(f"{root}/lj")
    make_lj_gas(f"{root}/lj", n=16, L=16.0, probs=(0.5, 0.0, 0.5, 0.0),
                fugacity=60.0, cutoff=6.0, tol=1e-3)
    for shape in SHAPES[1:]:
        os.makedirs(f"{root}/{shape}")
        tiny_system(f"{root}/{shape}", shape)


def _files(root, shape):
    d = f"{root}/{shape}"
    res = f"{d}/reservoir.data" if shape == "resv" else None
    return ((f"{d}/input.maniac", f"{d}/topology.data",
             f"{d}/parameters.inc"), res)


def _load(root, shape, device="cpu"):
    """A shape in f64 on the CPU, in f32 (the kernels' dtype) on a card."""
    files, res = _files(root, shape)
    return load_system(*files, reservoir_file=res,
                       capacity=None if shape == "lj" else 16,
                       dtype=torch.float64 if torch.device(device).type
                       == "cpu" else torch.float32, device=device,
                       logger=NullLogger())


def _count_collectives() -> dict:
    """Wrap every collective of torch.distributed with a counter; returns
    {name: calls}."""
    counts = {}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name in COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, wrap(name, getattr(dist, name)))
    return counts


def _fields(st, names=FIELDS):
    """The named fields of a state, on the host."""
    return {f: getattr(st, f).cpu() for f in names}


def _card_checks(mesh, spec, states):
    """Rank 0's kernel runs on a card: where K2 takes the spec, K2 and the
    plain steps on the same uniforms for CHECK_STEPS steps; one sharded
    block with the resync, the resync's launches in it, and the plain
    resync of its result."""
    from maniac_tpu_torch.kernels.blockg import run_block_kernel
    from maniac_tpu_torch.kernels.resync import resync_plain
    from maniac_tpu_torch.mc.driver import draw_uniforms, steps_plain
    every = list(vars(states))
    out = {}
    if use_block_kernel(spec, mesh.device):
        st, u = draw_uniforms(spec, states, CHECK_STEPS)
        out["block"] = (_fields(run_block_kernel(spec, st, u), every),
                        _fields(steps_plain(spec, st, u), every))
    n0 = trace.counters()
    rs = run_block_sharded(mesh, spec, states, N_STEPS, False, resync=True)
    out["resync_launches"] = build.launch_counts(n0)["resync"]
    out["resync"] = (_fields(rs, every), _fields(resync_plain(spec, rs),
                                                 every))
    return out


def _rank_main(rank, world, init, decks, out, device="cpu",
               n_replicas=N_REPLICAS):
    """One rank: every shape sharded over the world at ``n_replicas``, one
    block of N_STEPS, the gathered statistics and the collectives made in
    the block and in the gather; a world of 1 also runs the unsharded
    reference (replicate + run_block_replicated + gather_replica_stats
    without a mesh). On a card also each block's kernel launches and the
    dispatch, and rank 0's _card_checks. Saved to out/w<world>_r<rank>.pt."""
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=INIT_TIMEOUT)
    try:
        counts = _count_collectives()
        mesh = make_mesh(world, device=device)
        saved = {}
        for shape in SHAPES:
            sysm = _load(decks, shape, mesh.device)
            spec = replicate_spec(mesh, sysm.spec)
            states = shard_replicas(mesh, spec, sysm.state, n_replicas)
            counts.clear()
            n0 = trace.counters()
            states = run_block_sharded(mesh, spec, states, N_STEPS, False)
            launches = build.launch_counts(n0)
            in_block = sum(counts.values())
            stats = [t.cpu() for t in gather_replica_stats(
                states, spec.R, E_TOT, mesh=mesh)]
            row = {"span": mesh.span(n_replicas),
                   "state": _fields(states),
                   "stats": stats,
                   "collectives": (in_block,
                                   sum(counts.values()) - in_block)}
            if world == 1:
                ref = run_block_replicated(
                    spec, replicate(spec, sysm.state, n_replicas), N_STEPS,
                    False)
                row["ref"] = _fields(ref)
                row["ref_stats"] = [t.cpu() for t in gather_replica_stats(
                    ref, spec.R, E_TOT)]
            if device != "cpu":
                row["launches"] = launches
                row["dispatch"] = dispatch_report(spec, mesh.device)
                if rank == 0:
                    row["checks"] = _card_checks(mesh, spec, states)
            saved[shape] = row
        torch.save(saved, f"{out}/w{world}_r{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of _rank_main, every
    world's ranks spawned together; and the decks' root."""
    root = tmp_path_factory.mktemp("mesh")
    decks, out = str(root / "decks"), str(root / "out")
    _write_decks(decks)
    os.makedirs(out)
    argvs = [[sys.executable, os.path.abspath(__file__), str(r), str(w),
              f"file://{root}/rendezvous_{w}", decks, out]
             for w in WORLDS for r in range(w)]
    ranks = run_ranks(argvs, RANKS_TIMEOUT, env=_env())
    bad = [(argv[2:4], rc, text) for argv, (rc, text) in zip(argvs, ranks)
           if rc != 0]
    assert not bad, bad
    return decks, {w: [torch.load(f"{out}/w{w}_r{r}.pt") for r in range(w)]
                   for w in WORLDS}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_block_equals_unsharded(mesh_runs, world, shape):
    """Every rank's replicas, after one sharded f64 block, are its slice of
    one unsharded run_block_replicated bit for bit (populations, counters,
    energies, positions, keys and the rest of the state), and every rank's
    gathered statistics are the unsharded gather_replica_stats exactly."""
    _, runs = mesh_runs
    assert_sharded_equals_unsharded(runs, world, shape)


def assert_sharded_equals_unsharded(runs, world, shape):
    """test_sharded_block_equals_unsharded's assertions on the saved
    ranks ``runs`` ({world: [rank 0's saved results, ...]}, world 1
    among them)."""
    ref = runs[1][0][shape]
    n_replicas = ref["ref"]["key"].shape[0]
    spans = []
    for rank, saved in enumerate(runs[world]):
        got = saved[shape]
        lo, hi = got["span"]
        spans.append((lo, hi))
        for f in FIELDS:
            assert torch.equal(got["state"][f], ref["ref"][f][lo:hi]), \
                (world, rank, f)
        for a, b in zip(got["stats"], ref["ref_stats"]):
            assert torch.equal(a, b), (world, rank)
    n = n_replicas // world
    assert spans == [(r * n, (r + 1) * n) for r in range(world)]
    # the chains differ: each replica has its own key
    assert len({tuple(k) for k in ref["ref"]["key"].tolist()}) == n_replicas


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_block_makes_no_collective(mesh_runs, shape):
    """The design claim of the JAX package's HLO test, counted in the
    port: run_block_sharded makes no torch.distributed collective call on
    any rank of any world (a world of 1 has a gloo group here too), and
    the statistics' gather makes exactly one."""
    _, runs = mesh_runs
    for world in WORLDS:
        for rank, saved in enumerate(runs[world]):
            assert saved[shape]["collectives"] == (0, 1), (world, rank)


def test_sharded_block_matches_jax(mesh_runs):
    """The port's world-2 block on the LJ gas against JAX's
    run_block_sharded over conftest's 8 virtual devices (the setup of
    test_cli_and_parallel.py::test_mesh_sharded_replicas, f64, 16
    replicas, 60 steps, one seed): the same populations per replica,
    energies within 1e-9 relative, the statistics within 1e-9."""
    import jax
    import maniac_tpu
    from maniac_tpu.parallel.mesh import gather_replica_stats as jax_stats
    from maniac_tpu.parallel.mesh import make_mesh as jax_mesh
    from maniac_tpu.parallel.mesh import replicate_spec as jax_rspec
    from maniac_tpu.parallel.mesh import run_block_sharded as jax_block
    from maniac_tpu.parallel.mesh import shard_replicas as jax_shard
    from maniac_tpu.parallel.replicas import replicate as jax_replicate

    decks, runs = mesh_runs
    assert len(jax.devices()) >= 8
    files, _ = _files(decks, "lj")
    sysm = maniac_tpu.load_system(*files)
    mesh = jax_mesh(8)
    states = jax_shard(mesh, jax_replicate(sysm.spec, sysm.state,
                                           N_REPLICAS))
    states = jax_block(mesh, jax_rspec(mesh, sysm.spec), states, N_STEPS,
                       False)
    port = {f: torch.cat([s["lj"]["state"][f] for s in runs[2]]).numpy()
            for f in ("n_mol", "energy")}
    np.testing.assert_array_equal(port["n_mol"], np.asarray(states.n_mol))
    e_jax = np.asarray(states.energy)
    scale = np.maximum(1.0, np.abs(e_jax).max(axis=1, keepdims=True))
    assert np.all(np.abs(port["energy"] - e_jax) <= 1e-9 * scale)
    for a, b in zip(runs[2][0]["lj"]["stats"],
                    jax_stats(states, sysm.spec.R, E_TOT)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)


def _lj_small(d):
    """tests/test_cli_and_parallel.py's launcher system."""
    make_lj_gas(d, n=8, L=16.0, probs=(0.4, 0.0, 0.6, 0.0), fugacity=50.0,
                cutoff=6.0, tol=1e-3)
    return ["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data", "-p",
            f"{d}/parameters.inc"]


def _launcher_argv(files, extra):
    return ([sys.executable, "-m", "maniac_tpu_torch.tools.launch_multihost",
             "--platform", "cpu", *files, "--blocks", "2", "--steps", "40",
             "--seed", "77"] + extra)


def test_multihost_launcher_smoke(tmp_path, capsys):
    """The launcher in this process at --num-processes 1 --platform cpu
    (no process group): the header, a dispatch line, two block lines and
    the rate."""
    from maniac_tpu_torch.tools.launch_multihost import main
    files = _lj_small(str(tmp_path))
    assert main(["--num-processes", "1", "--platform", "cpu", *files,
                 "--replicas-per-device", "2", "--blocks", "2", "--steps",
                 "40"]) == 0
    out = capsys.readouterr().out
    assert "# 1 process(es), 1 global devices, B=2 replicas" in out
    assert "plain torch path (device cpu)" in out
    assert len([ln for ln in out.splitlines()
                if ln.startswith("block")]) == 2
    assert "M aggregate steps/s" in out
    assert not dist.is_initialized()


def test_multihost_two_processes(tmp_path):
    """A real two-process launch over gloo (a file:// rendezvous) prints
    the block lines of the one-process run of the same 4 replicas, to the
    character."""
    files = _lj_small(str(tmp_path / "sys"))
    coord = ["--coordinator", f"file://{tmp_path}/rendezvous",
             "--num-processes", "2"]
    argvs = [_launcher_argv(files, ["--replicas-per-device", "4"]),
             _launcher_argv(files, coord + ["--process-id", "0",
                                            "--replicas-per-device", "2"]),
             _launcher_argv(files, coord + ["--process-id", "1",
                                            "--replicas-per-device", "2"])]
    (rc_ref, ref), (rc0, two), (rc1, other) = run_ranks(
        argvs, RANKS_TIMEOUT, env=_env(), cwd=REPO)
    assert rc_ref == rc0 == rc1 == 0, (ref, two, other)
    assert "2 process(es), 2 global devices, B=4" in two, two
    assert other == ""

    def blocks(text):
        return [ln for ln in text.splitlines() if ln.startswith("block")]
    assert len(blocks(ref)) == 2
    assert blocks(two) == blocks(ref)


def test_launcher_refuses_without_cuda(tmp_path, capsys):
    """Without --platform cpu the launcher runs on the card; with no card it
    exits 1 and runs nothing (no fallback to the host)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from maniac_tpu_torch.tools.launch_multihost import main
    assert main(_lj_small(str(tmp_path))) == 1
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err
    assert "block" not in captured.out


def test_dryrun_multichip():
    """entry.dryrun_multichip(2): two gloo ranks run every execution
    regime's tiny shape sharded at 4 replicas."""
    from maniac_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2)


def test_entry_step(tmp_path):
    """entry(): fn(state, key) is one MC step on the flagship (f32, capacity
    128) from uniforms drawn from the key; the same key gives the same
    step, another key another draw."""
    from maniac_tpu_torch.entry import entry
    from maniac_tpu_torch.utils.threefry import prng_key
    fn, (state, key) = entry(device="cpu")
    assert state.pos.dtype == torch.float32 and tuple(key.shape) == (1, 2)
    a, b = fn(state, key), fn(state, key)
    assert int(a.counters.sum()) == int(state.counters.sum()) + 1
    assert torch.equal(a.pos, b.pos) and torch.equal(a.key, b.key)
    c = fn(state, prng_key(1)[None])
    assert not torch.equal(a.key, c.key)


def test_mesh_without_a_group(tmp_path):
    """With no process group the mesh is a world of 1: its shard is
    replicate's state, the block run_block_replicated's, the gathered
    statistics the single-device ones, and the mean population theirs."""
    files = _lj_small(str(tmp_path))
    sysm = load_system(*files[1::2], dtype=torch.float64, device="cpu",
                       logger=NullLogger())
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    spec = replicate_spec(mesh, sysm.spec)
    states = shard_replicas(mesh, spec, sysm.state, 6)
    ref = replicate(spec, sysm.state, 6)
    for f in FIELDS:
        assert torch.equal(getattr(states, f), getattr(ref, f)), f
    states = run_block_sharded(mesh, spec, states, 20, True)
    ref = run_block_replicated(spec, ref, 20, True)
    assert torch.equal(states.pos, ref.pos)
    for a, b in zip(gather_replica_stats(states, spec.R, E_TOT, mesh=mesh),
                    gather_replica_stats(ref, spec.R, E_TOT)):
        assert torch.equal(a, b)
    mean_n = gather_mean_population(mesh, states, spec.R)
    assert torch.equal(mean_n, ref.n_mol[:, :spec.R].double().mean(dim=0))


def test_mesh_refusals():
    """A replica count the world does not divide, a device count that is
    not the world size, a block on another device than the rank's, and
    the default device without a card all raise."""
    with pytest.raises(ValueError, match="do not split evenly"):
        Mesh(None, 1, 4, torch.device("cpu")).span(18)
    assert Mesh(None, 3, 4, torch.device("cpu")).span(16) == (12, 16)
    with pytest.raises(ValueError, match="the world has 1"):
        make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    mesh = Mesh(None, 0, 1, torch.device("cuda", 0))
    with tempfile.TemporaryDirectory() as tmp:
        sysm = load_system(*_lj_small(tmp)[1::2], device="cpu",
                           logger=NullLogger())
    with pytest.raises(ValueError, match="rank's device cuda:0"):
        run_block_sharded(mesh, sysm.spec, sysm.state, 1, False)


def test_run_ranks_kills_what_outlives_it():
    """run_ranks returns each rank's exit code and output; a rank that
    fails ends the others at once, and at the timeout the ranks still
    running are killed (exit code None)."""
    py = sys.executable
    ok = run_ranks([[py, "-c", "print('a')"], [py, "-c", "print('b')"]], 60)
    assert ok == [(0, "a\n"), (0, "b\n")]
    failed = run_ranks([[py, "-c", "raise SystemExit(3)"],
                        [py, "-c", "import time; time.sleep(60)"]], 60)
    assert failed[0][0] == 3 and failed[1][0] not in (0, None)
    late = run_ranks([[py, "-c", "import time; time.sleep(60)"]], 1)
    assert late == [(None, "")]


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7],
                        *map(int, sys.argv[7:])))
