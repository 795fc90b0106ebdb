"""maniac_tpu_torch's runs on a card: the command line, the tools' entry
points and subprocesses, the mesh, the validation anchors and the bench,
each with the kernel launches it must make. Every test here needs a CUDA
device and skips without one.

The file imports no jax (the machine with the card has none), so it runs
without the suite's conftest:

    python -m pytest tests/test_torch_gpu_runs.py --noconftest -q
"""

import contextlib
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

import test_torch_mesh as mesh_tests
from test_torch_gpu import _amp_check, _block_check, _recip
from maniac_tpu_torch import load_system, replicate, run_block_replicated
from maniac_tpu_torch.kernels import build
from maniac_tpu_torch.kernels.gpass import GPASS_VARIANTS
from maniac_tpu_torch.kernels.vpu import VPU_OPS
from maniac_tpu_torch.parallel.mesh import gather_replica_stats, run_ranks
from maniac_tpu_torch.system import E_TOT, SimState
from maniac_tpu_torch.systems import (make_triclinic_water, make_water_box,
                                      make_water_reservoir, make_zif_like)
from maniac_tpu_torch.tools.kernel_times import (ISOTHERM_FUGACITIES,
                                                 ISOTHERM_REPLICAS)
from maniac_tpu_torch.tools.launch_multihost import block_line
from maniac_tpu_torch.tools.resync_times import SYSTEMS
from maniac_tpu_torch.utils import trace
from maniac_tpu_torch.utils.logger import NullLogger

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the flagship deck (make_zif_like's ZIF-like framework and water) at its
# capacity, and its blocks of steps
FLAGSHIP = SYSTEMS["flagship"][1]
CAPACITY = 192
STEPS = 400
CHAIN_BLOCKS = 2
SEED = 1234
# seconds a subprocess (or a world of ranks) may take
TIMEOUT = 600


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _files(deck):
    return ["-i", f"{deck}/input.maniac", "-d", f"{deck}/topology.data",
            "-p", f"{deck}/parameters.inc"]


def _cli(argv, outdir):
    """maniac_tpu_torch.cli.main on argv with its outputs in outdir and its
    stdout sent to a file: (exit code, log.maniac's text, the kernel
    launches it made)."""
    from maniac_tpu_torch.cli import main
    n0 = trace.counters()
    with open(f"{outdir}.stdout", "w") as f, contextlib.redirect_stdout(f):
        rc = main(argv + ["-o", outdir])
    torch.cuda.synchronize()
    with open(f"{outdir}/log.maniac") as f:
        log = f.read()
    return rc, log, build.launch_counts(n0)


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f if not line.startswith("#")]


def _flagship_deck(d, blocks=CHAIN_BLOCKS):
    make_zif_like(d, **FLAGSHIP, nb_block=blocks, nb_step=STEPS)
    return _files(d) + ["--capacity", str(CAPACITY)]


def _resv_deck(d, blocks=CHAIN_BLOCKS):
    """bench.py's resv water box with its reservoir (-r)."""
    _, box, reservoir = SYSTEMS["resv"]
    make_water_box(d, nb_block=blocks, nb_step=STEPS, **box)
    return _files(d) + ["-r", make_water_reservoir(d, **reservoir),
                        "--capacity", str(CAPACITY)]


def _tricl_deck(d, blocks=CHAIN_BLOCKS):
    make_triclinic_water(d, nb_block=blocks, nb_step=STEPS,
                         **SYSTEMS["tricl"][1])
    return _files(d) + ["--capacity", str(CAPACITY)]


def test_cli_isotherm_runs_the_step_kernel(tmp_path):
    """The command line's isotherm on the flagship deck (8 fugacities x
    128 replicas, 3 blocks of 400 steps): exit 0, 8 finite rows, every
    population within [0, capacity], more water at the highest fugacity
    than at the lowest; K3 once a step, K2 never, the resync run."""
    _device()
    argv = _flagship_deck(str(tmp_path / "deck"), 3)
    out = str(tmp_path / "out")
    rc, _, launched = _cli(argv + [
        "--isotherm", ",".join(f"{f:g}" for f in ISOTHERM_FUGACITIES),
        "--replicas", str(ISOTHERM_REPLICAS)], out)
    rows = _rows(f"{out}/isotherm.dat")
    n = [float(r[2]) for r in rows]
    series = [float(v) for r in _rows(f"{out}/isotherm_wat.dat")
              for v in r[1:]]
    assert rc == 0 and len(rows) == len(ISOTHERM_FUGACITIES)
    assert all(math.isfinite(float(v)) for r in rows for v in r[1:4])
    assert all(0.0 <= v <= CAPACITY for v in n + series)
    assert n[-1] > n[0]
    assert launched["stepg"] == 3 * STEPS and launched["blockg"] == 0
    assert launched["resync"] >= 1


@pytest.mark.parametrize("deck", [_flagship_deck, _resv_deck, _tricl_deck],
                         ids=["flagship", "resv", "tricl"])
def test_cli_single_chain_runs_the_step_kernel(tmp_path, deck):
    """The command line's single chain, 2 blocks of 400 steps, on the
    flagship deck, bench.py's resv with -r and its tricl: exit 0, the
    completion banner, K3 once a step; energy.dat's 3 rows, and with -r
    reservoir.lammpstrj's 3 frames."""
    _device()
    argv = deck(str(tmp_path / "deck"))
    out = str(tmp_path / "out")
    rc, log, launched = _cli(argv, out)
    assert rc == 0 and "Simulation Completed" in log
    assert launched["stepg"] == CHAIN_BLOCKS * STEPS
    if deck is _resv_deck:
        with open(f"{out}/reservoir.lammpstrj") as f:
            assert f.read().count("ITEM: TIMESTEP") == CHAIN_BLOCKS + 1
    else:
        assert len(_rows(f"{out}/energy.dat")) == CHAIN_BLOCKS + 1


@pytest.mark.parametrize("replicas", [64, 1], ids=["replicas",
                                                   "single_chain"])
def test_cli_sentinel_finds_no_divergence(tmp_path, replicas):
    """--sentinel 1 on the flagship deck (2 blocks of 400 steps), as 64
    replicas (K2 and K1 each block) and as a single chain (K3 once a
    step): exit 0 and no divergence in the 2 cross-checked blocks."""
    _device()
    argv = _flagship_deck(str(tmp_path / "deck")) + ["--sentinel", "1"]
    if replicas > 1:
        argv += ["--replicas", str(replicas)]
    rc, log, launched = _cli(argv, str(tmp_path / "out"))
    assert rc == 0
    assert (f"sentinel: {CHAIN_BLOCKS} cross-checked blocks, 0 divergences"
            in log), log
    if replicas > 1:
        assert launched["blockg"] >= CHAIN_BLOCKS
        assert launched["resync"] >= CHAIN_BLOCKS
    else:
        assert launched["stepg"] == CHAIN_BLOCKS * STEPS


def test_cli_widom_and_resume(tmp_path):
    """The flagship deck's single chain (2 blocks of 400 steps, K3 once a
    step in every run): with --widom 256 energy.dat is the same text as
    without it, and widom.dat holds 2 finite rows (factors >= 0, a
    positive cumulative factor at the end); a 1-block run with
    --checkpoint, then --resume on the 2-block deck, writes block 2's
    energy.dat row as the uninterrupted run does."""
    _device()
    d = str(tmp_path / "chain")
    make_zif_like(d, **FLAGSHIP, nb_block=CHAIN_BLOCKS, nb_step=STEPS)
    deck, one = f"{d}/input.maniac", str(tmp_path / "one.maniac")
    with open(deck) as f:
        text = f.read()
    with open(one, "w") as f:
        f.write(text.replace(f"nb_block {CHAIN_BLOCKS}\n", "nb_block 1\n"))
    ck = str(tmp_path / "ck.npz")
    base = ["-d", f"{d}/topology.data", "-p", f"{d}/parameters.inc",
            "--capacity", str(CAPACITY), "--seed", str(SEED)]
    energy = {}
    for tag, dk, extra, blocks in (
            ("plain", deck, [], CHAIN_BLOCKS),
            ("widom", deck, ["--widom", "256"], CHAIN_BLOCKS),
            ("checkpoint", one, ["--checkpoint", ck], 1),
            ("resume", deck, ["--resume", ck], CHAIN_BLOCKS - 1)):
        out = str(tmp_path / tag)
        rc, log, launched = _cli(["-i", dk] + base + extra, out)
        assert rc == 0 and "Simulation Completed" in log, tag
        assert launched["stepg"] == blocks * STEPS, tag
        assert tag != "resume" or "Resumed" in log
        with open(f"{out}/energy.dat") as f:
            energy[tag] = f.read()
    assert energy["widom"] == energy["plain"]
    widom = _rows(f"{tmp_path}/widom/widom.dat")
    assert len(widom) == CHAIN_BLOCKS
    assert all(math.isfinite(float(v)) for r in widom for v in r[1:])
    assert all(float(r[1]) >= 0 for r in widom)
    assert float(widom[-1][2]) > 0
    plain, resumed = ([r for r in energy[t].splitlines()
                       if not r.startswith("#")] for t in ("plain", "resume"))
    assert [r.split()[0] for r in resumed] == ["0", str(CHAIN_BLOCKS)]
    assert resumed[1:] == plain[CHAIN_BLOCKS:]


def test_precision_probe_passes():
    """python -m maniac_tpu_torch.tools.precision_probe --blocks 4."""
    _device()
    proc = subprocess.run(
        [sys.executable, "-m", "maniac_tpu_torch.tools.precision_probe",
         "--blocks", "4"], cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert "RESULT: PASS" in proc.stdout, proc.stdout


# (tool, its arguments, the launch counters that must move)
TOOL_RUNS = ([("gpass_bench", [v], ("gpass",)) for v in GPASS_VARIANTS]
             + [("vpu_bench", [op], ("vpu_chain",)) for op in VPU_OPS]
             + [("vpu_bench", [f], ("cpass",)) for f in ("cpass", "cpassT")]
             + [("micro_times", ["--kernels", "K7", "--prims"],
                 ("vpu_chain", "prim_check"))])


@pytest.mark.parametrize("tool,argv,counters", TOOL_RUNS,
                         ids=["-".join([t] + [x.lstrip("-") for x in a])
                              for t, a, _ in TOOL_RUNS])
def test_micro_tool_entry_points(tool, argv, counters, capsys):
    """The micro-benchmarks' tools (K6: gpass_bench, K7 and K8:
    vpu_bench, micro_times with the primitives' exhaustive check) through
    their main: exit 0, their kernels launched."""
    _device()
    n0 = trace.counters()
    rc = importlib.import_module(f"maniac_tpu_torch.tools.{tool}").main(argv)
    launched = build.launch_counts(n0)
    assert rc == 0, capsys.readouterr().out
    for name in counters:
        assert launched[name] >= 1, launched


def _launcher(files, extra, blocks, replicas):
    return [sys.executable, "-m", "maniac_tpu_torch.tools.launch_multihost",
            *extra, "--num-processes", "1", "--replicas-per-device",
            str(replicas), *files, "--blocks", str(blocks), "--steps",
            str(STEPS), "--capacity", str(CAPACITY), "--seed", str(SEED)]


def test_launcher_on_the_card_prints_one_process_lines(tmp_path):
    """tools/launch_multihost on the flagship deck (B = 1024, 4 blocks of
    400 steps with the recalibration), at a world of 1 over NCCL and with
    no process group: each prints the block lines of run_block_replicated
    + gather_replica_stats in this process, to the character; over NCCL
    it launches K2 and T once a block."""
    dev = _device()
    deck = str(tmp_path / "deck")
    make_zif_like(deck, **FLAGSHIP)
    files = _files(deck)
    blocks, B = 4, 1024
    sysm = load_system(*files[1::2], capacity=CAPACITY, dtype=torch.float32,
                       device=dev, logger=NullLogger(), seed=SEED)
    states = replicate(sysm.spec, sysm.state, B)
    lines = []
    for b in range(1, blocks + 1):
        states = run_block_replicated(sysm.spec, states, STEPS, True)
        lines.append(block_line(b, *gather_replica_stats(
            states, sysm.spec.R, E_TOT)))
    nccl = ["--coordinator", f"file://{tmp_path}/rendezvous",
            "--process-id", "0"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in (nccl, []):
        [(rc, out)] = run_ranks([_launcher(files, extra, blocks, B)],
                                TIMEOUT, env=env, cwd=REPO)
        assert rc == 0, out
        assert [ln for ln in out.splitlines()
                if ln.startswith("block")] == lines, out
        if extra:
            assert re.search(r"launches: blockg (\d+), threefry (\d+)",
                             out).groups() == (str(blocks),) * 2, out


def _card_mesh_runs(tmp_path, n_replicas):
    """tests/test_torch_mesh.py's ranks on cuda:0 in f32 over gloo at
    ``n_replicas`` in all, worlds of 1 and 2 at once: {world: [rank 0's
    saved results, ...]}."""
    decks, out = str(tmp_path / "decks"), str(tmp_path / "out")
    mesh_tests._write_decks(decks)
    os.makedirs(out)
    worlds = (1, 2)
    argvs = [[sys.executable, mesh_tests.__file__, str(r), str(w),
              f"file://{tmp_path}/rendezvous_{w}", decks, out, "cuda:0",
              str(n_replicas)]
             for w in worlds for r in range(w)]
    ranks = run_ranks(argvs, TIMEOUT, env=mesh_tests._env())
    assert all(rc == 0 for rc, _ in ranks), ranks
    return {w: [torch.load(f"{out}/w{w}_r{r}.pt") for r in range(w)]
            for w in worlds}


def test_mesh_ranks_share_the_card_bit_for_bit(tmp_path):
    """tests/test_torch_mesh.py's ranks on cuda:0 in f32 over gloo, worlds
    of 1 and 2 at once: every rank's replicas after one sharded block are
    its slice of the unsharded run bit for bit, its statistics exactly
    the unsharded ones; each block launches T once, and K2 once where the
    dispatch names it, K3 once a step otherwise. In rank 0 of the world of
    2, K2 holds to the plain steps for 50 steps where it takes the shape
    (_block_check, at most one replica diverged), and a sharded block with
    the resync launches K1 once and holds to the plain resync
    (_amp_check)."""
    _device()
    runs = _card_mesh_runs(tmp_path, mesh_tests.N_REPLICAS)
    for shape in mesh_tests.SHAPES:
        for w in runs:
            mesh_tests.assert_sharded_equals_unsharded(runs, w, shape)
            for saved in runs[w]:
                row = saved[shape]
                kernel = "block: CUDA whole-block kernel" in row["dispatch"]
                assert row["launches"]["threefry"] == 1, row["launches"]
                assert row["launches"]["blockg"] == int(kernel)
                assert row["launches"]["stepg"] == (
                    0 if kernel else mesh_tests.N_STEPS)
        checks = runs[2][0][shape]["checks"]
        if "block" in checks:
            k, p = (SimState(**f) for f in checks["block"])
            _block_check(k, p, 1)
        assert checks["resync_launches"] == 1, shape
        k, p = (SimState(**f) for f in checks["resync"])
        _amp_check(*_recip(k), *_recip(p))


def test_mesh_ranks_take_the_whole_runs_step_form(tmp_path):
    """The mesh's ranks at twice kernels/stepg.py's CLUSTER_MAX_B replicas
    in all, so that a rank of the world of 2 holds CLUSTER_MAX_B, where
    K3 would take clusters on its own: every rank's replicas are still its
    slice of the unsharded run bit for bit (K3 takes the form of the
    run's count, one CTA a replica, on the shapes K2 does not take)."""
    from maniac_tpu_torch.kernels import stepg
    _device()
    n_replicas = 2 * stepg.CLUSTER_MAX_B
    assert stepg.cluster_size(n_replicas) != stepg.cluster_size(
        n_replicas // 2)
    runs = _card_mesh_runs(tmp_path, n_replicas)
    on_k3 = 0
    for shape in mesh_tests.SHAPES:
        for w in runs:
            mesh_tests.assert_sharded_equals_unsharded(runs, w, shape)
        on_k3 += runs[2][0][shape]["launches"]["stepg"] > 0
    assert on_k3 > 0


@pytest.mark.parametrize("path", ["block", "plain"])
def test_f32_delta_e_envelope(path):
    """tools/delta_e_report's f32 per-move dE envelope (the flagship
    chemistry, 64 replicas from seed 3, 200 steps) through K2 (200
    one-step blocks) and the plain f32 step, each accepted move's dE
    against an f64 recompute on the card: max < 5e-4 and mean < 1e-4
    kcal/mol (tests/test_precision.py's bounds) over more than 20 moves;
    the dispatch names K2 and K3, and TF32 stays off. (Through K3:
    tests/test_torch_gpu.py::test_step_kernel_f32_delta_e_envelope.)"""
    from maniac_tpu_torch.tools.delta_e_report import measure
    _device()
    n0 = trace.counters()
    rep = measure(200, 3, False, "cuda", 64, path)
    launched = build.launch_counts(n0)
    assert launched["blockg"] == (200 if path == "block" else 0)
    assert launched["stepg"] == 0
    assert rep["accepted_moves"] > 20
    assert rep["max_abs_dE_err_kcalmol"] < 5e-4, rep
    assert rep["mean_abs_dE_err_kcalmol"] < 1e-4, rep
    assert "block: CUDA whole-block kernel" in rep["dispatch"]
    assert "step: CUDA per-step kernel" in rep["dispatch"]
    assert not torch.backends.cuda.matmul.allow_tf32


def test_virial_anchor_on_the_block_kernel(tmp_path):
    """maniac_tpu_torch/virial.py's anchor (the LJ gas at z* = 0.032, T* =
    1.5, 64 replicas, 10 + 30 blocks of 150 steps, then 12 blocks of
    Widom) on K2 in f32 with the resync: <N> and the Widom factor match
    the virial values and resolve their shift from the ideal gas; K2, K1
    and T once a block."""
    from maniac_tpu_torch import virial
    from maniac_tpu_torch.kernels import use_block_kernel
    from maniac_tpu_torch.systems import make_lj_gas
    _device()
    make_lj_gas(str(tmp_path), **virial.lj_gas_kwargs())
    spec, state = virial.load(str(tmp_path), torch.float32, "cuda")
    assert use_block_kernel(spec, "cuda")
    n0 = trace.counters()
    eq = virial.equilibrate(spec, state, resync=True)
    occ = virial.occupancy(spec, eq, resync=True)
    wid = virial.widom(spec, eq, resync=True)
    launched = build.launch_counts(n0)
    blocks = virial.EQ_BLOCKS + virial.OCCUPANCY_BLOCKS + virial.WIDOM_BLOCKS
    assert occ["matches"] and occ["resolved"], occ
    assert wid["matches"] and wid["resolved"], wid
    for name in ("blockg", "resync", "threefry"):
        assert launched[name] == blocks, launched


def _sentinel_tally(log):
    """(checked blocks, divergences) from a log's sentinel summary."""
    m = re.search(r"sentinel: (\d+) cross-checked blocks, (\d+) "
                  r"divergences", log)
    assert m is not None, log
    return int(m.group(1)), int(m.group(2))


def test_examples_under_the_sentinel(tmp_path):
    """Every case of tools/run_examples.py through the command line with
    --sentinel 1 (the reference's contract, K3 once a step where the
    dispatch names it and the plain step otherwise, K2 never, a sentinel
    line each block and no SENTINEL: warning), the isotherm (K3 once a
    step, <N> within [0, 64]), then the flagship deck with --replicas 1024
    --sentinel 1 for 4 blocks (K2 once a block, K1 each block); the
    divergences of all of them within the command line's rule (cli.py:
    at most max(2, 4 x checked / 500))."""
    from maniac_tpu_torch.cli import SENTINEL_BENIGN_RATE
    from maniac_tpu_torch.tools import run_examples
    _device()
    checked = diverged = 0
    for name, (_, kw, _) in run_examples.CASES.items():
        d = str(tmp_path / name)
        argv = run_examples.case_argv(name, d, ["--sentinel", "1"])
        rc, log, launched = _cli(argv, f"{d}/outputs")
        on_k3 = "step: CUDA per-step kernel" in log
        n, k = _sentinel_tally(log)
        checked, diverged = checked + n, diverged + k
        assert run_examples.case_passed(rc, d), name
        assert launched["stepg"] == (
            kw["nb_block"] * kw["nb_step"] if on_k3 else 0), name
        assert launched["blockg"] == 0, name
        assert n == kw["nb_block"] and "SENTINEL:" not in log, name
    n0 = trace.counters()
    means = run_examples.isotherm("cuda")
    assert build.launch_counts(n0)["stepg"] == 2000 + 10 * 200
    assert all(0.0 <= m <= 64.0 for m in means), means
    blocks = 4
    d = str(tmp_path / "flagship")
    argv = _flagship_deck(d, blocks) + ["--replicas", "1024", "--sentinel",
                                        "1", "--seed", str(SEED)]
    rc, log, launched = _cli(argv, f"{d}/outputs")
    n, k = _sentinel_tally(log)
    checked, diverged = checked + n, diverged + k
    assert rc == 0 and "Simulation Completed" in log
    assert n == blocks and "SENTINEL:" not in log
    assert launched["blockg"] == blocks and launched["resync"] >= blocks
    assert diverged <= max(2.0, 4.0 * checked * SENTINEL_BENIGN_RATE), (
        checked, diverged)


def test_bench_f64_canary_takes_the_plain_path():
    """bench.run's f64 canary (zif, 64 replicas x 50 steps x 1 block, no
    hardware-precision check): every kernel gate refuses f64, so the
    dispatch names the plain path, the timed block launches T once and no
    other kernel, and its state passes the bench's check."""
    from maniac_tpu_torch import bench
    _device()
    r = bench.run("zif", "cuda", 64, 50, 1, dtype="f64", hwcheck=False,
                  log=io.StringIO())
    assert "CUDA" not in r["dispatch"], r["dispatch"]
    assert "plain torch path" in r["dispatch"], r["dispatch"]
    assert r["launches"] == {"threefry": 1, "blockg": 0, "resync": 0,
                             "stepg": 0}, r["launches"]
    assert r["state_check"] == "pass"


def test_bench_entry_point():
    """python -m maniac_tpu_torch.bench at its defaults (zif) in a
    subprocess: exit 0, and its last line a JSON object with the flagship's
    metric and both of its checks passed."""
    _device()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MANIAC_BENCH_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "maniac_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["metric"] == "port_mc_steps_per_sec_zif8_h2o", r
    assert r["hw_precision"] == "pass" and r["kernel_check"] == "pass", r
