"""Wall times of the command line's isotherm and single chain on the card,
run after run within one process, and where each run's time goes, so that
two trees of the package are timed alike.

    python -m maniac_tpu_torch.tools.cli_times [--runs 3] [--profile]
        [--top 0] [--smoke]

The decks are chip_smoke.py's phases 5 and 6: the flagship
(make_zif_like(n_cells=6, a=5.66, n_water=32, fugacity=30), capacity 192,
f32), as an isotherm (8 fugacities 1-3000 atm x 128 replicas, 3 blocks of
400 steps) and as a single chain (2 blocks of 400 steps). Each run calls
``maniac_tpu_torch.cli.main`` bracketed by ``torch.cuda.synchronize()``,
as chip_smoke.py's ``_cli`` does; the runs alternate, isotherm then chain,
``--runs`` times, so the first of each is the process's cold start. A line
a run: its seconds and MC steps/s (load included). With ``--profile`` the
runs go under cProfile (which slows them) and the line adds the
cumulative seconds of ``api.load_system``, of the blocks
(``run_block_sweep``, or ``block_body_u`` and the chain's energy refresh
``mc/driver.resync``) and of the rest (set-up, writes, logging). Where the
host waits for the card moves between these with the code, so compare
the whole run first. ``--top N`` adds each profiled run's N functions of
most own time.

``--smoke`` times the command line where chip_smoke.py times it, inside
its process after its earlier phases: it runs chip_smoke.py's ``main``
from the current directory (a tree's root), and each command-line call of
it (``_cli``: phases 5, 6, 7h, 9f, 10) is followed by a warm rerun and a
profiled rerun, each a line as above (the kernels' launch counters put
back, so chip_smoke.py's checks see its own calls only).

The file imports only the command line, the fixtures, the kernels'
wrappers and (with ``--smoke``) chip_smoke.py, so a copy of it in an
earlier tree times that tree the same way.
"""

from __future__ import annotations

import argparse
import cProfile
import contextlib
import io
import os
import pstats
import sys
import tempfile
import time

import torch

from . import card_label, require_cuda
from .kernel_times import ISOTHERM_FUGACITIES, ISOTHERM_REPLICAS

CAPACITY, STEPS, ISO_BLOCKS, CHAIN_BLOCKS = 192, 400, 3, 2
# (file suffix, function) whose cumulative time is each column
SPANS = {
    "load": (("api.py", "load_system"),),
    "blocks": (("replicas.py", "run_block_sweep"),
               ("driver.py", "block_body_u"), ("driver.py", "resync")),
}


def _decks(tmp: str) -> dict:
    """{"isotherm" | "chain": (argv, MC steps)} on the flagship decks."""
    from ..systems import make_zif_like
    out = {}
    for name, blocks in (("isotherm", ISO_BLOCKS), ("chain", CHAIN_BLOCKS)):
        d = f"{tmp}/{name}"
        make_zif_like(d, n_cells=6, a=5.66, n_water=32, fugacity=30.0,
                      nb_block=blocks, nb_step=STEPS)
        argv = ["-i", f"{d}/input.maniac", "-d", f"{d}/topology.data",
                "-p", f"{d}/parameters.inc", "--capacity", str(CAPACITY)]
        steps = blocks * STEPS
        if name == "isotherm":
            argv += ["--isotherm", ",".join(f"{f:g}" for f in
                                            ISOTHERM_FUGACITIES),
                     "--replicas", str(ISOTHERM_REPLICAS)]
            steps *= len(ISOTHERM_FUGACITIES) * ISOTHERM_REPLICAS
        out[name] = (argv, steps)
    return out


def _span(stats: pstats.Stats, keys) -> float:
    """Cumulative seconds of the outermost calls of the named functions."""
    total = 0.0
    def listed(path, func):
        return any(path.endswith(f) and func == fn for f, fn in keys)

    for (path, _, func), (_, _, _, cum, callers) in stats.stats.items():
        if listed(path, func):
            # the calls from another listed function are already counted
            total += cum - sum(v[3] for c, v in callers.items()
                               if listed(c[0], c[2]))
    return total


def run_once(argv, outdir: str, profile: bool) -> tuple:
    """(seconds, pstats.Stats or None) of one cli.main call, its log to a
    file."""
    from ..cli import main as cli_main
    prof = cProfile.Profile() if profile else None
    with open(f"{outdir}.stdout", "w") as f, contextlib.redirect_stdout(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        rc = cli_main(argv + ["-o", outdir])
        torch.cuda.synchronize()
        if prof:
            prof.disable()
        sec = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli_times: the command line exited {rc}")
    return sec, pstats.Stats(prof) if prof else None


def _line(name: str, sec: float, steps, stats, top: int, label: str):
    split = ""
    if stats:
        spans = {k: _span(stats, v) for k, v in SPANS.items()}
        split = (f"; profiled: load {spans['load']:.4f} s, blocks "
                 f"{spans['blocks']:.4f} s, rest "
                 f"{sec - sum(spans.values()):.4f} s")
    rate = f", {steps / sec:.0f} MC steps/s (load included)" if steps else ""
    print(f"cli_times: {name}: {sec:.4f} s{rate}{split} ({label})",
          flush=True)
    if stats and top:
        buf = io.StringIO()
        stats.stream = buf
        stats.sort_stats("tottime").print_stats(top)
        for line in buf.getvalue().splitlines():
            if line.strip() and line.lstrip()[0].isdigit():
                print(f"cli_times:   {line.strip()}")


def smoke(top: int, label: str) -> int:
    """chip_smoke.py's main from the current directory, each command-line
    call followed by a warm and a profiled rerun."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from ..utils import trace
    timed = chip_smoke._cli

    def cli(argv, outdir):
        rc, sec, log = timed(argv, outdir)
        counts = trace.counters()
        name = os.path.basename(outdir)
        _line(f"smoke {name}", sec, None, None, 0, label)
        for tag, profile in (("warm", False), ("profiled", True)):
            s, stats = run_once(argv, f"{outdir}_{tag}", profile)
            _line(f"smoke {name} {tag}", s, None, stats, top, label)
        # the reruns' counts taken back: chip_smoke's launch checks count
        # the timed call's alone
        for k, n in trace.since(counts).items():
            trace.count(k, -n)
        return rc, sec, log

    chip_smoke._cli = cli
    return chip_smoke.main()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cli_times",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="each run under cProfile, with its split")
    ap.add_argument("--top", type=int, default=0,
                    help="also each profiled run's N functions of most own "
                         "time")
    ap.add_argument("--smoke", action="store_true",
                    help="rerun chip_smoke.py's command-line calls in its "
                         "process")
    args = ap.parse_args(argv)
    if not require_cuda("cli_times"):
        return 1
    label = card_label()
    if args.smoke:
        return smoke(args.top, label)
    with tempfile.TemporaryDirectory() as tmp:
        decks = _decks(tmp)
        for run in range(args.runs):
            for name, (cmd, steps) in decks.items():
                sec, stats = run_once(cmd, f"{tmp}/{name}_out{run}",
                                      args.profile)
                _line(f"{name} run {run}", sec, steps, stats, args.top,
                      label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
