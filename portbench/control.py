"""The readings that a cell's limits are set from: the program's sound
runs and the control's, on the card at the cell's own size.

    python -m portbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--out <file>]

For each of ``--seeds`` one whole run of the cell (run.run, the window
``--seconds`` long) gives the program's readings. For each of
``--control-seeds`` the program is set up and runs a short window (the
warm-up, two blocks and the judged blocks, the cell's own load); then
the control, ref/ computed in bfloat16 (the precision below the
configuration's float32), is put in the program's place: its loaded
energy row, and its run of each judged block from the program's state
before it on the same uniforms, are judged by the same numbers as the
program's. Each reading
is one JSON line on standard output (and in ``--out``). The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from types import SimpleNamespace

import torch

from . import compare, program, run
from .ref import driver as ref

CONTROL_DTYPE = torch.bfloat16
CONTROL_BLOCKS = 2      # blocks before the judged ones, the warm-up's among them


def control_readings(workload: str, seed: int, device, root=run.ROOT,
                     blocks: int = CONTROL_BLOCKS, bench=None) -> dict:
    """The control's numbers for one seed (``bench`` None reads ``root``'s
    BENCHMARK.json)."""
    if bench is None:
        bench = run.read_json(root / "BENCHMARK.json")
    cell, _, config, traffic, _ = run.find_cell(bench, workload, root)
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        files, arrays = run.write_files(config, seed, tmp, root)
        ctx = SimpleNamespace(files=files, config=config, traffic=traffic,
                              seed=seed, device=torch.device(device))
        driver = run.load_module(root / run.PKG.name / "drivers"
                                 / f"{traffic['driver']}.py",
                                 traffic["driver"])
        drv = driver.Driver(ctx)
        judged = int(traffic["judged_blocks"])
        recent = []
        for _ in range(blocks + judged):
            drv.block(run.trace.Tracer(False).span)
            recent = (recent + [drv.pre])[-judged:]
        program.sync()
        reference = compare.Reference(files, arrays, config, seed,
                                      ctx.device)
        idx = compare.sample_rows(seed, drv.B,
                                  int(traffic["judged_replicas"]))
        end = drv.end_of_block
        pres = [compare.detached(pre, idx) for pre in recent]
        del drv, recent
        candidate = []
        for pre_rows in pres:
            _, u = ref.draw(pre_rows.key, int(traffic["steps_per_block"]),
                            reference.dtype)
            candidate.append((pre_rows, u, reference.replay(
                pre_rows, u, end, CONTROL_DTYPE)))
        loaded = reference.candidate_loaded(CONTROL_DTYPE)
        return compare.readings(reference, loaded, candidate, idx, end)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 1
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        def emit(line):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
        for seed in seeds:
            res = run.run(SimpleNamespace(workload=args.workload, seed=seed,
                                          seconds=args.seconds, trace=0))
            emit({"workload": args.workload, "side": "program",
                  "seed": seed, "correct": res["correct"],
                  "readings": {k: c["value"]
                               for k, c in res["checks"].items()},
                  "mc_steps_per_s": res["metrics"]["mc_steps_per_s"]
                  ["value"]})
        for seed in controls:
            emit({"workload": args.workload, "side": "control",
                  "dtype": str(CONTROL_DTYPE), "seed": seed,
                  "readings": control_readings(args.workload, seed,
                                               "cuda")})
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
