"""The framework rehearsal: the comparison on a charged framework with
guests in a non-cubic orthorhombic box. Not a configuration of
BENCHMARK.json: a fixture that the tests write, in the residue form of
writers/residues.py, and run through run.find_cell and run.run with an
in-memory benchmark.

The framework is one frozen molecule: a cage of ten charged sites at the
centre of each cell of a lattice (eight cube corners at +-0.45 e, two
axial sites at +-0.3 e, two LJ kinds), net neutral, so that the program's
framework split holds a far table. ``fw_water`` adds SPC/E water;
``fw_mixed`` adds TraPPE CO2 too, with swaps. ``full`` is the card's
size (6 x 7 x 5 cells, 2,100 frozen sites, the 10 A cutoff, water at its
vapour pressure, 0.0313 atm at 298 K, CO2 at 10 atm), ``small`` the
CPU's (2 x 3 x 2 cells, a 5 A cutoff, water at 30 atm, so that its few
guests do not leave the box and every replica moves in each block).

    python -m portbench.tests.framework --variants fw_water,fw_mixed \\
        --seeds 1,2 --control-seeds 3 --seconds 10 [--out <file>]

runs each variant at the card's size in the ``replicas`` traffic (1024
replicas, 400-step blocks): one whole run a seed of ``--seeds``, and the
control (control.py: ref/ in bfloat16 in the program's place) a seed of
``--control-seeds``, each reading a JSON line, as control.py prints them.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

from portbench import run

PKG = run.PKG
CELL_A = 6.5             # the lattice's cell edge
SIZES = {"full": {"cells": (6, 7, 5), "cutoff_A": 10.0, "capacity": 512,
                  "molecules": (24, 12), "fugacity_atm": (0.0313, 10.0),
                  "traffic": "replicas"},
         "small": {"cells": (2, 3, 2), "cutoff_A": 5.0, "capacity": 16,
                   "molecules": (4, 2), "fugacity_atm": (30.0, 10.0),
                   "traffic": "tiny_replicas"}}
TINY_REPLICAS = {"driver": "replicas", "replicas": 4, "steps_per_block": 40,
                 "resync": True, "judged_replicas": 4, "judged_blocks": 1}
# the main cell's limits: the rehearsal shows the framework inside them
LIMITS = run.read_json(PKG / "limits" / "spce750.replicas.json")["limits"]
VARIANTS = ("fw_water", "fw_mixed")


def cage():
    """(sites, q_e, offsets) of one cell's cage: net neutral."""
    corners = [(sx, sy, sz) for sx in (-1.1, 1.1) for sy in (-1.1, 1.1)
               for sz in (-1.1, 1.1)]
    q = [0.45 if (i + j + k) % 2 else -0.45 for i in range(2)
         for j in range(2) for k in range(2)]
    return (["Fa"] * 8 + ["Fb"] * 2, q + [0.3, -0.3],
            corners + [(0.0, 0.0, 1.9), (0.0, 0.0, -1.9)])


def framework(cells) -> tuple[dict, tuple]:
    """(the frozen residue, the box) of a lattice of ``cells`` cages."""
    names, q, offsets = cage()
    box = tuple(n * CELL_A for n in cells)
    geo = []
    for i in range(cells[0]):
        for j in range(cells[1]):
            for k in range(cells[2]):
                c = [-b / 2 + (x + 0.5) * CELL_A
                     for b, x in zip(box, (i, j, k))]
                geo += [[c[0] + o[0], c[1] + o[1], c[2] + o[2]]
                        for o in offsets]
    n = len(geo) // len(names)
    kind = {"Fa": (30.0, 3.0, 30.0), "Fb": (60.0, 3.3, 14.0)}
    return {"name": "cage", "frozen": True, "sites": names * n,
            "q_e": q * n, "eps_K": [kind[s][0] for s in names] * n,
            "sigma_A": [kind[s][1] for s in names] * n,
            "mass": [kind[s][2] for s in names] * n,
            "geometry_A": geo}, box


def water(molecules: int, fugacity: float) -> dict:
    """SPC/E as spce750 states it."""
    model = run.read_json(PKG / "configs" / "spce750.json")["model"]
    half = math.radians(model["angle_HOH_deg"]) / 2
    r = model["r_OH_A"]
    return {"name": "wat", "frozen": False, "sites": ["OW", "HW", "HW"],
            "q_e": model["q_e"], "eps_K": model["eps_K"],
            "sigma_A": model["sigma_A"], "mass": model["mass"],
            "geometry_A": [[0.0, 0.0, 0.0],
                           [r * math.sin(half), 0.0, r * math.cos(half)],
                           [-r * math.sin(half), 0.0, r * math.cos(half)]],
            "fugacity_atm": fugacity, "molecules": molecules}


def co2(molecules: int, fugacity: float) -> dict:
    """TraPPE CO2 (Potoff and Siepmann, AIChE J. 47, 1676, 2001)."""
    return {"name": "co2", "frozen": False, "sites": ["CC", "OC", "OC"],
            "q_e": [0.7, -0.35, -0.35], "eps_K": [27.0, 79.0, 79.0],
            "sigma_A": [2.8, 3.05, 3.05], "mass": [12.011, 15.999, 15.999],
            "geometry_A": [[0.0, 0.0, 0.0], [1.16, 0.0, 0.0],
                           [-1.16, 0.0, 0.0]],
            "fugacity_atm": fugacity, "molecules": molecules}


def config(variant: str, size: str) -> dict:
    s = SIZES[size]
    fw, box = framework(s["cells"])
    guests = [water(s["molecules"][0], s["fugacity_atm"][0])]
    probs = [0.3, 0.2, 0.5, 0.0]
    if variant == "fw_mixed":
        guests.append(co2(s["molecules"][1], s["fugacity_atm"][1]))
        probs = [0.3, 0.2, 0.3, 0.2]
    return {"writer": "residues",
            "writer_args": {"box_A": list(box), "cutoff_A": s["cutoff_A"],
                            "ewald_tolerance": 1e-05, "temp_K": 298.0,
                            "move_probabilities": probs,
                            "clearance_A": 2.2},
            "residues": [fw] + guests,
            "capacity": s["capacity"], "dtype": "float32"}


def cell_name(variant: str, size: str) -> str:
    return f"{variant}_{size}.{SIZES[size]['traffic']}"


def make_copy(root: Path, size: str, limits=None) -> tuple[Path, dict]:
    """The benchmark's files under ``root`` with the rehearsal's
    configurations, traffic and limits added as new files, and the
    in-memory benchmark that names its cells (BENCHMARK.json's own and
    the rehearsal's); nothing that was there is edited."""
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = run.read_json(PKG.parent / "BENCHMARK.json")
    (root / PKG.name / "traffic" / "tiny_replicas.json").write_text(
        json.dumps(TINY_REPLICAS))
    for variant in VARIANTS:
        name = f"{variant}_{size}"
        (root / PKG.name / "configs" / f"{name}.json").write_text(
            json.dumps(config(variant, size)))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"{PKG.name}/configs/{name}.json",
                                 "reduced": [], "why": "rehearsal"})
        cell = cell_name(variant, size)
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": SIZES[size]["traffic"],
                                   "chips": 1, "why": "rehearsal"})
        (root / PKG.name / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": limits or LIMITS}))
    return root, bench


def main(argv=None) -> int:
    from portbench import control
    p = argparse.ArgumentParser(prog="python -m portbench.tests.framework")
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.tests.framework: no CUDA device", file=sys.stderr)
        return 1
    tmp = Path(tempfile.mkdtemp(prefix="portbench-framework-"))
    out = open(args.out, "a") if args.out else None
    try:
        root, bench = make_copy(tmp, "full")

        def emit(line):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
        for variant in args.variants.split(","):
            cell = cell_name(variant, "full")
            for seed in [int(s) for s in args.seeds.split(",") if s]:
                res = run.run(SimpleNamespace(workload=cell, seed=seed,
                                              seconds=args.seconds, trace=0),
                              root=root, bench=bench)
                emit({"workload": cell, "side": "program", "seed": seed,
                      "correct": res["correct"],
                      "readings": {k: c["value"]
                                   for k, c in res["checks"].items()},
                      "mc_steps_per_s": res["metrics"]["mc_steps_per_s"]
                      ["value"],
                      "memory_peak_bytes":
                      res["device"]["memory_peak_bytes"]})
            for seed in [int(s) for s in args.control_seeds.split(",")
                         if s]:
                emit({"workload": cell, "side": "control", "seed": seed,
                      "dtype": str(control.CONTROL_DTYPE),
                      "readings": control.control_readings(
                          cell, seed, "cuda", root=root, bench=bench)})
    finally:
        if out:
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
