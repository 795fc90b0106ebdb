"""A copy of the benchmark with tiny cells, for rehearsals on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]

CONFIGS = {
    "tiny_spce": {"writer": "spce_box",
                  "writer_args": {"n_water": 8, "L": 16.0, "cutoff_A": 6.0,
                                  "ewald_tolerance": 1e-05, "temp_K": 298.0,
                                  "move_probabilities": [0.3, 0.2, 0.5, 0.0],
                                  "fugacity": 4000.0},
                  "capacity": 12, "dtype": "float32"},
}
# blocks of 40 steps, so that every sound replica moves in each
# (stalled_replicas is exact)
TRAFFIC = {
    "tiny_replicas": {"driver": "replicas", "replicas": 4,
                      "steps_per_block": 40, "resync": True,
                      "judged_replicas": 4, "judged_blocks": 1},
    "tiny_chain": {"driver": "chain", "steps_per_block": 40,
                   "judged_replicas": 1, "judged_blocks": 3},
}
CELLS = (("tiny_spce", "tiny_replicas"), ("tiny_spce", "tiny_chain"))
# generous: the rehearsal checks the path, not the precision
LIMITS = {"setup_energy_rel": 1e-3, "replay_diverged": 0,
          "energy_rel": 1e-3, "amp_rel": 1e-3}


def cell_name(config: str, traffic: str) -> str:
    return f"{config}.{traffic}"


def make_copy(root: Path) -> Path:
    """The benchmark's files under ``root`` with the tiny cells added as
    new files and entries; nothing that was there is edited."""
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    model = json.loads((PKG / "configs" / "spce750.json").read_text())[
        "model"]
    for name, cfg in CONFIGS.items():
        path = root / PKG.name / "configs" / f"{name}.json"
        path.write_text(json.dumps({**cfg, "model": model}))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"{PKG.name}/configs/{name}.json",
                                 "reduced": [], "why": "rehearsal"})
    for name, mix in TRAFFIC.items():
        (root / PKG.name / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for config, traffic in CELLS:
        name = cell_name(config, traffic)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "rehearsal"})
        (root / PKG.name / "limits" / f"{name}.json").write_text(
            json.dumps({"limits": LIMITS}))
        for m in bench["per_layer"]:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
