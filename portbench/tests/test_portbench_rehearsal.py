"""The harness end to end on the CPU at tiny sizes: each driver, the
traced run, new cells found from new files, and the faults the
comparison has to catch."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.tests import tiny

SEED = 2 ** 33 + 17   # more than 32 bits, as the driver's seeds are


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def run_cell(root, cell, trace=0, seconds=0.2):
    args = SimpleNamespace(workload=cell, seed=SEED, seconds=seconds,
                           trace=trace)
    return run.run(args, root=root, device="cpu")


@pytest.mark.parametrize("config,traffic", tiny.CELLS)
def test_driver_rehearsal(copy, config, traffic):
    res = run_cell(copy, tiny.cell_name(config, traffic))
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"mc_steps_per_s", "setup_s"}
    assert res["metrics"]["mc_steps_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"


def test_traced_rehearsal(copy):
    res = run_cell(copy, tiny.cell_name("tiny_spce", "tiny_chain"), trace=1)
    assert res["correct"] is True
    assert "setup.load_s" in res["metrics"]
    assert "mc_steps_per_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries run with no file of the benchmark edited."""
    root = tiny.make_copy(tmp_path)
    pkg = run.PKG
    before = digest(pkg)
    (root / pkg.name / "metrics" / "tiny.blocks.py").write_text(
        "def read(t):\n    return float(t.blocks)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = tiny.cell_name("tiny_spce", "tiny_replicas")
    bench["per_layer"].append({"name": "tiny.blocks", "unit": "blocks",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "mc_steps_per_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, cell, trace=1)
    assert res["metrics"]["tiny.blocks"]["value"] == res["attempted"]
    after = digest(root / pkg.name)
    assert all(after[k] == v for k, v in before.items()), \
        "a file of the benchmark differs in the copy"


def _unchanged(orig):
    return lambda spec, states, *a, **k: states


def _half(orig):
    def f(spec, states, u, *a, **k):
        h = states.B // 2
        top = orig(spec, type(states)(**{n: v[:h] for n, v in
                                         vars(states).items()}),
                   u[:h], *a, **k)
        return type(states)(**{n: torch.cat([getattr(top, n), v[h:]])
                               for n, v in vars(states).items()})
    return f


def _altered(orig):
    def f(spec, states, u, *a, **k):
        out = orig(spec, states, u, *a, **k)
        pos = out.pos.clone()
        guest = spec.site_base_list[spec.active_list.index(True)]
        pos[:, 0, guest] += 0.05
        return out.replace(pos=pos)
    return f


FAULTS = {"unchanged": _unchanged, "half_batch": _half,
          "altered": _altered}
# (cell, the program function the fault replaces, faults the cell can
# have: a single chain has no half of a batch)
FAULT_CELLS = (
    (tiny.cell_name("tiny_spce", "tiny_replicas"),
     "maniac_tpu_torch.parallel.replicas", "run_block_uniforms",
     ("unchanged", "half_batch", "altered")),
    (tiny.cell_name("tiny_spce", "tiny_chain"),
     "maniac_tpu_torch.mc.driver", "run_steps_u",
     ("unchanged", "altered")),
)


@pytest.mark.parametrize("cell,module,fn,fault", [
    (c, m, f, x) for c, m, f, xs in FAULT_CELLS for x in xs])
def test_fault_is_caught(copy, monkeypatch, cell, module, fn, fault):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, fn, FAULTS[fault](getattr(mod, fn)))
    res = run_cell(copy, cell)
    assert res["correct"] is False, res["checks"]
