"""The harness end to end on the CPU at tiny sizes: each driver, the
traced run, new cells found from new files, the framework rehearsal,
the stall count over runs of judged blocks, the program's spans for the
readers that ask, and the faults the comparison has to catch."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.tests import framework, tiny

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


# blocks of a framework run: the dilute water's replicas all hold a guest
# by then (a replica with none never moves, and counts as stalled)
FW_BLOCKS = 4


def fw_args(variant, seconds=0.5):
    return SimpleNamespace(workload=framework.cell_name(variant, "small"),
                           seed=SEED, seconds=seconds, trace=0)


@pytest.fixture(scope="module")
def fw_copy(tmp_path_factory):
    return framework.make_copy(tmp_path_factory.mktemp("fw"), "small")


@pytest.mark.parametrize("variant", framework.VARIANTS)
def test_framework_rehearsal(fw_copy, blocks, variant):
    """A frozen charged framework, guests of one or two types (swaps), a
    non-cubic box: judged correct, with the comparison's every number."""
    root, bench = fw_copy
    blocks(FW_BLOCKS)
    res = run.run(fw_args(variant), root=root, device="cpu", bench=bench)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["frozen_moved"] == {"value": 0, "limit": 0}


def _frozen_moved(orig):
    def f(spec, states, u, *a, **k):
        out = orig(spec, states, u, *a, **k)
        pos = out.pos.clone()
        pos[:, 0, 0] += 0.5                 # the framework's first site
        return out.replace(pos=pos)
    return f


def _data_rewritten(change):
    """load_system handed a data file whose Atoms lines ``change(mol,
    type, q)`` rewrote: the program reads its system wrong."""
    def wrap(orig):
        def load_system(input_file, data_file, params_file, **kw):
            lines = Path(data_file).read_text().splitlines()
            start = next(i for i, x in enumerate(lines)
                         if x.startswith("Atoms"))
            first_guest_type = None
            for i in range(start + 2, len(lines)):
                f = lines[i].split()
                if len(f) < 7:
                    break
                mol, typ = int(f[1]), int(f[2])
                if mol > 1 and first_guest_type is None:
                    first_guest_type = typ
                f[3] = f"{change(mol, typ, float(f[3]), first_guest_type):.6f}"
                lines[i] = " ".join(f)
            path = Path(data_file).with_suffix(".fault.data")
            path.write_text("\n".join(lines) + "\n")
            return orig(input_file, str(path), params_file, **kw)
        return load_system
    return wrap


FW_FAULTS = {
    "frozen_site_moved": ("maniac_tpu_torch.parallel.replicas",
                          "run_block_uniforms", _frozen_moved),
    "guest_charge_altered": ("maniac_tpu_torch.api", "load_system",
                             _data_rewritten(
                                 lambda mol, typ, q, guest:
                                 q + 0.05 if typ == guest else q)),
    "frozen_left_out": ("maniac_tpu_torch.api", "load_system",
                        _data_rewritten(
                            lambda mol, typ, q, guest:
                            0.0 if mol == 1 else q)),
}


@pytest.mark.parametrize("fault", sorted(FW_FAULTS))
@pytest.mark.parametrize("variant", framework.VARIANTS)
def test_framework_fault_is_caught(fw_copy, monkeypatch, blocks, variant,
                                   fault):
    import importlib
    blocks(FW_BLOCKS)
    module, fn, wrap = FW_FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, fn, wrap(getattr(mod, fn)))
    root, bench = fw_copy
    res = run.run(fw_args(variant), root=root, device="cpu", bench=bench)
    assert res["correct"] is False, res["checks"]


def test_stall_blocks_counts_over_the_run(tmp_path, monkeypatch, blocks):
    """With every other block left unchanged, each judged block alone
    finds every replica still; runs of three judged blocks find none."""
    import maniac_tpu_torch.parallel.replicas as replicas
    blocks(4)
    root = tiny.make_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = dict(tiny.TRAFFIC["tiny_replicas"], judged_blocks=3)
    stalled = {}
    for k in (1, 3):
        name = f"tiny_stall{k}"
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(dict(mix, stall_blocks=k)))
        (root / "portbench" / "limits" / f"tiny_spce.{name}.json"
         ).write_text(json.dumps({"limits": tiny.LIMITS}))
        bench["workloads"].append({"name": f"tiny_spce.{name}",
                                   "config": "tiny_spce", "traffic": name,
                                   "chips": 1, "why": "rehearsal"})
    orig, calls = replicas.run_block_uniforms, []

    def every_other(spec, states, u, *a, **k):
        calls.append(1)
        return states if len(calls) % 2 else orig(spec, states, u, *a, **k)
    monkeypatch.setattr(replicas, "run_block_uniforms", every_other)
    for k in (1, 3):
        calls.clear()
        res = run.run(SimpleNamespace(workload=f"tiny_spce.tiny_stall{k}",
                                      seed=SEED, seconds=1.0, trace=0),
                      root=root, device="cpu", bench=bench)
        assert res["attempted"] >= 3
        stalled[k] = res["checks"]["stalled_replicas"]["value"]
    assert stalled[1] >= 4 and stalled[3] == 0, stalled


SPANS_READER = """PROGRAM_SPANS = {on}


def read(t):
    from maniac_tpu_torch.utils import trace
    return float(len(getattr(t, "program", [])) * 1000
                 + 10 * isinstance(getattr(t, "counters", None), dict)
                 + trace.enabled())
"""


@pytest.mark.parametrize("on", [True, False])
def test_program_spans_reach_the_reader_that_asks(tmp_path, on):
    """A reader with PROGRAM_SPANS = True gets the program's spans and
    counters on its Trace; without it the trace is the harness's alone
    and the program's tracing stays off."""
    root = tiny.make_copy(tmp_path)
    (root / "portbench" / "metrics" / "tiny.program.py").write_text(
        SPANS_READER.format(on=on))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = tiny.cell_name("tiny_spce", "tiny_replicas")
    bench["per_layer"].append({"name": "tiny.program", "unit": "spans",
                               "better": "higher", "source": "program_span",
                               "layer": "test", "moves": "mc_steps_per_s",
                               "workloads": [cell]})
    res = run.run(SimpleNamespace(workload=cell, seed=SEED, seconds=0.2,
                                  trace=1), root=root, device="cpu",
                  bench=bench)
    value = res["metrics"]["tiny.program"]["value"]
    from maniac_tpu_torch.utils import trace as program_trace
    assert not program_trace.enabled()
    if on:
        assert value >= 1000, "no program span in the window"
        assert value % 1000 == 10, "no program counters on the trace"
    else:
        assert value == 0
    assert "setup.load_s" in res["metrics"]
