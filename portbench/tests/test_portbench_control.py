"""The control, the reference in bfloat16 put in the program's place, has
to come out as not correct: at a tiny size on the CPU here, at the cells'
own sizes on the card (``gpu``), and on the framework rehearsal at both
sizes."""

from __future__ import annotations

import json

import pytest

from portbench import compare, control, run
from portbench.tests import framework, tiny


@pytest.mark.parametrize("config,traffic", tiny.CELLS)
def test_control_fails_tiny(tmp_path, config, traffic):
    root = tiny.make_copy(tmp_path)
    readings = control.control_readings(tiny.cell_name(config, traffic),
                                        2 ** 32 + 9, "cpu", root=root)
    correct, _ = compare.verdict(readings, tiny.LIMITS)
    assert correct is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_on_card(card, cell):
    limits = run.read_json(run.PKG / "limits" / f"{cell}.json")["limits"]
    readings = control.control_readings(cell, 2 ** 31 + 3, card)
    correct, _ = compare.verdict(readings, limits)
    assert correct is False, readings


RELATIVE = ("setup_energy_rel", "energy_rel", "amp_rel")


@pytest.mark.parametrize("variant", framework.VARIANTS)
def test_control_fails_on_the_framework(tmp_path, variant):
    """The framework's constant terms do not hide the control: each
    relative number reads ten times its limit or more."""
    root, bench = framework.make_copy(tmp_path, "small")
    readings = control.control_readings(
        framework.cell_name(variant, "small"), 2 ** 32 + 9, "cpu",
        root=root, bench=bench)
    correct, _ = compare.verdict(readings, framework.LIMITS)
    assert correct is False
    for name in RELATIVE:
        assert readings[name] >= 10 * framework.LIMITS[name], readings


@pytest.mark.gpu
@pytest.mark.parametrize("variant", framework.VARIANTS)
def test_framework_rehearsal_on_card(card, tmp_path, variant):
    """The framework rehearsal at the card's size: 2,100 charged frozen
    sites, 1024 replicas x 400-step blocks; the program correct, the
    control ten times over each relative limit."""
    from types import SimpleNamespace
    root, bench = framework.make_copy(tmp_path, "full")
    cell = framework.cell_name(variant, "full")
    res = run.run(SimpleNamespace(workload=cell, seed=2 ** 31 + 5,
                                  seconds=5.0, trace=0), root=root,
                  bench=bench)
    assert res["correct"] is True, res["checks"]
    readings = control.control_readings(cell, 2 ** 31 + 7, card, root=root,
                                        bench=bench)
    for name in RELATIVE:
        assert readings[name] >= 10 * framework.LIMITS[name], readings
