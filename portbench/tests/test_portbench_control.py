"""The control, the reference in bfloat16 put in the program's place, has
to come out as not correct: at a tiny size on the CPU here, at the cells'
own sizes on the card (``gpu``)."""

from __future__ import annotations

import json

import pytest

from portbench import compare, control, run
from portbench.tests import tiny


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
