"""The program's spans and counters (maniac_tpu_torch/utils/trace.py) on
the CPU: off, the program records nothing and enters no profiler range;
on, its spans nest under the calls that caused them and, inside a
profile, are the profile's own ranges, on its clock; the kernel library's
build is a span and a counter; and the readers of portbench/spans.py give
exact values on a hand-made trace and run end to end on a tiny cell."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from maniac_tpu_torch import load_system, replicate
from maniac_tpu_torch.kernels import blockg, build
from maniac_tpu_torch.mc.driver import block_body_u, draw_uniforms, resync
from maniac_tpu_torch.parallel.replicas import run_block_uniforms
from maniac_tpu_torch.systems import make_water_box
from maniac_tpu_torch.utils import trace
from maniac_tpu_torch.utils.logger import NullLogger
from portbench import spans as program_spans

torch.set_num_threads(1)

# every span the program opens
SPAN_NAMES = {"load_system", "load.parse", "load.ewald", "load.build",
              "load.to_device", "load.energy", "replicate",
              "kernels.library", "kernels.build", "mc.draw", "mc.block",
              "mc.steps", "mc.recalibrate", "mc.resync_amplitudes",
              "kernels.blockg", "kernels.resync", "kernels.stepg",
              "mc.refresh", "energy.system", "energy.pair",
              "energy.amplitudes", "energy.intra"}


@pytest.fixture(autouse=True)
def fresh_trace():
    """Each test starts from no spans and no counters, tracing off, and
    leaves it so."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.fixture
def deck(tmp_path):
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=2000.0)
    return tmp_path


def _load(d: Path):
    return load_system(f"{d}/input.maniac", f"{d}/topology.data",
                       f"{d}/parameters.inc", capacity=12,
                       dtype=torch.float32, device="cpu",
                       logger=NullLogger(), seed=2 ** 33 + 5)


def _calls(sysm):
    """The calls a benchmark block makes: the replicas' (draw, block with
    recalibration and resync) and the single chain's (draw, steps,
    refresh)."""
    spec = sysm.spec
    states = replicate(spec, sysm.state, 2)
    states, u = draw_uniforms(spec, states, 5)
    run_block_uniforms(spec, states, u, True, True)
    st, u = draw_uniforms(spec, sysm.state, 5)
    resync(spec, block_body_u(spec, st, u, False))


def _profiled(fn):
    """(fn's result, the kineto events) of fn run inside a CPU profile, in
    a ``window`` range as the harness opens one."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window"):
            out = fn()
    return out, list(prof.profiler.kineto_results.events())


def test_off_records_nothing_and_enters_no_profile_range(deck):
    """Off: span() is one shared no-op, and a profile around the load and
    a block of each kind holds no range of a program span."""
    assert trace.span("mc.block") is trace.span("energy.pair")
    _, events = _profiled(lambda: _calls(_load(deck)))
    assert not {e.name() for e in events} & SPAN_NAMES
    assert any(e.name() == "window" for e in events)
    assert trace.spans() == []


def test_spans_nest_under_their_callers(deck):
    """On: each span's parent is the span of the call that made it, a
    child lies inside its parent, and the spans come in the order they
    were entered."""
    trace.enable(True)
    _calls(_load(deck))
    got = trace.spans()
    pairs = {(s.name, None if s.parent is None else got[s.parent].name)
             for s in got}
    assert pairs == {
        ("load_system", None), ("load.parse", "load_system"),
        ("load.ewald", "load_system"), ("load.build", "load_system"),
        ("load.to_device", "load_system"), ("load.energy", "load_system"),
        ("energy.system", "load.energy"), ("energy.pair", "energy.system"),
        ("energy.amplitudes", "energy.system"),
        ("energy.intra", "energy.system"), ("replicate", None),
        ("mc.draw", None), ("mc.block", None), ("mc.steps", "mc.block"),
        ("mc.recalibrate", "mc.block"), ("mc.resync_amplitudes", "mc.block"),
        # the chain's steps: on the CPU the step kernel's wrapper runs the
        # plain steps, whose own span lies inside the dispatching one
        ("mc.steps", None), ("mc.steps", "mc.steps"), ("mc.refresh", None),
        ("energy.system", "mc.refresh")}
    assert {s.name for s in got} <= SPAN_NAMES
    assert [s.start for s in got] == sorted(s.start for s in got)
    for s in got:
        assert s.start <= s.end and not s.profiled
        if s.parent is not None:
            p = got[s.parent]
            assert p.start <= s.start and s.end <= p.end


def test_refresh_off_the_card_runs_eagerly(deck):
    """On the CPU the chain's refresh (mc/driver.resync) is
    initialize_state called eagerly, bit for bit, each call's own
    energy.system span under mc.refresh, and no CUDA graph is captured
    (the card replays one: tests/test_torch_gpu.py)."""
    from maniac_tpu_torch.mc.driver import initialize_state
    sysm = _load(deck)
    st, u = draw_uniforms(sysm.spec, sysm.state, 5)
    st = block_body_u(sysm.spec, st, u, False)
    trace.enable(True)
    got = [resync(sysm.spec, st) for _ in range(2)]
    want = initialize_state(sysm.spec, st)
    for g in got:
        for field in ("energy", "amp_re", "amp_im"):
            assert torch.equal(getattr(g, field), getattr(want, field))
    names = [s.name for s in trace.spans()]
    assert names.count("mc.refresh") == 2
    assert names.count("energy.system") == 3
    assert "refresh.graph_captures" not in trace.counters()
    assert sysm.spec.graphs == {}


def test_graphs_live_on_their_spec(deck):
    """The CUDA graphs a spec keeps (SystemSpec.graphs, where the card's
    refresh keeps its graph) belong to that spec alone: one dict for the
    life of the spec, and a spec made from it by dataclasses.replace
    starts with its own, empty."""
    import dataclasses
    spec = _load(deck).spec
    spec.graphs["layout"] = "graph"
    assert spec.graphs is spec.graphs
    assert spec.graphs == {"layout": "graph"}
    assert dataclasses.replace(spec).graphs == {}
    assert spec.graphs == {"layout": "graph"}


def test_profiled_spans_are_the_profile_ranges(deck):
    """On, inside a profile: every span is a record_function range of the
    profile, of the same name and in the same order, nested as the spans
    are and inside the harness's own range, and as long as the span: the
    ranges are on the profile's clock, the clock of its device activities,
    and need no conversion."""
    sysm = _load(deck)
    trace.enable(True)
    _, events = _profiled(lambda: _calls(sysm))
    got = trace.spans()
    assert got and all(s.profiled for s in got)
    window = next(e for e in events if e.name() == "window")
    ranges = sorted(((e.start_ns(), -e.duration_ns(), e.name())
                     for e in events if e.name() in SPAN_NAMES))
    assert [n for _, _, n in ranges] == [s.name for s in got]
    w0, w1 = window.start_ns(), window.start_ns() + window.duration_ns()
    for (start, minus_dur, _), s in zip(ranges, got):
        assert w0 <= start and start - minus_dur <= w1
        assert (s.end - s.start) <= -minus_dur * 1.001 + 20_000
        if s.parent is not None:
            p_start, p_minus, _ = ranges[s.parent]
            assert p_start <= start
            assert start - minus_dur <= p_start - p_minus


def _load_config(name: str, outdir: Path):
    """A benchmark configuration (portbench/configs/<name>.json) written by
    its writer and loaded on the CPU in float32, without the initial
    energy."""
    from portbench import run
    cfg = run.read_json(run.PKG / "configs" / f"{name}.json")
    files, _ = run.write_files(cfg, 2 ** 33 + 5, str(outdir))
    return load_system(files["input"], files["data"], files["params"],
                       capacity=cfg["capacity"], dtype=torch.float32,
                       device="cpu", logger=NullLogger(), seed=2 ** 33 + 5,
                       compute_initial_energy=False)


@pytest.mark.parametrize(
    "config,split,frozen,charged,tiles,far,units,modes,active", [
        ("flue_slit", True, 1792, 0, 112, 0, 0, (1073, 2470), 2),
        ("nacl001_h2o", True, 576, 576, 40, 24964, 112, (1445, 3230), 1),
        ("spce750", False, 0, 0, 0, 0, 0, (1152, 2601), 1)])
def test_load_records_the_split_and_counts_what_it_built(
        tmp_path, config, split, frozen, charged, tiles, far, units, modes,
        active):
    """The framework split's build is a ``load.fwsplit`` span under
    ``load.build``, and the far table's a ``load.far_table`` span beside
    it, where there is a frozen type to build them from (the graphite
    slit, the salt slab) and no span where there is none (bulk water); the
    load counts its live frozen sites, those with a charge (none of the
    carbon, every ion of the salt), the tiles the kernels sweep them in
    (1,792 C or 576 ions in tiles of 16), the far table's nonzero
    coefficients and its work units (none without a charged frozen site),
    the weighted and the real k-space modes the kernels walk, and its
    active types."""
    trace.enable(True)
    sysm = _load_config(config, tmp_path)
    got = trace.spans()
    pairs = [(s.name, None if s.parent is None else got[s.parent].name)
             for s in got]
    assert sysm.spec.fw_split is split
    for name in ("load.fwsplit", "load.far_table"):
        assert ((name, "load.build") in pairs) is split
        assert [n for n, _ in pairs].count(name) == int(split)
    assert {k: v for k, v in trace.counters().items()
            if k.startswith("load.")} == {
        "load.frozen_sites": frozen, "load.frozen_charged_sites": charged,
        "load.frozen_tiles": tiles, "load.far_coefficients": far,
        "load.far_units": units,
        "load.kspace_modes": modes[0], "load.commit_modes": modes[1],
        "load.active_types": active}


def test_block_launch_counts_its_form(tmp_path, monkeypatch):
    """Each launch of the block kernel adds one to ``launch.blockg`` and
    one to the counter of its template form: ``blockg.form.multi_tiles``
    on the graphite slit (a frozen prefix, swept by tiles, two species, no
    far table), once a block; with the launcher stubbed, so on the
    CPU."""
    calls = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *a: (calls.append(name),
                                          trace.count("launch.blockg")))
    sysm = _load_config("flue_slit", tmp_path)
    spec = sysm.spec
    assert blockg.form(spec) == "multi_tiles"
    states = replicate(spec, sysm.state, 2)
    before = trace.counters()
    for _ in range(3):
        states, u = draw_uniforms(spec, states, 4)
        blockg._launch(spec, states, u)
    assert calls == ["blockg_launch"] * 3
    assert trace.since(before) == {"launch.blockg": 3,
                                   "blockg.form.multi_tiles": 3}
    # outside the ``launch.`` prefix, so that portbench's launch_host_us
    # counts each launch once
    t = _hand_made([], {"launch.blockg": 3, "blockg.form.multi_tiles": 3,
                        "launch_ns.blockg": 4500})
    assert program_spans.launch_host_us(t) == pytest.approx(1.5, rel=1e-12)


def test_counters_add_and_reset():
    """count() adds, since() gives what moved after a snapshot, reset()
    forgets; counters are kept with tracing off."""
    trace.count("launch.blockg")
    before = trace.counters()
    trace.count("launch.blockg", 2)
    trace.count("kernels.builds")
    assert trace.since(before) == {"launch.blockg": 2, "kernels.builds": 1}
    assert build.launch_counts(before)["blockg"] == 2
    assert build.launch_counts()["blockg"] == 3
    trace.reset()
    assert trace.counters() == {} and trace.spans() == []


def test_library_build_is_a_span_and_a_counter(tmp_path, monkeypatch):
    """The build runs in a ``kernels.build`` span and counts
    ``kernels.builds`` only when the library is missing."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_build",
                        lambda so, defines: Path(so).write_bytes(b""))
    trace.enable(True)
    build.library_path(("TRACE_TEST",))
    build.library_path(("TRACE_TEST",))
    assert [s.name for s in trace.spans()] == ["kernels.build"]
    assert trace.counters()["kernels.builds"] == 1


def _hand_made(program, counters=None, blocks=2):
    """Four device activities in a 100 us window, idle over [0, 10),
    [20, 30), [60, 70) and [80, 100)."""
    ops = [("k", 10.0, 20.0, 5.0), ("k", 30.0, 60.0, 25.0),
           ("copy", 70.0, 75.0, 65.0), ("copy", 75.0, 80.0, None)]
    return program_spans.ProgramTrace(
        device_ops=ops, spans=[], window=(0.0, 100.0), blocks=blocks, B=1,
        n_steps=1, program=program, counters=counters or {})


PROGRAM = [("mc.block", 0.0, 50.0), ("kernels.blockg", 5.0, 28.0),
           ("mc.refresh", 55.0, 90.0), ("energy.system", 56.0, 89.0)]


def test_readers_on_a_hand_made_trace():
    """The three readings and the idle table from known overlaps."""
    t = _hand_made(PROGRAM, {"launch.blockg": 3, "launch.resync": 1,
                             "launch_ns.blockg": 4500,
                             "launch_ns.resync": 3500, "kernels.builds": 0})
    assert program_spans.launch_host_us(t) == pytest.approx(2.0, rel=1e-12)
    assert program_spans.launch_host_us_by(t) == pytest.approx(
        {"blockg": 1.5, "resync": 3.5}, rel=1e-12)
    # idle inside [0, 50) and [55, 90): 10 + 10 + 10 + 10 of 100 us
    assert program_spans.idle_program_pct(t) == pytest.approx(40.0,
                                                              rel=1e-12)
    # idle inside [55, 90): [60, 70) and [80, 90)
    assert program_spans.refresh_idle_pct(t) == pytest.approx(20.0,
                                                              rel=1e-12)
    table = {n: (idle, queued, ops) for n, idle, queued, ops
             in program_spans.idle_by_span(t)}
    idle = {n: round(v[0] * 1e6, 9) for n, v in table.items()}
    assert idle == {"energy.system": 19.0, "kernels.blockg": 13.0,
                    program_spans.OUTSIDE: 10.0, "mc.block": 7.0,
                    "mc.refresh": 1.0}
    assert sum(idle.values()) == 50.0
    assert table["kernels.blockg"][1] == pytest.approx(40e-6, rel=1e-12)
    assert table["kernels.blockg"][2] == {"k": 1.0}
    assert table["energy.system"][2] == {"copy": 0.5}
    assert table[program_spans.OUTSIDE][2] == {"copy": 0.5}


def test_readers_find_nothing_without_program_spans():
    """No program span in the trace (the program's tracing off) and no
    launch timed: the three readers return None."""
    t = _hand_made([], {"launch.blockg": 3})
    assert program_spans.launch_host_us(t) is None
    assert program_spans.idle_program_pct(t) is None
    assert program_spans.refresh_idle_pct(t) is None
    assert program_spans.refresh_idle_pct(_hand_made(PROGRAM[:2])) is None


# the rehearsal runs in a process of its own: the harness refuses to run
# where JAX is loaded, as it is in this test process
REHEARSAL = """
import json, sys
from pathlib import Path
from types import SimpleNamespace
from maniac_tpu_torch.utils import trace
from portbench import spans
from portbench.tests import tiny
root = tiny.make_copy(Path(sys.argv[1]))
args = SimpleNamespace(workload=tiny.cell_name("tiny_spce", "tiny_chain"),
                       seed=2 ** 33 + 17, seconds=0.2, trace=1)
res = spans.run_traced(args, root=root, device="cpu")
print(json.dumps({"correct": res["correct"],
                  "breakdown": sorted(res["breakdown"]),
                  "program": sorted(res["program"]),
                  "spans": [[s.name, s.profiled] for s in trace.spans()],
                  "found": [r[0] for r in spans.ProgramTracer.last.program],
                  "on": trace.enabled()}))
"""


def test_spans_tool_rehearsal(tmp_path):
    """portbench.spans on a tiny single chain on the CPU: the set-up's
    spans record outside the profile, the window's are found in it in the
    order they were entered, and the harness's own readings keep their
    keys."""
    out = subprocess.run([sys.executable, "-c", REHEARSAL, str(tmp_path)],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True
    assert res["breakdown"] == ["device_ops", "idle_gaps"]
    assert res["program"] == ["device.idle_program_pct", "gc",
                              "idle_by_span", "launch.host_us",
                              "launch.host_us_by", "refresh.idle_pct"]
    assert res["spans"][0] == ["load_system", False]
    window = [n for n, profiled in res["spans"] if profiled]
    assert res["found"] == window and "mc.refresh" in window
    assert res["on"] is False
