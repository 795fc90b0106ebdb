"""A run of a cell with the program's own spans and counters on.

    python -m portbench.spans --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run.run of the cell with its ``program_spans`` on: the program's
tracing (maniac_tpu_torch/utils/trace.py) turned on before the cell's
files are written, so that the set-up's spans record too, and the window
profiled by ProgramTracer, the path that ``python -m portbench.run``
takes in a cell one of whose readers sets PROGRAM_SPANS. The
program's counters and the interpreter's garbage collections are read
over the window. The result line gains ``"program"``: ``launch.host_us``,
``launch.host_us_by`` and ``gc`` always, the rest with ``--trace 1``,
where the program's spans inside the window are ``record_function``
ranges of the profile, on the clock of its device activities. With
``--trace 0`` the result line's ``mc_steps_per_s`` is the rate with the
program's tracing on (against ``portbench.run``'s with it off: the cost
of the tracing).

* ``launch.host_us``: the host us a kernel launch takes inside
  kernels/build.launch, over the window's launches (``launch_ns.*`` over
  ``launch.*``); ``launch.host_us_by`` the same for each launcher.
* ``gc``: the window's garbage collections by generation, [count, s,
  longest s]: host pauses that no program span owns.
* ``device.idle_program_pct``: 100 x the window's device-idle time that
  overlaps some program span, over the window.
* ``refresh.idle_pct``: 100 x the device-idle time that overlaps the
  program's ``mc.refresh`` spans (the single chain's energy refresh),
  over the window.
* ``idle_by_span``: the window's device-idle seconds summed by the
  innermost program span the host was in (idle outside every program
  span under OUTSIDE), each with the device seconds of the activities
  queued from that span and the activities by name, per block.

Standard error adds the set-up's spans (seconds by name, nested) with
``kernels.builds`` and the idle table.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import sys
import time
from dataclasses import dataclass, field

import torch

from . import run, trace

OUTSIDE = "outside program spans"


@dataclass
class ProgramTrace(trace.Trace):
    """A Trace with the program's spans in the window, (name, start, end)
    in us on the profiler's clock, and its counters over the window."""
    program: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)


class ProgramTracer(trace.Tracer):
    """The harness's Tracer, which also keeps the program's counters over
    the window and reads the program's spans from the profile."""
    last = None

    def __init__(self, on: bool):
        super().__init__(on)
        ProgramTracer.last = self
        self.counters = {}
        self.program = []
        self.read_out = None
        self.gc = {}

    def _collected(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
            return
        n, s, top = self.gc.get(info["generation"], (0, 0.0, 0.0))
        d = time.perf_counter() - self._gc_t0
        self.gc[info["generation"]] = (n + 1, s + d, max(top, d))

    @contextlib.contextmanager
    def window(self):
        from maniac_tpu_torch.utils import trace as program_trace
        before = program_trace.counters()
        gc.callbacks.append(self._collected)
        try:
            with super().window():
                yield
        finally:
            gc.callbacks.remove(self._collected)
        self.counters = program_trace.since(before)

    def read(self):
        from maniac_tpu_torch.utils import trace as program_trace
        self.read_out = super().read()
        names = {s.name for s in program_trace.spans() if s.profiled}
        cuda = torch.autograd.DeviceType.CUDA
        self.program = sorted(
            ((e.name(), e.start_ns() / 1e3,
              (e.start_ns() + e.duration_ns()) / 1e3)
             for e in self.prof.profiler.kineto_results.events()
             if e.device_type() != cuda and e.name() in names),
            key=lambda r: (r[1], -r[2]))
        return self.read_out


def idle_intervals(t) -> list:
    """(start, end) us of the window's stretches with no device activity."""
    gaps, end = [], t.window[0]
    for _, s, e, _ in sorted(t.device_ops, key=lambda o: o[1]):
        if s > end:
            gaps.append((end, min(s, t.window[1])))
        end = max(end, e)
        if end >= t.window[1]:
            break
    if t.window[1] > end:
        gaps.append((end, t.window[1]))
    return [(s, e) for s, e in gaps if e > s]


def innermost_segments(ranges) -> list:
    """(start, end, name) stretches over which the innermost of the
    (name, start, end) ranges (nested, as one thread's spans are) is
    ``name``; stretches outside every range are left out."""
    ranges = [r for r in ranges if r[2] > r[1]]
    cuts = sorted({x for _, s, e in ranges for x in (s, e)})
    starts = sorted(ranges, key=lambda r: r[1])
    ends = sorted(ranges, key=lambda r: r[2])
    active, out, i, j = [], [], 0, 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(ends) and ends[j][2] <= a:
            active.remove(ends[j])
            j += 1
        while i < len(starts) and starts[i][1] <= a:
            active.append(starts[i])
            i += 1
        if active:
            out.append((a, b, active[-1][0]))
    return out


def _overlap(intervals, segments) -> dict:
    """{name: us} of the (start, end) intervals lying inside the (start,
    end, name) segments; both sorted and each list disjoint."""
    out, j = {}, 0
    for s, e in intervals:
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            a, b, name = segments[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out


def _union(ranges) -> list:
    """(start, end, "in") segments covering the union of the ranges."""
    out = []
    for _, s, e in sorted(ranges, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e), "in")
        else:
            out.append((s, e, "in"))
    return out


def _idle_share(t, ranges):
    if not ranges or not t.device_ops or t.window_s <= 0:
        return None
    us = _overlap(idle_intervals(t), _union(ranges)).get("in", 0.0)
    return 100.0 * us / 1e6 / t.window_s


def launch_host_us(t):
    """Host us a launch took in kernels/build.launch over the window's
    launches, or None where the window timed none."""
    ns = sum(v for k, v in t.counters.items() if k.startswith("launch_ns."))
    calls = sum(v for k, v in t.counters.items() if k.startswith("launch."))
    return ns / calls / 1e3 if ns and calls else None


def launch_host_us_by(t) -> dict:
    """{launcher: host us a launch} over the window's timed launches."""
    out = {}
    for k, ns in t.counters.items():
        if k.startswith("launch_ns."):
            name = k.removeprefix("launch_ns.")
            out[name] = ns / t.counters[f"launch.{name}"] / 1e3
    return out


def idle_program_pct(t):
    """100 x the device-idle time inside some program span, over the
    window; None without program spans or device activities."""
    return _idle_share(t, t.program)


def refresh_idle_pct(t):
    """100 x the device-idle time inside the program's mc.refresh spans,
    over the window; None where there are none."""
    return _idle_share(t, [r for r in t.program if r[0] == "mc.refresh"])


def idle_by_span(t, top: int = 10) -> list:
    """[name, idle s, queued device s, {activity: count per block}] for
    the ``top`` innermost program spans (and OUTSIDE) with most device-idle
    time in the window; the idle seconds add up to the window's."""
    segments = innermost_segments(t.program)
    idle = _overlap(idle_intervals(t), segments)
    total = sum(e - s for s, e in idle_intervals(t))
    idle[OUTSIDE] = total - sum(idle.values())
    starts = [s for s, _, _ in segments]
    queued, ops = {}, {}
    for name, s, e, launched in t.device_ops:
        span = OUTSIDE
        if launched is not None:
            i = bisect.bisect_right(starts, launched) - 1
            if i >= 0 and launched < segments[i][1]:
                span = segments[i][2]
        queued[span] = queued.get(span, 0.0) + (e - s)
        by_name = ops.setdefault(span, {})
        by_name[name] = by_name.get(name, 0) + 1
    rows = sorted(set(idle) | set(queued), key=lambda n: -idle.get(n, 0.0))
    return [[n, idle.get(n, 0.0) / 1e6, queued.get(n, 0.0) / 1e6,
             {k: c / t.blocks for k, c in ops.get(n, {}).items()}]
            for n in rows[:top]]


def readings(t) -> dict:
    return {"device.idle_program_pct": idle_program_pct(t),
            "refresh.idle_pct": refresh_idle_pct(t),
            "idle_by_span": idle_by_span(t)}


def setup_lines(spans, counters) -> list:
    """The spans that ran outside the profile (the set-up and the warm-up
    block), seconds summed by name under their parents, in the order first
    entered, and kernels.builds."""
    depth, sums, order = {}, {}, []
    for i, s in enumerate(spans):
        if s.profiled:
            continue
        depth[i] = 0 if s.parent is None else depth.get(s.parent, 0) + 1
        key = (depth[i], s.name)
        if key not in sums:
            order.append(key)
            sums[key] = [0.0, 0]
        sums[key][0] += (s.end - s.start) / 1e9
        sums[key][1] += 1
    lines = [f"# setup span {'  ' * d}{n}: {sums[(d, n)][0]:.6f} s"
             f" ({sums[(d, n)][1]} calls)" for d, n in order]
    return lines + [f"# kernels.builds {counters.get('kernels.builds', 0)}"]


def run_traced(args, log=sys.stderr, **kw) -> dict:
    """run.run(args, **kw) with the program's tracing on; the result
    gains ``"program"``, with the span readings where ``args.trace``."""
    from maniac_tpu_torch.utils import trace as program_trace
    result = run.run(args, log=log, program_spans=True, **kw)
    tracer = ProgramTracer.last
    for line in setup_lines(program_trace.spans(),
                            program_trace.counters()):
        log.write(line + "\n")
    t = ProgramTrace(device_ops=[], spans=[], window=(0.0, 0.0),
                     blocks=result["attempted"], B=0, n_steps=0,
                     program=tracer.program, counters=tracer.counters)
    result["program"] = {"launch.host_us": launch_host_us(t),
                         "launch.host_us_by": launch_host_us_by(t),
                         "gc": {str(g): list(v)
                                for g, v in sorted(tracer.gc.items())}}
    log.write(f"# gc by generation [count, s, longest s]: "
              f"{json.dumps(result['program']['gc'])}\n")
    if args.trace:
        t.device_ops, t.spans, t.window = tracer.read_out
        result["program"].update(readings(t))
        for name, idle, queued, ops in result["program"]["idle_by_span"]:
            log.write(f"# idle {idle:.6f} s in {name}; queued {queued:.6f}"
                      f" s: {json.dumps(ops)}\n")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_traced(args)
    except (run.Refused, ImportError) as e:
        print(f"portbench.spans: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # run.run imports portbench.spans: run that module, whose
    # ProgramTracer.last is the one the run sets
    from portbench import spans
    sys.exit(spans.main())
