"""One run of one cell of the benchmark of maniac_tpu_torch on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic mix are found by name:
BENCHMARK.json's workload, ``configs/<config>.json`` (written by
``writers/<writer>.py``), ``traffic/<traffic>.json`` (driven by
``drivers/<driver>.py``), the cell's limits ``limits/<cell>.json`` and,
with ``--trace 1``, each per-layer metric that lists the cell as
``metrics/<name>.py``. Where one of those sets ``PROGRAM_SPANS = True``,
the traced run turns the program's own tracing on from the start
(maniac_tpu_torch/utils/trace.py) and profiles the window with
spans.ProgramTracer, so that the Trace the readers get carries the
program's spans and counters (spans.ProgramTrace); otherwise the program's
tracing stays off. Set-up is everything from the start of this module
to the first timed block: imports, the CUDA context, the kernel library
built or found, the system written and loaded, the drivers' replication,
one warm-up block. The window then runs whole blocks,
synchronising the card after each, until ``--seconds`` have passed;
``mc_steps_per_s`` is every replica's steps of those blocks over their
wall time. After the window the peak device memory is read, the program's
state is freed but for the judged rows of the traffic's last
``judged_blocks`` blocks, and the comparison (compare.py) decides
``correct``. The last line of standard output is the result.

Without a card, with fewer cards than the cell asks for, with JAX or the
JAX package loaded, or where the program is missing, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from . import program, trace  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "maniac_tpu")


class Refused(RuntimeError):
    """The run cannot give a result."""


def load_module(path: Path, name: str):
    """A module of the benchmark found by file name (drivers, writers,
    metrics), imported inside this package."""
    if not path.is_file():
        raise Refused(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{path.parent.name}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"no {path}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str, root: Path = ROOT):
    """(workload, its configuration's entry, the configuration, the
    traffic mix, the cell's limits) under the checkout ``root``."""
    pkg = root / PKG.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(root / entry["file"])
    traffic = read_json(pkg / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(pkg / "limits" / f"{name}.json")
    return cell, entry, config, traffic, limits


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's, its
    relatives' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in (names or sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def write_files(config: dict, seed: int, outdir: str, root: Path = ROOT
                ) -> tuple[dict, dict]:
    """The configuration's system written by its writer from the seed:
    (the files, the arrays the writer generated)."""
    writer = load_module(root / PKG.name / "writers"
                         / f"{config['writer']}.py",
                         config["writer"])
    arrays = writer.write(outdir, seed, config)
    return {"input": f"{outdir}/input.maniac",
            "data": f"{outdir}/topology.data",
            "params": f"{outdir}/parameters.inc"}, arrays


def window(drv, tracer, seconds: float, judged_blocks: int):
    """Whole blocks, the card synchronised after each, until ``seconds``
    have passed. Returns (blocks, elapsed s, (before, after) counts of each
    block when tracing, (state before, uniforms) of the last
    ``judged_blocks`` blocks)."""
    records, blocks = [], 0
    recent = collections.deque(maxlen=judged_blocks)
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            drv.block(tracer.span)
            with tracer.span("sync"):
                program.sync()
            blocks += 1
            recent.append((drv.pre, drv.u))
            if tracer.on:
                records.append((counts(drv.pre), counts(drv.states)))
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                return blocks, elapsed, records, list(recent)


def counts(st):
    """The small tensors the bounds read of a state."""
    return SimpleNamespace(counters=st.counters, extras=st.extras,
                           n_mol=st.n_mol)


def host_counts(records):
    return [tuple(SimpleNamespace(**{k: v.cpu() for k, v in vars(c).items()})
                  for c in rec) for rec in records]


def readers(bench, cell_name, root: Path = ROOT) -> list:
    """(metric entry, reader module) of each per-layer metric that lists
    the cell."""
    return [(m, load_module(root / PKG.name / "metrics" / f"{m['name']}.py",
                            m["name"]))
            for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(metric_readers, tr) -> dict:
    """Each metric read from the trace; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m, mod in metric_readers:
        value = mod.read(tr)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def program_tracing(on: bool) -> None:
    """The program's spans and timed counters on, from a clean registry,
    or off."""
    from maniac_tpu_torch.utils import trace as program_trace
    if on:
        program_trace.reset()
    program_trace.enable(on)


def run(args, log=sys.stderr, root: Path = ROOT, device=None,
        bench: dict | None = None, program_spans: bool | None = None
        ) -> dict:
    """One run; ``device`` None looks for the card the cell asks for (the
    tests pass the CPU and a copy's ``root`` to rehearse the rest);
    ``bench`` None reads ``root``'s BENCHMARK.json (a rehearsal passes its
    own, in memory); ``program_spans`` None turns the program's tracing on
    where a reader of the cell sets PROGRAM_SPANS (spans.run_traced passes
    True)."""
    if bench is None:
        bench = read_json(root / "BENCHMARK.json")
    cell, _, config, traffic, limits = find_cell(bench, args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA device(s), "
                          f"the cell asks for {cell['chips']}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    device = torch.device(device)
    on_card = device.type == "cuda"
    metric_readers = readers(bench, args.workload, root) if args.trace \
        else []
    if program_spans is None:
        program_spans = any(getattr(mod, "PROGRAM_SPANS", False)
                            for _, mod in metric_readers)
    marks = {"start": time.perf_counter() - T0}
    tmp = tempfile.mkdtemp(prefix="portbench-")
    if program_spans:
        program_tracing(True)
    try:
        files, arrays = write_files(config, args.seed, tmp, root)
        marks["written"] = time.perf_counter() - T0
        ctx = SimpleNamespace(files=files, config=config, traffic=traffic,
                              seed=args.seed, device=device)
        driver = load_module(root / PKG.name / "drivers"
                             / f"{traffic['driver']}.py",
                             traffic["driver"])
        drv = driver.Driver(ctx)
        marks["driver"] = time.perf_counter() - T0
        if program_spans:
            from . import spans
            tracer = spans.ProgramTracer(bool(args.trace))
        else:
            tracer = trace.Tracer(bool(args.trace))
        drv.block(tracer.span)                       # warm-up
        program.sync()
        setup_s = time.perf_counter() - T0
        blocks, elapsed, records, recent = window(
            drv, tracer, args.seconds, int(traffic["judged_blocks"]))
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        steps = drv.B * drv.n_steps * blocks
        n = drv.states.n_mol[:, :drv.spec.R].sum(1).double()
        parts = {**marks, **drv.setup}
        log.write(f"# {args.workload} seed={args.seed}: setup "
                  f"{setup_s:.3f} s (at s: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                  + "); "
                  f"{blocks} blocks of B={drv.B} x {drv.n_steps} steps in "
                  f"{elapsed:.3f} s; mean population {float(n.mean()):.2f}; "
                  f"peak {peak} bytes\n")
        from . import compare   # the reference: not part of the set-up
        reference = compare.Reference(files, arrays, config, args.seed,
                                      device)
        setup = dict(drv.setup)
        t0 = time.perf_counter()
        numbers = compare.judge(drv, recent, reference,
                                int(traffic["judged_replicas"]), args.seed,
                                int(traffic.get("stall_blocks", 1)))
        log.write(f"# comparison {time.perf_counter() - t0:.1f} s\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if program_spans:
            program_tracing(False)
    correct, checks = compare.verdict(numbers, limits["limits"])
    if args.trace:
        dev_ops, harness_spans, win = tracer.read()
        fields = dict(device_ops=dev_ops, spans=harness_spans, window=win,
                      blocks=blocks, B=drv.B, n_steps=drv.n_steps,
                      records=host_counts(records), setup=setup,
                      spec=ref_cpu_spec(reference),
                      state1=reference.host_state)
        if program_spans:
            tr = spans.ProgramTrace(**fields, program=tracer.program,
                                    counters=tracer.counters)
        else:
            tr = trace.Trace(**fields)
        metrics = per_layer(metric_readers, tr)
    else:
        metrics = {"mc_steps_per_s": {"value": steps / elapsed,
                                      "unit": "steps/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules loaded that the benchmark must not load: "
                      f"{', '.join(bad)}")
    result = {"correct": correct, "attempted": blocks, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if args.trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    for name, c in checks.items():
        log.write(f"check {name} {c['value']} limit {c['limit']}\n")
    result["checks"] = checks
    return result


def ref_cpu_spec(reference):
    """The reference's float32 spec on the host, for the bounds."""
    from .ref.driver import cast
    return cast(reference.host_spec, "cpu", torch.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args)
    except (Refused, ImportError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
