"""The port's bench: aggregate MC steps/s of replica chains on one card.

    python -m maniac_tpu_torch.bench      # bench.py's flagship, zif

The counterpart of bench.py at the root of the repository, which drives
the JAX package on a TPU. It runs one of bench.py's systems through the
port's main path, load_system(..., device="cuda") -> replicate(B) ->
run_block_replicated(spec, states, steps, False, resync) with the resync on
in f32 and off in f64 (bench.py:146), and prints as its last line of
standard output one JSON object: ``metric``
(``port_mc_steps_per_sec_<system>``, ``..._zif8_h2o`` for zif), ``value``
(B x steps x blocks over the timed blocks' wall), ``unit``, ``device``
(the card's name and power limit as nvidia-smi gives them, the device
count), ``dispatch`` (kernels.dispatch_report's line), ``hw_precision``,
``kernel_check``, ``state_check``, the run's sizes, the set-up times, the
peak device memory, the launches of the timed blocks and the layers of one
block. Lines on standard error give the same numbers as they come.

Knobs, read from the environment as bench.py reads them:

  MANIAC_BENCH_SYSTEM    zif (default), mixed, resv, tricl or bigS (SYSTEMS)
  MANIAC_BENCH_REPLICAS  replica chains B (1024)
  MANIAC_BENCH_STEPS     MC steps a block (400)
  MANIAC_BENCH_BLOCKS    timed blocks (3)
  MANIAC_BENCH_DTYPE     f32 (default) or f64, the canary: every kernel
                         gate refuses f64, so it times the plain torch path
                         on the card, with the threefry kernel drawing
  MANIAC_BENCH_CAPACITY  molecules a type (2500 for bigS, else 192)
  MANIAC_BENCH_HWCHECK   0 skips the hardware-precision check (1)
  MANIAC_BENCH_FW_RCUT2, MANIAC_BENCH_FW_ALPHA2, MANIAC_BENCH_EWALD_ALPHA
                         zif's deck keywords fw_rcut2, fw_alpha2 and
                         ewald_alpha (bench.py:81-86)

In order: the kernels are built (``build_s``; kernels/build.library), the
system is loaded and replicated (``setup_s``), one warm-up block runs
(``warmup_s``), then one block alone (``ms_per_step``), then the timed
blocks between torch.cuda.synchronize() calls on the host clock, their
launch counts set to 0 just before. After the timing, one more block runs
with CUDA events around each of its launches (the draw, the block, the
resync): each launch's ms, the gaps between them, and the block's and the
resync's bounds (tools/bounds.py) on one line. Then the checks, after the
timing as bench.py:190-201 runs its probe: the state (finite, every
population within [0, capacity], box + reservoir + dropped molecules
conserved with a reservoir; on the card, the kernels the dispatch names
launched once a block), utils/hwprobe.hw_precision_check(blocks=4), and in
f32 the block kernel against the plain steps (kernel_check). A failed check
exits 1 with no result line.

Left out of bench.py, with the reason: MANIAC_BENCH_COMPILE_CACHE (an XLA
disk cache; the port compiles nothing but its kernels, whose build
kernels/build.py keys by the sources in kernels/_build/),
ensure_map_headroom (XLA:CPU's memory maps) and cached_spec_state (pickled
XLA set-up; bigS loads in seconds): ROADMAP's "Not to port". The TPU's
VPU and HBM estimate on standard error (a TPU's model) is replaced by the
layers line; vs_baseline is left out, its 1e6 target was set for a TPU
chip.

main() takes the card and nothing else: without CUDA it exits 1 and prints
no JSON line. run() holds the body and takes an explicit device, so that
the CPU tests can rehearse it at tiny sizes on the plain versions.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .api import load_system
from .kernels import (block_gate_failure, build, dispatch_report,
                      resync_gate_failure, use_resync_kernel)
from .mc.driver import (draw_uniforms, resync_amplitudes, run_steps_u,
                        steps_plain)
from .parallel.replicas import replicate, run_block_replicated
from .system import SimState
from .systems import (make_framework_mixed, make_triclinic_water,
                      make_water_box, make_water_reservoir, make_zif_like)
from .tools import bounds
from .utils import trace
from .utils.logger import NullLogger

# bench.py's systems (bench.py:91-110, its arguments verbatim): name ->
# (builder, its arguments, make_water_reservoir's arguments or None)
SYSTEMS = {
    "zif": (make_zif_like,
            dict(n_cells=6, a=5.66, n_water=32, fugacity=30.0), None),
    "mixed": (make_framework_mixed,
              dict(n_cells=6, a=5.66, n_water=24, n_dimer=12, cutoff=8.5,
                   tol=1e-5, probs=(0.25, 0.15, 0.4, 0.2)), None),
    "resv": (make_water_box,
             dict(n_water=48, L=24.0, cutoff=8.0, tol=1e-5,
                  probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0),
             dict(n_water=96, L=24.0)),
    "tricl": (make_triclinic_water,
              dict(n_water=24, L=22.0, tilt=(2.0, 1.2, 0.8), cutoff=7.0,
                   tol=1e-5, probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0),
              None),
    "bigS": (make_water_box,
             dict(n_water=2000, L=40.0, cutoff=8.5, tol=1e-5,
                  probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0), None),
}
# bench.py:52: the reference's capacity envelope for bigS
# (src/parameters.f90:8 caps a type at 5000), 192 for the others
CAPACITY = {"bigS": 2500}
DEFAULT_CAPACITY = 192
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# the deck knobs (bench.py:81-86): environment variable -> deck keyword
DECK_KNOBS = (("MANIAC_BENCH_FW_RCUT2", "fw_rcut2"),
              ("MANIAC_BENCH_FW_ALPHA2", "fw_alpha2"),
              ("MANIAC_BENCH_EWALD_ALPHA", "ewald_alpha"))
# the kernel check (tests/test_torch_gpu.py's bounds): replicas of the timed
# state and steps on the same uniforms; replicas whose decisions may differ
# (a Metropolis decision at its threshold may flip under f32 summation
# order); positions, COMs and reservoir rows (A); energy components (K)
CHECK_REPLICAS, CHECK_STEPS, CHECK_DIVERGED = 8, 50, 1
POS_TOL = 1e-4
ENERGY_TOL = 5.0
# systems whose energy components are too large for ENERGY_TOL alone:
# bigS's Coulomb components are some 1.2e8 K at load, where one f32 ulp is
# 8 K, and the running energies add each accepted delta to them, so each
# add may round the kernel's and the plain sum one ulp apart
ROUNDING_BOUND = ("bigS",)


class CheckFailed(RuntimeError):
    """A check of the bench's run failed: no result is printed."""


def default_capacity(system: str) -> int:
    return CAPACITY.get(system, DEFAULT_CAPACITY)


def metric_name(system: str) -> str:
    """The JSON line's metric, which a TPU's gcmc_steps_per_sec_per_chip_*
    (bench.py:203) cannot be taken for."""
    return ("port_mc_steps_per_sec_zif8_h2o" if system == "zif"
            else f"port_mc_steps_per_sec_{system}")


def write_system(system: str, outdir: str, **deck_kw) -> str | None:
    """Write bench.py's ``system`` (deck, data and pair coefficients, and a
    reservoir where it has one) into outdir; the deck knobs go to zif's
    deck, as bench.py passes them. Returns the reservoir file or None."""
    if system not in SYSTEMS:
        raise ValueError(f"unknown bench system {system!r} (one of "
                         f"{', '.join(SYSTEMS)})")
    make, kw, reservoir = SYSTEMS[system]
    make(outdir, **kw, **(deck_kw if system == "zif" else {}))
    return make_water_reservoir(outdir, **reservoir) if reservoir else None


def load(system: str, device, capacity: int | None = None,
         dtype: torch.dtype = torch.float32, **deck_kw):
    """load_system on bench.py's ``system`` written into a temporary
    directory, at ``capacity`` (default_capacity when None), quiet."""
    with tempfile.TemporaryDirectory() as tmp:
        res = write_system(system, tmp, **deck_kw)
        return load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", reservoir_file=res,
                           capacity=capacity or default_capacity(system),
                           dtype=dtype, device=device, logger=NullLogger())


def energy_bound(e_load, accepted) -> torch.Tensor:
    """(B, 6) bounds on |kernel - plain| energies for chains with
    ``accepted`` (B,) accepted steps from a system whose load-time energy
    row is e_load (6,): ENERGY_TOL plus one f32 ulp of each component's
    load-time magnitude per accepted step."""
    ulp = np.spacing(np.abs(np.asarray(e_load.cpu(), np.float32)))
    ulp = torch.as_tensor(ulp.astype(np.float64), device=accepted.device)
    return ENERGY_TOL + accepted.double()[:, None] * ulp[None, :]


def same_decisions(k, p) -> torch.Tensor:
    """(B,) mask of the replicas whose kernel (k) and plain (p) outputs of
    one block made the same decisions: populations, counters, extras and
    reservoir counts identical."""
    return ((k.n_mol == p.n_mol).all(dim=1)
            & (k.counters == p.counters).flatten(1).all(dim=1)
            & (k.extras == p.extras).all(dim=1)
            & (k.res_n == p.res_n).all(dim=1))


def block_errors(k, p, same, e_bound=None) -> tuple[float, float, bool]:
    """On the replicas of ``same`` (at least one): the largest position,
    COM or reservoir-row difference (A), the largest energy difference (K)
    and whether every energy difference is within e_bound (B, 6), or
    ENERGY_TOL where None."""
    pos_err = max(float((getattr(k, f) - getattr(p, f))[same].abs().max())
                  for f in ("pos", "com", "res_offset", "res_com"))
    d_e = (k.energy - p.energy).double().abs()[same]
    bound = ENERGY_TOL if e_bound is None else e_bound[same]
    return pos_err, float(d_e.max()), bool((d_e <= bound).all())


def kernel_check(spec, states, e_load=None, replicas=CHECK_REPLICAS,
                 steps=CHECK_STEPS) -> tuple[str, float, SimState]:
    """The block kernel (kernels/blockg.run_block_kernel) against the plain
    steps (mc/driver.steps_plain) on the first ``replicas`` replicas of
    ``states``, ``steps`` steps on the same uniforms: populations,
    counters, extras and reservoir counts identical on all but
    CHECK_DIVERGED replicas; on the rest positions, COMs and reservoir rows
    within POS_TOL and energies within ENERGY_TOL, or, given the load-time
    energy row e_load, within energy_bound. Returns (the detail, the
    largest position difference, the kernel's state); raises
    CheckFailed."""
    from .kernels.blockg import run_block_kernel
    few = SimState(**{k: v[:replicas] for k, v in vars(states).items()})
    few, u = draw_uniforms(spec, few, steps)
    k, p = run_block_kernel(spec, few, u), steps_plain(spec, few, u)
    same = same_decisions(k, p)
    n_div = int((~same).sum())
    if n_div > CHECK_DIVERGED:
        raise CheckFailed(f"kernel check: {n_div} of {few.B} replicas "
                          f"diverged (allowed {CHECK_DIVERGED})")
    accepted = (k.counters[:, 1] - few.counters[:, 1]).sum(1)
    bound = None if e_load is None else energy_bound(e_load, accepted)
    pos_err, e_err, e_ok = block_errors(k, p, same, bound)
    detail = (f"B={few.B} x {steps} steps: {n_div} of {few.B} replica(s) "
              f"diverged (allowed {CHECK_DIVERGED}); matching replicas "
              f"max|dpos| {pos_err:.3e} A (bound {POS_TOL:g}), max|dE| "
              f"{e_err:.3e} K (bound "
              + (f"{ENERGY_TOL:g}" if bound is None else
                 f"{ENERGY_TOL:g} + one f32 ulp of the component's load-time "
                 f"magnitude an accepted step, at most "
                 f"{float(bound[same].max()):.1f}")
              + f"); accepts {int(accepted.sum())}")
    if not pos_err <= POS_TOL or not e_ok:
        raise CheckFailed(f"kernel check: the block kernel disagrees with "
                          f"the plain steps: {detail}")
    return detail, pos_err, k


def conserved(st) -> torch.Tensor:
    """Box + reservoir + dropped molecules per replica."""
    return (st.n_mol[:, :-1].sum(1) + st.res_n[:, :-1].sum(1)
            + st.extras[:, 1])


def state_check(spec, start, states) -> str:
    """The timed blocks' state: finite floats, every population within
    [0, capacity], and with a reservoir box + reservoir + dropped molecules
    conserved on every replica since ``start``. Returns the detail; raises
    CheckFailed."""
    bad = [k for k, v in vars(states).items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad:
        raise CheckFailed(f"state check: non-finite values in {bad}")
    n = states.n_mol[:, :spec.R]
    caps = torch.tensor(spec.cap_list, device=n.device)
    if int(n.min()) < 0 or bool((n > caps).any()):
        raise CheckFailed("state check: a population outside [0, capacity]")
    if spec.has_reservoir and not torch.equal(conserved(states),
                                              conserved(start)):
        raise CheckFailed("state check: box + reservoir + dropped molecules "
                          "not conserved")
    return ("finite, within capacity"
            + (", box + reservoir + drops conserved"
               if spec.has_reservoir else ""))


def _stamp(device):
    """A timestamp on ``device``'s timeline: a recorded CUDA event on the
    card, the host clock on the CPU (where every call is synchronous)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def layers(spec, states, steps: int, resync: bool) -> dict:
    """One more block, run_block_replicated's launches one by one
    (draw_uniforms, then the block kernel or the per-step path, then the
    resync), with a timestamp before and after each: each launch's ms,
    the gap between one's end and the next one's start (the device waiting
    on the host), and the block kernel's and the resync kernel's bounds
    (tools/bounds.py) where they ran."""
    from .kernels.blockg import run_block_kernel
    dev = states.pos.device
    on_kernel = block_gate_failure(spec) is None
    block = run_block_kernel if on_kernel else run_steps_u
    t = [_stamp(dev)]
    drawn, u = draw_uniforms(spec, states, steps)
    t += [_stamp(dev), _stamp(dev)]
    out = block(spec, drawn, u)
    t += [_stamp(dev), _stamp(dev)]
    synced = resync_amplitudes(spec, out) if resync else out
    t.append(_stamp(dev))
    _sync(dev)
    out_ms = {"draw_ms": _ms(t[0], t[1]), "gap_draw_block_ms": _ms(t[1], t[2]),
              "block_ms": _ms(t[2], t[3])}
    if resync:
        out_ms.update(gap_block_resync_ms=_ms(t[3], t[4]),
                      resync_ms=_ms(t[4], t[5]))
    out_ms["clock"] = ("CUDA events" if dev.type == "cuda"
                       else "host clock")
    if on_kernel:
        b = bounds.block_bound(spec, drawn, out, u)
        out_ms.update(block_bound_ms=b[0], block_bound_by=b[1])
    if resync and resync_gate_failure(spec) is None:
        b = bounds.resync_bound(spec, out, synced)
        out_ms.update(resync_bound_ms=b[0], resync_bound_by=b[1])
    return out_ms


def _layers_line(lay: dict, kernel: bool) -> str:
    names = (("draw (T)", "block (K2)", "resync (K1)") if kernel
             else ("draw (T)", "block (plain)", "resync (plain)"))
    parts = [f"{names[0]} {lay['draw_ms']:.4f} ms",
             f"gap {lay['gap_draw_block_ms']:.4f} ms",
             f"{names[1]} {lay['block_ms']:.3f} ms"
             + (f" (bound {lay['block_bound_ms']:.4f} ms by "
                f"{lay['block_bound_by']})" if "block_bound_ms" in lay
                else "")]
    if "resync_ms" in lay:
        parts += [f"gap {lay['gap_block_resync_ms']:.4f} ms",
                  f"{names[2]} {lay['resync_ms']:.4f} ms"
                  + (f" (bound {lay['resync_bound_ms']:.4f} ms by "
                     f"{lay['resync_bound_by']})"
                     if "resync_bound_ms" in lay else "")]
    return f"# layers, one more block ({lay['clock']}): " + " | ".join(parts)


# the launchers whose launch counts (kernels/build.launch_counts) the
# result reports
LAUNCHES = ("threefry", "blockg", "resync", "stepg")


def _device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "card": None, "count": 0}
    from .tools import card_label
    return {"platform": "gpu", "card": card_label(),
            "count": torch.cuda.device_count()}


def run(system: str = "zif", device="cuda", replicas: int = 1024,
        steps: int = 400, blocks: int = 3, capacity: int | None = None,
        dtype: str = "f32", hwcheck: bool = True, deck_kw: dict | None = None,
        log=None) -> dict:
    """The bench on ``device``: returns the JSON line's object; raises
    CheckFailed when a check fails. Progress lines go to ``log`` (standard
    error by default)."""
    log = log or sys.stderr
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {list(DTYPES)}, got "
                         f"{dtype!r}")
    capacity = capacity or default_capacity(system)
    build_s = peak = None
    if device.type == "cuda":
        t0 = time.perf_counter()
        build.library()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    sysm = load(system, device, capacity, DTYPES[dtype], **(deck_kw or {}))
    spec = sysm.spec
    _sync(device)
    t_load = time.perf_counter() - t0
    states = replicate(spec, sysm.state, replicas)
    _sync(device)
    setup_s = time.perf_counter() - t0
    log.write(f"# setup split: load={t_load:.2f}s "
              f"replicate={setup_s - t_load:.2f}s\n")
    resync = dtype != "f64"    # f32 runs bound amplitude drift per block
    report = dispatch_report(spec, device)

    t0 = time.perf_counter()
    states = run_block_replicated(spec, states, steps, False, resync)
    _sync(device)
    warmup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_block_replicated(spec, states, steps, False, resync)
    _sync(device)
    ms_per_step = (time.perf_counter() - t0) / steps * 1e3

    before = trace.counters()
    start = states
    t0 = time.perf_counter()
    for _ in range(blocks):
        states = run_block_replicated(spec, states, steps, False, resync)
    _sync(device)
    elapsed = time.perf_counter() - t0
    counted = build.launch_counts(before)
    launches = {k: counted[k] for k in LAUNCHES}
    rate = replicas * steps * blocks / elapsed
    mean_n = float(states.n_mol[:, :spec.R].sum(1).double().mean())
    log.write(f"# device={device} dtype={dtype} replicas={replicas} "
              f"S={spec.S} K={spec.K} capacity={capacity}; {report}\n"
              f"# phases: setup={setup_s:.2f}s build="
              + ("-" if build_s is None else f"{build_s:.2f}s")
              + f" warmup={warmup_s:.2f}s block={ms_per_step:.4f}ms/step\n"
              f"# steps={replicas * steps * blocks:,} elapsed={elapsed:.4f}s "
              f"rate={rate:.1f} MC steps/s mean_N={mean_n:.2f} launches "
              f"{launches}\n")

    kernel_path = use_resync_kernel(spec, device) and \
        block_gate_failure(spec) is None
    lay = layers(spec, states, steps, resync)
    log.write(_layers_line(lay, kernel_path) + "\n")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)

    # the checks, after the timing
    detail = state_check(spec, start, states)
    if device.type == "cuda":
        want = {"threefry": blocks}
        if kernel_path:
            want.update(blockg=blocks, resync=blocks if resync else 0)
        if any(launches[k] != n for k, n in want.items()):
            raise CheckFailed(f"state check: launches {launches} of "
                              f"{blocks} blocks, want {want} ({report})")
        detail += f"; launches {launches}"
    log.write(f"# state_check=pass ({detail})\n")
    hw = "skipped"
    if hwcheck:
        from .utils.hwprobe import hw_precision_check
        t0 = time.perf_counter()
        hw, hw_detail = hw_precision_check(blocks=4, device=device)
        log.write(f"# hw_precision={hw} ({hw_detail}) "
                  f"[{time.perf_counter() - t0:.1f}s]\n")
        if hw != "pass":
            raise CheckFailed(f"hw_precision_check: {hw} ({hw_detail})")
    check = "skipped (f64: every kernel gate refuses f64)"
    if dtype == "f32":
        t0 = time.perf_counter()
        check_detail, _, _ = kernel_check(
            spec, states, sysm.state.energy[0] if system in ROUNDING_BOUND
            else None)
        check = "pass"
        log.write(f"# kernel_check=pass ({check_detail}) "
                  f"[{time.perf_counter() - t0:.1f}s]\n")

    return {
        "metric": metric_name(system), "value": rate, "unit": "MC steps/s",
        "system": system, "device": _device_info(device),
        "dispatch": report, "hw_precision": hw, "kernel_check": check,
        "state_check": "pass", "replicas": replicas, "steps": steps,
        "blocks": blocks, "dtype": dtype, "capacity": capacity,
        "S": spec.S, "K": spec.K, "mean_N": mean_n, "elapsed_s": elapsed,
        "ms_per_step": ms_per_step, "setup_s": setup_s, "build_s": build_s,
        "warmup_s": warmup_s, "peak_mem_bytes": peak, "launches": launches,
        "layers": lay}


def main() -> int:
    from .tools import require_cuda
    if not require_cuda("bench"):
        return 1
    env = os.environ
    system = env.get("MANIAC_BENCH_SYSTEM", "zif")
    if system not in SYSTEMS:
        print(f"bench: unknown MANIAC_BENCH_SYSTEM={system} (one of "
              f"{', '.join(SYSTEMS)})", file=sys.stderr)
        return 2
    deck_kw = {key: float(env[var]) for var, key in DECK_KNOBS
               if env.get(var)}
    try:
        result = run(
            system, "cuda", int(env.get("MANIAC_BENCH_REPLICAS", "1024")),
            int(env.get("MANIAC_BENCH_STEPS", "400")),
            int(env.get("MANIAC_BENCH_BLOCKS", "3")),
            int(env.get("MANIAC_BENCH_CAPACITY",
                        str(default_capacity(system)))),
            env.get("MANIAC_BENCH_DTYPE", "f32"),
            env.get("MANIAC_BENCH_HWCHECK", "1") != "0", deck_kw)
    except CheckFailed as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
