"""Times of the per-step path (K3's steps) and the one-hot kernel (K5) on the
card, so that two trees of the package are timed alike.

    python -m maniac_tpu_torch.tools.kernel_times [--seed 1234] [--forms]

Steps: ``mc/driver.run_steps_u`` (the dispatched per-step path: whatever
the tree runs for an MC step of a spec outside the block kernel's gate) on
20 steps of five cells, each from a seeded state: the flagship
(make_zif_like(n_cells=6, a=5.66, n_water=32, fugacity=30), capacity 192,
f32) at B = 1024 after one 400-step block of the main path; the same states
under the isotherm's spec (perturb_activity: 8 fugacities 1-3000 atm x 128
replicas, the command line's --isotherm); the flagship at B = 1; bench.py's
resv with its reservoir at B = 1 (the -r single chain); bench.py's tricl at
B = 1. Per step: host-paced (``cuda_ms``: CUDA events around the calls as
the host enqueues them; where the host takes longer to enqueue a step than
the card to run it, this times the host), device-paced (``device_ms``: the
calls queued behind a spin kernel that outlasts the host's enqueueing of
them, so the card runs them back to back, as long as the queue holds them
all), and from torch.profiler over one call: the device activities
(kernels, copies, fills) a step launches and their summed device time. K5:
``kernels/hwprobe.onehot_product`` beside ``torch.matmul`` on the probe's
(8, 256) x (256, 8) operands, both host-paced, as the target compares
whole calls: 100 calls each, K5, then its plain version, then
torch.matmul; and 2 x 1000 calls of K5 and torch.matmul in turns, the
smaller time of each. ``--forms`` times K3's two forms instead
(``form_times``): one CTA a replica and a cluster of ``CLUSTER``, each
device-paced, on the step's shape of the benchmark's spce750 and on the
flagship, at each of FORM_REPLICAS replicas.

The file imports only what the package has had since K5 was ported, so a
copy of it in an earlier tree times that tree the same way.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

from . import card_label, cuda_ms, require_cuda

SPIN_CYCLES = 1_000_000   # the spin kernel's calibration length


def device_ms(fn, reps: int) -> float:
    """Mean time of fn() in ms over reps calls that the card runs back to
    back. After one warm-up call and one timed pass of the host's issue,
    the calls are queued behind a spin kernel (torch.cuda._sleep) that
    lasts twice that issue time, and CUDA events bracket them. The host's
    pace drops out as long as fn never waits for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = SPIN_CYCLES / start.elapsed_time(end)
    torch.cuda._sleep(int(2.0 * issue_ms * cycles_per_ms) + SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


STEPS_TIMED = 20
ISOTHERM_FUGACITIES = (1.0, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0, 3000.0)
ISOTHERM_REPLICAS = 128
# the replica counts K3's two forms are timed at (--forms): either side of
# kernels/stepg.py's CLUSTER_MAX_B and up to the isotherm's 1024
FORM_REPLICAS = (1, 2, 8, 16, 17, 24, 32, 64, 128, 1024)


def profile_steps(fn, n_steps: int) -> tuple[float, float]:
    """(device activities, their summed device ms) per step of one call of
    fn, which runs n_steps steps, from torch.profiler after one warm-up
    call (CUDA kernels, copies and fills alike). A profile that recorded
    no device activity (it happened on the H100's host) is taken again,
    once."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    return len(dev) / n_steps, busy_us / 1e3 / n_steps


def isotherm_spec(spec):
    """The command line's isotherm spec on the flagship (``--isotherm
    1,...,3000 --replicas 128``): each active species' activity scaled by
    fugacity / 30 atm (the deck's), one fugacity a batch of 128 replicas,
    one activity table a replica (perturb_activity)."""
    from ..parallel.replicas import perturb_activity
    fugs = torch.tensor(ISOTHERM_FUGACITIES, device=spec.device)
    acts = spec.type_activity[None, :].repeat(len(fugs) * ISOTHERM_REPLICAS,
                                              1)
    active = torch.tensor(spec.active_list, device=spec.device)
    acts[:, active] *= (fugs / 30.0).repeat_interleave(
        ISOTHERM_REPLICAS)[:, None]
    return perturb_activity(spec, acts)


def step_cells(seed: int = 1234) -> dict:
    """{cell: (spec, states)}: the five cells the step times are taken on
    (see the module's docstring), each made from ``seed``."""
    from .. import load_system, replicate, run_block_replicated
    from ..systems import (make_triclinic_water, make_water_box,
                           make_water_reservoir, make_zif_like)
    dev = torch.device("cuda", 0)

    def load(make, reservoir=None, **kw):
        with tempfile.TemporaryDirectory() as tmp:
            make(tmp, **kw)
            res = make_water_reservoir(tmp, **reservoir) if reservoir else None
            return load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                               f"{tmp}/parameters.inc", reservoir_file=res,
                               capacity=192, dtype=torch.float32, device=dev,
                               seed=seed)
    zif = load(make_zif_like, n_cells=6, a=5.66, n_water=32, fugacity=30.0)
    spec = zif.spec
    states = run_block_replicated(spec, replicate(spec, zif.state, 1024),
                                  400, False, True)
    resv = load(make_water_box, reservoir=dict(n_water=96, L=24.0),
                n_water=48, L=24.0, cutoff=8.0, tol=1e-5,
                probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0)
    tricl = load(make_triclinic_water, n_water=24, L=22.0,
                 tilt=(2.0, 1.2, 0.8), cutoff=7.0, tol=1e-5,
                 probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0)
    return {"flagship B=1024": (spec, states),
            "isotherm 8 x 128": (isotherm_spec(spec), states),
            "flagship B=1": (spec, zif.state),
            "resv -r B=1": (resv.spec, resv.state),
            "tricl B=1": (tricl.spec, tricl.state)}


def step_times(seed: int = 1234, reps: int = 3) -> dict:
    """{cell: {"host-paced": ms, "device-paced": ms, "activities": n,
    "device busy": ms}}, each per step, of run_steps_u on STEPS_TIMED
    steps of each cell (step_cells), on uniforms from the cell's keys."""
    from ..mc.driver import draw_uniforms, run_steps_u
    out = {}
    for cell, (spec, states) in step_cells(seed).items():
        _, u = draw_uniforms(spec, states, STEPS_TIMED)

        def call():
            return run_steps_u(spec, states, u)
        n_act, busy = profile_steps(call, STEPS_TIMED)
        out[cell] = {"host-paced": cuda_ms(call, reps) / STEPS_TIMED,
                     "device-paced": device_ms(call, reps) / STEPS_TIMED,
                     "activities": n_act, "device busy": busy}
    return out


def form_times(seed: int = 1234, reps: int = 3) -> dict:
    """{(system, B): {CTAs a replica: device-paced ms a step}} of K3's two
    forms (kernels/stepg._run pinned to 1 and CLUSTER CTAs a replica) on
    STEPS_TIMED steps of B replicas of tools/section_split's spce750 and
    zif (the flagship), for each B of FORM_REPLICAS."""
    from .. import replicate
    from ..kernels.stepg import CLUSTER, _run
    from ..mc.driver import draw_uniforms
    from ..utils.threefry import prng_key
    from .section_split import _load
    dev = torch.device("cuda", 0)
    out = {}
    for system in ("spce750", "zif"):
        sysm = _load(system, dev)
        spec = sysm.spec
        state = sysm.state.replace(key=prng_key(seed, dev)[None])
        for B in FORM_REPLICAS:
            states = replicate(spec, state, B)
            _, u = draw_uniforms(spec, states, STEPS_TIMED)
            out[(system, B)] = {
                cl: device_ms(lambda: _run(spec, states, u, _cluster=cl),
                              reps) / STEPS_TIMED
                for cl in (1, CLUSTER)}
    return out


def k5_times() -> dict:
    """{"100 calls": (K5 ms, plain ms, torch.matmul ms), "2 x 1000 in
    turns": ((K5 ms, torch.matmul ms) of each turn)} on the probe's
    operands."""
    from ..kernels.hwprobe import onehot_product, onehot_product_plain
    from ..utils.hwprobe import onehot_operands
    dev = torch.device("cuda", 0)
    x, oh, _ = onehot_operands()
    xt, oht = torch.from_numpy(x).to(dev), torch.from_numpy(oh).to(dev)
    serial = tuple(cuda_ms(lambda: f(xt, oht), 100)
                   for f in (onehot_product, onehot_product_plain,
                             torch.matmul))
    turns = tuple((cuda_ms(lambda: onehot_product(xt, oht), 1000),
                   cuda_ms(lambda: torch.matmul(xt, oht), 1000))
                  for _ in range(2))
    return {"100 calls": serial, "2 x 1000 in turns": turns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_times",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--forms", action="store_true",
                    help="time K3's two forms (form_times) and nothing else")
    args = ap.parse_args(argv)
    if not require_cuda("kernel_times"):
        return 1
    label = f"{torch.cuda.get_device_name(0)}, {card_label()}"
    if args.forms:
        for (system, B), t in form_times(args.seed).items():
            print(f"kernel_times: K3 {system} B={B}: " + ", ".join(
                f"{cl} CTA{'s' * (cl > 1)} a replica {ms:.5f} ms"
                for cl, ms in t.items())
                + f" a step, device-paced ({STEPS_TIMED} steps a call; "
                f"{label})")
        return 0
    k5 = k5_times()
    k5_ms, plain_ms, mm_ms = k5["100 calls"]
    print(f"kernel_times: K5 100 calls: {k5_ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, torch.matmul {mm_ms:.4f} ms, K5 / torch.matmul "
          f"{k5_ms / mm_ms:.3f} ({label})")
    turns = k5["2 x 1000 in turns"]
    k5_min, mm_min = (min(t) for t in zip(*turns))
    print(f"kernel_times: K5 2 x 1000 in turns: " + ", ".join(
        f"K5 {k:.4f}, torch.matmul {m:.4f}" for k, m in turns)
        + f" ms; smaller {k5_min:.4f} / {mm_min:.4f}, K5 / torch.matmul "
        f"{k5_min / mm_min:.3f} ({label})")
    for cell, t in step_times(args.seed).items():
        print(f"kernel_times: step {cell}: device-paced "
              f"{t['device-paced']:.4f} ms, host-paced {t['host-paced']:.4f} "
              f"ms, {t['activities']:.2f} device activities of "
              f"{t['device busy']:.4f} ms (torch.profiler), per step "
              f"({STEPS_TIMED} steps a call; {label})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
