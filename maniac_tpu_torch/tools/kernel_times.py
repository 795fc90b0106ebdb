"""Times of the step kernel (K3) and the one-hot kernel (K5) on the card,
each taken in two ways, so that two trees of the package are timed alike.

    python -m maniac_tpu_torch.tools.kernel_times [--seed 1234]

K3: ``kernels/stepg.step_core`` on one proposal of the flagship
(make_zif_like(n_cells=6, a=5.66, n_water=32, fugacity=30), capacity 192,
f32) at B = 1024, after one 400-step block of the main path, 20 calls:
host-paced (``cuda_ms``: CUDA events around the calls as the host issues
them; where the host takes longer to issue a call than the card to run it,
this times the host) and device-paced (``device_ms``: the same calls queued
behind a spin kernel that outlasts the host's issue of all of them, so the
card runs them back to back). K5: ``kernels/hwprobe.onehot_product``
beside ``torch.matmul`` on the probe's (8, 256) x (256, 8) operands, both
host-paced, as the target compares whole calls: 100 calls each, K5, then
its plain version, then torch.matmul; and 2 x 1000 calls of K5 and
torch.matmul in turns, the smaller time of each.

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


def k3_times(seed: int = 1234, reps: int = 20) -> dict:
    """{"host-paced": ms, "device-paced": ms} of one step_core call on the
    flagship at B = 1024."""
    from .. import load_system, replicate, run_block_replicated
    from ..kernels.stepg import step_core
    from ..mc.driver import draw_uniforms
    from ..mc.moves import _propose
    from ..systems import make_zif_like
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        make_zif_like(tmp, n_cells=6, a=5.66, n_water=32, fugacity=30.0)
        sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", capacity=192,
                           dtype=torch.float32, device=dev)
    spec = sysm.spec
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    states = run_block_replicated(spec, replicate(spec, sysm.state, 1024),
                                  400, False, True, gen)
    pre = _propose(spec, states, draw_uniforms(spec, 1024, 1, gen)[:, 0])

    def call():
        return step_core(spec, states, pre)
    return {"host-paced": cuda_ms(call, reps),
            "device-paced": device_ms(call, reps)}


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
    args = ap.parse_args(argv)
    if not require_cuda("kernel_times"):
        return 1
    label = f"{torch.cuda.get_device_name(0)}, {card_label()}"
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
    for how, ms in k3_times(args.seed).items():
        print(f"kernel_times: K3 flagship B=1024 {how}: {ms:.4f} ms a call "
              f"(20 calls; {label})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
