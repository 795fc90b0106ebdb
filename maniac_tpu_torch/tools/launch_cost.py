"""The host's cost of one kernel launch through the launch path, on the card.

    python -m maniac_tpu_torch.tools.launch_cost [--calls 10000]

For tables of the lengths K5 (onehot_launch), K3 (stepg_launch) and K2
(blockg_launch) take, times ``--calls`` launches of the library's empty
kernel (noop_launch, csrc/launch.cu) through kernels/build.launch, by
time.perf_counter around a loop that ends in one torch.cuda.synchronize().
Prints microseconds per call with the synchronize, and the host's enqueue
alone (the clock read before it).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import card_label, require_cuda

# (pointers, ints, floats) of each launcher's tables (csrc/hwprobe.cu,
# stepg.cu and blockg.cu; tests/test_torch_launch.py checks them)
TABLES = {"K5": (3, 3, 0), "K3": (48, 25, 12), "K2": (59, 23, 12)}


def per_call_us(fn, calls: int) -> tuple[float, float]:
    """(us per call with the closing synchronize, us per call of the
    enqueue alone) over ``calls`` calls of fn after 100 warm-up calls."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t2 - t0) / calls * 1e6, (t1 - t0) / calls * 1e6


def measure(calls: int) -> dict:
    """{table: (us with sync, us enqueue)} of the empty kernel's launch."""
    from ..kernels import build
    buf = torch.zeros(64, device="cuda")
    out = {}
    for table, (n_p, n_i, n_f) in TABLES.items():
        ptrs = [buf.data_ptr()] * n_p
        ints = list(range(1, n_i + 1))
        floats = [0.5 * k for k in range(n_f)]
        out[table] = per_call_us(
            lambda: build.launch("noop_launch", ptrs, ints, floats,
                                 buf.device), calls)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="launch_cost",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=10000)
    args = ap.parse_args(argv)
    if not require_cuda("launch_cost"):
        return 1
    res = measure(args.calls)
    label = f"{torch.cuda.get_device_name(0)}, {card_label()}"
    for table, (us, us_host) in res.items():
        print(f"launch_cost: {table}'s table: {us:.2f} us per call, enqueue "
              f"{us_host:.2f} us ({args.calls} calls; {label})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
