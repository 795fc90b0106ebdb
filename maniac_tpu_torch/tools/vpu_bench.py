"""Micro-benchmark of f32 primitives on the card (the counterpart of
tools/vpu_bench.py): N loop-carried applications of one op to every
element of a (ROWS, COLS) plane in csrc/vpu.cu, or (``cpass``,
``cpassT``) N passes of the framework Coulomb pass's plane math.

    python -m maniac_tpu_torch.tools.vpu_bench [op ...] [--rows 128]
        [--cols 1280] [--n 512] [--reps 20]

ops: fma mul2 div rsqrt sqrt exp round cmpsel erfc (the default: all
nine), cpass, cpassT. Prints ms/call and ps/elem-op (cpass: us per plane
iteration) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import card_label, cuda_ms, require_cuda
from ..kernels.vpu import VPU_OPS, cpass, vpu_chain

ROWS, COLS, N = 128, 1280, 512
CPASS_NAMES = ("cpass", "cpassT")


def plane(rows: int, cols: int, device) -> torch.Tensor:
    """The chained ops' input: linspace(0.1, 3.0) over the plane, f32."""
    x = np.linspace(0.1, 3.0, rows * cols, dtype=np.float32)
    return torch.from_numpy(x.reshape(rows, cols)).to(device)


def cpass_inputs(rows: int, cols: int, device) -> tuple:
    """(px, py, pz, q, row table) of the JAX tool's run_cpass: x =
    linspace(0.1, 30.0) over the plane, px = x, py = x + 1, pz = x + 2,
    q = 0.1 x, and a (4, rows) table linspace(0, 1)."""
    x = np.linspace(0.1, 30.0, rows * cols,
                    dtype=np.float32).reshape(rows, cols)
    tab = np.linspace(0.0, 1.0, 4 * rows, dtype=np.float32).reshape(4, rows)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (x, x + 1.0, x + 2.0, x * 0.1, tab))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.vpu_bench",
        description="chained f32 primitives on the card")
    ap.add_argument("ops", nargs="*", choices=[*VPU_OPS, *CPASS_NAMES],
                    metavar="op", help=f"one of {', '.join(VPU_OPS)}, "
                                       f"cpass, cpassT (default: the nine "
                                       f"ops)")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=COLS)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not require_cuda("vpu_bench"):
        return 1
    dev = torch.device("cuda")
    R, C, n = args.rows, args.cols, args.n
    print(f"# plane ({R}, {C}), N={n} chained ops, device: {card_label()}",
          flush=True)
    for name in args.ops or VPU_OPS:
        if name in CPASS_NAMES:
            ins = cpass_inputs(R, C, dev)
            ms = cuda_ms(lambda: cpass(*ins, n, name == "cpassT"),
                         args.reps)
            print(f"{name:8s} {ms:8.3f} ms/call  {ms / n * 1e3:8.3f} "
                  f"us/plane-iter", flush=True)
        else:
            x = plane(R, C, dev)
            ms = cuda_ms(lambda: vpu_chain(x, name, n), args.reps)
            print(f"{name:8s} {ms:8.3f} ms/call  "
                  f"{ms * 1e9 / (n * R * C):8.3f} ps/elem-op", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
