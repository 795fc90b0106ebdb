"""Micro-benchmark of the whole-block kernel's guest pair pass on the card
(the counterpart of tools/gpass_bench.py): one (G, NC * 128)-shaped pass
run NSTEP times in csrc/gpass.cu, the footprint moved every step.

    python -m maniac_tpu_torch.tools.gpass_bench [variant ...] [--G 64]
        [--nc 47] [--steps 100] [--fl 2] [--fq 6] [--reps 3]

Variants: cur (the live kernel's math), noerfc (1/r in place of erfc),
nowrap (no minimum image), read (the inputs' sum only: each element is
read once and added every step in a register, so it is the floor of
csrc/gpass.cu's design, its one read and its reduction, not a per-step
read floor as the TPU tool's is). The JAX tool's rep, mrg, nodyn, noeps
and wN are TPU layout variants (tiling, merged tiles, static offsets, a
broadcast eps row, wider chunks) that compute cur's number; they run cur
when named (the default runs the four that compute distinct numbers).
Prints us/pass and us/chunk (a chunk is 128 sites) with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from . import card_label, cuda_ms, require_cuda
from ..kernels.gpass import BOX_L, GPASS_VARIANTS, gpass

G, NC, NSTEP, FL, FQ = 64, 47, 100, 2, 6
LAYOUT_VARIANTS = ("rep", "mrg", "nodyn", "noeps")


def kernel_variant(name: str) -> str:
    """The variant of kernels/gpass.py that computes ``name``'s number."""
    if name in GPASS_VARIANTS:
        return name
    if name in LAYOUT_VARIANTS or re.fullmatch(r"w\d+", name):
        return "cur"
    raise ValueError(f"unknown variant {name!r}")


def inputs(g: int, s: int, fl: int, device, seed: int = 0) -> tuple:
    """(x, y, z, q, eps, sig) drawn as the JAX tool draws them: positions
    uniform in the box, charges normal(0, 0.5), eps in [0.1, 0.2] and
    sigma^2 in [9, 11] per site, the same on each of the fl rows."""
    rng = np.random.default_rng(seed)
    x, y, z = (rng.uniform(-BOX_L / 2, BOX_L / 2, (g, s)) for _ in range(3))
    q = rng.normal(0, 0.5, (1, s))[0]
    eps = np.broadcast_to(rng.uniform(0.1, 0.2, (1, s)), (fl, s))
    sig = np.broadcast_to(rng.uniform(9, 11, (1, s)), (fl, s))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in (x, y, z, q, eps, sig))


def check_inputs(g: int, s: int, fl: int, fq: int, n_steps: int, device,
                 seed: int = 1, clearance: float = 2.0) -> tuple:
    """(x, y, z, q, eps, sig) for holding the LJ rows against plain: eps
    in [0.1, 0.2] and sigma^2 in [9, 11] drawn per row and site, so a pass
    that reads the wrong row shows, and every site at least ``clearance``
    A from every footprint point of an n_steps pass of max(fl, fq) * g
    rows. No pair then sits near the r2 floor (an LJ term stays under
    4 eps (sigma^2 / clearance^2)^6, some 350 at 2 A), so the sum of
    |terms| comes from the typical pairs."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-BOX_L / 2, BOX_L / 2, (3, g, s))
    # the footprint points lie on the segment t (1, 1/2, 1/4), 0 <= t <=
    # t_max, far from the box's faces, so the direct distance is the
    # nearest image's
    v = np.array([1.0, 0.5, 0.25])
    t_max = (max(fl, fq) * g - 1) * 0.003 + (n_steps - 1) * 0.01
    while True:
        t = np.clip(np.tensordot(v, pts, 1) / (v @ v), 0.0, t_max)
        near = ((pts - t * v[:, None, None]) ** 2).sum(0) < clearance ** 2
        if not near.any():
            break
        pts[:, near] = rng.uniform(-BOX_L / 2, BOX_L / 2,
                                   (3, int(near.sum())))
    q = rng.normal(0, 0.5, s)
    eps = rng.uniform(0.1, 0.2, (fl, s))
    sig = rng.uniform(9, 11, (fl, s))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in (*pts, q, eps, sig))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.gpass_bench",
        description="the guest pair pass on the card")
    ap.add_argument("variants", nargs="*", metavar="variant")
    ap.add_argument("--G", type=int, default=G)
    ap.add_argument("--nc", type=int, default=NC)
    ap.add_argument("--steps", type=int, default=NSTEP)
    ap.add_argument("--fl", type=int, default=FL)
    ap.add_argument("--fq", type=int, default=FQ)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    names = args.variants or GPASS_VARIANTS
    try:
        runs = [kernel_variant(v) for v in names]
    except ValueError as e:
        ap.error(str(e))
    if not require_cuda("gpass_bench"):
        return 1
    ins = inputs(args.G, args.nc * 128, args.fl, torch.device("cuda"))
    print(f"# G={args.G} NC={args.nc} FL={args.fl} FQ={args.fq} "
          f"NSTEP={args.steps} device: {card_label()}", flush=True)
    for name, run in zip(names, runs):
        ms = cuda_ms(lambda: gpass(*ins, args.steps, args.fq, run),
                     args.reps)
        us = ms * 1e3 / args.steps
        note = "" if run == name else "  (runs cur: a TPU layout variant)"
        print(f"{name:8s} {us:9.2f} us/pass  ({us / args.nc:6.3f} us/chunk)"
              f"{note}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
