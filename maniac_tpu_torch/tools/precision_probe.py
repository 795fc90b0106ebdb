"""Hardware-precision probe and rigid-geometry check on the card (the
counterpart of tools/precision_probe.py; the stages are documented in
maniac_tpu_torch/utils/hwprobe.py).

    python -m maniac_tpu_torch.tools.precision_probe [--blocks 8]
        [--path kernel|plain] [--no-sentinel]

Prints each stage's detail and verdict, then ``RESULT: PASS`` (exit 0) or
``RESULT: FAIL`` (exit 1).
"""

from __future__ import annotations

import argparse
import sys

from . import card_label, require_cuda


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.precision_probe",
        description="hardware-precision probe of the card")
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--path", choices=["kernel", "plain"], default="kernel")
    ap.add_argument("--no-sentinel", action="store_true")
    args = ap.parse_args(argv)
    if not require_cuda("precision_probe"):
        return 1

    from ..utils.hwprobe import probe_onehot_exact, probe_rigid_geometry

    print(f"# device: {card_label()}")
    ok1, d1 = probe_onehot_exact()
    print(f"stage 1: {d1}")
    print("stage 1:", "PASS" if ok1 else
          "FAIL (a reduced-precision product is live - is TF32 on?)")
    ok2, d2 = probe_rigid_geometry(args.blocks, args.path,
                                   sentinel=not args.no_sentinel)
    print(f"stage 2+3: {d2}")
    print("stage 2+3:", "PASS" if ok2 else
          "FAIL (rigid geometry deforming or kernel/plain divergence)")
    ok = ok1 and ok2
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
