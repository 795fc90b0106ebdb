"""The sentinel's benign divergence rate on the card: the command line's
``--sentinel 1`` on the flagship deck, replicated and as a single chain.

    python -m maniac_tpu_torch.tools.sentinel_rate [--blocks 100]
        [--replicas 1024] [--seed 1234]

Writes the flagship deck (make_zif_like(n_cells=6, a=5.66, n_water=32,
fugacity=30), ``--blocks`` blocks of 400 steps, capacity 192, f32) and runs
``maniac_tpu_torch.cli`` on it twice with ``--sentinel 1``: with
``--replicas`` chains (the block kernel and the resync) and as a single
chain (the step kernel). Every block replica 0's block is replayed on the
plain torch path and compared (mc/driver.sentinel_check). Prints each
run's checked blocks, divergences and wall time, then the total and its
rate beside the JAX package's benign 1/500 (cli.SENTINEL_BENIGN_RATE);
exits 1 if a run fails or the total breaks the command line's rule. Needs
the card (exit 1 without one).
"""

from __future__ import annotations

import argparse
import contextlib
import re
import sys
import tempfile
import time

from . import card_label, require_cuda


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.sentinel_rate",
        description="the sentinel's divergence rate on the card")
    ap.add_argument("--blocks", type=int, default=100)
    ap.add_argument("--replicas", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    if not require_cuda("sentinel_rate"):
        return 1

    from ..cli import SENTINEL_BENIGN_RATE
    from ..cli import main as cli_main
    from ..systems import make_zif_like

    label = card_label()
    checked = diverged = 0
    with tempfile.TemporaryDirectory() as tmp:
        make_zif_like(tmp, n_cells=6, a=5.66, n_water=32, fugacity=30.0,
                      nb_block=args.blocks, nb_step=400)
        files = ["-i", f"{tmp}/input.maniac", "-d", f"{tmp}/topology.data",
                 "-p", f"{tmp}/parameters.inc", "--capacity", "192",
                 "--seed", str(args.seed), "--sentinel", "1"]
        for tag, extra in (("replicated", ["--replicas",
                                           str(args.replicas)]),
                           ("single chain", [])):
            out = f"{tmp}/{tag.replace(' ', '_')}"
            t0 = time.perf_counter()
            with open(f"{out}.stdout", "w") as f, \
                    contextlib.redirect_stdout(f):
                rc = cli_main(files + extra + ["-o", out])
            sec = time.perf_counter() - t0
            log = open(f"{out}/log.maniac").read()
            m = re.search(r"sentinel: (\d+) cross-checked blocks, (\d+) "
                          r"divergences", log)
            if rc != 0 or m is None:
                print(f"{tag}: exit {rc}, no sentinel summary")
                return 1
            n, k = int(m.group(1)), int(m.group(2))
            checked, diverged = checked + n, diverged + k
            print(f"{tag}: {n} cross-checked blocks, {k} divergences in "
                  f"{sec:.1f} s ({label})", flush=True)
    expected = checked * SENTINEL_BENIGN_RATE
    ok = diverged <= max(2.0, 4.0 * expected)
    print(f"total: {checked} cross-checked blocks, {diverged} divergences, "
          f"rate {diverged / checked:.5f} (the JAX package's benign "
          f"{SENTINEL_BENIGN_RATE:.4f}; the command line's rule allows "
          f"{max(2.0, 4.0 * expected):.2f}) ({label})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
