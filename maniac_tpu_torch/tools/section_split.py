"""Where the whole-block kernel's time goes, section by section, on the card.

    python -m maniac_tpu_torch.tools.section_split [--system zif|mixed]
        [--replicas 1024] [--steps 400]

Builds an instrumented variant of the kernel library (the same sources
compiled with -DMANIAC_SECTION_CLOCKS, beside the production build in the
git-ignored kernels/_build/) and launches it through kernels/build.variant:
there every section of a step of csrc/blockg.cu ends in a CTA barrier, and
thread 0 of each replica adds the clock64 ticks since the previous section
to its row (csrc/common.cuh SECTION_MARK). Runs one block of the main
path's shape (``--replicas`` replicas, ``--steps`` steps) after one warm-up
block, and prints each section's share of the ticks summed over the
replicas, beside the instrumented call's time and the production kernel's
time on the same inputs (the barriers the instrumented build adds cost time
of their own).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile

import numpy as np
import torch

from . import card_label, cuda_ms, require_cuda

SECTIONS = ("proposal", "phase tables", "pair pass", "k-space delta",
            "far field", "reduction", "decision and commits",
            "amplitude commit")
SECTION_REPLICAS = 4096   # csrc/common.cuh
DEFINES = ("MANIAC_SECTION_CLOCKS",)
# chip_smoke.py's flagship and bench.py's mixed
SYSTEMS = {
    "zif": ("make_zif_like", dict(n_cells=6, a=5.66, n_water=32,
                                  fugacity=30.0)),
    "mixed": ("make_framework_mixed", dict(n_cells=6, a=5.66, n_water=24,
                                           n_dimer=12, cutoff=8.5, tol=1e-5,
                                           probs=(0.25, 0.15, 0.4, 0.2))),
}


def _load(system, dev):
    from .. import load_system, systems
    make, kw = SYSTEMS[system]
    with tempfile.TemporaryDirectory() as tmp:
        getattr(systems, make)(tmp, **kw)
        return load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", capacity=192,
                           dtype=torch.float32, device=dev)


def section_split(system: str, replicas: int, steps: int, seed: int = 1234):
    """(shares by section, instrumented ms, production ms) of one block."""
    from .. import replicate, run_block_replicated
    from ..kernels import build
    from ..kernels.blockg import run_block_kernel
    from ..mc.driver import draw_uniforms
    from ..utils.threefry import prng_key
    dev = torch.device("cuda", 0)
    sysm = _load(system, dev)
    spec = sysm.spec
    state = sysm.state.replace(key=prng_key(seed, dev)[None])
    states = run_block_replicated(spec, replicate(spec, state, replicas),
                                  steps, False, True)
    states, u = draw_uniforms(spec, states, steps)
    ms_prod = cuda_ms(lambda: run_block_kernel(spec, states, u), 1)
    ticks = np.zeros((SECTION_REPLICAS, len(SECTIONS)), dtype=np.int64)
    with build.variant(DEFINES) as lib:
        lib.maniac_section_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]

        def read():
            err = lib.maniac_section_clocks(ticks.ctypes.data, ticks.size)
            if err != 0:
                raise RuntimeError(f"maniac_section_clocks failed: error "
                                   f"{err}")
            return ticks[:replicas].sum(axis=0)

        run_block_kernel(spec, states, u)        # warm-up
        torch.cuda.synchronize()
        read()                                   # zero the counters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_block_kernel(spec, states, u)
        end.record()
        torch.cuda.synchronize()
        total = read()
    return total / total.sum(), start.elapsed_time(end), ms_prod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="section_split",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--system", choices=sorted(SYSTEMS), default="zif")
    ap.add_argument("--replicas", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    if not require_cuda("section_split"):
        return 1
    shares, ms_inst, ms_prod = section_split(args.system, args.replicas,
                                             args.steps)
    label = f"{torch.cuda.get_device_name(0)}, {card_label()}"
    print(f"section_split {args.system}: B={args.replicas} x {args.steps} "
          f"steps; instrumented {ms_inst:.3f} ms, production "
          f"{ms_prod:.3f} ms ({label})")
    for name, share in zip(SECTIONS, shares):
        print(f"section_split {args.system}: {name} {100 * share:.1f}% "
              f"({share * ms_inst:.3f} ms of the instrumented call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
