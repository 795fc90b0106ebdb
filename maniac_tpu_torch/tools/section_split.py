"""Where the whole-block kernel's time goes, section by section, on the card.

    python -m maniac_tpu_torch.tools.section_split
        [--system zif|mixed|spce750 | --deck DIR --capacity N]
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
of their own), and with a frozen prefix ``frozen.kept_share``: the share of
the frozen tiles its steps tested that they kept and swept (csrc/common.cuh
frozen_tile_pass, counted by the same build). ``--deck DIR`` splits a
written deck instead (DIR's input.maniac, topology.data and
parameters.inc, loaded at ``--capacity`` molecules a type), such as the
benchmark's graphite slit as its writer leaves it:

    python -c "from portbench import run; run.write_files(
        run.read_json(run.PKG / 'configs/flue_slit.json'), 1, 'slit')"
    python -m maniac_tpu_torch.tools.section_split --deck slit \
        --capacity 128
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
# bench.py's flagship (zif) and mixed (capacity 192 a type), and
# SPC/E water in the shape of the benchmark's spce750: 750 waters at 0.83
# g/cm^3 (a 30 A box), 10 A cutoff, Ewald tolerance 1e-5, 298 K, capacity
# 1024, the no-split form
SYSTEMS = {
    "zif": ("make_zif_like", dict(n_cells=6, a=5.66, n_water=32,
                                  fugacity=30.0), 192),
    "mixed": ("make_framework_mixed", dict(n_cells=6, a=5.66, n_water=24,
                                           n_dimer=12, cutoff=8.5, tol=1e-5,
                                           probs=(0.25, 0.15, 0.4, 0.2)),
              192),
    "spce750": ("make_spce_box", dict(n_water=750, density=0.83,
                                      cutoff=10.0, tol=1e-5, temp=298.0,
                                      probs=(0.3, 0.2, 0.5, 0.0),
                                      fugacity=1128.0), 1024),
}


def _load_deck(d, capacity, dev):
    from .. import load_system
    return load_system(f"{d}/input.maniac", f"{d}/topology.data",
                       f"{d}/parameters.inc", capacity=capacity,
                       dtype=torch.float32, device=dev)


def _load(system, dev):
    from .. import systems
    make, kw, capacity = SYSTEMS[system]
    with tempfile.TemporaryDirectory() as tmp:
        getattr(systems, make)(tmp, **kw)
        return _load_deck(tmp, capacity, dev)


def section_split(sysm, replicas: int, steps: int, seed: int = 1234):
    """(shares by section, instrumented ms, production ms, frozen tiles
    kept over tested, None without a frozen prefix) of one block of the
    loaded system ``sysm`` (on the card)."""
    from .. import replicate, run_block_replicated
    from ..kernels import build
    from ..kernels.blockg import run_block_kernel
    from ..mc.driver import draw_uniforms
    from ..utils.threefry import prng_key
    dev = sysm.spec.device
    spec = sysm.spec
    state = sysm.state.replace(key=prng_key(seed, dev)[None])
    states = run_block_replicated(spec, replicate(spec, state, replicas),
                                  steps, False, True)
    states, u = draw_uniforms(spec, states, steps)
    ms_prod = cuda_ms(lambda: run_block_kernel(spec, states, u), 1)
    ticks = np.zeros((SECTION_REPLICAS, len(SECTIONS)), dtype=np.int64)
    tiles = np.zeros((SECTION_REPLICAS, 2), dtype=np.int64)
    with build.variant(DEFINES) as lib:
        for fn in (lib.maniac_section_clocks, lib.maniac_tile_counts_read):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]

        def read():
            for name, out in (("maniac_section_clocks", ticks),
                              ("maniac_tile_counts_read", tiles)):
                err = getattr(lib, name)(out.ctypes.data, out.size)
                if err != 0:
                    raise RuntimeError(f"{name} failed: error {err}")
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
    tested, kept = tiles[:replicas].sum(axis=0)
    share = float(kept) / float(tested) if tested else None
    return total / total.sum(), start.elapsed_time(end), ms_prod, share


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="section_split",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--system", choices=sorted(SYSTEMS), default="zif")
    ap.add_argument("--deck", help="a directory with input.maniac, "
                    "topology.data and parameters.inc (replaces --system)")
    ap.add_argument("--capacity", type=int, help="molecules a type, with "
                    "--deck")
    ap.add_argument("--replicas", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    if (args.deck is None) != (args.capacity is None):
        ap.error("--deck and --capacity go together")
    if not require_cuda("section_split"):
        return 1
    dev = torch.device("cuda", 0)
    if args.deck is None:
        name, sysm = args.system, _load(args.system, dev)
    else:
        name, sysm = args.deck, _load_deck(args.deck, args.capacity, dev)
    shares, ms_inst, ms_prod, kept = section_split(sysm, args.replicas,
                                                   args.steps)
    label = f"{torch.cuda.get_device_name(0)}, {card_label()}"
    print(f"section_split {name}: B={args.replicas} x {args.steps} "
          f"steps; instrumented {ms_inst:.3f} ms, production "
          f"{ms_prod:.3f} ms ({label})")
    for section, share in zip(SECTIONS, shares):
        print(f"section_split {name}: {section} {100 * share:.1f}% "
              f"({share * ms_inst:.3f} ms of the instrumented call)")
    if kept is not None:
        print(f"section_split {name}: frozen.kept_share {kept:.4f} (of "
              f"{int(sysm.spec.fw_tile_box.shape[0])} frozen tiles a step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
