"""Times of the resync kernel on the card (K1 at B = 1024, K4 at B = 1),
and the edge replicas its checks add, so that two trees of the package are
timed alike.

    python -m maniac_tpu_torch.tools.resync_times [--seed 1234] [--blocks 4]
        [--split] [--isotherm]

On bench.py's four systems (the flagship make_zif_like(n_cells=6, a=5.66,
n_water=32, fugacity=30), mixed, resv with its reservoir, tricl; capacity
192, f32) the states of B = 1024 replicas after ``--blocks`` blocks of 400
steps of the main path (run_block_replicated with the resync) are
resynthesized by ``kernels/resync.resync_grouped``: device-paced
(kernel_times.device_ms: the calls queued behind a spin kernel, so the
host's pace drops out) and host-paced (CUDA events). K4 is the same
kernel at B = 1 through ``mc/driver.resync_amplitudes`` on replica 0 of
those states, device-paced and host-paced (at B = 1 the host's pace is
what a caller waits for). One line per system. With ``--split``, also
where the kernel's time goes, section by section, at both shapes: a
variant of the library built with -DMANIAC_SECTION_CLOCKS (beside the
production build, in the git-ignored kernels/_build/), where each section
of csrc/resync.cu ends in a CTA barrier and its clock64 ticks are summed
over the CTAs. With ``--isotherm``, only the resync's share of the
isotherm's blocks: the wall time of three 400-step blocks of
``run_block_sweep`` on the command line's isotherm spec
(kernel_times.isotherm_spec: the flagship at B = 1024, the per-step path,
then the resync), with and without the resync, after a warm-up block.

Without ``--split`` the file calls only the wrapper,
``mc/driver.resync_amplitudes``, the sweep and kernel_times, so a copy of
it in an earlier tree that has them times that tree the same way.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.threefry import fold_in, prng_key, uniform
from . import card_label, cuda_ms, require_cuda
from .kernel_times import device_ms

# bench.py's systems: (fixture maker name, its arguments, a reservoir)
SYSTEMS = {
    "flagship": ("make_zif_like", dict(n_cells=6, a=5.66, n_water=32,
                                       fugacity=30.0), None),
    "mixed": ("make_framework_mixed", dict(
        n_cells=6, a=5.66, n_water=24, n_dimer=12, cutoff=8.5, tol=1e-5,
        probs=(0.25, 0.15, 0.4, 0.2)), None),
    "resv": ("make_water_box", dict(
        n_water=48, L=24.0, cutoff=8.0, tol=1e-5, probs=(0.3, 0.2, 0.5, 0.0),
        fugacity=4000.0), dict(n_water=96, L=24.0)),
    "tricl": ("make_triclinic_water", dict(
        n_water=24, L=22.0, tilt=(2.0, 1.2, 0.8), cutoff=7.0, tol=1e-5,
        probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0), None),
}
CHUNK = 32   # csrc/resync.cu CH: charged sites a chunk
# csrc/resync.cu ResyncSection, in order
SECTIONS = ("set-up", "sites", "phase tables", "Pz and T", "contraction",
            "epilogue")


def replica(states, i: int):
    """Replica i of a batch, as a batch of one."""
    return states.replace(**{k: v[i:i + 1] for k, v in vars(states).items()})


def _charged(spec) -> dict:
    """{type: charged atoms per molecule} of the types the resynthesis
    covers (the spec's charge table)."""
    return {r: nq for _, _, nq, _, r in spec.q_regions.tolist()}


def edge_replicas(spec, states, seed: int = 0):
    """A copy of ``states`` (B >= 3) whose first three replicas are the
    resync's edges: replica 0 holds no molecule of a covered type (its
    amplitudes are fw_amp exactly); replica 1 holds every covered type at
    its capacity (slots that were empty get random positions in the box's
    bounding diagonal); replica 2 holds 11, 13, 15, ... molecules of the
    covered types with charges (at most their capacity), a number of
    charged sites that is not a multiple of the kernel's chunk, each such
    type with a different count."""
    if states.B < 3:
        raise ValueError("edge_replicas needs B >= 3")
    key = prng_key(seed)
    n_mol, pos = states.n_mol.clone(), states.pos.clone()
    charged = _charged(spec)
    counts = {}
    for k, r in enumerate(r for r in charged if charged[r]):
        counts[r] = min(spec.cap_list[r], 11 + 2 * k)
    if counts and sum(counts[r] * charged[r] for r in counts) % CHUNK == 0:
        r = next(iter(counts))
        counts[r] -= 1
    for r in charged:
        base, A, cap = (spec.site_base_list[r], spec.A_list[r],
                        spec.cap_list[r])
        live = int(n_mol[1, r]) * A
        fill = uniform(fold_in(key, r), (3, cap * A - live), torch.float64)
        pos[1, :, base + live:base + cap * A] = (
            fill * spec.box_diag.cpu().double()[:, None]).to(pos)
        n_mol[0, r] = 0
        n_mol[1, r] = cap
        n_mol[2, r] = counts.get(r, 0)
    return states.replace(n_mol=n_mol, pos=pos)


def load_cell(name: str, device, capacity: int = 192,
              seed: int | None = None):
    """load_system on one of SYSTEMS (f32, on ``device``; ``seed`` the
    state's key, default the deck's)."""
    from .. import load_system, systems
    make, kw, reservoir = SYSTEMS[name]
    with tempfile.TemporaryDirectory() as tmp:
        getattr(systems, make)(tmp, **kw)
        res = (systems.make_water_reservoir(tmp, **reservoir) if reservoir
               else None)
        return load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", reservoir_file=res,
                           capacity=capacity, dtype=torch.float32,
                           device=device, seed=seed)


def resync_cells(seed: int = 1234, blocks: int = 4) -> dict:
    """{system: (spec, states)}: each of SYSTEMS at B = 1024 after
    ``blocks`` blocks of 400 steps of the main path, made from ``seed``."""
    from .. import replicate, run_block_replicated
    dev = torch.device("cuda", 0)
    out = {}
    for name in SYSTEMS:
        sysm = load_cell(name, dev, seed=seed)
        states = replicate(sysm.spec, sysm.state, 1024)
        for _ in range(blocks):
            states = run_block_replicated(sysm.spec, states, 400, False,
                                          True)
        out[name] = (sysm.spec, states)
    return out


def resync_times(cells: dict, reps: int = 20) -> dict:
    """{system: {"K1 device-paced", "K1 host-paced", "K4 device-paced",
    "K4 host-paced": ms}} on resync_cells' cells."""
    from ..kernels.resync import resync_grouped
    from ..mc.driver import resync_amplitudes
    out = {}
    for name, (spec, states) in cells.items():
        one = replica(states, 0)
        out[name] = {
            "K1 device-paced": device_ms(
                lambda: resync_grouped(spec, states), reps),
            "K1 host-paced": cuda_ms(lambda: resync_grouped(spec, states),
                                     reps),
            "K4 device-paced": device_ms(
                lambda: resync_amplitudes(spec, one), 5 * reps),
            "K4 host-paced": cuda_ms(lambda: resync_amplitudes(spec, one),
                                     5 * reps)}
    return out


def resync_split(spec, states, reps: int = 5) -> tuple:
    """(share of the summed CTA ticks by section, instrumented ms,
    production ms) of resync_grouped on ``states``, each over reps calls."""
    from ..kernels import build
    from ..kernels.resync import resync_grouped
    ms_prod = cuda_ms(lambda: resync_grouped(spec, states), reps)
    ticks = np.zeros(len(SECTIONS), dtype=np.uint64)
    with build.variant(("MANIAC_SECTION_CLOCKS",)) as lib:
        lib.resync_section_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]

        def read():
            err = lib.resync_section_clocks(ticks.ctypes.data, ticks.size)
            if err != 0:
                raise RuntimeError(f"resync_section_clocks failed: error "
                                   f"{err}")
            return ticks.astype(np.float64)

        resync_grouped(spec, states)      # warm-up
        torch.cuda.synchronize()
        read()                            # zero the counters
        ms_inst = cuda_ms(lambda: resync_grouped(spec, states), reps)
        total = read()
    return total / total.sum(), ms_inst, ms_prod


def isotherm_blocks(seed: int = 1234, blocks: int = 3) -> tuple:
    """(seconds with the resync, seconds without, resync ms) of ``blocks``
    blocks of the isotherm's sweep, each timed from a synchronized card to
    the populations read back, after one warm-up block; the resync alone
    device-paced on the last states."""
    from .. import replicate
    from ..mc.driver import resync_amplitudes
    from ..parallel.replicas import run_block_sweep
    from .kernel_times import isotherm_spec
    dev = torch.device("cuda", 0)
    sysm = load_cell("flagship", dev, seed=seed)
    spec = isotherm_spec(sysm.spec)
    states = run_block_sweep(spec, replicate(sysm.spec, sysm.state, 1024),
                             400, True, True)
    out = []
    for resync in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(blocks):
            states = run_block_sweep(spec, states, 400, True, resync)
            states.n_mol.cpu()
        out.append(time.perf_counter() - t0)
    return (*out, device_ms(lambda: resync_amplitudes(spec, states), 20))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="resync_times",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--split", action="store_true",
                    help="also the time by section (instrumented build)")
    ap.add_argument("--isotherm", action="store_true",
                    help="only the resync's share of the isotherm's blocks")
    args = ap.parse_args(argv)
    if not require_cuda("resync_times"):
        return 1
    label = card_label()
    if args.isotherm:
        with_rs, without, ms = isotherm_blocks(args.seed)
        print(f"resync_times: isotherm 8 x 128, 3 blocks of 400 steps: "
              f"{with_rs:.4f} s with the resync, {without:.4f} s without; "
              f"the resync {ms:.4f} ms device-paced ({label})")
        return 0
    cells = resync_cells(args.seed, args.blocks)
    for name, t in resync_times(cells).items():
        print(f"resync_times: {name}: K1 B=1024 {t['K1 device-paced']:.4f} "
              f"ms device-paced, {t['K1 host-paced']:.4f} ms host-paced; K4 "
              f"B=1 {t['K4 device-paced']:.4f} ms device-paced, "
              f"{t['K4 host-paced']:.4f} ms host-paced ({label})",
              flush=True)
    if args.split:
        for name, (spec, states) in cells.items():
            for tag, st in (("K1 B=1024", states), ("K4 B=1",
                                                    replica(states, 0))):
                shares, ms_inst, ms_prod = resync_split(spec, st)
                print(f"resync_times: {name} {tag} by section: " + ", ".join(
                    f"{n} {100 * f:.1f}%" for n, f in zip(SECTIONS, shares))
                    + f"; instrumented {ms_inst:.4f} ms, production "
                    f"{ms_prod:.4f} ms host-paced ({label})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
