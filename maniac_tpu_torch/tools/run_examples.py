"""Named example launcher for the port (the counterpart of
examples/run_examples.py, the analog of the reference's run.sh cases).
Each case writes its own topology, deck and coefficients and runs the
port's command line, ``python -m maniac_tpu_torch.cli``, end to end.

    python -m maniac_tpu_torch.tools.run_examples            # list cases
    python -m maniac_tpu_torch.tools.run_examples H2O-gas    # one case
    python -m maniac_tpu_torch.tools.run_examples all isotherm \\
        [--platform cuda|cpu] [CLI flags, e.g. --sentinel 1]

``--platform`` goes to the command line (the card by default; without one
the tool exits 1 unless ``--platform cpu`` is given), and so does every
flag the tool does not know. ``isotherm`` runs the flagship chemistry's
adsorption isotherm in the library (parallel/replicas.perturb_activity
and run_block_sweep). A case passes when the command line exits 0 and
its log holds "Simulation Completed"; the tool prints each case's kernel
dispatch line and exits 1 if any case failed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

from .. import systems

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CASES = {
    # name: (the system's writer, its arguments, CLI extras)
    "H2O-gas": (systems.make_water_box,
                dict(n_water=8, L=14.0, cutoff=6.0, tol=1e-6, nb_block=5,
                     nb_step=500, probs=(0.5, 0.5, 0.0, 0.0)), []),
    "H2O-gcmc": (systems.make_water_box,
                 dict(n_water=8, L=14.0, cutoff=5.5, tol=1e-5, nb_block=5,
                      nb_step=500, probs=(0.3, 0.3, 0.4, 0.0),
                      fugacity=2000.0, recal=True), ["--widom", "32"]),
    "LJ-gas": (systems.make_lj_gas,
               dict(n=32, L=18.0, cutoff=6.0, tol=1e-4, nb_block=5,
                    nb_step=500, probs=(0.4, 0.0, 0.6, 0.0), fugacity=5.0),
               []),
    "LJ-swap": (systems.make_lj_gas,
                dict(n=24, L=16.0, two_species=True, cutoff=6.0, tol=1e-4,
                     nb_block=5, nb_step=400, probs=(0.2, 0.0, 0.3, 0.5),
                     fug_a=3.0, fug_b=3.0), []),
    "NaCl": (systems.make_nacl,
             dict(n_cells=2, cutoff=5.6, tol=1e-6, nb_block=2, nb_step=100,
                  probs=(1.0, 0.0, 0.0, 0.0)), []),
    "ZIF8-H2O": (systems.make_zif_like,
                 dict(n_cells=4, a=5.66, n_water=16, fugacity=30.0,
                      nb_block=3, nb_step=300), ["--capacity", "64"]),
    "DIPOLE-triclinic": (systems.make_triclinic_water,
                         dict(n_water=6, L=14.0, tilt=(2.0, 1.2, 0.8),
                              cutoff=5.5, tol=1e-5, nb_block=3, nb_step=300,
                              probs=(0.4, 0.3, 0.3, 0.0), fugacity=1000.0),
                         []),
    # analogs of the remaining reference run.sh cases (run.sh:4-96)
    "SLIT": (systems.make_slit_pore,
             dict(n_water=8, nb_block=3, nb_step=300, fugacity=80.0),
             ["--capacity", "24", "--profile", "16"]),
    "MFI-CO2": (systems.make_mfi_co2,
                dict(n_co2=8, nb_block=3, nb_step=300, fugacity=40.0),
                ["--capacity", "32"]),
    "CH4O-H2O": (systems.make_fw_ch4o_h2o,
                 dict(n_water=6, n_meoh=6, nb_block=3, nb_step=300),
                 ["--capacity", "24"]),
}
# the isotherm's fugacity scales of the deck's fugacity
ISOTHERM_SCALES = (0.25, 1.0, 4.0, 16.0)


def case_argv(name: str, outdir: str, extra=()) -> list[str]:
    """Write case ``name``'s files into outdir and return the command
    line's arguments for it (outputs in outdir/outputs/), the case's own
    flags, then ``extra``."""
    make, kw, flags = CASES[name]
    make(outdir, **kw)
    return (["-i", f"{outdir}/input.maniac", "-d", f"{outdir}/topology.data",
             "-p", f"{outdir}/parameters.inc", "-o",
             os.path.join(outdir, "outputs/")] + flags + list(extra))


def case_passed(rc: int, outdir: str) -> bool:
    """The reference's black-box contract: exit 0 and the banner."""
    log = os.path.join(outdir, "outputs", "log.maniac")
    return (rc == 0 and os.path.exists(log)
            and "Simulation Completed" in open(log).read())


def dispatch_line(outdir: str) -> str:
    """The kernel dispatch line of a case's log ("" when there is none)."""
    log = os.path.join(outdir, "outputs", "log.maniac")
    if not os.path.exists(log):
        return ""
    return next((ln.strip() for ln in open(log) if "kernel dispatch" in ln),
                "")


def run_case(name: str, extra=()) -> int:
    """Run one case through ``python -m maniac_tpu_torch.cli``; 0 if it
    passed."""
    tmp = tempfile.mkdtemp(prefix=f"maniac-torch-{name}-")
    cmd = [sys.executable, "-m", "maniac_tpu_torch.cli"] + case_argv(
        name, tmp, extra)
    print(f"== {name}: {' '.join(cmd)}", flush=True)
    rc = subprocess.call(cmd, cwd=REPO)
    ok = case_passed(rc, tmp)
    print(f"== {name}: {dispatch_line(tmp)}")
    print(f"== {name}: {'OK' if ok else 'FAILED'} (outputs in {tmp}/outputs)",
          flush=True)
    return 0 if ok else 1


def isotherm(device: str) -> list[float]:
    """One batched run is a whole adsorption isotherm: one replica a
    fugacity scale (ISOTHERM_SCALES), each with its own activity, on the
    ZIF-like flagship chemistry (capacity 64; f32 on the card, f64 on the
    CPU, the command line's defaults): 2000 burn-in steps, then the mean
    water count over 10 blocks of 200. Returns the means."""
    import numpy as np
    import torch

    from ..api import load_system
    from ..parallel.replicas import (perturb_activity, replicate,
                                     run_block_sweep)

    tmp = tempfile.mkdtemp(prefix="maniac-torch-isotherm-")
    systems.make_zif_like(tmp, n_cells=3, a=5.66, n_water=4, fugacity=10.0)
    dtype = torch.float32 if device == "cuda" else torch.float64
    sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                       f"{tmp}/parameters.inc", capacity=64, dtype=dtype,
                       device=device)
    spec, state = sysm.spec, sysm.state
    scale = np.array(ISOTHERM_SCALES)
    base = spec.type_activity.cpu().double().numpy()[None, :] * scale[:, None]
    spec_sweep = perturb_activity(spec, base)
    states = replicate(spec, state, len(scale))
    states = run_block_sweep(spec_sweep, states, 2000, False)  # burn-in
    counts = np.zeros(len(scale))
    for _ in range(10):
        states = run_block_sweep(spec_sweep, states, 200, False)
        counts += states.n_mol[:, 1].cpu().numpy()
    means = list(counts / 10)
    print("== isotherm (fugacity scale -> <N waters>):")
    for s, n in zip(scale, means):
        print(f"   {s:6.2f}x -> {n:7.2f}")
    return means


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.run_examples",
        description="run the named examples through the port's command "
                    "line; unknown flags go to the command line")
    ap.add_argument("names", nargs="*",
                    help=f"cases ({' '.join(CASES)}), isotherm, or all")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    args, extra = ap.parse_known_args(argv)
    if not args.names:
        print("cases:", " ".join(CASES), "isotherm")
        return 0
    if args.platform == "cuda":
        from . import card_label, require_cuda
        if not require_cuda("run_examples"):
            return 1
        print(f"# device: {card_label()}")
    names = list(CASES) if args.names == ["all"] else args.names
    unknown = [n for n in names if n not in CASES and n != "isotherm"]
    if unknown:
        ap.error(f"unknown case(s): {' '.join(unknown)}")
    rc = 0
    for n in names:
        if n == "isotherm":
            isotherm(args.platform)
        else:
            rc = max(rc, run_case(n, ["--platform", args.platform] + extra))
    return rc


if __name__ == "__main__":
    sys.exit(main())
