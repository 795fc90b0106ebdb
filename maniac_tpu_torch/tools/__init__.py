"""Command-line tools that measure the card: ``precision_probe`` (the
hardware-precision probe), ``gpass_bench`` (the guest pair pass),
``vpu_bench`` (chained f32 primitives and the framework Coulomb pass's
plane math), ``section_split`` (the block kernel's time by section, from a
clock64-instrumented build), ``launch_cost`` (the host's cost of a
kernel launch), ``kernel_times`` (the step and one-hot kernels, each
timed two ways), ``micro_times`` (the micro-benchmark kernels timed two
ways and their loops' SASS), ``resync_times`` (the resync kernel at B =
1024 and B = 1, and its time by section), ``cli_times`` (the command line's
isotherm and single chain, run after run in one process) and
``sentinel_rate`` (the sentinel's divergences over long command-line
runs), each run as ``python -m maniac_tpu_torch.tools.<name>``.
They need a CUDA device and exit 1 without one; every time they print
comes with the card's name and power limit. The validation tools
``delta_e_report`` (the f32 per-move dE envelope), ``validate_spce``
(SPC/E's Widom mu_ex) and ``run_examples`` (the named examples through
the command line) run on the card by default, and on the CPU when given
``--platform cpu``. ``bounds`` has no command line: it counts the least
time the card could take for a kernel call's work, for chip_smoke.py and
``python -m maniac_tpu_torch.bench``.
"""

from __future__ import annotations

import subprocess
import sys

import torch


def require_cuda(tool: str) -> bool:
    """True when a CUDA device is present; else a message on stderr."""
    if torch.cuda.is_available():
        return True
    print(f"{tool}: no CUDA device (this tool measures the card)",
          file=sys.stderr)
    return False


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() in ms over reps calls after one warm-up call, by
    CUDA events (for a launch-bound fn this includes the device waiting on
    the host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
