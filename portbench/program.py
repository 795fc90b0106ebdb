"""What the drivers take of the program under test, maniac_tpu_torch.

Every import of the program happens inside a function, at run time, so
that importing the harness loads nothing of it.
"""

from __future__ import annotations

import time

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def load(ctx):
    """load_system on the cell's files at the configuration's capacity and
    dtype, the threefry key from the run's seed; returns the LoadedSystem
    and the seconds it took, synchronised."""
    from maniac_tpu_torch.api import load_system
    from maniac_tpu_torch.utils.logger import NullLogger
    t0 = time.perf_counter()
    sysm = load_system(ctx.files["input"], ctx.files["data"],
                       ctx.files["params"],
                       capacity=ctx.config["capacity"],
                       dtype=DTYPES[ctx.config["dtype"]], device=ctx.device,
                       logger=NullLogger(), seed=ctx.seed)
    sync()
    return sysm, time.perf_counter() - t0
