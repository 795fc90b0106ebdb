"""Cross-replica diagnostics.

Counterpart of maniac_tpu/parallel/mesh.py::gather_replica_stats; the rest
of that module (the multi-device mesh) is not ported yet.
"""

from __future__ import annotations

import torch

from ..system import SimState


def gather_replica_stats(states: SimState, R: int, e_tot: int):
    """Per-block cross-replica observables, reduced on the device so only
    2R+2 numbers reach the host: mean and population std of N per residue
    type, and of the running total energy (f64 accumulation)."""
    n = states.n_mol[:, :R].to(torch.float64)
    e = states.energy[:, e_tot].to(torch.float64)
    return (n.mean(dim=0), n.std(dim=0, unbiased=False), e.mean(),
            e.std(unbiased=False))
