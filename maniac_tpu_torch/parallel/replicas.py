"""Batched replica chains on one device.

Counterpart of maniac_tpu/parallel/replicas.py. Replicas are the leading
axis of every SimState tensor; they start from one state and differ only
through the uniforms each one consumes. A spec inside a kernel's gate goes
through the kernel's wrapper, which launches kernels/csrc/blockg.cu or
kernels/csrc/resync.cu for CUDA tensors and runs its plain version for CPU
tensors; a spec outside the gate runs the plain torch path
(kernels.dispatch_report says which).
"""

from __future__ import annotations

import torch

from ..kernels import block_gate_failure, resync_gate_failure
from ..mc.driver import (_recalibrate, draw_uniforms, resync_amplitudes_body,
                         run_steps_u)
from ..system import SimState, SystemSpec


def replicate(spec: SystemSpec, state: SimState, n_replicas: int) -> SimState:
    """Broadcast replica 0 of ``state`` into n_replicas chains (copies)."""
    return SimState(**{k: v[:1].expand(n_replicas, *v.shape[1:]).contiguous()
                       for k, v in vars(state).items()})


def run_block_uniforms(spec: SystemSpec, states: SimState, uniforms,
                       recalibrate: bool, resync: bool = False) -> SimState:
    """One block over all replicas from explicit uniforms (B, n_steps, 21):
    the MC steps, the step-size recalibration and (resync=True) the
    amplitude resynthesis."""
    from ..kernels.blockg import run_block_kernel
    from ..kernels.resync import resync_grouped
    block = (run_block_kernel if block_gate_failure(spec) is None
             else run_steps_u)
    out = _recalibrate(block(spec, states, uniforms), recalibrate)
    if resync:
        out = (resync_grouped if resync_gate_failure(spec) is None
               else resync_amplitudes_body)(spec, out)
    return out


def run_block_replicated(spec: SystemSpec, states: SimState, n_steps: int,
                         recalibrate: bool, resync: bool,
                         generator: torch.Generator) -> SimState:
    """One block over all replicas with uniforms drawn from ``generator``
    (on the states' device)."""
    u = draw_uniforms(spec, states.B, n_steps, generator)
    return run_block_uniforms(spec, states, u, recalibrate, resync)
