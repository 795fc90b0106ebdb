"""Batched replica chains on one device.

Counterpart of maniac_tpu/parallel/replicas.py. Replicas are the leading
axis of every SimState tensor; they start from one state and differ only
through the uniforms each one draws from its own key (and, in an isotherm
sweep, their activities). A spec inside a kernel's gate goes through the
kernel's wrapper, which launches kernels/csrc/blockg.cu or
kernels/csrc/resync.cu for CUDA tensors and runs its plain version for
CPU tensors; a block
outside the whole-block gate runs the per-step path, whose steps are
kernels/csrc/stepg.cu, one launch a step, under the same rule
(kernels.dispatch_report says which).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import block_gate_failure
from ..mc.driver import (_recalibrate, draw_uniforms, resync_amplitudes,
                         run_steps_u)
from ..system import SimState, SystemSpec
from ..utils import trace
from ..utils.threefry import split


def replicate(spec: SystemSpec, state: SimState, n_replicas: int) -> SimState:
    """Broadcast replica 0 of ``state`` into n_replicas chains (copies),
    each with its own key: split(replica 0's key, n_replicas), computed on
    the host, as maniac_tpu/parallel/replicas.py::replicate does."""
    with trace.span("replicate"):
        out = SimState(**{k: v[:1].expand(n_replicas, *v.shape[1:])
                          .contiguous() for k, v in vars(state).items()})
        return out.replace(key=split(state.key[0].cpu(), n_replicas)
                           .to(state.key.device))


def perturb_activity(spec: SystemSpec, activities) -> SystemSpec:
    """Per-replica chemical potentials for isotherm sweeps: a spec whose
    type_activity is (n_replicas, R), one activity table per replica."""
    act = torch.as_tensor(activities, dtype=spec.dtype, device=spec.device)
    if act.dim() != 2 or act.shape[1] != spec.R:
        raise ValueError(f"activities must be (n_replicas, {spec.R}), got "
                         f"{tuple(act.shape)}")
    return dataclasses.replace(spec, type_activity=act.contiguous())


def run_block_uniforms(spec: SystemSpec, states: SimState, uniforms,
                       recalibrate: bool, resync: bool = False,
                       n_replicas: int | None = None) -> SimState:
    """One block over all replicas from explicit uniforms (B, n_steps, 21):
    the MC steps, the step-size recalibration and (resync=True) the
    amplitude resynthesis. ``n_replicas``: the run's replicas in all where
    ``states`` is one rank's slice (mc/driver.py::run_steps_u)."""
    from ..kernels.blockg import run_block_kernel
    with trace.span("mc.block"):
        if block_gate_failure(spec) is None:
            out = run_block_kernel(spec, states, uniforms)
        else:
            out = run_steps_u(spec, states, uniforms, n_replicas=n_replicas)
        if recalibrate:
            with trace.span("mc.recalibrate"):
                out = _recalibrate(out, recalibrate)
        return resync_amplitudes(spec, out) if resync else out


def run_block_replicated(spec: SystemSpec, states: SimState, n_steps: int,
                         recalibrate: bool, resync: bool = False,
                         n_replicas: int | None = None) -> SimState:
    """One block over all replicas with uniforms drawn from their keys
    (draw_uniforms); ``n_replicas`` as in run_block_uniforms."""
    states, u = draw_uniforms(spec, states, n_steps)
    return run_block_uniforms(spec, states, u, recalibrate, resync,
                              n_replicas)


def run_block_sweep_uniforms(spec: SystemSpec, states: SimState, uniforms,
                             recalibrate: bool,
                             resync: bool = False) -> SimState:
    """run_block_uniforms for a spec with a per-replica activity axis
    (perturb_activity): one isotherm, every state point a batch of
    replicas, in one block. The block kernel does not take a per-replica
    activity, so the steps run the per-step path (the step kernel reads
    each replica's activity table), then the resync."""
    if tuple(spec.type_activity.shape) != (states.B, spec.R):
        raise ValueError(f"a sweep needs type_activity ({states.B}, "
                         f"{spec.R}), got {tuple(spec.type_activity.shape)}")
    return run_block_uniforms(spec, states, uniforms, recalibrate, resync)


def run_block_sweep(spec: SystemSpec, states: SimState, n_steps: int,
                    recalibrate: bool, resync: bool = False) -> SimState:
    """run_block_sweep_uniforms with uniforms drawn from the replicas'
    keys (draw_uniforms)."""
    states, u = draw_uniforms(spec, states, n_steps)
    return run_block_sweep_uniforms(spec, states, u, recalibrate, resync)
