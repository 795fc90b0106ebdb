"""Hand-written CUDA kernels for the hot path, and their dispatch.

Three kernels serve the MC paths on a CUDA device:

* ``blockg.run_block_kernel`` (csrc/blockg.cu): a whole block of MC steps
  per replica, the counterpart of maniac_tpu/kernels/blockg.py
  ``_blockg_kernel`` in all its f32 forms: one or more active species
  (with the swap move), the framework split or every type active, an
  orthorhombic or a triclinic box (27-image minimum image; the split is
  orthorhombic only), each with or without a reservoir, and one activity
  for every replica;
* ``stepg.run_steps_kernel`` (csrc/stepg.cu): whole MC steps for B
  replicas, one launch a step, in place on a clone of the caller's state:
  the counterpart of maniac_tpu/kernels/stepg.py ``_stepg_kernel`` with the
  proposal and the bookkeeping around it (and, on triclinic boxes, of the
  XLA core the JAX package runs there). It runs the same step body as the
  block kernel (csrc/step_body.cuh). Every f32 block outside the block
  kernel's gate (a per-replica activity sweep, a single chain, an inactive
  type without the framework split) runs its steps through it;
* ``resync.resync_grouped`` (csrc/resync.cu): the per-block amplitude
  resync for B replicas, the counterpart of maniac_tpu/kernels/resync.py
  ``_resyncg_kernel``, and at B = 1 of ``_resync_kernel``.

Every block draws its uniforms through ``threefry.split_uniform``
(csrc/threefry.cu, no gate: any spec, f32 or f64), which splits each
replica's threefry key and writes the block's uniforms, JAX's stream.

Beside them, off the MC paths and without a gate: ``hwprobe.onehot_product``
(csrc/hwprobe.cu), stage 1 of the hardware-precision probe
(utils/hwprobe.py), and the micro-benchmarks ``gpass.gpass``
(csrc/gpass.cu, the block kernel's guest pair pass) and ``vpu.vpu_chain``
and ``vpu.cpass`` (csrc/vpu.cu, chained f32 primitives and the framework
Coulomb pass's plane math), driven by maniac_tpu_torch/tools.

Dispatch is split by what it depends on. The spec gates
(``block_gate_failure``, ``step_gate_failure``, ``resync_gate_failure``)
are the only rule on the spec: the callers (parallel/replicas.py,
mc/moves.py, mc/driver.py) call a wrapper for a spec inside its gate and
the plain path otherwise, and dispatch_report says which. The device is
decided only in the wrappers: for tensors on the CPU they run their plain
torch version; for a CUDA tensor they launch the kernel or raise (there is
no fallback). ``use_block_kernel``, ``use_step_kernel`` and
``use_resync_kernel`` combine the two for a given device.
"""

from __future__ import annotations

import torch


def block_gate_failure(spec) -> str | None:
    """First static-spec condition the block kernel does not take, or None
    (the counterpart of maniac_tpu.kernels.use_blockg): the step kernel's
    gate, then the framework split or every type active, and one activity
    table. Any number of active species, a triclinic box and a reservoir
    are taken."""
    failure = step_gate_failure(spec)
    if failure is not None:
        return failure
    if not spec.fw_split and spec.R != spec.n_active:
        return "framework split off with inactive types"
    if spec.type_activity.dim() != 1:
        return "per-replica activity (the kernel reads one activity table)"
    return None


def _table_limit_failure(spec) -> str | None:
    """The kernels' static shared-memory tables (csrc/common.cuh MAXA,
    MAXR, JMAX)."""
    if spec.A_act > 8:
        return f"{spec.A_act} atoms per molecule (kernel takes <= 8)"
    if spec.R > 8:
        return f"{spec.R} residue types (kernel takes <= 8)"
    if max(spec.kmax_xyz + spec.kmax2_xyz) > 31:
        return "k-grid order above 31"
    return None


def step_gate_failure(spec) -> str | None:
    """First static-spec condition the per-step kernel does not take, or
    None. It takes any number of active species, with the framework split
    on or off (an inactive type without the split included), an
    orthorhombic or a triclinic box, one activity table or one per replica,
    and a reservoir. Tabulated potentials (use_table) are named first, in
    any dtype: they take the plain torch step on every device, as the JAX
    package runs them on XLA (maniac_tpu/kernels/__init__.py)."""
    if spec.use_table:
        return "tabulated potentials"
    if spec.dtype_name != "float32":
        return f"dtype {spec.dtype_name} (the kernels take float32)"
    return _table_limit_failure(spec)


def resync_gate_failure(spec) -> str | None:
    """Why the resync kernel does not take the spec, or None (it is f32-only;
    the resynthesis does not depend on the move set)."""
    if spec.dtype_name != "float32":
        return f"dtype {spec.dtype_name} (the kernels take float32)"
    return None


def use_block_kernel(spec, device) -> bool:
    """True when a block runs in the CUDA whole-block kernel."""
    return (torch.device(device).type == "cuda"
            and block_gate_failure(spec) is None)


def use_step_kernel(spec, device) -> bool:
    """True when an MC step runs in the CUDA per-step kernel (the whole
    step: proposal, energies, decision and commits)."""
    return (torch.device(device).type == "cuda"
            and step_gate_failure(spec) is None)


def use_resync_kernel(spec, device) -> bool:
    """True when the amplitude resync runs in the CUDA kernel."""
    return (torch.device(device).type == "cuda"
            and resync_gate_failure(spec) is None)


def dispatch_report(spec, device) -> str:
    """One line naming the implementation of the block, of the MC steps of
    a block that is not the whole-block kernel (the per-step kernel runs
    whole steps, one launch each), and of the resync on ``device``, with the
    reason when it is not the kernel."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"kernel dispatch: plain torch path (device {device.type})"
    block = ("CUDA whole-block kernel" if use_block_kernel(spec, device)
             else f"per-step path ({block_gate_failure(spec)})")
    step = ("CUDA per-step kernel" if use_step_kernel(spec, device)
            else f"plain torch path ({step_gate_failure(spec)})")
    resync = ("CUDA resync kernel" if use_resync_kernel(spec, device)
              else f"plain torch path ({resync_gate_failure(spec)})")
    return f"kernel dispatch: block: {block}; step: {step}; resync: {resync}"
