"""Hand-written CUDA kernels for the hot path, and their dispatch.

Two kernels serve the main path on a CUDA device:

* ``blockg.run_block_kernel`` (csrc/blockg.cu): a whole block of MC steps
  per replica, the counterpart of maniac_tpu/kernels/blockg.py
  ``_blockg_kernel`` in its one-active-species, framework-split,
  orthorhombic, no-reservoir form;
* ``resync.resync_grouped`` (csrc/resync.cu): the per-block amplitude
  resynthesis, the counterpart of maniac_tpu/kernels/resync.py
  ``_resyncg_kernel``.

Dispatch is split by what it depends on. The spec gates
(``block_gate_failure``, ``resync_gate_failure``) are the only rule on the
spec: parallel/replicas.py calls a wrapper for a spec inside its gate and
the plain path otherwise, and dispatch_report says which. The device is
decided only in the wrappers: for tensors on the CPU they run their plain
torch version; for a CUDA tensor they launch the kernel or raise (there is
no fallback). ``use_block_kernel`` and ``use_resync_kernel`` combine the two
for a given device.
"""

from __future__ import annotations

import torch


def block_gate_failure(spec) -> str | None:
    """First static-spec condition the block kernel does not take, or None
    (the counterpart of maniac_tpu.kernels.use_blockg)."""
    if spec.dtype_name != "float32":
        return f"dtype {spec.dtype_name} (the kernels take float32)"
    if spec.n_active != 1:
        return f"{spec.n_active} active species (kernel takes 1)"
    if not spec.fw_split:
        return "framework split off"
    if spec.is_triclinic:
        return "triclinic box"
    if spec.has_reservoir:
        return "reservoir"
    if spec.use_table:
        return "tabulated potentials"
    # the kernel's static shared-memory tables (csrc/blockg.cu MAXA, MAXR,
    # JMAX)
    if spec.A_act > 8:
        return f"{spec.A_act} atoms per molecule (kernel takes <= 8)"
    if spec.R > 8:
        return f"{spec.R} residue types (kernel takes <= 8)"
    if max(spec.kmax_xyz + spec.kmax2_xyz) > 31:
        return "k-grid order above 31"
    return None


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


def use_resync_kernel(spec, device) -> bool:
    """True when the amplitude resync runs in the CUDA kernel."""
    return (torch.device(device).type == "cuda"
            and resync_gate_failure(spec) is None)


def dispatch_report(spec, device) -> str:
    """One line naming the implementation of the block and of the resync
    on ``device``, with the reason when it is the plain path."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"kernel dispatch: plain torch path (device {device.type})"
    block = ("CUDA whole-block kernel" if use_block_kernel(spec, device)
             else f"plain torch path ({block_gate_failure(spec)})")
    resync = ("CUDA resync kernel" if use_resync_kernel(spec, device)
              else f"plain torch path ({resync_gate_failure(spec)})")
    return f"kernel dispatch: block: {block}; resync: {resync}"
