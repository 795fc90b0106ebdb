"""Whole-block MC kernel for B replicas.

``run_block_kernel`` replaces maniac_tpu/kernels/blockg.py::
run_block_grouped (kernel ``_blockg_kernel``) in all its f32 forms: one or
more active species (with the swap move), framework split or no split with
every type active, an orthorhombic or a triclinic box, each with or
without a reservoir (kernels.block_gate_failure is the gate).
For a CUDA state it launches csrc/blockg.cu; for a CPU state it runs its
plain version, mc/driver.py::steps_plain (a Python loop of
mc/moves.py::mc_step_u with the plain energy core and the reservoir moves)
over the same uniforms. Step-size recalibration runs after it, in torch.
"""

from __future__ import annotations

import torch

from ..mc.driver import steps_plain
from ..system import SimState, SystemSpec
from ..utils import trace
from . import block_gate_failure, build, image_failure
from .stepg import RES_KEYS, STATE_KEYS, step_tables


def run_block_kernel(spec: SystemSpec, states: SimState, uniforms) -> SimState:
    """Run uniforms.shape[1] MC steps for every replica; uniforms are
    replica-major (B, n_steps, 21) in the spec dtype."""
    if states.pos.device.type == "cpu":
        return steps_plain(spec, states, uniforms)
    with trace.span("kernels.blockg"):
        return _launch(spec, states, uniforms)


def _launch(spec, states, uniforms):
    """Check the inputs, allocate the outputs and launch csrc/blockg.cu."""
    failure = block_gate_failure(spec) or image_failure(spec)
    if failure is not None:
        raise ValueError(f"the block kernel does not take this spec: "
                         f"{failure}")
    # the kernel writes the reservoir only when there is one; otherwise the
    # (tiny, unread) inputs pass through as they are
    keys = STATE_KEYS + (RES_KEYS if spec.has_reservoir else ())
    out = states.replace(**{k: torch.empty_like(getattr(states, k))
                            for k in keys})
    ptrs, ints, floats = step_tables(spec, states, uniforms, out)
    # blockg.cu's own pointers after the shared ones: the input state
    ptrs += [getattr(states, k).data_ptr() for k in STATE_KEYS + RES_KEYS]
    build.launch("blockg_launch", ptrs, ints, floats, states.pos.device)
    trace.count(f"blockg.form.{form(spec)}")
    return out


def form(spec: SystemSpec) -> str:
    """The template form of csrc/blockg.cu (<TRICLINIC, MULTI, FAR, TILES>)
    a launch for ``spec`` takes, as its counter ``blockg.form.<form>``
    names it: the forms' flags joined by ``_`` (``tricl``, ``multi``,
    ``far``, ``tiles``: a frozen prefix, swept by tiles; a triclinic box
    has neither, and a far table comes with tiles), ``single`` for
    none."""
    tiles = spec.fw_split and spec.fw_tile_box.shape[0] > 0
    far = tiles and spec.far_units.shape[0] > 0
    flags = [name for name, on in (("tricl", spec.is_triclinic),
                                   ("multi", spec.n_active >= 2),
                                   ("far", far), ("tiles", tiles)) if on]
    return "_".join(flags) or "single"
