"""A single chain, as the command line runs one without ``--replicas``.

load_system, then a block is the command line's f32 single-chain block
(maniac_tpu_torch/cli.py:196-232) with no files written: draw_uniforms,
block_body_u (the step kernel, K3, once a step at B = 1) and the per-block
refresh of the energy from positions (mc/driver.resync, plain torch).
"""

from __future__ import annotations

from .. import program


class Driver:
    end_of_block = "refresh"

    def __init__(self, ctx):
        sysm, load_s = program.load(ctx)
        self.spec = sysm.spec
        self.loaded_energy = sysm.state.energy[0]
        self.states = self.pre = sysm.state
        self.B = 1
        self.n_steps = int(ctx.traffic["steps_per_block"])
        self.setup = {"load_s": load_s}
        self.u = None

    def block(self, span):
        from maniac_tpu_torch.mc.driver import (block_body_u, draw_uniforms,
                                                resync)
        self.pre = self.states
        with span("draw"):
            st, self.u = draw_uniforms(self.spec, self.states,
                                       self.n_steps)
        with span("steps"):
            st = block_body_u(self.spec, st, self.u, False)
        with span("refresh"):
            self.states = resync(self.spec, st)
