"""Many replica chains at the deck's fugacity: the main path.

load_system -> replicate(B), then a block is run_block_replicated(spec,
states, steps, False, resync) in its two calls: draw_uniforms (the
threefry kernel) and run_block_uniforms (the whole-block kernel, K2, and
the amplitude resync, K1), so that the block's uniforms are kept.
"""

from __future__ import annotations

import time

from .. import program


class Driver:
    end_of_block = "resync"

    def __init__(self, ctx):
        from maniac_tpu_torch.parallel.replicas import replicate
        sysm, load_s = program.load(ctx)
        t0 = time.perf_counter()
        self.spec = sysm.spec
        self.loaded_energy = sysm.state.energy[0]
        self.B = int(ctx.traffic["replicas"])
        self.n_steps = int(ctx.traffic["steps_per_block"])
        self.resync = bool(ctx.traffic["resync"])
        self.states = replicate(self.spec, sysm.state, self.B)
        program.sync()
        self.setup = {"load_s": load_s,
                      "replicate_s": time.perf_counter() - t0}
        self.pre = self.states
        self.u = None

    def block(self, span):
        from maniac_tpu_torch.mc.driver import draw_uniforms
        from maniac_tpu_torch.parallel.replicas import run_block_uniforms
        self.pre = self.states
        with span("draw"):
            st, self.u = draw_uniforms(self.spec, self.states, self.n_steps)
        with span("block"):
            self.states = run_block_uniforms(self.spec, st, self.u, False,
                                             self.resync)
