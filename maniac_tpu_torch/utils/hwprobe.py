"""Hardware-precision evidence on the card; counterpart of
maniac_tpu/utils/hwprobe.py (tools/precision_probe.py of this package is
the command line).

On a TPU the risk was bf16 rounding of f32 matmul operands; on this card it
is TF32 (a 10-bit mantissa) in library products. The engine moves
positions through every product, so the probes check, on the device that
runs them:

stage 1  a column read through a one-hot matrix must be exact, both from
         the library product (torch.matmul) under the port's precision
         settings (system.disable_tf32, which load_system applies on the
         card) and from the port's own kernel (kernels/hwprobe.py, K5).
         Detects TF32 switched back on.
stage 2  rigid molecules stay rigid on the default dispatch: SPC/E water
         NVT blocks (the whole-block kernel on the card), then
         max | |O-H| - 1 A | must sit at f32 rounding scale (some 1e-6 A;
         a 10-bit mantissa would give 1e-3 A). Detects reduced precision
         anywhere positions flow.
stage 3  sentinel: one more block replayed through the plain path from the
         same pre-block state and uniforms must reproduce the kernel's
         populations and counters (mc/driver.py::sentinel_check). A
         Metropolis decision at its threshold can flip under another f32
         summation order; PROBE_SEED's threefry stream was checked on the
         card to give 0 mismatches (PERF.md), so the check is
         deterministic.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

# the seed of stages 2-3's threefry keys (also the SPC/E box's placement
# seed)
PROBE_SEED = 20260820
PROBE_REPLICAS = 8
PROBE_CAPACITY = 96
# f32 rounding's random walk is some 1e-6 A; a 10-bit mantissa's rounding
# of the geometry some 1e-3 A per block; 1e-4 separates them
RIGID_TOL = 1e-4


def onehot_operands():
    """(x (8, 256) f32, one-hot (256, 8) f32, the exact x @ oh in f64):
    x from a seeded uniform on [-20, 20], oh picking columns 100-107."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-20, 20, (8, 256)).astype(np.float32)
    oh = np.zeros((256, 8), np.float32)
    for j in range(8):
        oh[100 + j, j] = 1.0
    return x, oh, x[:, 100:108].astype(np.float64)


def onehot_verdict(library, kernel, want) -> tuple[bool, str]:
    """(both products exact, detail) for the library's and the kernel's
    products (numpy) against the exact one."""
    e_lib = float(np.abs(np.asarray(library, np.float64) - want).max())
    e_ker = float(np.abs(np.asarray(kernel, np.float64) - want).max())
    ok = e_lib == 0.0 and e_ker == 0.0
    return ok, f"one-hot read error library={e_lib:.3e} kernel={e_ker:.3e}"


def probe_onehot_exact(device="cuda") -> tuple[bool, str]:
    """Stage 1: one-hot reads through torch.matmul and through the K5
    kernel must be bit-exact."""
    from ..kernels.hwprobe import onehot_product
    from ..system import disable_tf32
    disable_tf32()
    x, oh, want = onehot_operands()
    xt = torch.from_numpy(x).to(device)
    oht = torch.from_numpy(oh).to(device)
    return onehot_verdict(torch.matmul(xt, oht).cpu().numpy(),
                          onehot_product(xt, oht).cpu().numpy(), want)


def rigid_deviation(spec, states) -> float:
    """max | |O-H| - 1 A | over the live SPC/E waters of every replica (the
    first type's molecules, sites O, H, H)."""
    n = int(states.n_mol[:, 0].min())
    base = spec.site_base_list[0]
    o = [base + 3 * m for m in range(n) for _ in (1, 2)]
    h = [base + 3 * m + k for m in range(n) for k in (1, 2)]
    pos = states.pos.double()
    d = torch.linalg.vector_norm(pos[:, :, h] - pos[:, :, o], dim=1)
    return float((d - 1.0).abs().max()) if n else 0.0


def probe_rigid_geometry(blocks: int = 8, path: str = "kernel",
                         sentinel: bool = True, n_steps: int = 2000,
                         device="cuda") -> tuple[bool, str]:
    """Stages 2 and 3 on 64 SPC/E waters (capacity 96, f32, 8 replicas):
    ``blocks`` NVT blocks of n_steps steps from keys of PROBE_SEED (split
    over the replicas), the geometry check, then (``sentinel``) one more
    block and its replay. ``path`` "kernel" runs the blocks on the default
    dispatch (run_block_uniforms), "plain" on the plain path."""
    from ..api import load_system
    from ..mc.driver import (block_body_u, draw_uniforms, sentinel_check,
                             sentinel_passed)
    from ..mc.moves import _core_plain
    from ..parallel.replicas import replicate, run_block_uniforms
    from ..systems import make_spce_box

    if path == "kernel":
        def block(spec, st, u):
            return run_block_uniforms(spec, st, u, True)
    elif path == "plain":
        def block(spec, st, u):
            return block_body_u(spec, st, u, True, core=_core_plain)
    else:
        raise ValueError(f"path must be 'kernel' or 'plain', got {path!r}")
    with tempfile.TemporaryDirectory() as tmp:
        make_spce_box(tmp, n_water=64, density=0.997, temp=298.0, cutoff=6.0,
                      tol=1e-5, probs=(0.5, 0.5, 0.0, 0.0), tstep=0.25,
                      rstep=0.4, recal=True, seed=PROBE_SEED)
        sysm = load_system(f"{tmp}/input.maniac", f"{tmp}/topology.data",
                           f"{tmp}/parameters.inc", capacity=PROBE_CAPACITY,
                           dtype=torch.float32, device=device,
                           seed=PROBE_SEED)
    spec = sysm.spec
    states = replicate(spec, sysm.state, PROBE_REPLICAS)
    for _ in range(blocks):
        states, u = draw_uniforms(spec, states, n_steps)
        states = block(spec, states, u)
    dev = rigid_deviation(spec, states)
    ok = dev < RIGID_TOL
    detail = f"{blocks}x{n_steps} NVT blocks, max |d(O-H)|={dev:.3e} A"
    if sentinel:
        states, u = draw_uniforms(spec, states, n_steps)
        post = block(spec, states, u)
        rep = sentinel_check(spec, states, post, u, True)
        ok = ok and sentinel_passed(rep)
        detail += (f"; sentinel n_mol_mm={rep['n_mol_mismatch']} "
                   f"ctr_mm={rep['counter_mismatch']} "
                   f"pos_dmax={rep['pos_max_diff']:.3e}")
    return ok, detail


def hw_precision_check(blocks: int = 4, device="cuda") -> tuple[str, str]:
    """All stages on the default dispatch: ("pass"|"fail", detail)."""
    ok1, d1 = probe_onehot_exact(device)
    ok2, d2 = probe_rigid_geometry(blocks=blocks, device=device)
    return ("pass" if ok1 and ok2 else "fail"), f"{d1}; {d2}"
