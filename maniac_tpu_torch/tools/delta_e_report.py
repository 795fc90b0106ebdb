"""Per-move dE precision: the f32 engine against an f64 recompute (the
counterpart of scripts/delta_e_report.py).

    python -m maniac_tpu_torch.tools.delta_e_report [--steps 400]
        [--seed 0] [--replicas 1] [--path step|block|plain]
        [--platform cuda|cpu]

Advances f32 chains on the flagship chemistry (make_zif_like(n_cells=4,
a=5.66, n_water=16, fugacity=50), capacity 64) and, for every accepted
move, compares the engine's running dE with the difference of two exact
f64 recomputes of the total energy (physics/energy.system_energy) of the
configurations before and after it. Step i draws from key i of
split(prng_key(seed), steps): with one replica that key itself, the JAX
script's chain (mc_step); with B replicas split(key i, B), one key a
replica. ``--path`` picks what runs the step: ``step`` is mc/moves.mc_step
(on the card the per-step kernel, csrc/stepg.cu), ``block`` the
whole-block kernel (csrc/blockg.cu) as one-step blocks, ``plain`` the
plain torch step. The card is the default; without one the tool exits 1
unless ``--platform cpu`` is given. Prints the accepted moves and the max,
mean and p99 of |dE_f32 - dE_f64| in kcal/mol.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

PATHS = ("step", "block", "plain")


def _rows(state, idx):
    from ..system import SimState
    return SimState(**{k: v[idx] for k, v in vars(state).items()})


def exact_energy(spec64, base64, state) -> torch.Tensor:
    """E_TOT (B,) in f64 of ``state``'s configurations, recomputed from
    scratch: the positions, COMs and populations cast into ``base64`` (a
    one-replica f64 state of the same system), as the JAX script casts
    them (f32 values embed exactly in f64)."""
    import dataclasses

    from ..physics.energy import system_energy
    from ..system import E_TOT
    B = state.B
    st = dataclasses.replace(
        _rows(base64, torch.zeros(B, dtype=torch.long,
                                  device=base64.pos.device)),
        com=state.com.double(), pos=state.pos.double(), n_mol=state.n_mol)
    return system_energy(spec64, st)[0][:, E_TOT]


def _stepper(path: str):
    """(spec, state, key) -> state, one MC step on ``path``."""
    from ..kernels.blockg import run_block_kernel
    from ..mc.driver import steps_plain
    from ..mc.moves import N_UNIFORMS, mc_step
    from ..utils.threefry import uniform

    def uniforms(spec, state, key):
        u = uniform(key, (N_UNIFORMS,), spec.dtype)
        return u.reshape(-1, 1, N_UNIFORMS).expand(state.B, -1, -1)

    if path == "step":
        return mc_step
    if path == "block":
        return lambda spec, st, key: run_block_kernel(
            spec, st, uniforms(spec, st, key).contiguous())
    if path == "plain":
        return lambda spec, st, key: steps_plain(spec, st,
                                                 uniforms(spec, st, key))
    raise ValueError(f"path {path!r} is not one of {PATHS}")


def per_move_delta_e(spec, state, spec64, base64, keys, path="step"):
    """Walk ``state`` one step a key of ``keys`` (n_steps, 2) on ``path``
    and record every accepted move (a replica whose running E_TOT changed,
    as the JAX script detects one). Returns numpy arrays (step, replica,
    dE of the running energy, dE of the f64 recomputes), energies in
    Kelvin."""
    from ..system import E_TOT
    from ..utils.threefry import split
    step = _stepper(path)
    B = state.B
    e_run = state.energy[:, E_TOT].double()
    e_exact = exact_energy(spec64, base64, state)
    rec = {k: [] for k in ("step", "replica", "de_run", "de_exact")}
    for i, key in enumerate(keys):
        state = step(spec, state, key if B == 1 else split(key, B))
        e_now = state.energy[:, E_TOT].double()
        idx = (e_now != e_run).nonzero()[:, 0]
        if idx.numel():
            e_new = exact_energy(spec64, base64, _rows(state, idx))
            rec["step"].append(np.full(idx.numel(), i))
            rec["replica"].append(idx.cpu().numpy())
            rec["de_run"].append((e_now[idx] - e_run[idx]).cpu().numpy())
            rec["de_exact"].append((e_new - e_exact[idx]).cpu().numpy())
            e_exact[idx] = e_new
        e_run = e_now
    return tuple(np.concatenate(rec[k]) if rec[k] else np.zeros(0)
                 for k in ("step", "replica", "de_run", "de_exact"))


def measure(n_steps: int = 400, seed: int = 0, verbose: bool = True,
            device: str | torch.device = "cuda", replicas: int = 1,
            path: str = "step") -> dict:
    """The f32 per-move dE envelope on ``device``: ``replicas`` chains of
    ``n_steps`` steps on ``path`` (module docstring). Returns
    {"accepted_moves", "max_abs_dE_err_kcalmol", "mean_abs_dE_err_kcalmol",
    "p99_abs_dE_err_kcalmol", "dispatch"}."""
    from ..api import load_system
    from ..constants import KB_KCALMOL
    from ..kernels import dispatch_report
    from ..parallel.replicas import replicate
    from ..systems import make_zif_like
    from ..utils.threefry import prng_key, split

    with tempfile.TemporaryDirectory() as tmp:
        make_zif_like(tmp, n_cells=4, a=5.66, n_water=16, fugacity=50.0)
        args = (f"{tmp}/input.maniac", f"{tmp}/topology.data",
                f"{tmp}/parameters.inc")
        sys32 = load_system(*args, dtype=torch.float32, capacity=64,
                            device=device)
        sys64 = load_system(*args, dtype=torch.float64, capacity=64,
                            device=device)
    spec = sys32.spec
    state = (sys32.state if replicas == 1
             else replicate(spec, sys32.state, replicas))
    keys = split(prng_key(seed, device=spec.device), n_steps)
    _, _, de_run, de_exact = per_move_delta_e(spec, state, sys64.spec,
                                              sys64.state, keys, path)
    errs = np.abs(de_run - de_exact) * KB_KCALMOL
    report = {
        "accepted_moves": int(errs.size),
        "max_abs_dE_err_kcalmol": float(errs.max()),
        "mean_abs_dE_err_kcalmol": float(errs.mean()),
        "p99_abs_dE_err_kcalmol": float(np.percentile(errs, 99)),
        "dispatch": dispatch_report(spec, spec.device),
    }
    if verbose:
        print(f"# per-move dE error, f32 engine ({path}, {replicas} "
              f"replicas, {n_steps} steps on {spec.device}) vs exact f64 "
              f"recompute (flagship chemistry, kcal/mol)")
        for k, v in report.items():
            print(f"{k:28s} {v:.3e}" if isinstance(v, float) else
                  f"{k:28s} {v}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.delta_e_report",
        description="f32 per-move dE against an f64 recompute")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--path", choices=PATHS, default="step")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.platform == "cuda":
        from . import card_label, require_cuda
        if not require_cuda("delta_e_report"):
            return 1
        print(f"# device: {card_label()}")
    measure(args.steps, args.seed, True, args.platform, args.replicas,
            args.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
