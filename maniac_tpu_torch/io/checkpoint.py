"""Full-fidelity checkpoint/resume.

Counterpart of maniac_tpu/io/checkpoint.py, in its format. The reference's
only restart mechanism is the per-block LAMMPS topology.data re-emit
(configuration only: counters, step sizes, reservoir and random state are
lost; reference: src/write_utils.f90:190-412); that path still works
(reload it with -d). A checkpoint is one .npz with every SimState field
(positions, populations, structure factors, energies, counters, adaptive
step sizes, the threefry keys, reservoir; batched replica states
included) and the meta entries (format version, block, S, K, cap_list).
The keys are written as uint32 and a single chain without its B = 1 axis,
as the JAX package writes them, so a checkpoint of either package resumes
in the other. Reloads are bit-exact.

A checkpoint of the port before it drew from threefry keys (a
``rng__generator`` entry and no ``state__key``) is refused (ValueError),
not resumed on a fresh stream.
"""

from __future__ import annotations

import numpy as np

from ..system import SimState, SystemSpec, state_from_numpy, tensor_fields

_FORMAT_VERSION = 2  # v2: SimState stores absolute site positions ("pos")


def save_checkpoint(path: str, spec: SystemSpec, state: SimState,
                    block: int = 0, single_chain: bool = False) -> None:
    """Write ``state`` (every field, the keys as uint32) and the meta
    entries to ``path`` (.npz). ``single_chain``: ``state`` is one chain
    (B = 1) that was never replicated, written without its leading axis
    as the JAX package writes its unreplicated state."""
    if single_chain and state.B != 1:
        raise ValueError(f"single_chain: the state holds {state.B} replicas")
    arrays = {"state__" + name: t.detach().cpu().numpy()
              for name, t in tensor_fields(state)}
    if single_chain:
        arrays = {k: a[0] for k, a in arrays.items()}
    arrays["state__key"] = arrays["state__key"].astype(np.uint32)
    arrays["meta__version"] = np.asarray(_FORMAT_VERSION)
    arrays["meta__block"] = np.asarray(block)
    arrays["meta__S"] = np.asarray(spec.S)
    arrays["meta__K"] = np.asarray(spec.K)
    arrays["meta__cap_list"] = np.asarray(spec.cap_list)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, spec: SystemSpec) -> tuple[SimState, int]:
    """Returns (state, block), the state on the spec's device and dtype.
    Checks the version and the S/K layout against ``spec``, and refuses a
    checkpoint without threefry keys (ValueError)."""
    with np.load(path) as z:
        if int(z["meta__version"]) != _FORMAT_VERSION:
            raise ValueError("incompatible checkpoint version")
        if int(z["meta__S"]) != spec.S or int(z["meta__K"]) != spec.K:
            raise ValueError(
                "checkpoint layout does not match the loaded system "
                f"(S={int(z['meta__S'])} vs {spec.S}, "
                f"K={int(z['meta__K'])} vs {spec.K}); use the same inputs "
                "and capacity")
        if "state__key" not in z.files:
            raise ValueError(
                f"{path} holds a torch.Generator state (rng__generator) and "
                "no threefry key: it is in the format of the port's "
                "generator stream, which the threefry stream replaced, so "
                "its chain cannot be continued; start a fresh run from its "
                "topology.data instead")
        state = state_from_numpy(
            {f.removeprefix("state__"): z[f] for f in z.files
             if f.startswith("state__")},
            device=spec.device, dtype=spec.dtype)
        return state, int(z["meta__block"])
