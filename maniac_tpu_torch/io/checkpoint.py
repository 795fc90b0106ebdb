"""Full-fidelity checkpoint/resume.

Counterpart of maniac_tpu/io/checkpoint.py. The reference's only restart
mechanism is the per-block LAMMPS topology.data re-emit (configuration
only: counters, step sizes, reservoir and random state are lost;
reference: src/write_utils.f90:190-412); that path still works (reload it
with -d). A checkpoint is one .npz with every SimState field (positions,
populations, structure factors, energies, counters, adaptive step sizes,
reservoir; batched replica states included), the JAX package's meta
entries (format version, block, S, K, cap_list), and the state of the
torch.Generator the chain draws its uniforms from: the port keeps no PRNG
key in its state, so without the generator a resumed run would not be the
run it continues. Reloads are bit-exact.

A checkpoint written by the JAX package carries a threefry key where the
generator state would be; it is refused (ValueError), not resumed on a
fresh stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..system import SimState, SystemSpec, state_from_numpy, tensor_fields

_FORMAT_VERSION = 2  # v2: SimState stores absolute site positions ("pos")


def save_checkpoint(path: str, spec: SystemSpec, state: SimState,
                    block: int = 0,
                    generator: torch.Generator | None = None) -> None:
    """Write ``state`` (every field), the meta entries and ``generator``'s
    state (when given) to ``path`` (.npz)."""
    arrays = {"state__" + name: t.detach().cpu().numpy()
              for name, t in tensor_fields(state)}
    arrays["meta__version"] = np.asarray(_FORMAT_VERSION)
    arrays["meta__block"] = np.asarray(block)
    arrays["meta__S"] = np.asarray(spec.S)
    arrays["meta__K"] = np.asarray(spec.K)
    arrays["meta__cap_list"] = np.asarray(spec.cap_list)
    if generator is not None:
        arrays["rng__generator"] = generator.get_state().numpy()
        arrays["rng__device"] = np.asarray(generator.device.type)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, spec: SystemSpec,
                    generator: torch.Generator | None = None
                    ) -> tuple[SimState, int]:
    """Returns (state, block), the state on the spec's device and dtype;
    sets ``generator`` (when given) to the saved generator state. Checks
    the version and the S/K layout against ``spec``, and refuses a
    checkpoint of the JAX package or one without the generator a caller
    asks to restore (ValueError)."""
    with np.load(path) as z:
        if int(z["meta__version"]) != _FORMAT_VERSION:
            raise ValueError("incompatible checkpoint version")
        if int(z["meta__S"]) != spec.S or int(z["meta__K"]) != spec.K:
            raise ValueError(
                "checkpoint layout does not match the loaded system "
                f"(S={int(z['meta__S'])} vs {spec.S}, "
                f"K={int(z['meta__K'])} vs {spec.K}); use the same inputs "
                "and capacity")
        if "state__key" in z.files:
            raise ValueError(
                f"{path} was written by the JAX package: it carries a "
                "threefry PRNG key, not a torch.Generator state, so its "
                "chain cannot be continued here; start a fresh run from "
                "its topology.data instead")
        if generator is not None:
            if "rng__generator" not in z.files:
                raise ValueError(f"{path} holds no generator state")
            saved = str(z["rng__device"])
            if saved != generator.device.type:
                raise ValueError(
                    f"{path} holds the state of a {saved} generator, and "
                    f"the run draws from a {generator.device.type} one; "
                    f"resume on the device the checkpoint was written on")
            generator.set_state(torch.from_numpy(z["rng__generator"]))
        state = state_from_numpy(
            {f.removeprefix("state__"): z[f] for f in z.files
             if f.startswith("state__")},
            device=spec.device, dtype=spec.dtype)
        return state, int(z["meta__block"])
