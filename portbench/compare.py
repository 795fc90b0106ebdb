"""The comparison that decides ``correct``: the program against the
references, on what the timed path produced.

Two references, neither of which imports the program:

* oracle.py, independent code: brute-force float64 sums of the energy
  components and the structure factors under the Fortran reference's
  definitions, from the configuration's molecule, box, cutoff and Ewald
  tolerance and the positions. It judges every energy and amplitude.
* ref/, a frozen copy of the program's plain path: the threefry stream
  and the plain MC step. It replays the judged block step by step.

After the window, on the blocks the window ran last (the traffic's
``judged_blocks``, the judged blocks):

* ``draw_mismatch``: the uniforms the judged blocks ran on (kept from the
  window) and the keys after each, against the reference's stream; exact.
* ``capacity_violations``: populations outside [0, capacity] and
  non-finite values, over every replica of the final state; exact.
* ``stalled_replicas``: replicas whose positions did not change at all
  in a judged block, over every replica; exact (a sound block of 400
  steps accepts some hundred moves).
* ``setup_energy_rel``: the loaded state's energy against the oracle's of
  the written positions (the Ewald set-up and the weights that load_system
  derived all enter).
* ``replay_diverged``: a sample of replicas drawn from the seed is run
  through each judged block by ref/ (float32, the configuration's
  precision), from the program's state before the block on the
  reference's uniforms, with the block's resync or refresh; it counts the
  (replica, block) pairs whose populations, counters or extras differ
  from the program's, or a position by more than POS_AGREE_A. A single
  one is a Metropolis decision so close to its threshold that the two
  float32 sums round it apart (maniac_tpu_torch/mc/driver.py::
  sentinel_check says the same); many are a fault.
* ``energy_rel``: the program's energy after each judged block (the
  running sums of the whole window, and the resync's or refresh's terms)
  against the oracle's of the program's positions, on the sample.
* ``amp_rel``: the program's structure factors after each judged block
  against the oracle's of its positions, at every mode of the Ewald sum,
  on the sample.

An energy's six components (LJ, reciprocal, real-space, self,
intramolecular Coulomb, total) are compared one by one, each gap against
the larger of the oracle's component and the median of its six
magnitudes. A structure-factor gap is taken against the larger of 1 and
the largest oracle amplitude of the replica.
"""

from __future__ import annotations

import gc
import sys

import torch

from .oracle import Oracle
from .ref import driver as ref
from .ref.system import E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF, E_TOT

# a replay agrees on positions within this (the JAX package's sentinel
# rule, maniac_tpu/mc/driver.py::sentinel_passed)
POS_AGREE_A = 1e-3
EXACT = ("draw_mismatch", "capacity_violations", "stalled_replicas")
NUMBERS = ("setup_energy_rel", "replay_diverged", "energy_rel", "amp_rel")


def sample_rows(seed: int, B: int, n: int) -> torch.Tensor:
    """n distinct replicas of B drawn from the seed, in order."""
    gen = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(B, generator=gen)[:n].sort().values


def components(energy) -> torch.Tensor:
    """The program's (..., 6) rows (recip, lj, coul, self, intra, tot) in
    the oracle's order (LJ, reciprocal, real space, self, intra, total)."""
    order = [E_LJ, E_RECIP, E_COUL, E_SELF, E_INTRA, E_TOT]
    return energy.double()[..., order]


def energy_gaps(energy, ref_energy) -> torch.Tensor:
    """(n, 6) relative gaps of the program's (n, 6) rows against the
    oracle's."""
    e, r = components(energy), ref_energy.double().to(energy.device)
    scale = torch.maximum(r.abs(), r.abs().median(dim=1, keepdim=True)
                          .values)
    return (e - r).abs() / scale


def amp_gap(st, oracle, ref_re, ref_im) -> float:
    """Largest structure-factor gap at the oracle's modes, each replica's
    against the larger of 1 and its largest oracle amplitude."""
    modes = oracle.grid_index(st.amp_re.shape[-1])
    re = st.amp_re.flatten(1)[:, modes].double()
    im = st.amp_im.flatten(1)[:, modes].double()
    d = torch.maximum((re - ref_re).abs(), (im - ref_im).abs())
    top = torch.maximum(ref_re.abs(), ref_im.abs())
    scale = torch.clamp(top.max(dim=1).values, min=1.0)
    return float((d.max(dim=1).values / scale).max())


def diverged(st, ref_st) -> int:
    """Replicas whose populations, counters or extras differ, or whose
    positions differ by more than POS_AGREE_A."""
    same = ((st.n_mol == ref_st.n_mol).all(dim=1)
            & (st.counters == ref_st.counters).flatten(1).all(dim=1)
            & (st.extras == ref_st.extras).all(dim=1))
    gap = (st.pos.double() - ref_st.pos.double()).abs().flatten(1)
    close = gap.max(dim=1).values <= POS_AGREE_A
    return int((~(same & close)).sum())


def state_faults(spec, st) -> int:
    """Populations outside [0, capacity] and non-finite floats."""
    n = st.n_mol[:, :spec.R]
    caps = torch.tensor(spec.cap_list, device=n.device)
    bad = int((n < 0).sum()) + int((n > caps).sum())
    for v in vars(st).values():
        if v.is_floating_point():
            bad += int((~torch.isfinite(v)).sum())
    return bad


def detached(st, idx):
    """Clones of the replicas ``idx`` of a state."""
    return type(st)(**{k: v[idx.to(v.device)].clone()
                       for k, v in vars(st).items()})


class Reference:
    """Both references for the cell: ref/ built from the cell's files
    (float32 for the replay, the control's dtype on request) and the
    oracle for the configuration's molecule, on ``device``."""

    def __init__(self, files, arrays, config, seed, device):
        self.host_spec, self.host_state = ref.build(
            files["input"], files["data"], files["params"],
            capacity=config["capacity"], seed=seed)
        if self.host_spec.R != 1:
            raise ValueError("the oracle takes one molecule type")
        self.device = device
        self.dtype = getattr(torch, config["dtype"])
        self.arrays = arrays
        args = config["writer_args"]
        self.oracle = Oracle(config["model"], arrays["L"], args["cutoff_A"],
                             args["ewald_tolerance"], device)
        self._specs = {}

    def spec(self, dtype):
        if dtype not in self._specs:
            self._specs[dtype] = ref.cast(self.host_spec, self.device, dtype)
        return self._specs[dtype]

    def molecules(self, st, row: int) -> torch.Tensor:
        """(n, A, 3) positions of the live molecules of a state's row."""
        base = self.host_spec.site_base_list[0]
        A = self.host_spec.A_list[0]
        n = int(st.n_mol[row, 0])
        return st.pos[row, :, base:base + n * A].T.reshape(n, A, 3)

    def loaded_energy(self) -> torch.Tensor:
        """(6,) the oracle's energy of the written positions."""
        return self.oracle.energies(torch.as_tensor(self.arrays["pos"]))

    def fresh(self, st):
        """(energies (n, 6), re (n, K), im (n, K)): the oracle's of each
        row's positions, at its modes."""
        es, res, ims = [], [], []
        for row in range(st.B):
            mol = self.molecules(st, row)
            es.append(self.oracle.energies(mol))
            re, im = self.oracle.structure_factors(mol)
            res.append(re)
            ims.append(im)
        return torch.stack(es), torch.stack(res), torch.stack(ims)

    def candidate_loaded(self, dtype) -> torch.Tensor:
        """(6,) ref/'s loaded energy in ``dtype`` (the control's)."""
        spec = self.spec(dtype)
        st = ref.refresh(spec, ref.cast(self.host_state, self.device, dtype))
        return st.energy[0]

    def replay(self, pre, u, end_of_block, dtype):
        """The block from ``pre`` on uniforms u, with its resync or
        refresh, in ``dtype``."""
        spec = self.spec(dtype)
        st = ref.steps(spec, ref.cast(pre, self.device, dtype), u.to(dtype))
        return (ref.resync(spec, st) if end_of_block == "resync"
                else ref.refresh(spec, st))


def judge(drv, recent, reference, n_judged, seed):
    """Every number of the comparison for a driver after its window, over
    ``recent``, the (state before, uniforms) of the judged blocks; frees
    the program's state on the way. Returns {name: value}."""
    out = {"draw_mismatch": 0, "stalled_replicas": 0}
    posts = [pre for pre, _ in recent[1:]] + [drv.states]
    idx = sample_rows(seed, drv.B, n_judged)
    blocks = []
    for (pre, u), post in zip(recent, posts):
        keys_ref, u_ref = ref.draw(pre.key, u.shape[1], reference.dtype)
        out["draw_mismatch"] += int((u != u_ref).sum()) + int(
            (keys_ref != post.key).sum())
        out["stalled_replicas"] += int(
            (post.pos == pre.pos).flatten(1).all(dim=1).sum())
        blocks.append((detached(pre, idx), u_ref[idx.to(u_ref.device)]
                       .clone(), detached(post, idx)))
    out["capacity_violations"] = state_faults(drv.spec, drv.states)
    loaded = drv.loaded_energy.clone()
    recent.clear()
    del posts, pre, post, u, u_ref, keys_ref
    drv.states = drv.pre = drv.u = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out.update(readings(reference, loaded, blocks, idx, drv.end_of_block))
    return out


def readings(reference, loaded, blocks, idx, end_of_block):
    """The four numbers with a limit between two readings, for a
    candidate's loaded (6,) energy row and, for each judged block, the
    rows (before, uniforms, after) of the judged replicas (the program's,
    or the control's put in its place)."""
    out = {"setup_energy_rel": float(energy_gaps(
        loaded[None], reference.loaded_energy()[None]).max()),
        "replay_diverged": 0, "energy_rel": 0.0, "amp_rel": 0.0}
    for pre_rows, u_rows, post_rows in blocks:
        replay = reference.replay(pre_rows, u_rows, end_of_block,
                                  reference.dtype)
        out["replay_diverged"] += diverged(post_rows, replay)
        energies, re, im = reference.fresh(post_rows)
        gaps = energy_gaps(post_rows.energy, energies)
        if float(gaps.max()) >= out["energy_rel"]:
            out["energy_rel"] = float(gaps.max())
            row, comp = divmod(int(gaps.argmax()), gaps.shape[1])
            worst = (f"# energy_rel: replica {int(idx[row])} component "
                     f"{comp} (LJ, recip, real, self, intra, total), n_mol "
                     f"{post_rows.n_mol[row].tolist()}; candidate "
                     f"{components(post_rows.energy[row]).tolist()}; "
                     f"oracle {energies[row].tolist()}\n")
        out["amp_rel"] = max(out["amp_rel"],
                             amp_gap(post_rows, reference.oracle, re, im))
    sys.stderr.write(worst)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number within its limit,
    the exact ones at 0."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = 0 if name in EXACT else limits.get(name)
        passed = limit is not None and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
