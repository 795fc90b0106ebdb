"""The comparison that decides ``correct``: the program against the
references, on what the timed path produced.

Two references, neither of which imports the program:

* oracle.py, independent code: brute-force float64 sums of the energy
  components and the structure factors under the Fortran reference's
  definitions, from the configuration's residue types (the writer's
  arrays: each type's sites, frozen or active, and the written
  positions), box, cutoff and Ewald tolerance and the positions. It
  judges every energy and amplitude.
* ref/, a frozen copy of the program's plain path: the threefry stream
  and the plain MC step. It replays the judged block step by step.

After the window, on the blocks the window ran last (the traffic's
``judged_blocks``, the judged blocks):

* ``draw_mismatch``: the uniforms the judged blocks ran on (kept from the
  window) and the keys after each, against the reference's stream; exact.
* ``capacity_violations``: populations outside [0, capacity] and
  non-finite values, over every replica of the final state; exact.
* ``stalled_replicas``: replicas whose positions did not change at all
  over ``stall_blocks`` judged blocks (the traffic's, 1 where it names
  none: each judged block alone), over every replica; exact (a sound
  block of 400 steps accepts some hundred moves, while at 50 steps one
  of 1024 replicas is still by chance in some 5% of runs, so a traffic
  of short blocks counts over several).
* ``frozen_moved``: over every replica of the final state, the frozen
  sites that are not where the writer put them (by more than POS_AGREE_A
  at the minimum image), and the frozen molecules missing or added;
  exact (a configuration without frozen types reads 0).
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
magnitudes, the oracle's energy of the frozen sites alone taken out of
both first. A structure-factor gap is taken against the larger of 1 and
the largest oracle amplitude of the replica, the frozen sites' part
taken out. The gaps are whole; only the scale leaves out what the
frozen sites alone give, a constant that would otherwise swamp the
guests' part, where every move is (without frozen sites the scale is
the oracle's whole energy and amplitudes, as it always was; a row with
no guest part at all, no guest present, takes each component against the
larger of it and the mean of the whole row's six magnitudes, which the
running sums' leftovers of deleted guests are held to). A gap of 0 reads
0, and one that is not a number, or infinite, reads the largest float.
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
EXACT = ("draw_mismatch", "capacity_violations", "stalled_replicas",
         "frozen_moved")
NUMBERS = ("setup_energy_rel", "replay_diverged", "energy_rel", "amp_rel")
# a gap that is not a number reads the largest float, as an infinite one
# does, so that it fails and the result line stays JSON
WORST = torch.finfo(torch.float64).max


def sample_rows(seed: int, B: int, n: int) -> torch.Tensor:
    """n distinct replicas of B drawn from the seed, in order."""
    gen = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(B, generator=gen)[:n].sort().values


def components(energy) -> torch.Tensor:
    """The program's (..., 6) rows (recip, lj, coul, self, intra, tot) in
    the oracle's order (LJ, reciprocal, real space, self, intra, total)."""
    order = [E_LJ, E_RECIP, E_COUL, E_SELF, E_INTRA, E_TOT]
    return energy.double()[..., order]


def energy_gaps(energy, ref_energy, constant=None) -> torch.Tensor:
    """(n, 6) relative gaps of the program's (n, 6) rows against the
    oracle's, each against the oracle's row less ``constant`` (the
    frozen sites' energy alone, (6,); none without frozen sites)."""
    e, r = components(energy), ref_energy.double().to(energy.device)
    part = r if constant is None else r - constant.to(r.device)
    scale = torch.maximum(part.abs(), part.abs().median(dim=1, keepdim=True)
                          .values)
    # a row with no guest part (no guest present) against the whole row,
    # with the mean of its magnitudes (half of them are 0 there)
    whole = torch.maximum(r.abs(), r.abs().mean(dim=1, keepdim=True))
    scale = torch.where((scale == 0).all(dim=1, keepdim=True), whole, scale)
    gap = (e - r).abs()
    return torch.where(gap == 0, 0.0, gap / scale).nan_to_num(nan=WORST)


def amp_gap(st, oracle, ref_re, ref_im) -> float:
    """Largest structure-factor gap at the oracle's modes, each replica's
    against the larger of 1 and its largest oracle amplitude less the
    frozen sites' part."""
    modes = oracle.grid_index(st.amp_re.shape[-1])
    re = st.amp_re.flatten(1)[:, modes].double()
    im = st.amp_im.flatten(1)[:, modes].double()
    d = torch.maximum((re - ref_re).abs(), (im - ref_im).abs())
    fw_re, fw_im = (a.to(ref_re.device) for a in oracle.frozen_amp)
    top = torch.maximum((ref_re - fw_re).abs(), (ref_im - fw_im).abs())
    scale = torch.clamp(top.max(dim=1).values, min=1.0)
    return float((d.max(dim=1).values / scale).nan_to_num(nan=WORST).max())


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
    oracle for the configuration's residue types, on ``device``."""

    def __init__(self, files, arrays, config, seed, device):
        self.host_spec, self.host_state = ref.build(
            files["input"], files["data"], files["params"],
            capacity=config["capacity"], seed=seed)
        self.device = device
        self.dtype = getattr(torch, config["dtype"])
        self.residues, box = arrays["residues"], arrays["box"]
        spec = self.host_spec
        if ([not t["frozen"] for t in self.residues] != list(
                spec.active_list) or [len(t["q_e"]) for t in self.residues]
                != list(spec.A_list)):
            raise ValueError("the written residue types are not the ones "
                             "the deck declares")
        args = config["writer_args"]
        self.oracle = Oracle(self.residues, box, args["cutoff_A"],
                             args["ewald_tolerance"], device)
        self._specs = {}

    def spec(self, dtype):
        if dtype not in self._specs:
            self._specs[dtype] = ref.cast(self.host_spec, self.device, dtype)
        return self._specs[dtype]

    def molecules(self, st, row: int) -> list:
        """[(n, A, 3)] positions of the live molecules of a state's row, one
        tensor for each active type in type order."""
        spec = self.host_spec
        out = []
        for r in self.oracle.active:
            base, A = spec.site_base_list[r], spec.A_list[r]
            n = int(st.n_mol[row, r])
            out.append(st.pos[row, :, base:base + n * A].T.reshape(n, A, 3))
        return out

    def frozen_moved(self, st) -> int:
        """Frozen sites of every replica away from where the writer put
        them, by more than POS_AGREE_A at the minimum image, and frozen
        molecules missing or added."""
        spec, bad = self.host_spec, 0
        for r, t in enumerate(self.residues):
            if not t["frozen"]:
                continue
            at = torch.as_tensor(t["pos"]).reshape(-1, 3).to(
                self.device, torch.float64)
            bad += int((st.n_mol[:, r] != at.shape[0] // spec.A_list[r])
                       .sum())
            base = spec.site_base_list[r]
            p = st.pos[:, :, base:base + at.shape[0]].transpose(1, 2)
            d = self.oracle.min_image(p.to(self.device, torch.float64) - at)
            bad += int((d.abs().amax(dim=-1) > POS_AGREE_A).sum())
        return bad

    def loaded_energy(self) -> torch.Tensor:
        """(6,) the oracle's energy of the written positions."""
        return self.oracle.energies([t["pos"] for t in self.residues
                                     if not t["frozen"]])

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


def judge(drv, recent, reference, n_judged, seed, stall_blocks: int = 1):
    """Every number of the comparison for a driver after its window, over
    ``recent``, the (state before, uniforms) of the judged blocks; frees
    the program's state on the way. Returns {name: value}."""
    out = {"draw_mismatch": 0, "stalled_replicas": 0}
    posts = [pre for pre, _ in recent[1:]] + [drv.states]
    idx = sample_rows(seed, drv.B, n_judged)
    blocks = []
    for i, ((pre, u), post) in enumerate(zip(recent, posts)):
        keys_ref, u_ref = ref.draw(pre.key, u.shape[1], reference.dtype)
        out["draw_mismatch"] += int((u != u_ref).sum()) + int(
            (keys_ref != post.key).sum())
        # runs of stall_blocks judged blocks, the last one shorter where
        # the window ran fewer
        if i % stall_blocks == stall_blocks - 1 or i == len(recent) - 1:
            first = recent[i - i % stall_blocks][0]
            out["stalled_replicas"] += int(
                (post.pos == first.pos).flatten(1).all(dim=1).sum())
        blocks.append((detached(pre, idx), u_ref[idx.to(u_ref.device)]
                       .clone(), detached(post, idx)))
    out["capacity_violations"] = state_faults(drv.spec, drv.states)
    out["frozen_moved"] = reference.frozen_moved(drv.states)
    loaded = drv.loaded_energy.clone()
    recent.clear()
    del posts, pre, post, u, u_ref, keys_ref, first
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
    constant = reference.oracle.frozen_energy
    out = {"setup_energy_rel": float(energy_gaps(
        loaded[None], reference.loaded_energy()[None], constant).max()),
        "replay_diverged": 0, "energy_rel": 0.0, "amp_rel": 0.0}
    worst = ""
    for pre_rows, u_rows, post_rows in blocks:
        replay = reference.replay(pre_rows, u_rows, end_of_block,
                                  reference.dtype)
        out["replay_diverged"] += diverged(post_rows, replay)
        energies, re, im = reference.fresh(post_rows)
        gaps = energy_gaps(post_rows.energy, energies, constant)
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
