"""Steps whose acceptance uniform u_acc is exactly 0.0, for the strict
acceptance test u_acc < p_acc: a creation whose acceptance
probability underflows to 0 and one whose probability is positive.
Imports no jax, so the card's tests (test_torch_gpu.py) use it too."""

import itertools

import torch

from maniac_tpu_torch.physics.energy import active_site_mask, site_positions


def creation_rows(spec, state) -> torch.Tensor:
    """(2, 1, 21) f32 uniforms on the state's device, one step each, both a
    creation of the first active type in the identity rotation with u_acc
    0.0: replica 0 puts the new molecule's centre 0.8 A from molecule 0's
    (its sites then sit on molecule 0's, so that exp(-dE / T) underflows to
    0 while dE stays finite); replica 1 puts it at the point of an 8^3
    grid of fractional positions farthest from every live site."""
    dev = state.pos.device
    lo, Hinv = spec.bounds[:, 0].double(), spec.Hinv.double()
    com0 = state.com[0, :, 0].double()
    near = (com0 + torch.tensor([0.8, 0.0, 0.0], dtype=torch.float64,
                                device=dev) - lo) @ Hinv.T
    sites = site_positions(spec, state)[0].double()
    sites = sites[active_site_mask(spec, state.n_mol)[0]]
    H, best = spec.H.double(), (-1.0, None)
    for f in itertools.product([(i + 0.5) / 8 for i in range(8)], repeat=3):
        frac = torch.tensor(f, dtype=torch.float64, device=dev)
        d = (lo + frac @ H.T) - sites
        d = d - torch.round(d @ Hinv.T) @ H.T
        gap = float(d.norm(dim=1).min())
        if gap > best[0]:
            best = (gap, frac)
    rows = torch.full((2, 1, 21), 0.37, dtype=torch.float32, device=dev)
    for b, frac in enumerate((near, best[1])):
        rows[b, 0, :3] = torch.tensor([0.7, 0.25, 0.0])  # creation; u_acc 0
        rows[b, 0, 6:9] = (frac - torch.floor(frac)).float()
        rows[b, 0, 15:17] = torch.tensor([0.0, 0.25])    # identity rotation
    return rows
