"""The share of the frozen tiles that the cull keeps at a replica's guests
(physics/fwsplit.py tiles_in_reach, the float32 copy of the kernels'
test), for the tests that hold the kernels' cull to the plain steps."""

from __future__ import annotations

import numpy as np

from maniac_tpu_torch.physics.fwsplit import side_reach, tiles_in_reach


def kept_share(spec, state, replica: int = 0) -> float:
    """Mean over the guests of ``replica`` of the share of the spec's
    frozen tiles a move with that molecule's atoms as one side keeps."""
    box = spec.fw_tile_box.cpu().double().numpy()
    L = spec.box_diag.cpu().double().numpy()
    cutoff, rcut2 = float(spec.cutoff), float(spec.rcut2)
    pos, com = (state.pos[replica].cpu().double().numpy(),
                state.com[replica].cpu().double().numpy())
    shares = []
    for t in spec.active_type_ids.tolist():
        base, A = spec.site_base_list[t], spec.A_list[t]
        mol_base = int(spec.type_mol_base[t])
        q = spec.type_q_rows[t, :A].cpu().double().numpy()
        for m in range(int(state.n_mol[replica, t])):
            p = pos[:, base + m * A:base + (m + 1) * A].T
            c = com[:, mol_base + m]
            shares.append(tiles_in_reach(
                box, [(c, *side_reach(p, q, c, cutoff, rcut2))], L).mean())
    return float(np.mean(shares))
