"""SystemSpec (static tables) and SimState (batched replica state) in torch.

Counterpart of maniac_tpu/system.py. The flat padded site layout, the dense
(JzP, JxyP) k-grid and the static-framework split tables are the same as in
the JAX package, field for field, so a state can be carried across with
``from_numpy`` and compared leaf for leaf.

Differences from the JAX data model:

* ``SimState`` is batched: every field has a leading replica axis B
  (``pos`` is (B, 3, S), ``energy`` (B, 6), ...). A single chain is B = 1.
  Its ``key`` holds each replica's threefry key, JAX's uint32 words as
  int64 (utils/threefry.py), so one seed walks the JAX package's chain.
* The spec keeps only the tables the port reads. The TPU layouts (ghost-
  sorted framework windows, 8-row LJ slabs, row selectors) are not built.
  The 27 lattice image shifts of the triclinic minimum image, the
  reservoir tables and state, and the tabulated potentials' tables are the
  JAX package's, with the same minimal dummies (one slot per type, two
  table points) when there is no reservoir or table.
* Dense-grid column index tables (``k_col_jx``/``k_col_jy`` and the far-
  grid ``k2_col_*``) are derived from the 0/1 selectors ``ex_sel``/
  ``ey_sel``: the port reads phase powers by index instead of expanding
  them with selector matmuls.
* The k-space mode lists (``k_weighted_modes``, ``k_weighted_w``,
  ``k_real_modes``) are derived from ``k_weights`` and the column tables:
  the modes the footprint kernels walk, as rows (m, jx, jy, jz), so that
  they skip the pad rows and columns of the (JzP, JxyP) layout
  (``_mode_lists``).
* The far table (``far_coef``, ``far_rows``, ``far_units``) is derived from
  the far-field coefficients: their nonzero entries laid out for the
  footprint kernels' separable contraction (physics/fwsplit.py FarTable).
* The frozen tiles (``fw_tile_*``) are derived from the frozen prefix of
  the loaded positions: its live sites in spatially compact tiles, which
  the footprint kernels sweep only within a move's reach (physics/fwsplit.py
  FrozenTiles). The state's frozen prefix stays as loaded.
* The charge table (``q_regions``, ``q_offsets``, ``q_mixed_types``) is
  derived from ``site_q``: the charged atoms of the molecules of each type
  the resync kernel covers (those at or above ``guest_base`` with the
  framework split, every type without), the only sites it synthesizes
  (``_charge_table``).

``build_spec_and_state`` runs in float64 numpy on the host; ``to_device``
casts the float tables to the working dtype and moves everything to the
device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch
from scipy.special import erfc as erfc_np

from .constants import (ATM_TO_PA, A3_TO_M3, COULOMB_K, ERFC_DECAY, KB_JK,
                        SMALL, SQRTPI)
from .ewald import EwaldSetup
from .geometry import image_shifts
from .io.deck import InputDeck
from .io.lammps_data import ParsedSystem
from .physics.fwsplit import (build_far_table, build_frozen_tiles,
                              live_frozen_sites)
from .utils import trace
from .utils.threefry import prng_key

# energy component indices (internal unit: Kelvin)
E_RECIP, E_LJ, E_COUL, E_SELF, E_INTRA, E_TOT = range(6)
# counter indices: counters[:, 0] = trials, counters[:, 1] = accepts
N_MOVE_TYPES = 5

_META_FIELDS = (
    "R", "A_list", "cap_list", "active_list", "A_act", "n_active", "S",
    "Mtot", "K", "box_kind", "is_triclinic", "dtype_name", "has_reservoir",
    "kmax_xyz", "amp_shape", "fw_split", "S_frozen", "guest_base",
    "kmax2_xyz", "amp2_shape", "site_base_list", "use_table", "gg_cut",
    "gg_rcut", "res_cap_list", "q_mixed_types", "image_reach")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class SystemSpec:
    # box
    H: torch.Tensor             # (3,3) cell vectors as columns
    Hinv: torch.Tensor          # (3,3)
    bounds: torch.Tensor        # (3,2)
    box_diag: torch.Tensor      # (3,)
    volume: torch.Tensor        # ()
    image_shifts: torch.Tensor  # (27,3) lattice image shifts (triclinic)
    # Ewald dense half-space grid (JzP, JxyP): rows signed jz, cols
    # jx*Jy + jy (maniac_tpu/ewald.py); invalid/pad modes carry weight 0
    k_cart: torch.Tensor        # (K,3)
    k_weights: torch.Tensor     # (JzP, JxyP)
    k_live: torch.Tensor        # (K,)
    ex_sel: torch.Tensor        # (Jx, JxyP) 0/1
    ey_sel: torch.Tensor        # (Jy, JxyP) 0/1
    k_col_jx: torch.Tensor      # (JxyP,) int32 jx of each column, -1 = pad
    k_col_jy: torch.Tensor      # (JxyP,) int32 signed jy of each column
    # the modes the footprint kernels walk (_mode_lists): rows (flat grid
    # index m, jx, jy, jz) of the modes with weight, ascending, and their
    # weights; rows of the real modes (not pad), ascending
    k_weighted_modes: torch.Tensor  # (n_weighted, 4) int32
    k_weighted_w: torch.Tensor      # (n_weighted,)
    k_real_modes: torch.Tensor      # (n_real, 4) int32
    two_pi_Hinv: torch.Tensor   # (3,3): theta = two_pi_Hinv @ r
    alpha: torch.Tensor
    cutoff: torch.Tensor
    temp_K: torch.Tensor
    # flat site tables (pad: q=0, cls=C, type=R, mol=Mtot, midx=2**30)
    site_q: torch.Tensor        # (S,)
    site_cls: torch.Tensor      # (S,) int32
    site_type: torch.Tensor     # (S,) int32
    site_mol: torch.Tensor      # (S,) int32
    site_midx: torch.Tensor     # (S,) int32
    mol_type: torch.Tensor      # (Mtot,) int32
    mol_midx: torch.Tensor      # (Mtot,) int32
    mol_site_start: torch.Tensor  # (Mtot,) int32
    # LJ class tables (C+1, C+1) and their class -> site expansions (C+1, S)
    eps_cls: torch.Tensor
    sig_cls: torch.Tensor
    eps_site: torch.Tensor
    sig2_site: torch.Tensor     # sigma^2
    # per residue type
    type_A: torch.Tensor        # (R,) int32
    type_cap: torch.Tensor      # (R,) int32
    type_site_base: torch.Tensor  # (R,) int32
    type_mol_base: torch.Tensor   # (R,) int32
    type_active: torch.Tensor     # (R,) bool
    type_activity: torch.Tensor   # (R,) 1/A^3
    type_self_energy: torch.Tensor  # (R,) K per molecule
    # (R,) K per molecule of an active type, from its insertion template
    # (physics/energy.py template_intra_energy); 0 for a frozen type
    type_intra_energy: torch.Tensor
    type_template_off: torch.Tensor  # (R, A_act, 3) insertion template
    type_q_rows: torch.Tensor     # (R, A_act)
    type_cls_rows: torch.Tensor   # (R, A_act) int32
    active_type_ids: torch.Tensor  # (n_active,) int32
    p_cum: torch.Tensor           # (4,) [trans, +rot, +indel, +swap]
    # static-framework split (physics/fwsplit.py): far-field coefficient
    # grid and its column index tables, the short-range split parameters,
    # and the constant framework amplitudes on the main grid
    c2_re: torch.Tensor           # (Jz2P, Jxy2P)
    c2_im: torch.Tensor
    ex2_sel: torch.Tensor         # (Jx2, Jxy2P)
    ey2_sel: torch.Tensor         # (Jy2, Jxy2P)
    k2_col_jx: torch.Tensor       # (Jxy2P,) int32, -1 = pad
    k2_col_jy: torch.Tensor       # (Jxy2P,) int32 signed jy
    # the far table the footprint kernels contract (physics/fwsplit.py
    # FarTable; empty without the split): coefficients, rows, units
    far_coef: torch.Tensor        # (n_tiles, 8, FAR_TCH, 32, 2)
    far_rows: torch.Tensor        # (n_groups * 32, 4) int32
    far_units: torch.Tensor       # (n_tiles, 8, 4) int32
    # the frozen tiles the footprint kernels sweep in place of the frozen
    # prefix (physics/fwsplit.py FrozenTiles; empty without the split): per
    # slot its site (-1 on a pad), x, y, z, q and LJ entries against each
    # class; per tile its box's centre, charge flag and half-extents
    fw_tile_site: torch.Tensor    # (n_slots,) int32
    fw_tile_pq: torch.Tensor      # (n_slots, 4)
    fw_tile_eps: torch.Tensor     # (C+1, n_slots)
    fw_tile_sig2: torch.Tensor    # (C+1, n_slots)
    fw_tile_box: torch.Tensor     # (n_tiles, 2, 4)
    # the charge table (_charge_table): per type the resync covers (site
    # base, atoms per molecule, charged atoms per molecule, first entry of
    # q_offsets, type), and the charged atoms' offsets within a molecule,
    # type by type
    q_regions: torch.Tensor       # (n_types, 5) int32
    q_offsets: torch.Tensor       # (max(1, n),) int32
    alpha2: torch.Tensor
    rcut2: torch.Tensor
    fw_d0: torch.Tensor
    fw_amp_re: torch.Tensor       # (JzP, JxyP)
    fw_amp_im: torch.Tensor
    # the frozen sites' LJ and real-space Coulomb among themselves (K):
    # what a replica without guests holds (physics/energy.py
    # frozen_pair_energy; the resync sets such a replica's so)
    fw_pair_energy: torch.Tensor  # (2,)
    # reservoir layout (flat per-type slots, as the primary's; one slot per
    # type when there is no reservoir)
    res_type_site_base: torch.Tensor  # (R,) int32
    res_type_mol_base: torch.Tensor   # (R,) int32
    res_cap: torch.Tensor             # (R,) int32
    res_H: torch.Tensor               # (3,3) reservoir cell vectors
    res_bounds_lo: torch.Tensor       # (3,)
    # tabulated pair potentials (use_table; maniac_tpu/system.py): (P+1,)
    # grids over [0, cutoff] spaced tab_dx, read by physics/energy.py
    # tab_lookup; size-2 dummies without a table
    tab_erfc: torch.Tensor            # erfc(alpha r)/r; f(0) 2 alpha/sqrt(pi)
    tab_r6: torch.Tensor              # r^6 (f(0) = 0)
    tab_r12: torch.Tensor             # r^12 (f(0) = 0)
    tab_dx: torch.Tensor              # () grid spacing
    # --- static metadata ---
    R: int
    A_list: tuple
    cap_list: tuple
    active_list: tuple
    A_act: int
    n_active: int
    S: int
    Mtot: int
    K: int
    box_kind: int
    is_triclinic: bool
    dtype_name: str
    has_reservoir: bool
    kmax_xyz: tuple
    amp_shape: tuple
    fw_split: bool
    S_frozen: int
    guest_base: int
    kmax2_xyz: tuple
    amp2_shape: tuple
    site_base_list: tuple
    use_table: bool
    gg_cut: bool
    gg_rcut: float
    res_cap_list: tuple
    q_mixed_types: tuple  # covered types whose molecules differ in charges
    image_reach: tuple    # per axis, the largest |dx| of two sites

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @property
    def device(self) -> torch.device:
        return self.site_q.device

    @functools.cached_property
    def host_scalars(self) -> dict:
        """The 0-d scalar tables as Python floats, read back once per spec
        so that kernel launches pass them by value without a device sync."""
        return {name: float(getattr(self, name)) for name in (
            "alpha", "alpha2", "cutoff", "rcut2", "temp_K", "volume",
            "fw_d0")}

    @functools.cached_property
    def graphs(self) -> dict:
        """CUDA graphs captured for this spec (mc/driver.resync's refresh,
        by state layout): they and their memory live as long as the spec,
        and a spec made from it (dataclasses.replace) starts with none."""
        return {}

    @functools.cached_property
    def host_box(self) -> tuple:
        """The box lengths (box_diag) as Python floats, read back once."""
        return tuple(float(x) for x in self.box_diag.cpu())


@dataclass
class SimState:
    """Batched replica state; the layouts are the JAX package's with a
    leading replica axis."""
    com: torch.Tensor         # (B, 3, Mtot+1); last column = pad molecule
    pos: torch.Tensor         # (B, 3, S) absolute site positions
    n_mol: torch.Tensor       # (B, R+1) int32; last entry 0 (pad type)
    amp_re: torch.Tensor      # (B, JzP, JxyP)
    amp_im: torch.Tensor
    energy: torch.Tensor      # (B, 6) K: recip, lj, coul, self, intra, tot
    counters: torch.Tensor    # (B, 2, 5) int32: [trials, accepts] x move
    extras: torch.Tensor      # (B, 4) int32: overflow rejections, ...
    trans_step: torch.Tensor  # (B,)
    rot_step: torch.Tensor    # (B,)
    key: torch.Tensor         # (B, 2) int64 threefry key words
    res_com: torch.Tensor     # (B, Mres+1, 3) reservoir molecule COMs
    res_offset: torch.Tensor  # (B, Sres, 3) reservoir site offsets
    res_n: torch.Tensor       # (B, R+1) int32 reservoir populations

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    @property
    def B(self) -> int:
        return int(self.pos.shape[0])


def tensor_fields(obj):
    """(name, tensor) pairs of a SystemSpec or SimState."""
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.name not in _META_FIELDS]


def disable_tf32() -> None:
    """Turn TF32 off for matrix products and cuDNN: positions and energies
    must never pass through reduced-precision math."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_device(obj, device, dtype=None):
    """Move a SystemSpec or SimState to ``device``; floating tensors are
    cast to ``dtype`` (default: keep). Picking a CUDA device turns TF32 off
    (disable_tf32); a spec the kernels take there must lie inside their
    minimum image (kernels.require_image_domain raises otherwise)."""
    device = torch.device(device)
    if device.type == "cuda":
        disable_tf32()
    kw = {}
    for name, t in tensor_fields(obj):
        if t.is_floating_point() and dtype is not None:
            kw[name] = t.to(device=device, dtype=dtype)
        else:
            kw[name] = t.to(device=device)
    if isinstance(obj, SystemSpec) and dtype is not None:
        kw["dtype_name"] = str(dtype).replace("torch.", "")
    out = dataclasses.replace(obj, **kw)
    if isinstance(obj, SystemSpec) and device.type == "cuda":
        from .kernels import require_image_domain
        require_image_domain(out)
    return out


def _grid_columns(ex_sel: np.ndarray, ey_sel: np.ndarray):
    """Per dense-grid column: (jx, signed jy), with jx = -1 on pad columns.
    Read off the 0/1 expansion selectors, so the convention (cols
    jx*JyB + jy, signed jy rows of ey_sel) is whatever the builder used."""
    ky = (ey_sel.shape[0] - 1) // 2
    live = (ex_sel.sum(0) > 0) & (ey_sel.sum(0) > 0)
    jx = np.where(live, np.argmax(ex_sel, axis=0), -1).astype(np.int32)
    jy = np.where(live, np.argmax(ey_sel, axis=0) - ky, 0).astype(np.int32)
    return jx, jy


def _mode_lists(k_weights, col_jx, col_jy, kz: int):
    """The k-space modes the footprint kernels walk, each a row (m, jx, jy,
    jz) of its flat index m = row * JxyP + col in the (JzP, JxyP) grid and
    its signed indices: (the modes of nonzero weight, ascending, which the
    k-space delta sums; their weights; the real modes, row < 2 kz + 1 and
    col_jx >= 0, ascending, which an accepted move's amplitude commit
    updates). The grid pads rows to a multiple of 8 and columns to one of
    128, the TPU's tiles: walking the lists, no thread takes a pad mode."""
    w = np.asarray(k_weights).ravel()
    col_jx, col_jy = np.asarray(col_jx), np.asarray(col_jy)
    JxyP = col_jx.shape[0]
    row, col = np.divmod(np.arange(w.shape[0]), JxyP)
    table = np.stack([np.arange(w.shape[0]), col_jx[col], col_jy[col],
                      row - kz], axis=1).astype(np.int32)
    real = (row < 2 * kz + 1) & (col_jx[col] >= 0)
    weighted = w != 0
    if (weighted & ~real).any():
        raise ValueError("a k-space mode of nonzero weight lies in the "
                         "grid's padding")
    return table[weighted], w[weighted], table[real]


def _host_tensor(a) -> torch.Tensor:
    """C-contiguous host tensor (a copy): float64, bool or int32 by kind."""
    a = np.asarray(a)
    dt = {"f": np.float64, "b": bool}.get(a.dtype.kind, np.int32)
    return torch.from_numpy(np.array(a, dtype=dt, order="C"))


def _charge_table(site_q, base_list, A_list, cap_list, lo):
    """The charged atoms of the molecules the resync kernel synthesizes: the
    types whose sites start at ``lo`` or above (guest_base with the
    framework split, 0 without), each read off its first molecule slot.
    Returns ((n_types, 5) int32 rows (site base, atoms per molecule,
    charged atoms per molecule, first entry of the offsets, type), (n,)
    int32 offsets of the charged atoms within a molecule, type by type (one
    0 when there are none), and those types whose molecule slots do not all
    carry the first slot's charges)."""
    q = np.asarray(site_q)
    rows, offsets, mixed = [], [], []
    for r, (base, A, cap) in enumerate(zip(base_list, A_list, cap_list)):
        if base < lo:
            continue
        slots = q[base:base + cap * A].reshape(cap, A)
        off = np.flatnonzero(slots[0] != 0)
        if not (slots == slots[0]).all():
            mixed.append(r)
        rows.append((base, A, len(off), len(offsets), r))
        offsets.extend(off)
    return (np.asarray(rows, dtype=np.int32).reshape(-1, 5),
            np.asarray(offsets or [0], dtype=np.int32), tuple(mixed))


def _image_reach(leaves: dict, pos, com, n_mol, res_offset) -> tuple:
    """Per axis, the largest |x_i - x_j| of two sites the MC moves can
    give: the bound on every dx the kernels' minimum image takes, held to
    the domain of their image thresholds where the spec is loaded onto the
    card (kernels.require_image_domain). A molecule of an active type lies within ``rad`` of
    its COM, and the COM within the box [lo, lo + L] (wrapped at load and
    by a translation, drawn inside it by an insertion); ``rad`` is the
    largest offset norm of an initial molecule, an insertion template and a
    reservoir molecule (rotations keep the norms). Sites of inactive types
    stay where they were loaded. ``leaves`` are the spec's arrays; pos
    (..., 3, S), com (..., 3, Mtot + 1), n_mol (..., R + 1) and res_offset
    (..., Sres, 3) the loaded state's."""
    lo = np.asarray(leaves["bounds"], dtype=np.float64)[:, 0]
    length = np.asarray(leaves["box_diag"], dtype=np.float64)
    site_type = np.asarray(leaves["site_type"])
    active = np.append(np.asarray(leaves["type_active"], dtype=bool), False)
    S = site_type.shape[0]
    pos = np.asarray(pos, dtype=np.float64).reshape(-1, 3, S)
    com = np.asarray(com, dtype=np.float64)
    com = com.reshape(-1, 3, com.shape[-1])
    n_mol = np.asarray(n_mol).reshape(pos.shape[0], -1)
    live = (np.asarray(leaves["site_midx"])[None]
            < np.take_along_axis(n_mol, site_type[None].repeat(
                pos.shape[0], 0), axis=1))
    mobile = live & active[site_type][None]
    fixed = live & ~active[site_type][None]
    offsets = pos - com[:, :, np.asarray(leaves["site_mol"])]
    rows = [np.linalg.norm(offsets, axis=1)[mobile],
            np.linalg.norm(np.asarray(leaves["type_template_off"])[
                active[:-1]], axis=-1).ravel(),
            np.linalg.norm(np.asarray(res_offset).reshape(-1, 3), axis=-1)]
    rad = max(float(np.max(r, initial=0.0)) for r in rows)
    lo_all, hi_all = lo - rad, lo + length + rad
    if fixed.any():
        placed = pos.transpose(0, 2, 1)[fixed]
        lo_all = np.minimum(lo_all, placed.min(axis=0))
        hi_all = np.maximum(hi_all, placed.max(axis=0))
    return tuple(float(x) for x in hi_all - lo_all)


def _frozen_tiles(leaves: dict, pos, n_mol):
    """The frozen tiles (physics/fwsplit.py build_frozen_tiles) of the
    live frozen sites at ``pos`` (3, S) with populations ``n_mol``; none
    without the framework split."""
    frozen = [r for r, on in enumerate(leaves["active_list"]) if not on]
    cols = (live_frozen_sites(leaves["type_site_base"], leaves["A_list"],
                              n_mol, frozen)
            if leaves["fw_split"] else np.zeros(0, dtype=np.int64))
    return build_frozen_tiles(np.asarray(pos, dtype=np.float64).T, cols,
                              leaves["site_q"], leaves["eps_site"],
                              leaves["sig2_site"], leaves["box_diag"])


def _spec_from_leaves(leaves: dict, pos, n_mol) -> SystemSpec:
    """Assemble a host (float64 / int32) SystemSpec from numpy arrays and
    meta values keyed by field name; ``pos`` (3, S) and ``n_mol`` (R + 1,)
    of one replica give the frozen sites' own pair energy."""
    kw = {}
    derived = ("k_col_jx", "k_col_jy", "k2_col_jx", "k2_col_jy",
               "k_weighted_modes", "k_weighted_w", "k_real_modes",
               "far_coef", "far_rows", "far_units", "fw_tile_site",
               "fw_tile_pq", "fw_tile_eps", "fw_tile_sig2", "fw_tile_box",
               "q_regions", "q_offsets", "q_mixed_types", "fw_pair_energy",
               "type_intra_energy")
    for f in dataclasses.fields(SystemSpec):
        if f.name not in _META_FIELDS and f.name not in derived:
            kw[f.name] = _host_tensor(leaves[f.name])
    for dst, (ex, ey) in (("k", ("ex_sel", "ey_sel")),
                          ("k2", ("ex2_sel", "ey2_sel"))):
        jx, jy = _grid_columns(np.asarray(leaves[ex]), np.asarray(leaves[ey]))
        kw[f"{dst}_col_jx"] = torch.from_numpy(jx)
        kw[f"{dst}_col_jy"] = torch.from_numpy(jy)
    modes, weights, real = _mode_lists(leaves["k_weights"], kw["k_col_jx"],
                                       kw["k_col_jy"], leaves["kmax_xyz"][2])
    kw["k_weighted_modes"] = torch.from_numpy(modes)
    kw["k_weighted_w"] = _host_tensor(weights)
    kw["k_real_modes"] = torch.from_numpy(real)
    # a span only where the split gives a far grid to build the table of
    with (trace.span("load.far_table") if leaves["fw_split"]
          else contextlib.nullcontext()):
        far = build_far_table(leaves["c2_re"], leaves["c2_im"],
                              kw["k2_col_jx"], kw["k2_col_jy"],
                              leaves["kmax2_xyz"][1], leaves["kmax2_xyz"][2])
    for name in ("coef", "rows", "units"):
        kw[f"far_{name}"] = _host_tensor(getattr(far, name))
    tiles = _frozen_tiles(leaves, pos, n_mol)
    for name in ("site", "pq", "eps", "sig2", "box"):
        kw[f"fw_tile_{name}"] = _host_tensor(getattr(tiles, name))
    regions, offsets, kw["q_mixed_types"] = _charge_table(
        leaves["site_q"], leaves["site_base_list"], leaves["A_list"],
        leaves["cap_list"],
        leaves["guest_base"] if leaves["fw_split"] else 0)
    kw["q_regions"] = torch.from_numpy(regions)
    kw["q_offsets"] = torch.from_numpy(offsets)
    kw.update({name: leaves[name] for name in _META_FIELDS
               if name not in derived})
    kw["dtype_name"] = "float64"
    kw["fw_pair_energy"] = torch.zeros(2, dtype=torch.float64)
    kw["type_intra_energy"] = torch.zeros(len(kw["A_list"]),
                                          dtype=torch.float64)
    spec = SystemSpec(**kw)
    from .physics.energy import frozen_pair_energy, template_intra_energy
    return dataclasses.replace(
        spec, type_intra_energy=template_intra_energy(spec),
        fw_pair_energy=frozen_pair_energy(spec, _host_tensor(pos).T,
                                          _host_tensor(n_mol)))


def _state_from_arrays(arrays: dict) -> SimState:
    kw = {}
    batched = np.ndim(arrays["pos"]) == 3
    for f in dataclasses.fields(SimState):
        a = np.asarray(arrays[f.name])
        a = a if batched else a[None]
        # the key's uint32 words do not fit int32
        kw[f.name] = (torch.from_numpy(a.astype(np.int64)) if f.name == "key"
                      else _host_tensor(a))
    return SimState(**kw)


def state_from_numpy(state_arrays: dict, *, device, dtype) -> SimState:
    """SimState leaves (numpy arrays keyed by field name, the JAX package's
    uint32 key included) -> the port's SimState on ``device``, floating
    fields in ``dtype``; a single-chain state gains B = 1."""
    return to_device(_state_from_arrays(state_arrays), device, dtype)


def from_numpy(spec_arrays: dict, state_arrays: dict, *, device, dtype):
    """JAX SystemSpec/SimState leaves (numpy arrays and meta values keyed by
    field name) -> the port's (SystemSpec, SimState) on ``device``.

    Spec leaves the port does not keep (TPU window tables) are ignored; the
    state's PRNG key is carried over; a single-chain state gains B = 1."""
    reach = _image_reach(spec_arrays, state_arrays["pos"],
                         state_arrays["com"], state_arrays["n_mol"],
                         state_arrays["res_offset"])
    pos = np.asarray(state_arrays["pos"])
    n_mol = np.asarray(state_arrays["n_mol"])
    spec = _spec_from_leaves({**spec_arrays, "image_reach": reach},
                             pos.reshape(-1, *pos.shape[-2:])[0],
                             n_mol.reshape(-1, n_mol.shape[-1])[0])
    return (to_device(spec, device, dtype),
            state_from_numpy(state_arrays, device=device, dtype=dtype))


def convert_fugacity(fugacity_atm: float, temp_K: float) -> float:
    """atm -> activity in A^-3 (reference: src/prepare_utils.f90:48-73)."""
    return fugacity_atm * ATM_TO_PA * A3_TO_M3 / (KB_JK * temp_K)


def _default_capacity(n_init: int, requested: int | None) -> int:
    if requested is not None:
        return max(requested, n_init)
    return max(_round_up(2 * n_init + 64, 64), 256)


def build_spec_and_state(deck: InputDeck, parsed: ParsedSystem,
                         eps, sig, ewald: EwaldSetup,
                         reservoir: ParsedSystem | None = None,
                         capacity: int | None = None
                         ) -> tuple[SystemSpec, SimState]:
    """Host-side (float64) system assembly; same layout and values as
    maniac_tpu/system.py::build_spec_and_state. The state has B = 1 and
    zero energies/amplitudes (driver.initialize_state fills them) and
    the key of the deck's seed (0 when it has none), as the JAX package's
    state."""
    R = deck.n_residue_types
    A_list = tuple(int(r.nb_atoms) for r in deck.residues)
    active = [bool(r.active) for r in deck.residues]
    cap_list = tuple(
        _default_capacity(parsed.n_mol[r], capacity) if active[r]
        else max(parsed.n_mol[r], 1)
        for r in range(R))
    A_act = max((A_list[r] for r in range(R) if active[r]), default=1)

    Mtot = sum(cap_list)
    base_list = []
    s_acc = 0
    for r in range(R):
        base_list.append(s_acc)
        s_acc = _round_up(s_acc + cap_list[r] * A_list[r], 128)
    S = _round_up(s_acc + A_act, 128)
    K = int(np.prod(ewald.grid2_shape))

    # ---- class tables -------------------------------------------------
    class_base = np.zeros(R + 1, dtype=np.int64)
    for r in range(R):
        class_base[r + 1] = class_base[r] + A_list[r]
    C = int(class_base[R])
    eps_cls = np.zeros((C + 1, C + 1))
    sig_cls = np.zeros((C + 1, C + 1))
    for i in range(R):
        for j in range(R):
            eps_cls[class_base[i]:class_base[i + 1],
                    class_base[j]:class_base[j + 1]] = eps[i][j]
            sig_cls[class_base[i]:class_base[i + 1],
                    class_base[j]:class_base[j + 1]] = sig[i][j]

    # ---- flat site / molecule tables ----------------------------------
    site_q = np.zeros(S)
    site_cls = np.full(S, C, dtype=np.int32)
    site_type = np.full(S, R, dtype=np.int32)
    site_mol = np.full(S, Mtot, dtype=np.int32)
    site_midx = np.full(S, 2**30, dtype=np.int32)
    mol_type = np.zeros(Mtot, dtype=np.int32)
    mol_midx = np.zeros(Mtot, dtype=np.int32)
    mol_site_start = np.zeros(Mtot, dtype=np.int32)
    type_site_base = np.zeros(R, dtype=np.int32)
    type_mol_base = np.zeros(R, dtype=np.int32)
    com0 = np.zeros((Mtot + 1, 3))
    pos0 = np.zeros((S, 3))

    m = 0
    for r in range(R):
        s = base_list[r]
        type_site_base[r] = s
        type_mol_base[r] = m
        A = A_list[r]
        q_template = parsed.atom_charges[r]
        for mi in range(cap_list[r]):
            mol_type[m] = r
            mol_midx[m] = mi
            mol_site_start[m] = s
            site_q[s:s + A] = q_template
            site_cls[s:s + A] = np.arange(class_base[r], class_base[r + 1])
            site_type[s:s + A] = r
            site_mol[s:s + A] = m
            site_midx[s:s + A] = mi
            if mi < parsed.n_mol[r]:
                com0[m] = parsed.mol_com[r][mi]
                pos0[s:s + A] = (parsed.mol_com[r][mi]
                                 + parsed.site_offset[r][mi])
            m += 1
            s += A

    # ---- per-type constants --------------------------------------------
    temp_K = deck.temp_K
    activity = np.zeros(R)
    for r, res in enumerate(deck.residues):
        if res.active:
            activity[r] = convert_fugacity(res.fugacity, temp_K)
    self_e = np.zeros(R)
    for r in range(R):
        q = parsed.atom_charges[r]
        q = np.where(np.abs(q) < 1e-10, 0.0, q)
        self_e[r] = -ewald.alpha / SQRTPI * np.sum(q * q) * COULOMB_K

    type_q_rows = np.zeros((R, A_act))
    type_cls_rows = np.full((R, A_act), C, dtype=np.int32)
    for r in range(R):
        A = min(A_list[r], A_act)
        type_q_rows[r, :A] = parsed.atom_charges[r][:A]
        type_cls_rows[r, :A] = np.arange(class_base[r], class_base[r] + A)

    # rigid-geometry insertion templates: first molecule of the initial
    # configuration, else first reservoir molecule (collapsed all-zero
    # template when there is neither)
    template_off = np.zeros((R, A_act, 3))
    for r in range(R):
        A = min(A_list[r], A_act)
        if parsed.n_mol[r] > 0:
            template_off[r, :A] = parsed.site_offset[r][0][:A]
        elif reservoir is not None and reservoir.n_mol[r] > 0:
            template_off[r, :A] = reservoir.site_offset[r][0][:A]

    active_ids = np.asarray([r for r in range(R) if active[r]], dtype=np.int32)
    p = deck.proba
    p_cum = np.cumsum([p.translation, p.rotation, p.insertion_deletion, p.swap])
    box = parsed.box

    # ---- reservoir -------------------------------------------------------
    has_res = reservoir is not None
    res_cap_list = tuple(
        (_default_capacity(reservoir.n_mol[r], capacity) if active[r] else 1)
        for r in range(R)) if has_res else tuple(1 for _ in range(R))
    (res_com, res_offset, res_n, res_site_base,
     res_mol_base) = _build_reservoir_arrays(
        reservoir, A_list, res_cap_list, R, A_act)
    res_H = reservoir.box.matrix if has_res else box.matrix
    res_lo = reservoir.box.bounds[:, 0] if has_res else box.bounds[:, 0]

    eps_site = eps_cls[:, site_cls]       # (C+1, S)
    sig_site = sig_cls[:, site_cls]
    sig2_site = sig_site * sig_site

    # ---- static-framework split (physics/fwsplit.py) --------------------
    mol_rad = 0.0
    for r in range(R):
        if not active[r]:
            continue
        A = A_list[r]
        mol_rad = max(mol_rad, float(np.max(
            np.linalg.norm(template_off[r, :A], axis=1), initial=0.0)))
        for src_sys in (parsed, reservoir):
            if src_sys is not None and src_sys.n_mol[r]:
                offs = np.asarray(src_sys.site_offset[r])
                mol_rad = max(mol_rad, float(
                    np.max(np.linalg.norm(offs, axis=-1))))
    fw_mode = getattr(deck, "framework_split", "auto")
    use_table = bool(getattr(deck, "use_table", False))
    if use_table:
        # tables replace the direct pair math wholesale, and the split's
        # erfc(alpha2 r) short form has no table (io/deck.py aborts on
        # framework_split on with use_table)
        fw_mode = "off"
    from .physics.fwsplit import build_fwsplit
    # a span only where there is a frozen type to build the split from
    with (trace.span("load.fwsplit") if fw_mode != "off" and not all(active)
          else contextlib.nullcontext()):
        fws = build_fwsplit(
            box, float(ewald.alpha), float(ewald.real_space_cutoff),
            kmax_xyz=tuple(int(k) for k in ewald.kmax),
            amp_shape=tuple(ewald.grid2_shape),
            R=R, active_list=active, A_list=A_list, cap_list=cap_list,
            n_mol_init=parsed.n_mol, type_site_base=type_site_base,
            site_q=site_q, pos0=pos0, mol_radius=mol_rad, enabled=fw_mode,
            alpha2=getattr(deck, "fw_alpha2", 0.0),
            rcut2=getattr(deck, "fw_rcut2", 0.0))
    if fw_mode == "on" and not fws.enabled:
        raise ValueError(f"framework_split on but ineligible: {fws.reason}")
    if fws.enabled:
        fw = dict(c2_re=fws.c2_re, c2_im=fws.c2_im, ex2_sel=fws.ex2_sel,
                  ey2_sel=fws.ey2_sel, alpha2=fws.alpha2, rcut2=fws.rcut2,
                  fw_d0=fws.d0, fw_amp_re=fws.amp_fw_re,
                  fw_amp_im=fws.amp_fw_im)
        fw_meta = dict(S_frozen=int(fws.S_frozen),
                       guest_base=int(fws.guest_base),
                       kmax2_xyz=tuple(fws.kmax2),
                       amp2_shape=tuple(fws.amp2_shape))
    else:  # inert dummies, same shapes as the JAX package's
        fw = dict(c2_re=np.zeros((8, 128)), c2_im=np.zeros((8, 128)),
                  ex2_sel=np.zeros((1, 128)), ey2_sel=np.zeros((1, 128)),
                  alpha2=0.0, rcut2=0.0, fw_d0=0.0,
                  fw_amp_re=np.zeros(ewald.grid2_shape),
                  fw_amp_im=np.zeros(ewald.grid2_shape))
        fw_meta = dict(S_frozen=0, guest_base=0, kmax2_xyz=(0, 0, 0),
                       amp2_shape=(8, 128))

    # ---- guest<->guest honest Coulomb cutoff (DIVERGENCES.md #22) --------
    gg_mode = getattr(deck, "guest_split", "auto")
    # a table returns 0 beyond its grid: its own cutoff, so no gate
    gg_cut = gg_mode in ("auto", "on") and not use_table
    gg_rcut = float(getattr(deck, "gg_rcut", 0.0) or 0.0)
    if not gg_rcut:
        gg_rcut = ERFC_DECAY / float(ewald.alpha)

    # ---- tabulated pair potentials (opt-in) ------------------------------
    # P+1 points over [0, cutoff] in f64, as the reference builds them
    # (src/tabulated_utils.f90:21-88): erfc(alpha r)/r with f(0) = 2
    # alpha/sqrt(pi), r^6 and r^12 with f(0) = 0
    if use_table:
        P = int(getattr(deck, "tabulated_points", 5000))
        tab_dx = float(ewald.real_space_cutoff) / P
        r_grid = np.arange(P + 1) * tab_dx
        with np.errstate(divide="ignore", invalid="ignore"):
            tab_erfc = np.where(
                r_grid < SMALL, 2.0 * ewald.alpha / SQRTPI,
                erfc_np(ewald.alpha * r_grid) / np.maximum(r_grid, 1e-300))
        tab_r6 = np.where(r_grid < SMALL, 0.0, r_grid ** 6)
        tab_r12 = np.where(r_grid < SMALL, 0.0, r_grid ** 12)
    else:
        tab_dx, tab_erfc, tab_r6, tab_r12 = 1.0, *np.zeros((3, 2))

    arrays = dict(
        H=box.matrix, Hinv=box.reciprocal, bounds=box.bounds,
        box_diag=np.diag(box.matrix), volume=box.volume,
        image_shifts=image_shifts(box), k_cart=ewald.dense_cart,
        k_weights=ewald.dense_weights,
        k_live=ewald.dense_live, ex_sel=ewald.ex_sel, ey_sel=ewald.ey_sel,
        two_pi_Hinv=2.0 * np.pi * box.reciprocal, alpha=ewald.alpha,
        cutoff=ewald.real_space_cutoff, temp_K=temp_K,
        site_q=site_q, site_cls=site_cls, site_type=site_type,
        site_mol=site_mol, site_midx=site_midx, mol_type=mol_type,
        mol_midx=mol_midx, mol_site_start=mol_site_start,
        eps_cls=eps_cls, sig_cls=sig_cls, eps_site=eps_site,
        sig2_site=sig2_site, type_A=np.asarray(A_list),
        type_cap=np.asarray(cap_list), type_site_base=type_site_base,
        type_mol_base=type_mol_base, type_active=np.asarray(active),
        type_activity=activity, type_self_energy=self_e,
        type_template_off=template_off, type_q_rows=type_q_rows,
        type_cls_rows=type_cls_rows, active_type_ids=active_ids,
        p_cum=p_cum, res_type_site_base=res_site_base,
        res_type_mol_base=res_mol_base, res_cap=np.asarray(res_cap_list),
        res_H=res_H, res_bounds_lo=res_lo, tab_erfc=tab_erfc, tab_r6=tab_r6,
        tab_r12=tab_r12, tab_dx=tab_dx, **fw)
    meta = dict(
        R=R, A_list=A_list, cap_list=cap_list, active_list=tuple(active),
        A_act=A_act, n_active=len(active_ids), S=S, Mtot=Mtot, K=K,
        box_kind=box.kind, is_triclinic=box.is_triclinic,
        dtype_name="float64", has_reservoir=has_res,
        kmax_xyz=tuple(int(k) for k in ewald.kmax),
        amp_shape=tuple(ewald.grid2_shape), fw_split=bool(fws.enabled),
        site_base_list=tuple(base_list), use_table=use_table,
        gg_cut=bool(gg_cut), gg_rcut=float(gg_rcut),
        res_cap_list=res_cap_list, **fw_meta)
    n_mol0 = np.zeros(R + 1, dtype=np.int32)
    n_mol0[:R] = parsed.n_mol
    meta["image_reach"] = _image_reach(arrays, pos0.T, com0.T, n_mol0,
                                       res_offset)
    spec = _spec_from_leaves({**arrays, **meta}, pos0.T, n_mol0)
    state = _state_from_arrays(dict(
        com=com0.T, pos=pos0.T, n_mol=n_mol0,
        amp_re=np.zeros(ewald.grid2_shape), amp_im=np.zeros(ewald.grid2_shape),
        energy=np.zeros(6), counters=np.zeros((2, N_MOVE_TYPES), np.int32),
        extras=np.zeros(4, np.int32),
        trans_step=np.float64(deck.translation_step),
        rot_step=np.float64(deck.rotation_step_angle),
        key=prng_key(deck.seed or 0).numpy(), res_com=res_com,
        res_offset=res_offset, res_n=res_n))
    return spec, state


def _build_reservoir_arrays(reservoir: ParsedSystem | None, A_list,
                            res_cap_list, R, A_act):
    """Flat reservoir layout (maniac_tpu/system.py::_build_reservoir_arrays):
    per type res_cap_list[r] molecule slots of A_list[r] site offsets, plus
    A_act pad rows and one pad COM."""
    Mres = sum(res_cap_list)
    Sres = sum(res_cap_list[r] * A_list[r] for r in range(R)) + A_act
    com = np.zeros((Mres + 1, 3))
    off = np.zeros((Sres, 3))
    n = np.zeros(R + 1, dtype=np.int32)
    site_base = np.zeros(R, dtype=np.int32)
    mol_base = np.zeros(R, dtype=np.int32)
    s = 0
    m = 0
    for r in range(R):
        site_base[r] = s
        mol_base[r] = m
        A = A_list[r]
        for mi in range(res_cap_list[r]):
            if reservoir is not None and mi < reservoir.n_mol[r]:
                com[m] = reservoir.mol_com[r][mi]
                off[s:s + A] = reservoir.site_offset[r][mi]
            m += 1
            s += A
        if reservoir is not None:
            n[r] = reservoir.n_mol[r]
    return com, off, n, site_base, mol_base
