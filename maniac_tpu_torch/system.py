"""SystemSpec (static tables) and SimState (batched replica state) in torch.

Counterpart of maniac_tpu/system.py. The flat padded site layout, the dense
(JzP, JxyP) k-grid and the static-framework split tables are the same as in
the JAX package, field for field, so a state can be carried across with
``from_numpy`` and compared leaf for leaf.

Differences from the JAX data model:

* ``SimState`` is batched: every field has a leading replica axis B
  (``pos`` is (B, 3, S), ``energy`` (B, 6), ...). A single chain is B = 1.
  It holds no PRNG key; randomness comes from an explicit
  ``torch.Generator``.
* The spec keeps only the tables the port reads. The TPU layouts (ghost-
  sorted framework windows, 8-row LJ slabs, row selectors) and the
  reservoir, triclinic-image and tabulated-potential tables are not built.
* Dense-grid column index tables (``k_col_jx``/``k_col_jy`` and the far-
  grid ``k2_col_*``) are derived from the 0/1 selectors ``ex_sel``/
  ``ey_sel``: the port reads phase powers by index instead of expanding
  them with selector matmuls.

``build_spec_and_state`` runs in float64 numpy on the host; ``to_device``
casts the float tables to the working dtype and moves everything to the
device.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .constants import ATM_TO_PA, A3_TO_M3, COULOMB_K, ERFC_DECAY, KB_JK, SQRTPI
from .ewald import EwaldSetup
from .io.deck import InputDeck
from .io.lammps_data import ParsedSystem

# energy component indices (internal unit: Kelvin)
E_RECIP, E_LJ, E_COUL, E_SELF, E_INTRA, E_TOT = range(6)
# counter indices: counters[:, 0] = trials, counters[:, 1] = accepts
N_MOVE_TYPES = 5

_META_FIELDS = (
    "R", "A_list", "cap_list", "active_list", "A_act", "n_active", "S",
    "Mtot", "K", "box_kind", "is_triclinic", "dtype_name", "has_reservoir",
    "kmax_xyz", "amp_shape", "fw_split", "S_frozen", "guest_base",
    "kmax2_xyz", "amp2_shape", "site_base_list", "use_table", "gg_cut",
    "gg_rcut")


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
    # Ewald dense half-space grid (JzP, JxyP): rows signed jz, cols
    # jx*Jy + jy (maniac_tpu/ewald.py); invalid/pad modes carry weight 0
    k_cart: torch.Tensor        # (K,3)
    k_weights: torch.Tensor     # (JzP, JxyP)
    k_live: torch.Tensor        # (K,)
    ex_sel: torch.Tensor        # (Jx, JxyP) 0/1
    ey_sel: torch.Tensor        # (Jy, JxyP) 0/1
    k_col_jx: torch.Tensor      # (JxyP,) int32 jx of each column, -1 = pad
    k_col_jy: torch.Tensor      # (JxyP,) int32 signed jy of each column
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
    alpha2: torch.Tensor
    rcut2: torch.Tensor
    fw_d0: torch.Tensor
    fw_amp_re: torch.Tensor       # (JzP, JxyP)
    fw_amp_im: torch.Tensor
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

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    @property
    def B(self) -> int:
        return int(self.pos.shape[0])


def tensor_fields(obj):
    """(name, tensor) pairs of a SystemSpec or SimState."""
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.name not in _META_FIELDS]


def to_device(obj, device, dtype=None):
    """Move a SystemSpec or SimState to ``device``; floating tensors are
    cast to ``dtype`` (default: keep). Picking a CUDA device turns TF32 off:
    positions and energies must never pass through reduced-precision math."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kw = {}
    for name, t in tensor_fields(obj):
        if t.is_floating_point() and dtype is not None:
            kw[name] = t.to(device=device, dtype=dtype)
        else:
            kw[name] = t.to(device=device)
    if isinstance(obj, SystemSpec) and dtype is not None:
        kw["dtype_name"] = str(dtype).replace("torch.", "")
    return dataclasses.replace(obj, **kw)


def _grid_columns(ex_sel: np.ndarray, ey_sel: np.ndarray):
    """Per dense-grid column: (jx, signed jy), with jx = -1 on pad columns.
    Read off the 0/1 expansion selectors, so the convention (cols
    jx*JyB + jy, signed jy rows of ey_sel) is whatever the builder used."""
    ky = (ey_sel.shape[0] - 1) // 2
    live = (ex_sel.sum(0) > 0) & (ey_sel.sum(0) > 0)
    jx = np.where(live, np.argmax(ex_sel, axis=0), -1).astype(np.int32)
    jy = np.where(live, np.argmax(ey_sel, axis=0) - ky, 0).astype(np.int32)
    return jx, jy


def _host_tensor(a) -> torch.Tensor:
    """C-contiguous host tensor (a copy): float64, bool or int32 by kind."""
    a = np.asarray(a)
    dt = {"f": np.float64, "b": bool}.get(a.dtype.kind, np.int32)
    return torch.from_numpy(np.array(a, dtype=dt, order="C"))


def _spec_from_leaves(leaves: dict) -> SystemSpec:
    """Assemble a host (float64 / int32) SystemSpec from numpy arrays and
    meta values keyed by field name."""
    kw = {}
    derived = ("k_col_jx", "k_col_jy", "k2_col_jx", "k2_col_jy")
    for f in dataclasses.fields(SystemSpec):
        if f.name not in _META_FIELDS and f.name not in derived:
            kw[f.name] = _host_tensor(leaves[f.name])
    for dst, (ex, ey) in (("k", ("ex_sel", "ey_sel")),
                          ("k2", ("ex2_sel", "ey2_sel"))):
        jx, jy = _grid_columns(np.asarray(leaves[ex]), np.asarray(leaves[ey]))
        kw[f"{dst}_col_jx"] = torch.from_numpy(jx)
        kw[f"{dst}_col_jy"] = torch.from_numpy(jy)
    kw.update({name: leaves[name] for name in _META_FIELDS})
    kw["dtype_name"] = "float64"
    return SystemSpec(**kw)


def _state_from_arrays(arrays: dict) -> SimState:
    kw = {}
    batched = np.ndim(arrays["pos"]) == 3
    for f in dataclasses.fields(SimState):
        a = np.asarray(arrays[f.name])
        kw[f.name] = _host_tensor(a if batched else a[None])
    return SimState(**kw)


def from_numpy(spec_arrays: dict, state_arrays: dict, *, device, dtype):
    """JAX SystemSpec/SimState leaves (numpy arrays and meta values keyed by
    field name) -> the port's (SystemSpec, SimState) on ``device``.

    Leaves the port does not keep (TPU window tables, the PRNG key, the
    reservoir arrays) are ignored; a single-chain state gains B = 1."""
    spec = _spec_from_leaves(spec_arrays)
    state = _state_from_arrays(state_arrays)
    return to_device(spec, device, dtype), to_device(state, device, dtype)


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
    zero energies/amplitudes (driver.initialize_state fills them)."""
    if reservoir is not None:
        raise NotImplementedError("reservoir systems are not ported yet")
    if bool(getattr(deck, "use_table", False)):
        raise NotImplementedError("tabulated potentials are not ported yet")
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
    # configuration (collapsed all-zero template when there is none)
    template_off = np.zeros((R, A_act, 3))
    for r in range(R):
        A = min(A_list[r], A_act)
        if parsed.n_mol[r] > 0:
            template_off[r, :A] = parsed.site_offset[r][0][:A]

    active_ids = np.asarray([r for r in range(R) if active[r]], dtype=np.int32)
    p = deck.proba
    p_cum = np.cumsum([p.translation, p.rotation, p.insertion_deletion, p.swap])
    box = parsed.box

    eps_site = eps_cls[:, site_cls]       # (C+1, S)
    sig_site = sig_cls[:, site_cls]
    sig2_site = sig_site * sig_site

    # ---- static-framework split (physics/fwsplit.py) --------------------
    lj_idx = []
    for r in range(R):
        A = min(A_list[r], A_act)
        lj_idx.append([a for a in range(A)
                       if np.any(eps_cls[class_base[r] + a] != 0.0)])
    Lmax = max([len(lj_idx[r]) for r in range(R) if active[r]] + [1])
    mol_rad = 0.0
    for r in range(R):
        if not active[r]:
            continue
        A = A_list[r]
        mol_rad = max(mol_rad, float(np.max(
            np.linalg.norm(template_off[r, :A], axis=1), initial=0.0)))
        if parsed.n_mol[r]:
            offs = np.asarray(parsed.site_offset[r])
            mol_rad = max(mol_rad, float(np.max(np.linalg.norm(offs, axis=-1))))
    fw_mode = getattr(deck, "framework_split", "auto")
    from .physics.fwsplit import build_fwsplit
    fws = build_fwsplit(
        box, float(ewald.alpha), float(ewald.real_space_cutoff),
        kmax_xyz=tuple(int(k) for k in ewald.kmax),
        amp_shape=tuple(ewald.grid2_shape),
        R=R, active_list=active, A_list=A_list, cap_list=cap_list,
        n_mol_init=parsed.n_mol, type_site_base=type_site_base,
        site_q=site_q, site_cls=site_cls, pos0=pos0,
        eps_cls=eps_cls, sig_cls=sig_cls, class_base=class_base,
        lj_idx=lj_idx, Lmax=Lmax, active_ids=active_ids,
        mol_radius=mol_rad, enabled=fw_mode,
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
    gg_cut = gg_mode in ("auto", "on")
    gg_rcut = float(getattr(deck, "gg_rcut", 0.0) or 0.0)
    if not gg_rcut:
        gg_rcut = ERFC_DECAY / float(ewald.alpha)

    arrays = dict(
        H=box.matrix, Hinv=box.reciprocal, bounds=box.bounds,
        box_diag=np.diag(box.matrix), volume=box.volume,
        k_cart=ewald.dense_cart, k_weights=ewald.dense_weights,
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
        p_cum=p_cum, **fw)
    meta = dict(
        R=R, A_list=A_list, cap_list=cap_list, active_list=tuple(active),
        A_act=A_act, n_active=len(active_ids), S=S, Mtot=Mtot, K=K,
        box_kind=box.kind, is_triclinic=box.is_triclinic,
        dtype_name="float64", has_reservoir=False,
        kmax_xyz=tuple(int(k) for k in ewald.kmax),
        amp_shape=tuple(ewald.grid2_shape), fw_split=bool(fws.enabled),
        site_base_list=tuple(base_list), use_table=False,
        gg_cut=bool(gg_cut), gg_rcut=float(gg_rcut), **fw_meta)
    spec = _spec_from_leaves({**arrays, **meta})

    n_mol0 = np.zeros(R + 1, dtype=np.int32)
    n_mol0[:R] = parsed.n_mol
    state = _state_from_arrays(dict(
        com=com0.T, pos=pos0.T, n_mol=n_mol0,
        amp_re=np.zeros(ewald.grid2_shape), amp_im=np.zeros(ewald.grid2_shape),
        energy=np.zeros(6), counters=np.zeros((2, N_MOVE_TYPES), np.int32),
        extras=np.zeros(4, np.int32),
        trans_step=np.float64(deck.translation_step),
        rot_step=np.float64(deck.rotation_step_angle)))
    return spec, state
