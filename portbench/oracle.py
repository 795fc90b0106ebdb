"""The independent energy reference: brute-force sums in float64.

It shares no code with the program or with ref/. From the configuration's
residue types (each type's sites: charges, LJ epsilon and sigma; whether
it is frozen), the box's three edges, the cutoff, the Ewald tolerance and
the positions (the writer's, or the program's after a block) it computes,
in float64 on the device and in blocks of rows, the energy under the
Fortran reference's definitions (src/energy_utils.f90:18-35):

* LJ: 12-6 between sites of different molecules, Lorentz-Berthelot
  mixing, a hard cutoff, the minimum image, no tail; frozen sites
  included (guest-framework pairs under the same cutoff, and
  framework-framework pairs of different frozen molecules);
* the Ewald split of the reference's set-up (src/prepare_utils.f90:
  103-214): the cutoff clamped to half the shortest edge where it passes
  that edge, alpha from the tolerance and the cutoff, a kmax for each
  axis from its edge, the modes of the ellipsoid sum (n_i / kmax_i)^2 <=
  1, tinfoil boundary. Real space: erfc(alpha r) / r between sites of
  different molecules at the minimum image, with no cutoff, frozen sites
  included (the reference's guest-framework sum over every frozen site,
  src/energy_utils.f90:374-442; DIVERGENCES.md #21 and #22 say how the
  program's split and guest cutoff differ from it, by under 1e-6
  kcal/mol a move); reciprocal: (2 pi / V) sum_k exp(-k^2 / (4 alpha^2))
  / k^2 |S(k)|^2 over every site present; self: -alpha / sqrt(pi) sum
  q^2 over every site present; within a molecule of an active type only
  (src/energy_utils.f90:55-81): q_a q_b (erfc(alpha r) - 1) / r at the
  minimum image;
* the structure factors S(k) = sum_i q_i exp(i k.r_i) over every site
  present, frozen ones included, on the program's half-space grid (n_x
  >= 0, rows n_z, columns n_x (2 kmax_y + 1) + n_y).

Frozen sites are given once, with their types; what they add alone
(their pairs, their self term, their part of S(k), and so
``frozen_energy``, the energy of the frozen sites alone) is summed once.

``Oracle(..., converged=True)`` takes a split converged to round-off
instead (alpha = 7 / shortest edge, on each axis every mode with |n_i|
<= 14 edge_i / shortest edge, the real space over the nearest 27
images): its Coulomb energy of guests is then the exact periodic one,
which the tests hold the split against.
The pattern is scripts/oracle.py of this repository (pure numpy), moved
to torch so that it runs on the card. Orthorhombic boxes only. The unit
constants are those the Fortran reference states (src/constants.f90:
e^2 / (4 pi eps0) = 14.40198 eV A, kB = 8.6173852e-5 eV/K); energies are
in Kelvin.
"""

from __future__ import annotations

import math

import torch

COULOMB_K = 14.40198 / 8.6173852e-5     # e^2 / (4 pi eps0 kB), K A
ROWS = 64            # rows of a block of the pair sums
MODES = 4096         # modes of a block of the reciprocal sum
LJ, RECIP, REAL, SELF, INTRA, TOTAL = range(6)
CONVERGED_MODES = 14     # modes on the shortest edge's axis when converged


def edges(box) -> tuple:
    """(Lx, Ly, Lz) of an orthorhombic box's three edges."""
    e = tuple(float(x) for x in box)
    if len(e) != 3:
        raise ValueError(f"a box has three edges, not {len(e)}")
    return e


def ewald_split(box, cutoff: float, tolerance: float):
    """(alpha, (kmax_x, kmax_y, kmax_z)) of the reference's set-up for an
    orthorhombic box of three edges."""
    L = edges(box)
    rc = cutoff if cutoff <= min(L) else min(L) / 2
    tol = min(abs(tolerance), 0.5)
    screening = math.sqrt(abs(math.log(tol * rc)))
    alpha = math.sqrt(abs(math.log(tol * rc * screening))) / rc
    precision = math.sqrt(-math.log(tol * rc * (2 * screening * alpha) ** 2))
    return alpha, tuple(max(1, round(0.25 + e * alpha * precision / math.pi))
                        for e in L)


class Oracle:
    """The sums for residue types in an orthorhombic box.

    ``residues``: a list, in the program's type order, of dicts with the
    per-site ``q_e``, ``eps_K`` and ``sigma_A`` of one molecule of the
    type and ``frozen``; a frozen type also gives ``pos`` (n, A, 3), its
    molecules' sites. ``box``: its three edges."""

    def __init__(self, residues, box, cutoff: float, tolerance: float,
                 device, converged: bool = False):
        f64 = dict(dtype=torch.float64, device=device)
        self.device = device
        self.L = torch.tensor(edges(box), **f64)
        self.cutoff = float(cutoff)
        self.types = list(residues)
        self.q, self.eps, self.sig = [], [], []
        for t in self.types:
            self.q.append(torch.tensor(t["q_e"], **f64))
            self.eps.append(torch.tensor(t["eps_K"], **f64))
            self.sig.append(torch.tensor(t["sigma_A"], **f64))
        self.active = [r for r, t in enumerate(self.types)
                       if not t["frozen"]]
        self.converged = converged
        L = edges(box)
        if converged:
            self.alpha = 7.0 / min(L)
            kmax = [math.ceil(CONVERGED_MODES * e / min(L)) for e in L]
            r = torch.arange(-1, 2, device=device)
            self.shifts = torch.cartesian_prod(r, r, r).double() * self.L
        else:
            self.alpha, kmax = ewald_split(L, cutoff, tolerance)
            self.shifts = torch.zeros(1, 3, **f64)
        self.kmax = tuple(int(k) for k in kmax)
        kx, ky, kz = (torch.arange(-k, k + 1, device=device)
                      for k in self.kmax)
        n = torch.cartesian_prod(kx.clamp(min=0).unique(), ky, kz)
        keep = (n != 0).any(1)
        if not converged:
            norm = n.double() / torch.tensor(self.kmax, **f64)
            keep &= (norm ** 2).sum(1) <= 1.0
        self.n = n[keep]                                    # n_x >= 0
        kv = self.n.double() * (2 * math.pi / self.L)
        k2 = (kv * kv).sum(1)
        self.kvec = kv
        volume = float(self.L.prod())
        # n and -n: the columns n_x = 0 hold both, the others one of two
        form = torch.where(self.n[:, 0] > 0, 2.0, 1.0).double()
        self.kw = form * (2 * math.pi / volume) * torch.exp(
            -k2 / (4 * self.alpha ** 2)) / k2
        self._frozen_sites()

    def _sites(self, pos_by_type, first_mol: int = 0):
        """Flat site tables of molecules {type: (n, A, 3)}: wrapped
        positions, unwrapped ones, q, eps, sigma, molecule ids from
        ``first_mol``."""
        p, q, eps, sig, mol = [], [], [], [], []
        for r, pos in pos_by_type.items():
            M, A = pos.shape[0], pos.shape[1]
            p.append(pos.reshape(-1, 3))
            q.append(self.q[r].repeat(M))
            eps.append(self.eps[r].repeat(M))
            sig.append(self.sig[r].repeat(M))
            mol.append(first_mol + torch.arange(
                M, device=self.device).repeat_interleave(A))
            first_mol += M
        f64 = dict(dtype=torch.float64, device=self.device)
        if not p:
            return (torch.zeros(0, 3, **f64),) * 2 + (
                torch.zeros(0, **f64),) * 3 + (
                torch.zeros(0, dtype=torch.long, device=self.device),)
        raw = torch.cat(p)
        return (self.wrap(raw), raw, torch.cat(q), torch.cat(eps),
                torch.cat(sig), torch.cat(mol))

    def _frozen_sites(self):
        """The frozen types' sites, and what they add alone: their pairs,
        their self term and their part of S(k)."""
        frozen = {r: torch.as_tensor(t["pos"]).to(self.device, torch.float64)
                  for r, t in enumerate(self.types) if t["frozen"]}
        self.frozen = self._sites(frozen, first_mol=0)
        self.n_frozen_mol = sum(p.shape[0] for p in frozen.values())
        p, _, q, eps, sig, mol = self.frozen
        self.frozen_amp = self.amplitudes(p, q)
        self.frozen_lj = self.lj_rows(self.frozen, self.frozen, True)
        self.frozen_real = self.real_rows(self.frozen, self.frozen, True)
        self.frozen_q2 = (q * q).sum()
        re, im = self.frozen_amp
        e = torch.stack([
            self.frozen_lj, (self.kw * (re * re + im * im)).sum() * COULOMB_K,
            self.frozen_real,
            -self.alpha / math.sqrt(math.pi) * self.frozen_q2 * COULOMB_K,
            torch.zeros((), dtype=torch.float64, device=self.device)])
        # (6,) the energy of the frozen sites alone: the constant part
        self.frozen_energy = torch.cat([e, e.sum()[None]])

    def wrap(self, p):
        return p - self.L * torch.floor(p / self.L)

    def min_image(self, d):
        return d - self.L * torch.round(d / self.L)

    def grid_index(self, jxy_padded: int) -> torch.Tensor:
        """Each mode's index in the program's flattened (JzP, JxyP)
        amplitude grid."""
        jy = 2 * self.kmax[1] + 1
        return ((self.n[:, 2] + self.kmax[2]) * jxy_padded
                + self.n[:, 0] * jy + self.n[:, 1] + self.kmax[1])

    def by_type(self, pos) -> dict:
        """{active type: (n, A, 3) float64} of the positions of the active
        types, a list in type order."""
        if len(pos) != len(self.active):
            raise ValueError(f"positions of {len(pos)} active types, the "
                             f"configuration has {len(self.active)}")
        return {r: torch.as_tensor(p).to(self.device, torch.float64)
                for r, p in zip(self.active, pos)}

    def energies(self, pos) -> torch.Tensor:
        """(6,) [LJ, reciprocal, real space, self, intramolecular, total]
        in K of the frozen sites and the active types' molecules ``pos``
        (a list of one (M, A, 3) tensor for each active type in order)."""
        mols = self.by_type(pos)
        guests = self._sites(mols, first_mol=self.n_frozen_mol)
        re, im = self.amplitudes(guests[0], guests[2])
        re, im = re + self.frozen_amp[0], im + self.frozen_amp[1]
        q = guests[2]
        e = torch.stack([
            self.frozen_lj + self.lj_rows(guests, self.frozen, False)
            + self.lj_rows(guests, guests, True),
            (self.kw * (re * re + im * im)).sum() * COULOMB_K,
            self.frozen_real + self.real_rows(guests, self.frozen, False)
            + self.real_rows(guests, guests, True),
            -self.alpha / math.sqrt(math.pi) * ((q * q).sum()
                                                + self.frozen_q2)
            * COULOMB_K,
            sum((self.intra(r, p) for r, p in mols.items()),
                torch.zeros((), dtype=torch.float64, device=self.device))])
        return torch.cat([e, e.sum()[None]])

    def lj_rows(self, rows, cols, same: bool):
        """LJ between the sites ``rows`` and ``cols`` (each _sites tables)
        of different molecules, halved where both are one set."""
        _, p, _, eps, sig, mol = rows
        _, pc, _, epsc, sigc, molc = cols
        has, hasc = eps > 0, epsc > 0
        p, eps, sig, mol = p[has], eps[has], sig[has], mol[has]
        pc, epsc, sigc, molc = pc[hasc], epsc[hasc], sigc[hasc], molc[hasc]
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, p.shape[0], ROWS):
            d = self.min_image(p[lo:lo + ROWS, None] - pc[None])
            r2 = (d * d).sum(-1)
            s2 = ((sig[lo:lo + ROWS, None] + sigc[None]) / 2) ** 2
            e = torch.sqrt(eps[lo:lo + ROWS, None] * epsc[None])
            keep = (mol[lo:lo + ROWS, None] != molc[None]) & (
                r2 < self.cutoff ** 2)
            sr6 = (s2 / torch.where(keep, r2, 1.0)) ** 3
            total = total + torch.where(keep, 4 * e * (sr6 * sr6 - sr6),
                                        0.0).sum()
        return total / 2 if same else total

    def real_rows(self, rows, cols, same: bool):
        """Real-space Ewald energy between the wrapped sites ``rows`` and
        ``cols`` of different molecules: at the minimum image, or
        converged over the nearest 27 images; halved where both are one
        set."""
        p, _, q, _, _, mol = rows
        pc, _, qc, _, _, molc = cols
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, p.shape[0], ROWS):
            d = p[lo:lo + ROWS, None, None] - pc[None, :, None]
            if self.converged:
                d = d + self.shifts[None, None]
            else:
                d = self.min_image(d)
            r = torch.sqrt((d * d).sum(-1))                     # (b, n, 27)
            other = mol[lo:lo + ROWS, None] != molc[None]
            r = torch.where(other[..., None], r, 1.0)
            pair = (torch.special.erfc(self.alpha * r) / r).sum(-1)
            total = total + torch.where(
                other, q[lo:lo + ROWS, None] * qc[None] * pair, 0.0).sum()
        return (total / 2 if same else total) * COULOMB_K

    def intra(self, r: int, pos):
        """q_a q_b (erfc(alpha r) - 1) / r within each molecule of the
        active type r."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        q = self.q[r]
        for a in range(q.shape[0]):
            for b in range(a + 1, q.shape[0]):
                d = self.min_image(pos[:, a] - pos[:, b])
                dist = torch.sqrt((d * d).sum(-1))
                total = total + q[a] * q[b] * (
                    (torch.special.erfc(self.alpha * dist) - 1) / dist).sum()
        return total * COULOMB_K

    def amplitudes(self, p, q):
        """S(k) of sites p (n, 3) with charges q at every mode."""
        re, im = [], []
        for lo in range(0, self.kvec.shape[0], MODES):
            th = p @ self.kvec[lo:lo + MODES].T
            re.append(q @ torch.cos(th))
            im.append(q @ torch.sin(th))
        return torch.cat(re), torch.cat(im)

    def structure_factors(self, pos):
        """(re, im) at every mode of the frozen sites and the active
        types' molecules ``pos``."""
        guests = self._sites(self.by_type(pos), first_mol=self.n_frozen_mol)
        re, im = self.amplitudes(guests[1], guests[2])
        return re + self.frozen_amp[0], im + self.frozen_amp[1]
