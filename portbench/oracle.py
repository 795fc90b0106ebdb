"""The independent energy reference: brute-force sums in float64.

It shares no code with the program or with ref/. From the configuration's
molecule (charges, LJ sites), the box, the cutoff, the Ewald tolerance and
the positions (the writer's, or the program's after a block) it computes,
in float64 on the device and in blocks of rows, the energy under the
Fortran reference's definitions (src/energy_utils.f90:18-35):

* LJ: 12-6 between sites of different molecules, Lorentz-Berthelot
  mixing, a hard cutoff, the minimum image, no tail;
* the Ewald split of the reference's set-up (src/prepare_utils.f90:
  103-214): alpha and kmax derived from the tolerance and the cutoff,
  the modes of the ellipsoid sum (n_i / kmax_i)^2 <= 1, tinfoil boundary.
  Real space: erfc(alpha r) / r between sites of different molecules at
  the minimum image; reciprocal: (2 pi / V) sum_k exp(-k^2 / (4
  alpha^2)) / k^2 |S(k)|^2; self: -alpha / sqrt(pi) sum q^2; within a
  molecule: q_a q_b (erfc(alpha r) - 1) / r at the minimum image;
* the structure factors S(k) = sum_i q_i exp(i k.r_i) on the program's
  half-space grid (n_x >= 0, rows n_z, columns n_x (2 kmax_y + 1) + n_y).

``Oracle(..., converged=True)`` takes a split converged to round-off
instead (alpha = 7 / L, every mode with |n_i| <= 14, the real space over
the nearest 27 images): its Coulomb energy is then the exact periodic
one, which the tests hold the split against.
The pattern is scripts/oracle.py of this repository (pure numpy), moved
to torch so that it runs on the card. Cubic boxes only. The unit
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


def ewald_split(L: float, cutoff: float, tolerance: float):
    """(alpha, kmax) of the reference's set-up for a cubic box."""
    rc = cutoff if cutoff <= L else L / 2
    tol = min(abs(tolerance), 0.5)
    screening = math.sqrt(abs(math.log(tol * rc)))
    alpha = math.sqrt(abs(math.log(tol * rc * screening))) / rc
    precision = math.sqrt(-math.log(tol * rc * (2 * screening * alpha) ** 2))
    return alpha, max(1, round(0.25 + L * alpha * precision / math.pi))


class Oracle:
    """The sums for one molecule type in a cubic box of edge ``L``."""

    def __init__(self, model: dict, L: float, cutoff: float,
                 tolerance: float, device, converged: bool = False):
        f64 = dict(dtype=torch.float64, device=device)
        self.device = device
        self.L, self.cutoff = float(L), float(cutoff)
        self.q = torch.tensor(model["q_e"], **f64)
        self.eps = torch.tensor(model["eps_K"], **f64)
        self.sig = torch.tensor(model["sigma_A"], **f64)
        self.A = len(model["q_e"])
        self.converged = converged
        if converged:
            self.alpha, self.kmax = 7.0 / self.L, 14
            r = torch.arange(-1, 2, device=device)
            self.shifts = torch.cartesian_prod(r, r, r).double() * self.L
        else:
            self.alpha, self.kmax = ewald_split(self.L, cutoff, tolerance)
            self.shifts = torch.zeros(1, 3, **f64)
        k = torch.arange(-self.kmax, self.kmax + 1, device=device)
        n = torch.cartesian_prod(k.clamp(min=0).unique(), k, k)
        keep = (n != 0).any(1)
        if not converged:
            keep &= ((n.double() / self.kmax) ** 2).sum(1) <= 1.0
        self.n = n[keep]                                    # n_x >= 0
        kv = self.n.double() * (2 * math.pi / self.L)
        k2 = (kv * kv).sum(1)
        self.kvec = kv
        # n and -n: the columns n_x = 0 hold both, the others one of two
        form = torch.where(self.n[:, 0] > 0, 2.0, 1.0).double()
        self.kw = form * (2 * math.pi / self.L ** 3) * torch.exp(
            -k2 / (4 * self.alpha ** 2)) / k2

    def grid_index(self, jxy_padded: int) -> torch.Tensor:
        """Each mode's index in the program's flattened (JzP, JxyP)
        amplitude grid."""
        jy = 2 * self.kmax + 1
        return ((self.n[:, 2] + self.kmax) * jxy_padded
                + self.n[:, 0] * jy + self.n[:, 1] + self.kmax)

    def energies(self, pos: torch.Tensor) -> torch.Tensor:
        """(6,) [LJ, reciprocal, real space, self, intramolecular, total]
        in K of molecules (M, A, 3)."""
        pos = pos.to(self.device, torch.float64)
        p = pos.reshape(-1, 3)
        p = p - self.L * torch.floor(p / self.L)
        q = self.q.repeat(pos.shape[0])
        re, im = self.amplitudes(p, q)
        e = torch.stack([
            self.lj(pos),
            (self.kw * (re * re + im * im)).sum() * COULOMB_K,
            self.real(p, q, pos.shape[0]),
            -self.alpha / math.sqrt(math.pi) * (q * q).sum() * COULOMB_K,
            self.intra(pos)])
        return torch.cat([e, e.sum()[None]])

    def lj(self, pos):
        M = pos.shape[0]
        has = self.eps > 0
        p = pos[:, has].reshape(-1, 3)
        mol = torch.arange(M, device=self.device).repeat_interleave(
            int(has.sum()))
        eps = self.eps[has].repeat(M)
        sig = self.sig[has].repeat(M)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, p.shape[0], ROWS):
            d = p[lo:lo + ROWS, None] - p[None]
            d = d - self.L * torch.round(d / self.L)
            r2 = (d * d).sum(-1)
            s2 = ((sig[lo:lo + ROWS, None] + sig[None]) / 2) ** 2
            e = torch.sqrt(eps[lo:lo + ROWS, None] * eps[None])
            keep = (mol[lo:lo + ROWS, None] != mol[None]) & (
                r2 < self.cutoff ** 2)
            sr6 = (s2 / torch.where(keep, r2, 1.0)) ** 3
            total = total + torch.where(keep, 4 * e * (sr6 * sr6 - sr6),
                                        0.0).sum()
        return total / 2

    def real(self, p, q, M):
        """Real-space Ewald energy between sites of different molecules,
        wrapped sites p (n, 3): at the minimum image, or converged over
        the nearest 27 images."""
        mol = torch.arange(M, device=self.device).repeat_interleave(self.A)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, p.shape[0], ROWS):
            d = p[lo:lo + ROWS, None, None] - p[None, :, None]
            if self.converged:
                d = d + self.shifts[None, None]
            else:
                d = d - self.L * torch.round(d / self.L)
            r = torch.sqrt((d * d).sum(-1))                     # (b, n, 27)
            pair = (torch.special.erfc(self.alpha * r) / r).sum(-1)
            other = mol[lo:lo + ROWS, None] != mol[None]
            total = total + torch.where(
                other, q[lo:lo + ROWS, None] * q[None] * pair, 0.0).sum()
        return total / 2 * COULOMB_K

    def intra(self, pos):
        """q_a q_b (erfc(alpha r) - 1) / r within each molecule."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for a in range(self.A):
            for b in range(a + 1, self.A):
                d = pos[:, a] - pos[:, b]
                d = d - self.L * torch.round(d / self.L)
                r = torch.sqrt((d * d).sum(-1))
                total = total + self.q[a] * self.q[b] * (
                    (torch.special.erfc(self.alpha * r) - 1) / r).sum()
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
        """(re, im) at every mode of molecules (M, A, 3)."""
        pos = pos.to(self.device, torch.float64)
        return self.amplitudes(pos.reshape(-1, 3),
                               self.q.repeat(pos.shape[0]))
