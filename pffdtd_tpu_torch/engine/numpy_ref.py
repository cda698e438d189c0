"""NumPy reference engine: the port's correctness oracle.

Copy of `abc_q_grid` and `NumpyEngine` from pffdtd_tpu/engine/numpy_ref.py,
held array-for-array equal to them (tests/test_torch_oracle.py).  A direct,
unoptimised implementation of the FVTD-inspired FDTD scheme with
frequency-dependent impedance boundaries, SAF corrections, first-order
ABCs and machine-precision energy accounting; step order: save ABC state
-> halo flips -> air/boundary Laplacian -> leapfrog -> lossy-boundary ODEs
-> ABC loss -> in/out -> swaps.  fcc_flag=2 (the folded grid) is
supported.  A folder is read through the port's `io.simdata`, so h5py is
needed only when one is given.
"""

from __future__ import annotations

import numpy as np

from pffdtd_tpu_torch.engine.coeffs import MatCoeffs, SchemeCoeffs
from pffdtd_tpu_torch.io.simdata import MMb, read_sim_folder
from pffdtd_tpu_torch.voxelizer.vox import CART_VECTORS, FCC_VECTORS


def abc_q_grid(Nx, Ny, Nz, folded_y: bool = False) -> np.ndarray:
    """Q (ABC loss order) per interior node: # of dims at their extreme layer.

    With folded_y (fcc_flag=2), only the low-y layer carries ABCs (the high-y
    layer is the fold ghost).
    """
    qx = np.zeros(Nx, np.int8)
    qx[[1, Nx - 2]] = 1
    qy = np.zeros(Ny, np.int8)
    qy[1] = 1
    if not folded_y:
        qy[Ny - 2] = 1
    qz = np.zeros(Nz, np.int8)
    qz[[1, Nz - 2]] = 1
    Q = qx[:, None, None] + qy[None, :, None] + qz[None, None, :]
    # halo layers never get ABC updates
    Q[0], Q[-1] = 0, 0
    Q[:, 0], Q[:, -1] = 0, 0
    Q[:, :, 0], Q[:, :, -1] = 0, 0
    return Q


class NumpyEngine:
    def __init__(self, folder=None, *, consts=None, vox=None, comms=None,
                 mats=None, energy_on=False, fp32_eps=0.0):
        if folder is not None:
            sf = read_sim_folder(folder)
            consts, vox, comms, mats = sf.consts, sf.vox, sf.comms, sf.mats
        self.consts, self.vox, self.comms, self.mats = consts, vox, comms, mats
        self.energy_on = energy_on
        self.fcc_flag = consts.fcc_flag
        self.fcc = consts.fcc_flag > 0
        self.folded = consts.fcc_flag == 2

        self.Nx, self.Ny, self.Nz = vox.Nx, vox.Ny, vox.Nz
        self.Nt, self.Ns, self.Nr = comms.Nt, comms.Ns, comms.Nr
        self.sc = SchemeCoeffs.make(consts.l, consts.l2, self.fcc, eps=fp32_eps)
        self.mc = MatCoeffs.from_mats(mats, consts.Ts)
        self.VV = (FCC_VECTORS if self.fcc else CART_VECTORS).astype(np.int64)

        # lossy (non-rigid) boundary subset
        lossy = vox.mat_bn > -1
        self.bnl_ixyz = vox.bn_ixyz[lossy]
        self.mat_bnl = vox.mat_bn[lossy]
        saf = vox.saf_bn[lossy]
        self.ssaf_bnl = saf * (0.5 / np.sqrt(2.0)) if self.fcc else saf
        self.Nbl = int(self.bnl_ixyz.size)
        self.mcl = self.mc.gather(self.mat_bnl)  # (Nbl, MMb) rows

        # full-grid adjacency/bn masks
        self.bn_mask = np.zeros((self.Nx, self.Ny, self.Nz), bool)
        self.bn_mask.flat[vox.bn_ixyz] = True

        self.Q_bna = abc_q_grid(self.Nx, self.Ny, self.Nz, folded_y=self.folded)
        self.V_bna = 2.0 ** (-self.Q_bna.astype(np.float64))

        self._allocate()

    def _allocate(self):
        shape = (self.Nx, self.Ny, self.Nz)
        self.u0 = np.zeros(shape)
        self.u1 = np.zeros(shape)
        self.Lu1 = np.zeros(shape)
        self.u_out = np.zeros((self.Nr, self.Nt))
        self.vh1 = np.zeros((self.Nbl, MMb))
        self.gh1 = np.zeros((self.Nbl, MMb))
        self.vh0 = np.zeros((self.Nbl, MMb))
        self._vh1_old = np.zeros((self.Nbl, MMb))
        self.n = 0
        if self.energy_on:
            self.H_tot = np.zeros(self.Nt)
            self.E_lost = np.zeros(self.Nt + 1)
            self.E_in = np.zeros(self.Nt + 1)

    # ------------------------------------------------------------- sub-steps
    def _flip_halos(self, u):
        u[:, :, 0] = u[:, :, 2]
        u[:, :, -1] = u[:, :, -3]
        u[:, 0, :] = u[:, 2, :]
        if self.folded:
            u[:, -1, :] = u[:, -2, :]  # fold ghost row
        else:
            u[:, -1, :] = u[:, -3, :]
        u[0, :, :] = u[2, :, :]
        u[-1, :, :] = u[-3, :, :]

    def _stencil(self, u1):
        """Laplacian*lfac on the interior: air nodes full stencil, boundary
        nodes adjacency-masked (writes into self.Lu1)."""
        Lu = self.Lu1
        c = u1[1:-1, 1:-1, 1:-1]
        acc = -float(self.sc.K) * c
        for v in self.VV:
            dx, dy, dz = v
            acc = acc + u1[1 + dx:self.Nx - 1 + dx,
                           1 + dy:self.Ny - 1 + dy,
                           1 + dz:self.Nz - 1 + dz]
        if self.fcc_flag == 1:
            # only even-parity nodes live on the FCC subgrid
            ix, iy, iz = np.meshgrid(np.arange(1, self.Nx - 1),
                                     np.arange(1, self.Ny - 1),
                                     np.arange(1, self.Nz - 1), indexing="ij")
            acc = np.where((ix + iy + iz) % 2 == 0, acc, 0.0)
        Lu[1:-1, 1:-1, 1:-1] = self.sc.lfac * acc

        # overwrite boundary nodes with adjacency-masked legs
        bn = self.vox.bn_ixyz
        adj = self.vox.adj_bn.astype(np.float64)
        K = adj.sum(-1)
        acc = -K * u1.flat[bn]
        strides = self.VV @ np.array([self.Ny * self.Nz, self.Nz, 1])
        for k, s in enumerate(strides):
            acc = acc + adj[:, k] * u1.flat[bn + s]
        Lu.flat[bn] = self.sc.lfac * acc

    def _update_bnl(self, u0, u2b):
        """Frequency-dependent impedance boundary update (per-node ODE branches)."""
        if self.Nbl == 0:
            return
        m = self.mcl
        l = self.sc.l
        lo2 = self.sc.lo2
        ssaf = self.ssaf_bnl
        vh1, gh1 = self.vh1, self.gh1

        ib = self.bnl_ixyz
        lo2Kbg = lo2 * ssaf * m["beta"]
        ub = u0.flat[ib] - l * ssaf * np.sum(
            2.0 * m["bDh"] * vh1 - m["bFh"] * gh1, axis=-1)
        ub = (ub + lo2Kbg * u2b) / (1.0 + lo2Kbg)
        u0.flat[ib] = ub

        vh0 = m["b"] * (ub[:, None] - u2b[:, None]) + m["bd"] * vh1 \
            - 2.0 * m["bFh"] * gh1
        gh1 += 0.5 * (vh0 + vh1)
        self.vh0 = vh0  # for energy accounting
        self.vh1 = vh0  # swap: newest becomes vh1 next step
        self._vh1_old = vh1

    def _update_abc(self, u0, u2ba):
        lQ = self.sc.l * self.Q_bna
        mask = self.Q_bna > 0
        u0[mask] = (u0[mask] + lQ[mask] * u2ba[mask]) / (1.0 + lQ[mask])

    # ------------------------------------------------------------------ run
    def run_steps(self, nsteps: int):
        sc = self.sc
        V_fac = 2.0 if self.fcc else 1.0
        h, c, Ts, l, l2 = (self.consts.h, self.consts.c, self.consts.Ts,
                           sc.l, sc.l2)
        in_ixyz, out_ixyz = self.comms.in_ixyz, self.comms.out_ixyz
        in_sigs = self.comms.in_sigs
        abc_mask = self.Q_bna > 0

        for n in range(self.n, self.n + nsteps):
            u0, u1 = self.u0, self.u1

            if self.energy_on:
                # H_tot[n] from u^n (=u1), u^{n-1} (=u0) and L u^{n-1} (=Lu1)
                u2, Lu2 = u0, self.Lu1
                u2in = u0.flat[in_ixyz].copy()
                core = ((u1 - u2) ** 2 / l2 - u1 * Lu2)[1:-1, 1:-1, 1:-1]
                H = V_fac * 0.5 * h * np.sum(core)
                corr = (1.0 - self.V_bna[abc_mask]) * (
                    (u1[abc_mask] - u2[abc_mask]) ** 2 / l2
                    - u1[abc_mask] * Lu2[abc_mask])
                H -= V_fac * 0.5 * h * np.sum(corr)
                H += V_fac * 0.5 * c / l2 * np.sum(
                    self.ssaf_bnl[:, None] * (self.vh1 ** 2 * self.mcl["D"]
                                              + (Ts * self.gh1) ** 2 * self.mcl["F"]))
                self.H_tot[n] = H

            if self.folded:
                u1[:, -1, :] = u1[:, -2, :]
            u2ba = np.where(abc_mask, u0, 0.0)
            self._flip_halos(u1)

            self._stencil(u1)
            u2b = u0.flat[self.bnl_ixyz].copy()
            # leapfrog on the interior
            u0[1:-1, 1:-1, 1:-1] = (2.0 * u1 - u0)[1:-1, 1:-1, 1:-1] \
                + l2 * self.Lu1[1:-1, 1:-1, 1:-1]
            self._update_bnl(u0, u2b)
            self._update_abc(u0, u2ba)

            u0.flat[in_ixyz] += in_sigs[:, n]
            self.u_out[:, n] = u1.flat[out_ixyz]

            if self.energy_on:
                self.E_lost[n + 1] = self.E_lost[n] + V_fac * 0.25 * h / l * np.sum(
                    self.ssaf_bnl[:, None]
                    * ((self.vh0 + self._vh1_old) ** 2 * self.mcl["E"]))
                self.E_lost[n + 1] += 0.5 * V_fac * h / l * np.sum(
                    (self.V_bna[abc_mask] * self.Q_bna[abc_mask])
                    * (u0[abc_mask] - u2ba[abc_mask]) ** 2)
                self.E_in[n + 1] = self.E_in[n] + (V_fac * h / l2) * 0.5 * np.sum(
                    (u0.flat[in_ixyz] - u2in) * in_sigs[:, n])

            self.u0, self.u1 = u1, u0
            self.n = n + 1

    def run_all(self):
        self.run_steps(self.Nt - self.n)
        return self.u_out

    def energy_balance(self):
        """Normalised energy-balance residuals (should be ~machine eps)."""
        from pffdtd_tpu_torch.utils import rel_diff

        assert self.energy_on
        n = self.n
        return rel_diff(self.H_tot[:n] + self.E_lost[:n], self.E_in[:n])
