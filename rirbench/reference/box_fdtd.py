"""Plain PyTorch reference: a closed box room with lossy walls, stepped on
its natural grid.

Everything is worked out here again from the room description (the
configuration's file and the request's source, receivers and duration):
the grid lines, the boundary nodes and their open legs, the wall
coefficients of the RLC branches, the trilinear source and receiver
weights and the input signal.  The grid is the natural one: not rotated,
and on FCC not folded.  On FCC only the even-parity points (x + y + z
even) are stored, each z column at its own parity: natural point
(x, y, z) is stored at (x, y, z // 2).  It imports nothing of the program
under test.

The scheme is the reference PFFDTD's leapfrog (fdtd_common.h), as a reader
of its equations would write it:

    u^{n+1} = (2 - sl2 K) u^n - u^{n-1} + a2 sum_{open legs} u^n(x + v)

with K the count of open legs, a2 = lfac l2, sl2 = (1 + fp32_eps) a2 and
lfac 1/4 (FCC) or 1 (Cartesian): on every interior point as if all its
legs were open, then again at the nodes with a cut leg over their open
legs only; then at the nodes inside the room that
have a cut leg the RLC-branch ODE of the walls, then the source samples.
The grid spacing is the configuration's: h = c / (fmax ppw).
A leg is cut where it crosses a wall: its two ends lie on different sides.
The exterior (grid lines past the walls, ABC layers, halos) is then never
reached from inside and stays exactly zero, so no ABC is computed.

`round_fn` stores every new value through a rounding (the control: TF32)."""

from __future__ import annotations

import math

import numpy as np
import torch

OFFSET = 3.5          # grid lines past each wall, in units of h
CART_LEGS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
             (0, 0, -1))
FCC_LEGS = ((1, 1, 0), (-1, -1, 0), (0, 1, 1), (0, -1, -1), (1, 0, 1),
            (-1, 0, -1), (1, -1, 0), (-1, 1, 0), (0, 1, -1), (0, -1, 1),
            (1, 0, -1), (-1, 0, 1))
CORNERS = np.array([[0, 0, 0], [-1, 0, 0], [0, -1, 0], [0, 0, -1],
                    [-1, -1, 0], [-1, 0, -1], [0, -1, -1], [-1, -1, -1]])


def identity(t):
    return t


def tf32(t):
    """Round a float32 tensor to TF32 (10 mantissa bits), to nearest even."""
    i = t.view(torch.int32)
    r = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    return r.view(torch.float32)


class Scheme:
    """The constants of one configuration: grid, time step, wall
    coefficients."""

    def __init__(self, cfg: dict, sim_seconds: float):
        self.fcc = cfg["grid"] == "fcc"
        self.L = np.array([cfg["room"][k] for k in ("Lx", "Ly", "Lz")], float)
        self.c = float(cfg["c"])
        self.h = h = self.c / (float(cfg["fmax_hz"]) * float(cfg["ppw"]))
        # the Courant number: the stability limit, backed off
        self.l = float(cfg["courant_backoff"]) * math.sqrt(
            1.0 if self.fcc else 1.0 / 3.0)
        self.l2 = self.l * self.l
        self.Ts = h * self.l / self.c
        self.Nt = int(np.ceil(sim_seconds / self.Ts))
        lfac = 0.25 if self.fcc else 1.0
        self.a2 = lfac * self.l2
        self.sl2 = (1.0 + float(cfg.get("fp32_eps", 0.0))) * self.a2
        self.legs = FCC_LEGS if self.fcc else CART_LEGS
        self.axes = [self._axis(L) for L in self.L]
        self.N = tuple(v.size for v in self.axes)
        # the points the scheme updates: on FCC the even-parity half
        self.points = math.prod(self.N) // (2 if self.fcc else 1)
        # the RLC branches: admittance branches D s + E + F / s, bilinear
        D, E, F = np.asarray(cfg["material_DEF"], float).T
        Dh, Eh, Fh = D / self.Ts, E, F * self.Ts
        self.b = 1.0 / (2.0 * Dh + Eh + 0.5 * Fh)
        self.bd = self.b * (2.0 * Dh - Eh - 0.5 * Fh)
        self.bDh = self.b * Dh
        self.bFh = self.b * Fh
        self.beta = float(self.b.sum())

    def _axis(self, L):
        """Grid lines from OFFSET h below 0 to at least OFFSET h past L; an
        even count on FCC."""
        lo, hi = -OFFSET * self.h, L + OFFSET * self.h
        n = int(np.ceil((hi - lo) / self.h)) + 1
        while lo + (n - 1) * self.h < hi:
            n += 1
        if self.fcc:
            n += n % 2
        return np.arange(n) * self.h + lo

    def inside(self):
        """Per axis, the grid lines strictly inside the room."""
        eps = 1e-9 * self.h
        return [(v > eps) & (v < L - eps) for v, L in zip(self.axes, self.L)]

    def weights(self, pos):
        """Trilinear weights and natural flat indices of the 8 grid points
        around `pos`; on FCC the cell is the 2h cube of even-parity
        points."""
        pos = np.asarray(pos, float)
        anchor = np.array([int(np.flatnonzero(v >= p)[0])
                           for v, p in zip(self.axes, pos)])
        step = 1
        if self.fcc:
            step = 2
            a = np.array([(v[i] - p) / self.h
                          for v, i, p in zip(self.axes, anchor, pos)])
            if anchor.sum() % 2:
                anchor[np.argmin(a)] += 1
        a = np.array([(v[i] - p) / (step * self.h)
                      for v, i, p in zip(self.axes, anchor, pos)])
        pts = anchor + step * CORNERS
        w = np.prod(np.where(CORNERS != 0, a, 1.0 - a), axis=1)
        Ny, Nz = self.N[1], self.N[2]
        return w, (pts[:, 0] * Ny + pts[:, 1]) * Nz + pts[:, 2]

    def source_signal(self, kind: str, diff: bool):
        """The input's samples, scaled to the grid (c^2 Ts^2 over the cell
        volume); `diff`: through the bilinear differentiator."""
        if kind != "impulse":
            raise ValueError(f"signal {kind!r}: the reference has impulse")
        s = np.zeros(self.Nt)
        s[0] = 1.0
        if diff:
            y, prev_x, prev_y = np.zeros(self.Nt), 0.0, 0.0
            for n in range(self.Nt):
                y[n] = 2.0 / self.Ts * (s[n] - prev_x) - prev_y
                prev_x, prev_y = s[n], y[n]
            s = y
        return s * (0.5 * self.l2 / self.h if self.fcc else self.l2 / self.h)


def boundary_nodes(sc: Scheme, device):
    """The nodes with a cut leg: natural flat indices (Nb,), their open
    legs (Nb, NN) and whether each lies inside the room (its lossy
    nodes).  On FCC only even-parity points are nodes.  Found by slabs of
    x of at most 2^30 points."""
    Nx, Ny, Nz = sc.N
    ix, iy, iz = (torch.from_numpy(m).to(device) for m in sc.inside())
    inside = ix[:, None, None] & iy[None, :, None] & iz[None, None, :]
    odd = [torch.arange(n, device=device) % 2 == 1 for n in (Nx, Ny, Nz)]
    slab = max(1, 2**30 // (Ny * Nz))
    pts = []
    for x0 in range(1, Nx - 1, slab):
        x1 = min(x0 + slab, Nx - 1)
        here = inside[x0:x1, 1:-1, 1:-1]
        cut = torch.zeros_like(here)
        for dx, dy, dz in sc.legs:
            cut |= here != inside[x0 + dx:x1 + dx, 1 + dy:Ny - 1 + dy,
                                  1 + dz:Nz - 1 + dz]
        if sc.fcc:
            cut &= ~(odd[0][x0:x1, None, None] ^ odd[1][None, 1:-1, None]
                     ^ odd[2][None, None, 1:-1])
        p = torch.nonzero(cut)
        p[:, 0] += x0
        p[:, 1:] += 1
        pts.append(p)
        del cut
    p = torch.cat(pts)
    flat = (p[:, 0] * Ny + p[:, 1]) * Nz + p[:, 2]
    off = torch.tensor([(dx * Ny + dy) * Nz + dz for dx, dy, dz in sc.legs],
                       device=device)
    ins = inside.view(-1)
    adj = ins[flat][:, None] == ins[flat[:, None] + off[None, :]]
    return flat, adj, ins[flat], off


class BoxFDTD:
    """The reference simulation of one request on `device` in `dtype`."""

    def __init__(self, cfg: dict, src, rx, sim_seconds: float, signal: str,
                 diff: bool, device="cpu", dtype=torch.float64,
                 round_fn=identity):
        self.sc = sc = Scheme(cfg, sim_seconds)
        self.device, self.dtype, self.round = device, dtype, round_fn
        self.Nt = sc.Nt
        bn, adj, lossy, off = boundary_nodes(sc, device)
        self.shape = sc.N[:2] + (sc.N[2] // 2,) if sc.fcc else sc.N
        st = self.stored
        self.bn, self.adj = st(bn), adj.to(dtype)
        self.legs_idx = st(bn[:, None] + off[None, :])
        self.K = self.adj.sum(1)
        # the wall's staircase area: a cut leg counts |v . n| = 1 on the
        # Cartesian grid, 1/sqrt(2) on FCC, whose scheme scales it by
        # 1/(2 sqrt(2)) again
        ncut = (~adj).sum(1).to(torch.float64)
        ssaf = ncut if not sc.fcc else ncut / math.sqrt(2.0) * (
            0.5 / math.sqrt(2.0))
        self.lossy = bn[lossy]                 # natural, for the comparison
        self.lossy_st = st(self.lossy)
        self.ssaf = ssaf[lossy].to(dtype)
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)[:, None]
        self.b, self.bd, self.bDh, self.bFh = (t(sc.b), t(sc.bd), t(sc.bDh),
                                               t(sc.bFh))
        self.lo2Kbg = 0.5 * sc.l * self.ssaf * sc.beta
        sig = sc.source_signal(signal, diff)
        w, idx = sc.weights(src)
        self.src = st(torch.from_numpy(idx).to(device))
        self.sig = torch.from_numpy(w[:, None] * sig[None, :]).to(
            device, dtype)                                     # (8, Nt)
        taps = [sc.weights(r) for r in np.atleast_2d(rx)]
        self.rx_w = torch.tensor(np.stack([w for w, _ in taps]),
                                 dtype=torch.float64)          # (Nr, 8)
        self.rx_idx = st(torch.from_numpy(
            np.concatenate([i for _, i in taps])).to(device))

    def stored(self, nat):
        """Flat indices in the stored grid of natural flat indices (on FCC
        of even-parity points)."""
        if not self.sc.fcc:
            return nat
        nz = self.sc.N[2]
        return nat // nz * (nz // 2) + nat % nz // 2

    def _stencil(self, u1, u0, u2):
        """u2 = a1 u1 + a2 (the sum of u1 over every leg) - u0 on every
        interior point, as if all its legs were open."""
        sc = self.sc
        c = (slice(1, -1),) * 3
        if sc.fcc:
            # stored (x, y, k) is natural z = 2k + p, p = (x + y) % 2: the
            # legs (x+-1, y+-1, z) stay in the column's parity, at k; the
            # legs (x+-1, y, z+-1) and (x, y+-1, z+-1) go to columns of the
            # other parity, at k and at k - 1 (p = 0) or k + 1 (p = 1)
            ax = u1[2:] + u1[:-2]
            s = ax[:, 2:, 1:-1] + ax[:, :-2, 1:-1]
            n4 = ax[:, 1:-1] + u1[1:-1, 2:]
            n4 += u1[1:-1, :-2]
            del ax
            s += n4[:, :, 1:-1]
            for i, j in ((0, 0), (1, 1)):       # p = 0: k - 1
                s[i::2, j::2] += n4[i::2, j::2, :-2]
            for i, j in ((0, 1), (1, 0)):       # p = 1: k + 1
                s[i::2, j::2] += n4[i::2, j::2, 2:]
            del n4
        else:
            s = u1[2:, 1:-1, 1:-1] + u1[:-2, 1:-1, 1:-1]
            for t in (u1[1:-1, 2:, 1:-1], u1[1:-1, :-2, 1:-1],
                      u1[1:-1, 1:-1, 2:], u1[1:-1, 1:-1, :-2]):
                s += t
        s.mul_(sc.a2).add_(u1[c], alpha=2.0 - sc.sl2 * len(sc.legs))
        torch.sub(s, u0[c], out=u2[c])

    def run(self):
        """Returns (receivers (Nr, Nt) float64 on the host, u^Nt on the
        device, in the stored grid); the branch states at the end stay in
        `vh` (M, Nl), at the lossy nodes `lossy` (natural)."""
        sc, dev, dt = self.sc, self.device, self.dtype
        z = lambda *s: torch.zeros(s, dtype=dt, device=dev)
        u0, u1, u2 = z(*self.shape), z(*self.shape), z(*self.shape)
        M, nl = self.b.shape[0], self.lossy.numel()
        vh, gh = z(M, nl), z(M, nl)
        taps = z(sc.Nt, self.rx_idx.numel())
        inner = (slice(1, -1),) * 3
        lossy = self.lossy_st
        for n in range(sc.Nt):
            taps[n] = u1.view(-1)[self.rx_idx]
            # every interior point as if all its legs were open ...
            self._stencil(u1, u0, u2)
            # ... then the boundary nodes over their open legs only
            f1, f2 = u1.view(-1), u2.view(-1)
            nb = f1[self.legs_idx]
            f2[self.bn] = ((2.0 - sc.sl2 * self.K) * f1[self.bn]
                           - u0.view(-1)[self.bn]
                           + sc.a2 * (self.adj * nb).sum(1))
            # the walls' branches at the lossy nodes
            ul, u0l = f2[lossy], u0.view(-1)[lossy]
            s = (2.0 * self.bDh * vh - self.bFh * gh).sum(0)
            ul = (ul - sc.l * self.ssaf * s + self.lo2Kbg * u0l) / (
                1.0 + self.lo2Kbg)
            vh1 = self.b * (ul - u0l) + self.bd * vh - 2.0 * self.bFh * gh
            gh = self.round(gh + 0.5 * (vh1 + vh))
            vh = self.round(vh1)
            f2[lossy] = ul
            f2.index_add_(0, self.src, self.sig[:, n])
            if self.round is not identity:
                u2[inner] = self.round(u2[inner])
            u0, u1, u2 = u1, u2, u0
        self.vh = vh
        rx = (self.rx_w[:, None, :] * taps.to(torch.float64).cpu().T.reshape(
            -1, 8, sc.Nt).transpose(1, 2)).sum(2)
        return rx.numpy(), u1
