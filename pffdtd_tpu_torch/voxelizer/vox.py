"""Scene voxelizer: builds the FDTD adjacency graph, materials and SAF weights.

Copy of `VoxScene`, `CART_VECTORS`, `FCC_VECTORS` and `NEIGHBOR_VECTORS`
from pffdtd_tpu/voxelizer/vox.py, held array-for-array equal to them on
both backends (tests/test_torch_setup.py).  Per grid point and neighbour
direction k, a ray of length h_f*(1+eps) is cast from point-minus-leg
towards the neighbour; a triangle hit cuts that leg and marks the point a
boundary node; points within 1e-6*h_f of a surface get all legs cut (fully
rigid); material sidedness marks wrong-side nodes rigid; the staircase
surface-area factor is saf = sum_k(!adj_k)|v_k . n|.  The grid is tiled
into blocks, each processed with vectorised ray-triangle batches; the
native C++/OpenMP backend (`voxelizer/native.py`) replaces that loop.
`check_adj_full` verifies mutual adjacency, the scheme's stability
precondition.  Leg k of the vector tables is bit k of a packed mask.
"""

from __future__ import annotations

import numpy as np

from pffdtd_tpu_torch.geometry.predicates import (tri_box_intersect,
                                                  tri_ray_intersect)
from pffdtd_tpu_torch.geometry.room import RoomGeo
from pffdtd_tpu_torch.spans import span
from pffdtd_tpu_torch.utils import dotv, sub2ind3d
from pffdtd_tpu_torch.voxelizer.grid import CartGrid

R_EPS = 1e-6  # relative eps (to grid spacing) for near hits

# neighbour direction vectors, ordered in (+,-) opposite pairs
CART_VECTORS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float64)
FCC_VECTORS = np.array(
    [[+1, +1, 0], [-1, -1, 0], [0, +1, +1], [0, -1, -1], [+1, 0, +1], [-1, 0, -1],
     [+1, -1, 0], [-1, +1, 0], [0, +1, -1], [0, -1, +1], [+1, 0, -1], [-1, 0, +1]],
    np.float64)
NEIGHBOR_VECTORS = {6: CART_VECTORS, 12: FCC_VECTORS}


class VoxScene:
    def __init__(self, room_geo: RoomGeo, cart_grid: CartGrid, fcc: bool = False):
        self.rg = room_geo
        self.cg = cart_grid
        self.fcc = fcc
        h = cart_grid.h
        if fcc:
            self.NN = 12
            self.VV = FCC_VECTORS
            self.hf = h * np.sqrt(2.0)           # FCC subgrid spacing
            self.face_area = h * h / np.sqrt(2.0)
        else:
            self.NN = 6
            self.VV = CART_VECTORS
            self.hf = h
            self.face_area = h * h
        self.uvv = self.VV / np.linalg.norm(self.VV, axis=-1, keepdims=True)
        self.vvh = h * self.VV

        self.bn_ixyz = None
        self.adj_bn = None
        self.mat_bn = None
        self.saf_bn = None

    def print(self, s):
        print(f"--VOX_SCENE: {s}")

    # ------------------------------------------------------------------ main
    @span("vox.adj")
    def calc_adj(self, block_size: int = 32, backend: str = "auto"):
        """Compute boundary nodes, adjacency, materials and SAF weights."""
        if backend in ("auto", "native"):
            try:
                self._calc_adj_native(block_size)
                self._symmetrize_adj()
                self._finalise_materials()
                return
            except Exception as e:  # noqa: BLE001 - fall back to numpy
                if backend == "native":
                    raise
                self.print(f"native backend unavailable ({e}); using numpy")
        self._calc_adj_numpy(block_size)
        self._symmetrize_adj()
        self._finalise_materials()

    @span("vox.symmetrize")
    def _symmetrize_adj(self):
        """Enforce mutual adjacency: a cut leg cuts BOTH directions.

        The per-leg ray casts evaluate each segment twice (once per
        endpoint) with different fp rounding, so a hit exactly on a
        triangle edge (geometry aligned to the grid - seen on the real
        CTK church at fmax=1400) can be counted from one side only, and
        near-boundary full-rigid nodes cut legs their partners never
        tested.  Mutual adjacency is the stability precondition (the
        energy analysis assumes a symmetric graph; reference check:
        vox_scene.py:496-529), so the rare asymmetric legs are resolved
        cut-wins here.  One pass suffices: an induced cut's own partner
        is the original cut.  Partners not yet in the boundary list are
        appended (full adjacency except the cut legs, material from the
        partner's nearest triangle)."""
        bn, adj = self.bn_ixyz, self.adj_bn
        if not bn.size:
            return
        cg = self.cg
        NyNz = cg.Ny * cg.Nz
        iv = self.VV.astype(np.int64)
        strides = iv @ np.array([NyNz, cg.Nz, 1])
        new: dict[int, tuple[list, int]] = {}   # q -> ([cut legs], tidx)
        nfix = 0
        for k in range(self.NN):
            cut = np.flatnonzero(~adj[:, k])
            if not cut.size:
                continue
            p = bn[cut]
            ix = p // NyNz
            iy = (p // cg.Nz) % cg.Ny
            iz = p % cg.Nz
            dx, dy, dz = iv[k]
            inside = ((ix + dx >= 0) & (ix + dx < cg.Nx)
                      & (iy + dy >= 0) & (iy + dy < cg.Ny)
                      & (iz + dz >= 0) & (iz + dz < cg.Nz))
            q = (p + strides[k])[inside]
            cut = cut[inside]
            pos = np.searchsorted(bn, q)
            found = (pos < bn.size) & (bn[np.minimum(pos, bn.size - 1)] == q)
            miss = adj[np.minimum(pos, bn.size - 1), k ^ 1] & found
            nfix += int(miss.sum())
            adj[pos[miss], k ^ 1] = False
            for qq, ci in zip(q[~found], cut[~found]):
                legs, _ = new.setdefault(int(qq),
                                         ([], int(self.tidx_bn[ci])))
                legs.append(k ^ 1)
        if new:
            qs = np.array(sorted(new), np.int64)
            na = np.ones((qs.size, self.NN), bool)
            nt = np.zeros(qs.size, np.int32)
            for i, qq in enumerate(qs):
                legs, t = new[int(qq)]
                na[i, legs] = False
                nt[i] = t
            self.bn_ixyz = np.concatenate([bn, qs])
            self.adj_bn = np.concatenate([adj, na])
            self.tidx_bn = np.concatenate([self.tidx_bn, nt])
            self.ndist_bn = np.concatenate(
                [self.ndist_bn, np.full(qs.size, self.hf)])
            order = np.argsort(self.bn_ixyz)
            self.bn_ixyz = self.bn_ixyz[order]
            self.adj_bn = self.adj_bn[order]
            self.tidx_bn = self.tidx_bn[order]
            self.ndist_bn = self.ndist_bn[order]
        if nfix or new:
            self.print(f"--VOX_SCENE: symmetrized {nfix} legs, "
                       f"{len(new)} added boundary nodes")

    def _calc_adj_native(self, block_size: int):
        from pffdtd_tpu_torch.voxelizer import native

        res = native.calc_adj(self, block_size)
        self.bn_ixyz, self.adj_bn, self.tidx_bn, self.ndist_bn = res

    def _calc_adj_numpy(self, block_size: int):
        cg, rg = self.cg, self.rg
        Nx, Ny, Nz = cg.Nx, cg.Ny, cg.Nz
        h, hf = cg.h, self.hf
        NN, vvh, uvv = self.NN, self.vvh, self.uvv
        tp = rg.tris_pre

        bn_parts = []  # (ixyz, adj, tidx, ndist) per block

        # tile interior points [1, N-2] into blocks
        xs = np.arange(1, Nx - 1, block_size)
        ys = np.arange(1, Ny - 1, block_size)
        zs = np.arange(1, Nz - 1, block_size)
        margin = hf * (1 + R_EPS) + np.abs(vvh).max()

        for x0 in xs:
            x1 = min(x0 + block_size, Nx - 1)
            for y0 in ys:
                y1 = min(y0 + block_size, Ny - 1)
                for z0 in zs:
                    z1 = min(z0 + block_size, Nz - 1)
                    # candidate tris: bbox overlap with the expanded block box
                    bmin = np.array([cg.xv[x0], cg.yv[y0], cg.zv[z0]]) - margin
                    bmax = np.array([cg.xv[x1 - 1], cg.yv[y1 - 1], cg.zv[z1 - 1]]) + margin
                    cand = np.flatnonzero(
                        np.all(tp.bmin <= bmax, -1) & np.all(tp.bmax >= bmin, -1))
                    if cand.size == 0:
                        continue
                    cand = cand[tri_box_intersect(bmin, bmax, tp.select(cand))]
                    if cand.size == 0:
                        continue
                    part = self._process_block(
                        (x0, x1), (y0, y1), (z0, z1), cand)
                    if part is not None:
                        bn_parts.append(part)

        if bn_parts:
            self.bn_ixyz = np.concatenate([p[0] for p in bn_parts])
            self.adj_bn = np.concatenate([p[1] for p in bn_parts])
            self.tidx_bn = np.concatenate([p[2] for p in bn_parts])
            self.ndist_bn = np.concatenate([p[3] for p in bn_parts])
        else:
            self.bn_ixyz = np.zeros((0,), np.int64)
            self.adj_bn = np.zeros((0, NN), bool)
            self.tidx_bn = np.zeros((0,), np.int32)
            self.ndist_bn = np.zeros((0,), np.float64)
        order = np.argsort(self.bn_ixyz)
        self.bn_ixyz = self.bn_ixyz[order]
        self.adj_bn = self.adj_bn[order]
        self.tidx_bn = self.tidx_bn[order]
        self.ndist_bn = self.ndist_bn[order]
        assert np.unique(self.bn_ixyz).size == self.bn_ixyz.size

    def _process_block(self, xr, yr, zr, cand):
        """Vectorised adjacency for one block of grid points."""
        cg = self.cg
        NN, hf, h = self.NN, self.hf, cg.h
        tp = self.rg.tris_pre

        ix, iy, iz = np.meshgrid(np.arange(*xr), np.arange(*yr), np.arange(*zr),
                                 indexing="ij")
        ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
        if self.fcc:  # only even-parity points live on the FCC subgrid
            keep = (ix + iy + iz) % 2 == 0
            ix, iy, iz = ix[keep], iy[keep], iz[keep]
        if ix.size == 0:
            return None
        P = ix.size
        xyz = np.stack([cg.xv[ix], cg.yv[iy], cg.zv[iz]], axis=-1)

        adj = np.ones((P, NN), bool)
        bp = np.zeros(P, bool)
        nb = np.zeros(P, bool)          # near-boundary -> fully rigid
        ndist = np.full(P, np.inf)
        tidx = np.full(P, -1, np.int32)

        for t in cand:
            tri = tp.select(slice(t, t + 1))
            # cull by triangle bbox then plane distance
            m = (np.all(xyz >= tri.bmin[0] - hf * (1 + R_EPS), -1)
                 & np.all(xyz <= tri.bmax[0] + hf * (1 + R_EPS), -1))
            if not m.any():
                continue
            sel = np.flatnonzero(m)
            dtp = dotv(tri.unor[0], tri.cent[0] - xyz[sel])
            sel = sel[np.abs(dtp) <= hf * (1 + R_EPS)]
            if sel.size == 0:
                continue

            # all NN ray casts against this triangle in one batched call:
            # origins p - leg_k, directions u_k, lengths shifted by hf
            ro = (xyz[sel][:, None, :] - self.vvh[None, :, :]).reshape(-1, 3)
            rd = np.broadcast_to(self.uvv[None], (sel.size, NN, 3)).reshape(-1, 3)
            _, dist = tri_ray_intersect(ro, rd, tri, d_eps=1e-3 * h)
            dist = dist.reshape(sel.size, NN) - hf
            dist[dist < -R_EPS * hf] = np.inf   # hit behind the point

            tnb = np.abs(dist) <= R_EPS * hf    # grazing hits: near-boundary
            nb[sel] |= tnb.any(-1)
            dist = np.abs(dist)

            within = dist <= (1 + R_EPS) * hf
            adj[sel] &= ~within
            bp[sel] |= within.any(-1)

            dmin = dist.min(-1)
            nearer = within.any(-1) & (dmin < ndist[sel])
            ndist[sel[nearer]] = dmin[nearer]
            tidx[sel[nearer]] = t

        adj[nb, :] = False  # near-boundary points: fully rigid

        if not bp.any():
            return None
        q = np.flatnonzero(bp)
        ixyz = sub2ind3d(ix[q], iy[q], iz[q], cg.Nx, cg.Ny, cg.Nz)
        return ixyz, adj[q], tidx[q], ndist[q]

    # --------------------------------------------------------- consolidation
    @span("vox.materials")
    def _finalise_materials(self):
        """Material sidedness + SAF staircase correction (vox_scene.py:392-431)."""
        rg, cg = self.rg, self.cg
        tp = rg.tris_pre
        bn_ixyz, adj_bn, tidx = self.bn_ixyz, self.adj_bn, self.tidx_bn

        ix = bn_ixyz // (cg.Ny * cg.Nz)
        iy = (bn_ixyz // cg.Nz) % cg.Ny
        iz = bn_ixyz % cg.Nz
        xyz_bn = np.stack([cg.xv[ix], cg.yv[iy], cg.zv[iz]], -1)
        dv = dotv(xyz_bn - tp.cent[tidx], tp.unor[tidx])

        mat_bn = rg.mat_ind[tidx].astype(np.int8)
        side = rg.mat_side[tidx]
        mat_bn[(dv > 0) & (side == 1)] = -1  # wrong side of back-only tri
        mat_bn[(dv < 0) & (side == 2)] = -1  # wrong side of front-only tri
        mat_bn[np.all(~adj_bn, axis=-1)] = -1  # fully rigid (near-boundary)

        # SAF: effective surface area seen through cut legs, one face per pair
        saf_bn = np.zeros(bn_ixyz.size, np.float64)
        for j in range(0, self.NN, 2):
            saf = np.abs(dotv(self.uvv[j], tp.unor[tidx]))
            saf_bn += ((~adj_bn[:, j]).astype(np.float64)
                       + (~adj_bn[:, j + 1])) * saf

        self.mat_bn = mat_bn
        self.saf_bn = saf_bn

        # per-material approximated area report (diagnostic)
        sa = np.zeros(rg.Nmat + 1)
        np.add.at(sa, mat_bn, self.face_area * saf_bn)
        for i in range(rg.Nmat):
            if rg.mat_area[i] > 0:
                err = (sa[i] / rg.mat_area[i] - 1) * 100
                self.print(f"mat {rg.mat_str[i]}: corrected area {err:+.3f}% over")

    # ---------------------------------------------------------------- checks
    @span("vox.check_adj_full")
    def check_adj_full(self, chunk: int = 1 << 24):
        """Mutual-adjacency check: adj[p,k] == adj[p+v_k, opp(k)] everywhere.

        A stability precondition for the FDTD scheme (energy analysis assumes
        a symmetric graph).  SPARSE: non-boundary nodes carry the implicit
        all-ones mask, so a violation always involves a boundary node - each
        node's NN partners are resolved by searchsorted into the sorted
        boundary list (air partner => adjacency must be 1).  O(Nb log Nb)
        time and O(chunk) memory: no dense grid exists at any point, unlike
        the reference's full-grid bit-packed memmap (vox_scene.py:496-529),
        so the check scales to 1e10+ voxel setups in bounded RAM.
        """
        cg = self.cg
        NN = self.NN
        bn = np.asarray(self.bn_ixyz, np.int64)
        assert np.all(np.diff(bn) > 0), "bn_ixyz must be sorted/unique"
        adj = np.asarray(self.adj_bn, bool)
        iv = self.VV.astype(np.int64)
        NyNz = cg.Ny * cg.Nz
        strides = iv @ np.array([NyNz, cg.Nz, 1])
        for c0 in range(0, bn.size, chunk):
            p = bn[c0:c0 + chunk]
            ix = p // NyNz
            iy = (p // cg.Nz) % cg.Ny
            iz = p % cg.Nz
            for k in range(NN):
                dx, dy, dz = iv[k]
                inside = ((ix + dx >= 0) & (ix + dx < cg.Nx)
                          & (iy + dy >= 0) & (iy + dy < cg.Ny)
                          & (iz + dz >= 0) & (iz + dz < cg.Nz))
                q = p + strides[k]
                pos = np.searchsorted(bn, q)
                found = (pos < bn.size) & (bn[np.minimum(pos, bn.size - 1)]
                                           == q)
                a_q = np.where(found,
                               adj[np.minimum(pos, bn.size - 1), k ^ 1],
                               True)
                ok = adj[c0:c0 + chunk, k] == a_q
                if not np.all(ok | ~inside):
                    raise AssertionError(
                        f"adjacency not mutual along direction {k}")
        self.print("check_adj_full: passed")

    # ------------------------------------------------------------------ save
    def save(self, save_folder, compress=None):
        from pffdtd_tpu_torch.io.h5 import write_vox
        from pffdtd_tpu_torch.io.simdata import VoxData

        write_vox(save_folder, VoxData(
            Nx=self.cg.Nx, Ny=self.cg.Ny, Nz=self.cg.Nz,
            bn_ixyz=self.bn_ixyz, adj_bn=self.adj_bn,
            mat_bn=self.mat_bn, saf_bn=self.saf_bn,
            xv=self.cg.xv, yv=self.cg.yv, zv=self.cg.zv, h=self.cg.h,
        ), compress=compress)
