"""Host-side preparation of the static arrays one step needs, numpy only.

Counterpart of `GridSpec` and `EngineData` in
`pffdtd_tpu/engine/jax_engine.py:50-199`, without the TPU's padding (lane
and sublane alignment of z and y, x-row tiles, boundary windows) and without
its plane/stray partitions: the grid keeps its true (Nx, Ny, Nz) extents and
every lossy node goes through one node list.  Kept from the original:
- the bit-packed adjacency (bit k = leg k is open; air nodes carry the
  all-ones mask), uint8 for the 6 Cartesian legs, uint16 for the 12 FCC:
  `bn_adj` a boundary node, and `adj_grid`, the (Nx, Ny, Nz) grid, built
  at first use.  The step route's K1 reads neither as is: the engine
  uploads the compact form (`kernels.stencil.CompactAdj`, a bit a point
  and the legs of the flagged points) built from `bn_ixyz` and `bn_adj`.
  The grid is read where something besides K1 reads the adjacency: the
  energy route (K1e, K7), the tb and pair routes (K3) and the x-slab path
  (K5, K6);
- the lossy-node list with its scaled surface-area factors `ssaf`;
- the fp32 input scaling `infac`.
Material coefficients stay per material, a (Nmat+1, 4, MMb) table with
`beta (Nmat+1,)`, indexed per node by `mat_bnl`: per-node (Nbl, MMb) rows
would cost about 0.5 GB at the headline scene's size.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from pffdtd_tpu_torch.engine.coeffs import FP32_EPS, MatCoeffs, SchemeCoeffs
from pffdtd_tpu_torch.io.h5 import SimFolder


@dataclass
class GridSpec:
    """Static geometry of the grid."""

    Nx: int
    Ny: int
    Nz: int
    fcc_flag: int

    @property
    def shape(self):
        return (self.Nx, self.Ny, self.Nz)

    @property
    def folded(self):
        return self.fcc_flag == 2

    @property
    def n_interior(self) -> int:
        return (self.Nx - 2) * (self.Ny - 2) * (self.Nz - 2)


@dataclass
class SlabSpec:
    """An x-slab of a global grid, as the sharded engine holds it.

    Local row i is global row i + xo.  The slab owns the S global rows
    xo+G .. xo+G+S-1 (local rows G .. G+S-1), between G ghost rows a side
    that carry the neighbours' rows, or the global halo and rows past it on
    a slab at a global edge.  The single-device grid is the slab
    (S, G, xo) = (Nx-2, 1, 0)."""

    grid: GridSpec      # the global grid
    S: int
    G: int
    xo: int

    @property
    def shape(self):
        return (self.S + 2 * self.G, self.grid.Ny, self.grid.Nz)

    @property
    def x0(self) -> int:
        """Global row of the first owned row."""
        return self.xo + self.G

    @property
    def owned(self):
        """[lo, hi) of the owned local rows."""
        return self.G, self.G + self.S

    @property
    def computable(self):
        """[lo, hi) of the local rows that are global interior rows: the
        most a TB sweep may compute."""
        return max(0, 1 - self.xo), min(self.S + 2 * self.G,
                                        self.grid.Nx - 1 - self.xo)


def mirror_index(ixyz, grid: GridSpec) -> np.ndarray:
    """Flat indices after the mirror halo flips: the point whose value a
    flipped grid holds at `ixyz` (identity on the interior)."""
    ixyz = np.asarray(ixyz, np.int64)
    Nx, Ny, Nz = grid.shape
    ix, iy, iz = ixyz // (Ny * Nz), (ixyz // Nz) % Ny, ixyz % Nz
    y_hi = Ny - 2 if grid.folded else Ny - 3
    ix = np.where(ix == 0, 2, np.where(ix == Nx - 1, Nx - 3, ix))
    iy = np.where(iy == 0, 2, np.where(iy == Ny - 1, y_hi, iy))
    iz = np.where(iz == 0, 2, np.where(iz == Nz - 1, Nz - 3, iz))
    return (ix * Ny + iy) * Nz + iz


@dataclass
class TileLists:
    """Per-tile CSR lists of the lossy nodes for K3, the TB-step sweep.

    The interior is cut into owned boxes of `box` = (Bx, By, Bz) points,
    tile (tx, ty, tz) with id (tx*nty + ty)*ntz + tz: for K3's x-marching
    blocks, Bx is the chunk of rows a block marches over and (By, Bz) its
    y-z tile.  A tile's region R is its owned box grown by TB on every
    axis, clamped to the interior; step s of the sweep (0-based) computes
    the owned box grown by TB-1-s.  Tile t's entries ptr[t]:ptr[t+1] are the
    lossy nodes within TB-1 of its owned box (the reach of step 0), sorted
    by row x, then node id:
    - node: index into the engine's node arrays (bnl_ixyz, ssaf, mat, vh);
    - off:  the node's offset in the tile's R layout, z fastest;
    - ring: its Chebyshev distance outside the owned box, so it takes part
      in steps s <= TB-1-ring, and ring 0 marks the owner (`owned`);
    - row:  its row x;
    - yz:   its offset in one plane slot of K3, the owned y-z tile grown by
      TB on each side without clamping, (y - oy0 + TB) * (Bz + 2 TB) +
      (z - oz0 + TB);
    - rptr: per tile, W + 1 = Bx + 2(TB-1) + 1 row pointers: tile t's
      entries of row x0(t) - (TB-1) + k are rptr[t*(W+1) + k] ..
      rptr[t*(W+1) + k + 1], x0(t) its first owned row.
    This replaces the TPU kernels' plane/stray partitions
    (pallas_boundary.py `partition_boundary_planes` / `_strays`): every
    lossy node goes through one list, whatever its geometry."""

    TB: int
    box: tuple
    ntiles: tuple
    ptr: np.ndarray     # (ntx*nty*ntz + 1,) int32
    node: np.ndarray    # (E,) int32
    off: np.ndarray     # (E,) int32
    ring: np.ndarray    # (E,) int32
    row: np.ndarray     # (E,) int32
    yz: np.ndarray      # (E,) int32
    rptr: np.ndarray    # (ntx*nty*ntz * (Bx + 2TB - 1),) int32

    @property
    def owned(self) -> np.ndarray:
        return self.ring == 0

    @property
    def max_per_tile(self) -> int:
        return int(np.diff(self.ptr).max()) if self.ptr.size > 1 else 0


def tile_bounds(t, B, N, grow, span=None):
    """[lo, hi) of tile t's owned box (size B along an axis of N points)
    grown by `grow`, clamped to the interior 1..N-2; works on arrays.

    span = (a0, a1, c0, c1): tiles cover [a0, a1) and grown boxes clamp to
    [c0, c1) instead (a slab's x axis: its owned and computable rows)."""
    a0, a1, c0, c1 = (1, N - 1, 1, N - 1) if span is None else span
    o0 = a0 + np.asarray(t) * B
    o1 = np.minimum(o0 + B, a1)
    return np.maximum(o0 - grow, c0), np.minimum(o1 + grow, c1)


def build_tile_lists(bnl_ixyz, grid: GridSpec, box, TB: int,
                     slab: SlabSpec | None = None) -> TileLists:
    """The CSR lists of `TileLists` for the nodes at flat indices bnl_ixyz
    (all interior), tiles of `box` points and TB steps per sweep.

    With `slab`, the indices are local to the slab's (S + 2G, Ny, Nz)
    layout, tiles cover its owned rows and the regions clamp to its
    computable rows (K6): nodes of the ghost bands within TB-1 of the owned
    rows enter the lists with ring > 0."""
    if not 2 <= TB <= 8:
        raise ValueError(f"TB={TB}: 2..8 steps per sweep")
    N = np.array(grid.shape if slab is None else slab.shape, np.int64)
    # per axis: tiles cover [a0, a1), grown boxes clamp to [c0, c1)
    spans = [(1, n - 1, 1, n - 1) for n in N]
    if slab is not None:
        spans[0] = (*slab.owned, *slab.computable)
    a0, a1, c0, c1 = (np.array(v, np.int64)[:, None] for v in zip(*spans))
    B = np.array(box, np.int64)
    nt = -(-(a1[:, 0] - a0[:, 0]) // B)
    bnl = np.asarray(bnl_ixyz, np.int64)
    c = np.stack([bnl // (N[1] * N[2]), (bnl // N[2]) % N[1], bnl % N[2]])
    if bnl.size and ((c < c0).any() or (c >= c1).any()):
        raise ValueError("lossy nodes must lie in the computable interior")
    r = TB - 1
    # tiles whose owned box lies within r of the node, per axis
    t_lo = np.maximum((c - a0 - r) // B[:, None], 0)
    t_hi = np.minimum((c - a0 + r) // B[:, None], (nt - 1)[:, None])
    span = (t_hi - t_lo + 1).max(1) if bnl.size else np.zeros(3, np.int64)
    tiles, nodes = [], []
    ids = np.arange(bnl.size, dtype=np.int64)
    for d in np.ndindex(*(max(int(s), 0) for s in span)):
        t = t_lo + np.array(d)[:, None]
        ok = (t <= t_hi).all(0)
        tiles.append(t[:, ok])
        nodes.append(ids[ok])
    t = np.concatenate(tiles, 1) if tiles else np.zeros((3, 0), np.int64)
    node = np.concatenate(nodes) if nodes else np.zeros(0, np.int64)
    cn = c[:, node]
    ring = np.zeros(node.size, np.int64)
    off = np.zeros(node.size, np.int64)
    o0s = []
    for a in range(3):
        o0, o1 = tile_bounds(t[a], B[a], N[a], 0, spans[a])
        o0s.append(o0)
        ring = np.maximum(ring, np.maximum(o0 - cn[a], cn[a] - (o1 - 1)))
        r0, r1 = tile_bounds(t[a], B[a], N[a], TB, spans[a])
        off = off * (r1 - r0) + (cn[a] - r0)
    assert (ring >= 0).all()
    yz = (cn[1] - o0s[1] + TB) * (B[2] + 2 * TB) + (cn[2] - o0s[2] + TB)
    # rows of a tile's list, counted from its first owned row - (TB-1)
    k = cn[0] - (o0s[0] - r)
    # a partial last tile may take a node r+1 past its rows: drop those
    keep = ring <= r
    t, node, off, ring, yz, k = (t[:, keep], node[keep], off[keep],
                                 ring[keep], yz[keep], k[keep])
    ntot = int(nt.prod())
    tid = (t[0] * nt[1] + t[1]) * nt[2] + t[2]
    order = np.lexsort((node, k, tid))
    ptr = np.zeros(ntot + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(tid, minlength=ntot))
    W = int(B[0]) + 2 * r
    key = (tid * W + k)[order]
    rptr = np.searchsorted(key, (np.arange(ntot)[:, None] * W
                                 + np.arange(W + 1)[None]).ravel())
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return TileLists(TB=TB, box=tuple(int(b) for b in B),
                     ntiles=tuple(int(n) for n in nt), ptr=i32(ptr),
                     node=i32(node[order]), off=i32(off[order]),
                     ring=i32(ring[order]), row=i32(cn[0][keep][order]),
                     yz=i32(yz[order]), rptr=i32(rptr))


def abc_q(ixyz, grid: GridSpec) -> np.ndarray:
    """Q, the number of axes on which a flat index lies on an ABC layer
    (0..3, uint8), by K1's rule: the folded grid's high-y layer is the fold
    ghost, not an ABC face."""
    ixyz = np.asarray(ixyz, np.int64)
    Nx, Ny, Nz = grid.shape
    ix, iy, iz = ixyz // (Ny * Nz), (ixyz // Nz) % Ny, ixyz % Nz
    y_ext = (iy == 1) if grid.folded else ((iy == 1) | (iy == Ny - 2))
    faces = [(ix == 1) | (ix == Nx - 2), y_ext, (iz == 1) | (iz == Nz - 2)]
    return np.sum(faces, axis=0, dtype=np.uint8)


class EngineData:
    """Static arrays of one scene: grid, adjacency, lossy nodes, sources.

    fp32_eps: the stencil's diagonal shift, sl2 = (1 + fp32_eps) lfac l2
    (jax_engine.py:89-97): None takes FP32_EPS in fp32 and 0 in fp64; an
    explicit value is used in both precisions.  `self.fp32_eps` holds the
    value in use."""

    def __init__(self, consts, vox, comms, mats, dtype=np.float32,
                 fp32_eps: float | None = None):
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.float32, np.float64):
            raise ValueError(f"dtype {self.dtype}: float32 or float64 only")
        self.fcc = consts.fcc_flag > 0
        if fp32_eps is None:
            fp32_eps = self.default_fp32_eps(self.dtype)
        self.fp32_eps = fp32_eps
        self.sc = SchemeCoeffs.make(consts.l, consts.l2, self.fcc,
                                    eps=fp32_eps)
        self.mc = MatCoeffs.from_mats(mats, consts.Ts)
        self.consts = consts
        self.grid = GridSpec(Nx=int(vox.Nx), Ny=int(vox.Ny), Nz=int(vox.Nz),
                             fcc_flag=int(consts.fcc_flag))
        self.NN = 12 if self.fcc else 6

        # bit-packed adjacency of the boundary nodes (`adj_grid` the grid)
        bn = np.asarray(vox.bn_ixyz, np.int64)
        adt = np.uint16 if self.NN == 12 else np.uint8
        packed = np.zeros(bn.shape[0], adt)
        for k in range(self.NN):
            packed |= vox.adj_bn[:, k].astype(adt) << adt(k)
        self.bn_ixyz, self.bn_adj = bn, packed

        # lossy boundary subset, per-material coefficient table
        lossy = vox.mat_bn > -1
        self.Nbl = int(lossy.sum())
        self.bnl_ixyz = bn[lossy]
        if np.unique(self.bnl_ixyz).size != self.Nbl:
            raise ValueError("lossy boundary nodes must be unique")
        saf = vox.saf_bn[lossy]
        ssaf = saf * (0.5 / np.sqrt(2.0)) if self.fcc else saf
        self.ssaf_bnl = ssaf.astype(self.dtype)
        self.mat_bnl = vox.mat_bn[lossy].astype(np.int32)
        # Q of the lossy nodes on an ABC layer (0 elsewhere), or None when
        # none is: K2, K3 and K6 then launch without their ABC modes
        q = abc_q(self.bnl_ixyz, self.grid)
        self.abcq_bnl = q if q.any() else None
        self.coef_table = self.mc.table(self.dtype)      # (Nmat+1, 4, MMb)
        self.beta = self.mc.beta.astype(self.dtype)      # (Nmat+1,)

        # energy accounting (engine/energy.py): the raw D | E | F branch
        # rows per material, indexed by mat_bnl like coef_table, and the
        # constants of the functionals (jax_engine.py:379-395)
        self.def_table = np.stack([self.mc.D, self.mc.E, self.mc.F],
                                  1).astype(self.dtype)  # (Nmat+1, 3, MMb)
        self.V_fac = 2.0 if self.fcc else 1.0
        self.e_h, self.e_c, self.e_Ts = consts.h, consts.c, consts.Ts

        # sources / receivers
        self.in_ixyz = np.asarray(comms.in_ixyz, np.int64)
        self.out_ixyz = np.asarray(comms.out_ixyz, np.int64)
        self.in_sigs = np.asarray(comms.in_sigs, np.float64)  # (Ns, Nt)
        self.Nt = int(comms.Nt)
        self.out_reorder = comms.out_reorder

        # input scaling to the middle of the floating-point exponent range
        # (fdtd_data.h:878-909); applied for fp32, identity for fp64
        if self.dtype == np.float32:
            max_in = np.abs(self.in_sigs).max()
            pow2 = int(round(0.5 * (np.finfo(np.float32).maxexp
                                    + np.finfo(np.float32).minexp)))
            self.infac = max_in / 2.0 ** pow2 if max_in > 0 else 1.0
        else:
            self.infac = 1.0

    @functools.cached_property
    def adj_grid(self) -> np.ndarray:
        """The bit-packed adjacency grid; air nodes carry the all-ones
        mask."""
        adt = self.bn_adj.dtype
        adj_grid = np.full(self.grid.shape, adt.type((1 << self.NN) - 1),
                           adt)
        adj_grid.reshape(-1)[self.bn_ixyz] = self.bn_adj
        return adj_grid

    @staticmethod
    def default_fp32_eps(dtype) -> float:
        """The shift that fp32_eps=None stands for in `dtype`."""
        return FP32_EPS if np.dtype(dtype) == np.float32 else 0.0

    @classmethod
    def from_folder(cls, folder, **kw) -> "EngineData":
        """From a sim folder's four inputs (`io.h5.SimFolder`, needs h5py);
        kw as the constructor's (jax_engine.py:263-266)."""
        sf = SimFolder(folder)
        return cls(sf.consts, sf.vox, sf.comms, sf.mats, **kw)
