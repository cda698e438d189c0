"""Host partition of a scene into x-slabs, numpy only.

The counterpart of the JAX engines' host partitions
(`pffdtd_tpu/parallel/sharded_engine.py:70-139` `_partition`,
`sharded_pallas.py:98-161` and :437-679).  The Nx - 2 interior rows split
into D slabs of S rows; slab k owns global rows 1 + k*S .. (k+1)*S and holds
them at local rows G .. G+S-1 between G ghost rows a side (`SlabSpec`,
local row i = global row i + xo).  G = 1 on the single-step route, G = TB on
the TB routes.  Per slab:

- the adjacency slab, the neighbours' rows in the ghost rows (the global
  halo and rows past it at a global edge hold the all-open mask, never
  read);
- the lossy nodes within G-1 rows of the owned rows (its owned ones and, on
  the TB routes, the ghost bands' ones that its sweeps recompute), as local
  flat indices with their ids into the global node arrays;
- the sources on those rows, with an owner mask: a sweep adds every one it
  recomputes, a single step only the owned ones;
- the receivers it owns: the owner of a receiver is the slab that owns the
  global row of its mirrored point, so each has exactly one.

`grafts` lists, for the TB routes, which slab owns each ghost-band node, so
that the engine can copy the owner's end-of-sweep branch states over the
recomputing slab's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pffdtd_tpu_torch.engine.data import GridSpec, SlabSpec, mirror_index


def x_slabs(grid: GridSpec, D: int, G: int) -> list[SlabSpec]:
    """The D slabs of `grid` with G ghost rows a side."""
    if D < 1 or (grid.Nx - 2) % D:
        raise ValueError(f"interior rows {grid.Nx - 2} do not split into "
                         f"{D} slabs: pad the grid (scene.pad_x_interior)")
    S = (grid.Nx - 2) // D
    return [SlabSpec(grid=grid, S=S, G=G, xo=1 + k * S - G)
            for k in range(D)]


def owner_of_row(gx, slabs: list[SlabSpec]) -> np.ndarray:
    """The slab that owns each global row (the halo rows go to the edge
    slabs)."""
    S = slabs[0].S
    return np.clip((np.asarray(gx, np.int64) - 1) // S, 0, len(slabs) - 1)


@dataclass
class SlabPart:
    """The host arrays of one slab (indices local to `slab.shape`)."""

    slab: SlabSpec
    adj: np.ndarray         # (S + 2G, Ny, Nz) packed adjacency
    nodes: np.ndarray       # ids into the global node arrays, ascending
    node_own: np.ndarray    # bool: node on an owned row
    bnl: np.ndarray         # local flat indices of `nodes`
    srcs: np.ndarray        # ids into the global source list, ascending
    src_own: np.ndarray     # bool: source on an owned row
    src_loc: np.ndarray     # local flat indices of `srcs`
    rcvs: np.ndarray        # ids of the owned receivers, ascending
    rcv_loc: np.ndarray     # local flat indices of their mirrored points


def _global_x(ixyz, grid: GridSpec) -> np.ndarray:
    return np.asarray(ixyz, np.int64) // (grid.Ny * grid.Nz)


def partition(data, slabs: list[SlabSpec]) -> list[SlabPart]:
    """Split an `EngineData`'s static arrays over `slabs`."""
    g = data.grid
    plane = g.Ny * g.Nz
    nx = _global_x(data.bnl_ixyz, g)
    sx = _global_x(data.in_ixyz, g)
    out_f = mirror_index(data.out_ixyz, g)
    r_owner = owner_of_row(_global_x(out_f, g), slabs)
    full = (1 << data.NN) - 1
    parts = []
    for k, sl in enumerate(slabs):
        lo, hi = sl.x0, sl.x0 + sl.S            # owned global rows
        adj = np.full(sl.shape, full, data.adj_grid.dtype)
        a, b = max(sl.xo, 0), min(sl.xo + sl.shape[0], g.Nx)
        adj[a - sl.xo:b - sl.xo] = data.adj_grid[a:b]
        reach = sl.G - 1

        def within(x):
            return (x >= lo - reach) & (x < hi + reach)

        nodes = np.flatnonzero(within(nx))
        srcs = np.flatnonzero(within(sx))
        rcvs = np.flatnonzero(r_owner == k)
        shift = sl.xo * plane
        parts.append(SlabPart(
            slab=sl, adj=adj, nodes=nodes,
            node_own=(nx[nodes] >= lo) & (nx[nodes] < hi),
            bnl=data.bnl_ixyz[nodes] - shift, srcs=srcs,
            src_own=(sx[srcs] >= lo) & (sx[srcs] < hi),
            src_loc=data.in_ixyz[srcs] - shift, rcvs=rcvs,
            rcv_loc=out_f[rcvs] - shift))
    return parts


@dataclass
class Graft:
    """Slab `dst`'s ghost-band nodes `dst_slots` (positions in its node
    arrays) are owned by slab `src`, at `src_slots` in its arrays."""

    dst: int
    src: int
    dst_slots: np.ndarray
    src_slots: np.ndarray


def grafts(parts: list[SlabPart]) -> list[Graft]:
    """The owner of every ghost-band node, one `Graft` per (slab, owner)."""
    slabs = [p.slab for p in parts]
    g = slabs[0].grid
    out = []
    for k, p in enumerate(parts):
        ghost = np.flatnonzero(~p.node_own)
        gx = (p.bnl[ghost] // (g.Ny * g.Nz)) + p.slab.xo
        owner = owner_of_row(gx, slabs)
        for j in np.unique(owner):
            mine = ghost[owner == j]
            slots = np.searchsorted(parts[j].nodes, p.nodes[mine])
            assert (parts[j].nodes[slots] == p.nodes[mine]).all()
            assert parts[j].node_own[slots].all()
            out.append(Graft(dst=k, src=int(j), dst_slots=mine,
                             src_slots=slots))
    return out


def split_rows(u, slabs: list[SlabSpec]) -> list[np.ndarray]:
    """A global (Nx, ...) array cut into the slabs' local arrays: every
    local row that is a global row holds it, rows past the grid are 0."""
    u = np.asarray(u)
    Nx = slabs[0].grid.Nx
    out = []
    for sl in slabs:
        a = np.zeros((sl.shape[0],) + u.shape[1:], u.dtype)
        lo, hi = max(sl.xo, 0), min(sl.xo + sl.shape[0], Nx)
        a[lo - sl.xo:hi - sl.xo] = u[lo:hi]
        out.append(a)
    return out
