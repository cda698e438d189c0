"""State and static arrays carried across from the JAX engine's layouts.

This system has no weights: its parameters are the static per-scene arrays
and its state is (u0, u1, vh, gh).  The JAX engine pads the grid (z to 128
lanes, y to 8 sublanes, jax_engine.py:101-111), keeps branch states (Nbl, MMb)
on its XLA path, and packs them per tile or subwindow, (n, MMb, T), for its
Pallas boundary kernels (`node_slot` gives each node's position,
pallas_boundary.py:158 for tiles, :707 for dense subwindows).  The port keeps
the true grid and (MMb, Nbl) states.  These functions map one to the other,
so tests can start both implementations from the same random state.

The x-slab engines: `slabs_to_global` assembles the port's per-slab arrays
(`parallel.partition`) into the global grid, and `slabs_from_jax` /
`slabs_to_jax` map them from and to the JAX sharded layouts, (D*Nxp_loc,
Nyp, Nzp) with each shard's rows at [k*Nxp_loc, (k+1)*Nxp_loc): its S owned
rows after `ghosts` ghost rows, then the other side's ghosts and pad rows
(`ShardedPallasEngine`: ghosts = 1, local row 1 = global 1 + k*S;
`ShardedPairEngine`: ghosts = 2, x0 = k*S - 1).
"""

from __future__ import annotations

import numpy as np
import torch

from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.parallel.partition import split_rows


def _unpad_indices(ixyz, jax_grid):
    """Flat indices of the JAX padded layout -> the true (Nx, Ny, Nz)."""
    g = jax_grid
    ixyz = np.asarray(ixyz, np.int64)
    ix, iy, iz = ixyz // (g.Nyp * g.Nzp), (ixyz // g.Nzp) % g.Nyp, \
        ixyz % g.Nzp
    return (ix * g.Ny + iy) * g.Nz + iz


def crop(u, jax_grid) -> np.ndarray:
    """A JAX padded grid cropped to its true extents."""
    g = jax_grid
    return np.ascontiguousarray(np.asarray(u)[:g.Nx, :g.Ny, :g.Nz])


def data_from_jax(jax_data) -> dict:
    """The static arrays of a JAX `EngineData` in the port's layout, keyed by
    the port's `EngineData` attribute names."""
    g = jax_data.grid
    return {
        "adj_grid": crop(jax_data.adj_grid, g),
        "bnl_ixyz": _unpad_indices(jax_data.bnl_ixyz, g),
        "ssaf_bnl": np.asarray(jax_data.ssaf_bnl),
        "mat_bnl": np.asarray(jax_data.mat_bnl, np.int32),
        "in_ixyz": _unpad_indices(jax_data.in_ixyz, g),
        "out_ixyz": _unpad_indices(jax_data.out_ixyz, g),
        "infac": jax_data.infac,
    }


def state_from_jax_xla(carry, jax_data, data, device="cpu"):
    """A JAX XLA-path carry (u0, u1, vh (Nbl, MMb), gh) -> the port's state
    [u0, u1, u2, vh (MMb, Nbl), gh] as tensors of `data.dtype`."""
    u0, u1, vh, gh = (np.asarray(x) for x in carry[:4])
    g = jax_data.grid
    dt = data.dtype

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return [t(crop(u0, g)), t(crop(u1, g)), t(np.zeros(data.grid.shape)),
            t(vh.T), t(gh.T)]


def checkpoint_from_jax(jax_ckpt, jax_data, eng, path):
    """A `JaxEngine` XLA-route checkpoint (`_save_checkpoint`: n, carry0..3
    = u0, u1, vh (Nbl, MMb), gh, ys00 = the receiver rows so far) -> the
    port's checkpoint for `eng` (a TorchEngine with energy off), written to
    `path` through `eng.save_checkpoint`."""
    with np.load(jax_ckpt) as z:
        n = int(z["n"])
        state = state_from_jax_xla([z[f"carry{i}"] for i in range(4)],
                                   jax_data, eng.data, eng.device)
        out = torch.from_numpy(z["ys00"].astype(eng.data.dtype))
    eng.save_checkpoint(path, n, state, out.to(eng.device))


def state_from_tiles(x_tiles, node_slot) -> np.ndarray:
    """Packed Pallas states (n, MMb, T) -> per-node (MMb, Nbl)."""
    x = np.asarray(x_tiles)
    return np.moveaxis(x, 1, 0).reshape(MMb, -1)[:, np.asarray(node_slot)]


def state_to_tiles(x, node_slot, n_tiles: int, T: int) -> np.ndarray:
    """Per-node (MMb, Nbl) states -> packed (n_tiles, MMb, T), zeros in the
    padding slots."""
    flat = np.zeros((MMb, n_tiles * T), np.asarray(x).dtype)
    flat[:, np.asarray(node_slot)] = x
    return np.ascontiguousarray(np.moveaxis(flat.reshape(MMb, n_tiles, T),
                                            1, 0))


# ------------------------------------------ pair/TB branch-state families
# The JAX pair and TB kernels keep each lossy node's branch states in the
# layout of the axis-plane family that took it, or packed in stray chunks
# (pallas_boundary.py:906-931, 1023-1069, 1223-1268), with the branch dim
# padded from MMb to MZ:
#   z-planes (Nxp, P, MZ, Nyw)  [x, p, m, y]
#   y-planes (Nxp, P, MZ, W)    [x, p, m, z - z0]
#   x-planes (P, Nyp, MZ, Nzp)  [p, y, m, z]
#   strays   (chunks, MZ, TS)   [chunk, m, lane], slot = chunk*TS + lane
# A node belongs to the plane whose ssaf sheet is non-zero at it (every
# lossy node has a cut leg, so ssaf > 0).  Node ids index the lossy-node
# arrays, which the port and the JAX engine order alike.
def _family_index(planes, strays, data):
    """{family: (node ids, index tuple into the family's state array with
    the branch axis left as a slice)}."""
    g = data.grid
    bnl = np.asarray(data.bnl_ixyz, np.int64)
    ix, iy, iz = bnl // (g.Ny * g.Nz), (bnl // g.Nz) % g.Ny, bnl % g.Nz
    seen = np.zeros(bnl.size, np.int64)
    out = {}
    fams = {"z": getattr(planes, "z", None), "y": getattr(planes, "y", None),
            "x": getattr(planes, "x", None)}
    for fam, pp in fams.items():
        if pp is None:
            continue
        ssaf = np.asarray(pp.ssaf)
        ids, idx = [], []
        for p, c in enumerate(np.asarray(getattr(pp, fam + "p"))):
            if fam == "z":
                cand = np.flatnonzero(iz == c)
                hit = ssaf[ix[cand], p, iy[cand]] != 0
                n = cand[hit]
                ii = (ix[n], np.full(n.size, p), iy[n])
            elif fam == "y":
                z0, W = int(getattr(pp, "z0", 0)), ssaf.shape[2]
                cand = np.flatnonzero((iy == c) & (iz >= z0) & (iz < z0 + W))
                hit = ssaf[ix[cand], p, iz[cand] - z0] != 0
                n = cand[hit]
                ii = (ix[n], np.full(n.size, p), iz[n] - z0)
            else:
                cand = np.flatnonzero(ix == c)
                hit = ssaf[p, iy[cand], iz[cand]] != 0
                n = cand[hit]
                ii = (np.full(n.size, p), iy[n], iz[n])
            ids.append(n)
            idx.append(np.stack(ii))
        if ids:
            n = np.concatenate(ids)
            seen[n] += 1
            out[fam] = (n, np.concatenate(idx, 1))
    if strays is not None:
        n = np.asarray(planes.stray_idx, np.int64)
        slot = np.asarray(strays.node_slot, np.int64)
        seen[n] += 1
        out["s"] = (n, np.stack([slot // strays.TS, slot % strays.TS]))
    if not (seen == 1).all():
        raise ValueError("the plane/stray partition does not cover every "
                         "lossy node exactly once")
    return out


def _gather(arr, fam, idx):
    """(n, MMb) states of one family at `idx`, the MZ padding cropped."""
    a = np.asarray(arr)
    if fam == "s":
        return a[idx[0], :MMb, idx[1]]
    return a[idx[0], idx[1], :MMb, idx[2]]


def state_from_planes(vh, gh, planes, strays, data):
    """JAX pair/TB branch states {"z", "y", "x", "s": array} -> the port's
    (vh, gh), each (MMb, Nbl) numpy of the state dtype.

    planes: the JAX `BoundaryPlanes` (EngineData.planes); strays: its
    `BoundaryStrays` or None; data: the port's `EngineData`."""
    index = _family_index(planes, strays, data)
    res = []
    for st in (vh, gh):
        dt = np.asarray(next(iter(st.values()))).dtype if st else data.dtype
        x = np.zeros((MMb, data.Nbl), dt)
        for fam, (n, idx) in index.items():
            x[:, n] = _gather(st[fam], fam, idx).T
        res.append(x)
    return tuple(res)


def state_to_planes(vh, gh, planes, strays, data):
    """The inverse of `state_from_planes`: per-node (MMb, Nbl) states -> the
    JAX family dicts, zeros in every padding slot."""
    index = _family_index(planes, strays, data)
    shapes = {}
    for fam in ("z", "y", "x"):
        pp = getattr(planes, fam, None)
        if pp is not None:
            shapes[fam] = pp.state_shape(np.asarray(pp.ssaf).shape[0])
    if strays is not None:
        shapes["s"] = strays.state_shape()
    res = []
    for x in (vh, gh):
        x = np.asarray(x)
        d = {}
        for fam, shape in shapes.items():
            a = np.zeros(shape, x.dtype)
            if fam in index:
                n, idx = index[fam]
                if fam == "s":
                    a[idx[0], :MMb, idx[1]] = x[:, n].T
                else:
                    a[idx[0], idx[1], :MMb, idx[2]] = x[:, n].T
            d[fam] = a
        res.append(d)
    return tuple(res)


# ------------------------------------------------------------ x-slabs
def slabs_to_global(slabs, specs) -> np.ndarray:
    """Per-slab arrays or tensors (rows first, `SlabSpec` layouts) -> the
    global array: each row from the slab that owns it, the halo rows 0 and
    Nx-1 from the edge slabs."""
    arrs = [np.asarray(a.cpu() if torch.is_tensor(a) else a) for a in slabs]
    Nx = specs[0].grid.Nx
    out = np.zeros((Nx,) + arrs[0].shape[1:], arrs[0].dtype)
    for a, sl in zip(arrs, specs):
        lo = 0 if sl.x0 == 1 else sl.x0
        hi = Nx if sl.x0 + sl.S == Nx - 1 else sl.x0 + sl.S
        out[lo:hi] = a[lo - sl.xo:hi - sl.xo]
    return out


def _jax_rows(D, S, ghosts):
    """Per JAX shard k: (global row of its local row 0, rows it holds)."""
    return [(1 + k * S - ghosts, S + 2 * ghosts) for k in range(D)]


def slabs_from_jax(u, jax_grid, specs, ghosts: int) -> list[np.ndarray]:
    """A JAX sharded field (D*Nxp_loc, Nyp, Nzp) -> the port's slabs."""
    u = np.asarray(u)
    g, D, S = jax_grid, len(specs), specs[0].S
    nxp = u.shape[0] // D
    glob = np.zeros((g.Nx, g.Ny, g.Nz), u.dtype)
    for k, (x0, _) in enumerate(_jax_rows(D, S, ghosts)):
        lo = 0 if k == 0 else 1 + k * S
        hi = g.Nx if k == D - 1 else 1 + (k + 1) * S
        glob[lo:hi] = u[k * nxp + lo - x0:k * nxp + hi - x0, :g.Ny, :g.Nz]
    return split_rows(glob, specs)


def slabs_to_jax(slabs, specs, jax_grid, nxp_loc: int,
                 ghosts: int) -> np.ndarray:
    """The port's slabs -> a JAX sharded field (D*Nxp_loc, Nyp, Nzp): each
    shard's owned and ghost rows as the exchange leaves them (the global
    rows), zeros in the pad rows and the y/z padding."""
    glob = slabs_to_global(slabs, specs)
    g, D, S = jax_grid, len(specs), specs[0].S
    out = np.zeros((D, nxp_loc, g.Nyp, g.Nzp), glob.dtype)
    for k, (x0, n) in enumerate(_jax_rows(D, S, ghosts)):
        lo, hi = max(x0, 0), min(x0 + n, g.Nx)
        out[k, lo - x0:hi - x0, :g.Ny, :g.Nz] = glob[lo:hi]
    return out.reshape(D * nxp_loc, g.Nyp, g.Nzp)
