"""K1, the fused stencil step, K5, its shard mode, and their plain versions.

`stencil_step` launches the CUDA kernel of `csrc/stencil.cu` for tensors on
the card, on the tiles and chunks `plan_k1` gives its shape and dtype, and
runs `stencil_step_plain` for tensors on the CPU.  Both compute, on the
interior (1..N-2 on every axis) of `out`, one step of
`pffdtd_tpu/engine/jax_engine.py` `_step_core` with `rigid="dense"` minus the
lossy ODE and the sources (K2 and the engine do those):

    u1f  = u1 with mirror halo flips (z, then y, then x)
    unew = (2 - sl2*K) * u1f - u0 + a2 * sum_k bit_k * u1f(x + v_k)
    unew = (unew + l*Q*u0) / (1 + l*Q)        on the ABC layers (Q > 0)

The halo layers of `out` are left as they were: every step mirrors them
afresh from interior data, so they are never read.

`stencil_step_shard` (K5, the same kernel on a slab's rows) and
`stencil_step_shard_plain` compute the same step on the owned rows of one
x-slab (`engine.data.SlabSpec`), the counterpart of
`pffdtd_tpu/engine/pallas_stencil.py` `build_fused_stencil_sharded`.

`stencil_energy_step` (K1e, the 1-D kernel of the same source) runs the step
and, in the same launch, K7's grid half (`kernels.energy`): L u^n over L
u^{n-1} in place and H[n]'s grid sums into K7's scratch.  Its plain
version, `stencil_energy_step_plain`, is `energy_grid_pass_plain` followed
by `stencil_step_plain`.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch

from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.utils import as_dtype
from pffdtd_tpu_torch.voxelizer.vox import CART_VECTORS, FCC_VECTORS


# K1's march (csrc/stencil.cu): the constants the planner shares with it
MARCH_THREADS = 256       # kMarchThreads
MARCH_RING = 5            # kRing: planes of u^n a block holds
MARCH_MAX_ROWS = 4        # kMaxRows: tile rows a thread computes
MARCH_WIDTHS = (32, 64)   # the tile's z extents the kernel is built for
MARCH_CHUNK = 12          # rows a block marches over, where there are
GRID_YZ_LIMIT = 65535     # blocks along a launch's y and z


@dataclass(frozen=True)
class K1Geometry:
    """One K1 (or K5) launch: tiles of By x Bz interior points of (y, z),
    chunks of Cx rows, `grid` = (z tiles, y tiles, chunks) blocks of
    MARCH_THREADS threads, `smem` bytes of shared memory a block."""

    By: int
    Bz: int
    Cx: int
    grid: tuple
    smem: int

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


@functools.lru_cache(maxsize=64)
def plan_k1(rows: int, Ny: int, Nz: int, itemsize: int) -> K1Geometry:
    """K1's tiles and chunks for `rows` interior rows of an (Ny, Nz) plane
    at `itemsize` bytes a value, from those alone.

    Every thread computes MARCH_MAX_ROWS rows of its column (fewer where
    the plane has fewer rows), in fp32 and fp64 alike, on tiles 64 points
    wide in z (32 where the interior's z fits in 32), and every block
    marches MARCH_CHUNK rows (the extent evened out over the chunks).  Of
    the tiles and chunks timed on the H100 at the 1628 x 635 x 1048 FCC
    grid, the 1.049 Gvox Cartesian box and the 125 Mvox headline, in fp32
    and fp64 (PERF.md, PR 20), these are within 3% of the fastest (5% on
    the headline in fp64, where chunks of 6 rows led): two rows a thread
    took 12-21% longer than four, 32 x 32 tiles (rows of 128 B in fp32)
    8-24% longer than 16 x 64, tiles 128 or 256 wide up to 17% longer in
    fp64 and at most 3% shorter; chunks of 6 to 20 rows lie within 5% of
    each other, chunks of 32 to 63 rows took 3-16% longer.
    On the cell's 1046 interior z the last of 17 tiles idles 42 of 1,088
    lanes (3.9%, where the 1-D design idled 9.2%)."""
    if rows < 1 or min(Ny, Nz) < 5 or itemsize not in (4, 8):
        raise ValueError(f"rows={rows}, Ny={Ny}, Nz={Nz}, itemsize="
                         f"{itemsize}: no K1 launch")
    ny, nz = Ny - 2, Nz - 2
    Bz = MARCH_WIDTHS[0] if nz <= MARCH_WIDTHS[0] else MARCH_WIDTHS[1]
    teams = MARCH_THREADS // Bz
    By = teams * min(MARCH_MAX_ROWS, -(-ny // teams))
    Cx = -(-rows // -(-rows // MARCH_CHUNK))
    grid = (-(-nz // Bz), -(-ny // By), -(-rows // Cx))
    if max(grid[1:]) > GRID_YZ_LIMIT:
        raise ValueError(f"rows={rows}, Ny={Ny}: {grid} blocks exceed the "
                         "launch's limits")
    return K1Geometry(By, Bz, Cx, grid,
                      MARCH_RING * (By + 2) * (Bz + 2) * itemsize)


def abc_regions(grid):
    """Disjoint (slices, Q) regions of the ABC layers: 6 face interiors,
    12 edges, 8 corners (jax_engine.py `_abc_regions`).  On a folded grid
    the high-y layer is the fold ghost, not an ABC face."""
    Nx, Ny, Nz = grid.shape
    ext = {0: [1, Nx - 2], 1: [1] if grid.folded else [1, Ny - 2],
           2: [1, Nz - 2]}
    mid = {0: slice(2, Nx - 2),
           1: slice(2, Ny - 1) if grid.folded else slice(2, Ny - 2),
           2: slice(2, Nz - 2)}
    regions = []
    for r in (1, 2, 3):
        for dims in itertools.combinations((0, 1, 2), r):
            choices = [ext[d] if d in dims else [mid[d]] for d in (0, 1, 2)]
            for combo in itertools.product(*choices):
                regions.append((tuple(combo), r))
    return regions


def _check(u0, u1, adj, out, grid, shape=None):
    """Checks a step's tensors; `shape` is the slab's (default the grid's).
    Returns the leg count."""
    shape = tuple(grid.shape if shape is None else shape)
    for name, t in (("u0", u0), ("u1", u1), ("out", out)):
        if t.dtype not in (torch.float32, torch.float64) \
                or t.dtype != u1.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want u1's "
                            f"float32/float64 ({u1.dtype})")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {shape} grid")
    nn = 12 if grid.fcc_flag else 6
    adt = torch.uint16 if nn == 12 else torch.uint8
    if adj.dtype != adt or tuple(adj.shape) != shape \
            or not adj.is_contiguous():
        raise ValueError(f"adj: want a contiguous {shape} {adt} grid")
    if len({t.device for t in (u0, u1, adj, out)}) != 1:
        raise ValueError("u0, u1, adj and out must share one device")
    if min(grid.shape) < 5:
        raise ValueError(f"grid {grid.shape}: every extent must be >= 5")
    if shape[1] * shape[2] + shape[2] + 1 > 2**31 - 1:
        raise ValueError(f"grid {shape}: a (y, z) plane must hold < 2**31 "
                         "points (K1 offsets are 32-bit)")
    if len({u0.data_ptr(), u1.data_ptr(), out.data_ptr()}) != 3:
        raise ValueError("out must be a third buffer, distinct from u0, u1")
    return nn


def _launch_args(u0, u1, adj, out, nn):
    return (0 if u1.dtype == torch.float32 else 1, nn, u0.data_ptr(),
            u1.data_ptr(), adj.data_ptr(), out.data_ptr())


def stencil_step(u0, u1, adj, out, grid, sc):
    """One K1 step into the interior of `out`; returns `out`.

    u0 = u^{n-1}, u1 = u^n, out = scratch for u^{n+1} (all (Nx, Ny, Nz));
    adj: packed adjacency grid; grid: GridSpec; sc: SchemeCoeffs."""
    nn = _check(u0, u1, adj, out, grid)
    if u1.device.type == "cpu":
        return stencil_step_plain(u0, u1, adj, out, grid, sc)
    if u1.device.type != "cuda":
        raise ValueError(f"device {u1.device}: cpu or cuda only")
    lib = _build.library()
    Nx, Ny, Nz = grid.shape
    geo = plan_k1(Nx - 2, Ny, Nz, u1.element_size())
    with _build.on_device(u1.device):
        rc = lib.pf_stencil_step(
            *_launch_args(u0, u1, adj, out, nn), Nx, Ny, Nz,
            int(grid.folded), geo.By, geo.Bz, geo.Cx, sc.a2, sc.sl2,
            sc.l * 1, sc.l * 2, sc.l * 3,
            torch.cuda.current_stream(u1.device).cuda_stream)
    _build.check(rc, "stencil_step")
    stencil_step.launches += 1
    stencil_step.geometry = geo
    return out


stencil_step.launches = 0
stencil_step.geometry = None   # the K1Geometry of the last launch


def stencil_energy_step(u0, u1, adj, out, Lu, part, grid, sc, es):
    """One K1e call: K1's step into `out` and K7's grid half in the same
    launch (L u^n over `Lu`, H[n]'s grid sums into `part`, then K7's
    middle stage); returns `out`.

    u0 = u^{n-1}, u1 = u^n, out = scratch for u^{n+1}, Lu = L u^{n-1}
    (zero halos); part: (kernels.energy.scratch_size(grid, Nbl),) float64;
    es: the engine.energy.EnergyScene of this grid, holding `adj`."""
    # kernels.energy imports engine.energy, which imports this module
    from pffdtd_tpu_torch.kernels.energy import _check_grid, _distinct
    dev, _ = _check_grid(es, u0, u1, Lu, part)
    nn = _check(u0, u1, adj, out, grid)
    if adj.data_ptr() != es.adj.data_ptr() or es.grid != grid:
        raise ValueError("es: the energy scene must be of this grid and "
                         "hold this adjacency")
    _distinct((("Lu", Lu), ("out", out)))
    if dev.type == "cpu":
        return stencil_energy_step_plain(u0, u1, adj, out, Lu, part, grid,
                                         sc, es)
    lib = _build.library()
    Nx, Ny, Nz = grid.shape
    with _build.on_device(dev):
        rc = lib.pf_stencil_energy_step(
            *_launch_args(u0, u1, adj, out, nn), Lu.data_ptr(),
            part.data_ptr(), part.numel(), Nx, Ny, Nz, int(grid.folded),
            sc.a2, sc.sl2, sc.l * 1, sc.l * 2, sc.l * 3, es.lfac, es.inv_l2,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stencil_energy_step")
    stencil_energy_step.launches += 1
    return out


stencil_energy_step.launches = 0


def stencil_energy_step_plain(u0, u1, adj, out, Lu, part, grid, sc, es):
    """PyTorch version of K1e (same signature and result): K7's plain grid
    half (H[n]'s grid terms, in the state's dtype, to part[0]), then K1's
    plain step."""
    from pffdtd_tpu_torch.kernels.energy import energy_grid_pass_plain
    energy_grid_pass_plain(es, u0, u1, Lu, part)
    return stencil_step_plain(u0, u1, adj, out, grid, sc)


def stencil_step_plain(u0, u1, adj, out, grid, sc):
    """Shifted-slice PyTorch version of K1 (same signature and result)."""
    return stencil_rows_plain(u0, u1, adj, out, grid, sc, 0, 1,
                              grid.Nx - 1)


def _check_slab(slab):
    g = slab.grid
    if not (slab.G >= 1 and slab.S >= 1 and slab.x0 >= 1
            and slab.x0 + slab.S <= g.Nx - 1):
        raise ValueError(f"slab S={slab.S}, G={slab.G}, xo={slab.xo}: the "
                         f"owned rows must be global interior rows of "
                         f"Nx={g.Nx}")


def stencil_step_shard(u0, u1, adj, out, slab, sc):
    """One K5 step: K1 on the owned rows of an x-slab; returns `out`.

    u0, u1, adj, out: (S + 2G, Ny, Nz) slab tensors (`slab.shape`) whose
    ghost rows hold the neighbours' rows; slab: engine.data.SlabSpec.  The
    x mirror and the ABC's x faces act only where the slab owns global row
    1 or Nx-2; rows outside the owned ones are not written."""
    _check_slab(slab)
    nn = _check(u0, u1, adj, out, slab.grid, slab.shape)
    if u1.device.type == "cpu":
        return stencil_step_shard_plain(u0, u1, adj, out, slab, sc)
    if u1.device.type != "cuda":
        raise ValueError(f"device {u1.device}: cpu or cuda only")
    lib = _build.library()
    g = slab.grid
    geo = plan_k1(slab.S, g.Ny, g.Nz, u1.element_size())
    with _build.on_device(u1.device):
        rc = lib.pf_stencil_step_shard(
            *_launch_args(u0, u1, adj, out, nn), g.Nx, g.Ny, g.Nz,
            int(g.folded), slab.G, slab.S, slab.xo, geo.By, geo.Bz, geo.Cx,
            sc.a2, sc.sl2, sc.l * 1, sc.l * 2, sc.l * 3,
            torch.cuda.current_stream(u1.device).cuda_stream)
    _build.check(rc, "stencil_step_shard")
    stencil_step_shard.launches += 1
    stencil_step_shard.geometry = geo
    return out


stencil_step_shard.launches = 0
stencil_step_shard.geometry = None   # the K1Geometry of the last launch


def stencil_step_shard_plain(u0, u1, adj, out, slab, sc):
    """PyTorch version of K5 (same signature and result)."""
    _check_slab(slab)
    lo, hi = slab.owned
    return stencil_rows_plain(u0, u1, adj, out, slab.grid, sc, slab.xo, lo,
                              hi)


def _local_x(ix, xo, r0, r1):
    """A region's x part (a global row or slice) on local rows [r0, r1) of
    a slab whose local row i is global row i + xo; None if it misses."""
    if isinstance(ix, slice):
        lo, hi = max(ix.start - xo, r0), min(ix.stop - xo, r1)
        return slice(lo, hi) if lo < hi else None
    return ix - xo if r0 <= ix - xo < r1 else None


def mirrored(u, grid, xo=0):
    """A copy of `u` with the mirror halo flips (z, then y, then x) of
    `_flip_halos` (jax_engine.py:270-283), for a slab whose local row i is
    global row i + xo (the whole grid: xo = 0)."""
    Nx, Ny, Nz = grid.shape
    n = u.shape[0]
    uf = u.clone()
    uf[:, :, 0] = uf[:, :, 2]
    uf[:, :, Nz - 1] = uf[:, :, Nz - 3]
    uf[:, 0, :] = uf[:, 2, :]
    uf[:, Ny - 1, :] = uf[:, Ny - 2 if grid.folded else Ny - 3, :]
    if 0 <= -xo < n:                     # global row 0 mirrors row 2
        uf[-xo] = uf[2 - xo]
    if 0 <= Nx - 1 - xo < n:             # global row Nx-1 mirrors Nx-3
        uf[Nx - 1 - xo] = uf[Nx - 3 - xo]
    return uf


def masked_legs(uf, adj, grid, r0, r1):
    """(acc, K) on the local rows [r0, r1) and the interior y, z: acc =
    sum_k bit_k * uf(x + v_k) and K = sum_k bit_k, in uf's dtype, from the
    packed adjacency bits; uf holds the mirrored field (`mirrored`)."""
    Ny, Nz = grid.Ny, grid.Nz
    # torch has no >> for uint16 on the CPU: unpack from an int32 copy
    a = adj[r0:r1, 1:Ny - 1, 1:Nz - 1].to(torch.int32)
    VV = (FCC_VECTORS if grid.fcc_flag else CART_VECTORS).astype(np.int64)
    acc = K = None
    for k, (dx, dy, dz) in enumerate(VV):
        bit = ((a >> k) & 1).to(uf.dtype)
        t = bit * uf[r0 + dx:r1 + dx, 1 + dy:Ny - 1 + dy, 1 + dz:Nz - 1 + dz]
        acc = t if acc is None else acc + t
        K = bit if K is None else K + bit
    return acc, K


def stencil_rows_plain(u0, u1, adj, out, grid, sc, xo, r0, r1):
    """K1's step on the local rows [r0, r1) of a slab whose local row i is
    global row i + xo (grid: the global GridSpec; rows r0-1 and r1 must
    exist).  The whole grid is the slab xo = 0, rows [1, Nx-1).

    Each point's operations are the same, in the same order, whatever the
    slab, so slabs and the whole grid agree bit for bit."""
    Nx, Ny, Nz = grid.shape
    dt = u1.dtype
    u1f = mirrored(u1, grid, xo)

    rows = (slice(r0, r1), slice(1, Ny - 1), slice(1, Nz - 1))
    acc, K = masked_legs(u1f, adj, grid, r0, r1)
    sl2 = as_dtype(sc.sl2, dt)
    a2 = as_dtype(sc.a2, dt)
    out[rows] = (2.0 - sl2 * K) * u1f[rows] - u0[rows] + a2 * acc
    del acc, K, u1f
    for (ix, iy, iz), Q in abc_regions(grid):
        lx = _local_x(ix, xo, r0, r1)
        if lx is None:
            continue
        sl = (lx, iy, iz)
        lQ = as_dtype(sc.l * Q, dt)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds differently from K1
        den = torch.full((), 1.0 + lQ, dtype=dt, device=out.device)
        out[sl] = (out[sl] + lQ * u0[sl]) / den
    return out
