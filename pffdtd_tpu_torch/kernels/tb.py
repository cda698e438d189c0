"""K3, the temporally-blocked sweep, and its plain PyTorch version.

`tb_sweep` launches the CUDA kernel of `csrc/tb.cu` for tensors on the card
and runs `tb_sweep_plain` for tensors on the CPU.  Both advance
(u0, u1) = (u^{n-1}, u^n) by TB leapfrog steps into (out0, out1) =
(u^{n+TB-1}, u^{n+TB}) and the branch states (vh_in, gh_in) into
(vh_out, gh_out).  Each step is the engine's single step: K1 (virtual
flips, masked stencil, leapfrog, ABC), K2 (the lossy ODE), then the
sources.  The receiver samples of the intermediate fields u^{n+1} ..
u^{n+TB-2} go into `taps`, a (TB-2, Nr) view (None for TB = 2).

Open rooms: where lossy nodes lie on an ABC layer, the scene's `abcq`
((Nbl,) uint8, Q a node, `EngineData.abcq_bnl`) selects the kernel's ABC
mode, the sweep's counterpart of K2's: at a node with Q > 0 the ODE undoes
the stencil's ABC, runs on that value and applies the ABC to what it
writes, so each step is the reference's stencil, ODE, ABC
(jax_engine.py:664-685), and the plain versions pass `abcq` to
`boundary_update_plain`.  A scene without such a node has `abcq` None and
launches the sweep without that code.

It replaces pffdtd_tpu/engine/pallas_pair.py `build_fused_pair` (TB = 2)
and pallas_tb.py `build_fused_tb` (TB = 2..8), single-device mode.

`tb_sweep_shard` (K6, the same source in shard mode, `csrc/tb_shard.cu`)
and `tb_sweep_shard_plain` run the sweep on one x-slab of the sharded
engine (a `TBScene` made by `TBScene.make_slab`), the counterpart of
`build_fused_pair(shard=)` generalised to TB = 2..8: the owned rows end the
sweep at step n+TB, the ghost rows feed the halo ring, and only the owned
nodes' branch states are written.

Race rule: no output aliases an input.  A tile of the kernel reads its
neighbours' start-of-sweep fields and branch states while their owners
write end-of-sweep values, so the caller rotates four field buffers and
double-buffers the branch states; the wrapper refuses aliased buffers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pffdtd_tpu_torch.engine.data import (GridSpec, SlabSpec, TileLists,
                                          build_tile_lists, mirror_index)
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.kernels.boundary import boundary_update_plain
from pffdtd_tpu_torch.kernels.stencil import (stencil_rows_plain,
                                              stencil_step_plain)

# mirrors of csrc/tb.cu's constants
SKEW = 2               # kSkew: level s works at plane X - SKEW * s
MAX_ROWS = 8           # kMaxRows: tile rows a thread holds
MAX_THREADS = 512      # kMaxThreads
THREADS = 256          # the block size the planner starts from
CHUNK = 64             # most rows a block marches over (kMaxChunk = 128)
MIN_CHUNK = 16         # fewest, where the extent has them
# row widths Bz + 2TB the kernel is built for, per itemsize
ROW_WIDTHS = {4: (32, 64), 8: (32,)}
SMEM_LIMIT = 232448    # shared memory one block may use on the H100
SMEM_SM = 233472       # shared memory of one SM; each block also takes 1 KiB
SMS = 132              # streaming multiprocessors of the H100 SXM
# the planner's costs, in lane-point-steps (fitted to chip_smoke.py's
# headline scene on the H100): a thread's own work at each march position
# and level (bookkeeping, barriers), and the ramp of a chunk per step
THREAD_COST = 3.0
RAMP_ROWS = 1.5


def ring_slots(s: int, TB: int) -> int:
    """Plane slots of level s (-1 .. TB) in shared memory (csrc/tb.cu's
    ring-slot rule)."""
    if s == -1:
        return 3
    return 2 * SKEW + 1 if s < TB else 2


def smem_bytes(By: int, Bz: int, TB: int, itemsize: int,
               adj_itemsize: int) -> int:
    """Shared memory of one K3 block: the plane rings of every level and of
    adj over the y-z tile grown by TB."""
    fields = sum(ring_slots(s, TB) for s in range(-1, TB + 1))
    adjs = SKEW * TB + 1
    return (By + 2 * TB) * (Bz + 2 * TB) * (fields * itemsize
                                            + adjs * adj_itemsize)


def tile_threads(box, TB: int) -> int:
    """Threads of a K3 block for the owned box (Cx, By, Bz): teams of
    Rz = Bz + 2TB threads, each team a set of the tile's rows; 0 when no
    block of at most MAX_THREADS holds the tile."""
    _, By, Bz = box
    Rz, Ry = Bz + 2 * TB, By + 2 * TB
    teams = max(THREADS // Rz, -(-Ry // MAX_ROWS), 1)
    return teams * Rz if teams * Rz <= MAX_THREADS else 0


def plan_chunk(rows: int, ntiles: int, TB: int, per_sm: int) -> int:
    """Rows Cx a block marches over, for `rows` rows to cover with `ntiles`
    y-z tiles at `per_sm` blocks an SM.

    A launch ends with its last blocks running beside idle slots: that tail
    lasts about one block's march, Cx rows.  Each chunk adds a ramp of about
    RAMP_ROWS * TB rows (the levels filling and draining).  Over the
    ntiles * rows / slots rows each of the SMS * per_sm slots marches, the
    sum is least at Cx = sqrt(RAMP_ROWS * TB * ntiles * rows / slots), taken
    within MIN_CHUNK .. CHUNK and then evened out over the chunks.  So a
    short slab marches short chunks (17 rows at TB = 2 on a 198-row slab of
    the headline scene), a whole grid longer ones (35 rows)."""
    slots = SMS * per_sm
    cx = round(math.sqrt(RAMP_ROWS * TB * ntiles * rows / slots))
    cx = max(1, min(CHUNK, rows, max(cx, MIN_CHUNK)))
    n = -(-rows // cx)
    return -(-rows // n)


def plan_tiles(grid: GridSpec, TB: int, itemsize: int, bnl_ixyz,
               slab: SlabSpec | None = None) -> TileLists:
    """K3's block for this grid, TB and dtype, with its lossy lists (of a
    slab's local node indices when `slab` is given).

    Candidates are y-z tiles of By x Bz owned columns with Bz + 2TB one
    of the row widths the kernel is built for (ROW_WIDTHS: whole warps on
    a row).  Among those whose shared memory lets two blocks share an SM
    (else one), the planner takes the one that costs the least per owned
    point-step on this grid: the lane-point-steps it computes (the y and z
    halo, the lanes of a part-filled last tile and the idle lanes of the
    levels' narrower rows all count) plus THREAD_COST for each thread,
    march position and level, so that of two tiles with as many lanes the
    one with more rows a thread wins.  The chunk comes from `plan_chunk`.
    Raises only where no tile fits."""
    if not 2 <= TB <= 8:
        raise ValueError(f"TB={TB}: 2..8 steps per sweep")
    adj_itemsize = 2 if grid.fcc_flag else 1
    _, Ny, Nz = grid.shape
    rows = slab.S if slab is not None else grid.Nx - 2
    best = None
    for per_sm, budget in ((2, SMEM_SM // 2 - 1024), (1, SMEM_LIMIT)):
        for Rz in ROW_WIDTHS[itemsize]:
            Bz = Rz - 2 * TB
            if Bz < 1:
                continue
            for By in range(1, 257):
                if smem_bytes(By, Bz, TB, itemsize, adj_itemsize) > budget:
                    break
                nthr = tile_threads((1, By, Bz), TB)
                if not nthr:
                    continue
                lanes = sum(By + 2 * (TB - s) for s in range(1, TB + 1))
                tiles = -(-(Ny - 2) // By) * -(-(Nz - 2) // Bz)
                cost = (tiles * (lanes * Rz + THREAD_COST * TB * nthr)
                        / ((Ny - 2) * (Nz - 2) * TB))
                if best is None or cost < best[0]:
                    best = (cost, By, Bz, tiles, per_sm)
        if best is not None:
            break
    if best is None:
        raise ValueError(f"no K3 tile fits TB={TB} at {itemsize} B a value")
    _, By, Bz, tiles, per_sm = best
    box = (plan_chunk(rows, tiles, TB, per_sm), By, Bz)
    return build_tile_lists(bnl_ixyz, grid, box, TB, slab)


def _xyz(ixyz, grid) -> np.ndarray:
    """(n, 3) int32 coordinates of flat indices (grid: anything with the
    grid's or a slab's `shape`)."""
    ixyz = np.asarray(ixyz, np.int64)
    Nx, Ny, Nz = grid.shape
    return np.ascontiguousarray(np.stack(
        [ixyz // (Ny * Nz), (ixyz // Nz) % Ny, ixyz % Nz], 1), np.int32)


@dataclass
class TBScene:
    """The static tensors of a sweep, on one device.

    The plain version reads the engine's arrays (adj .. out_ixyz_f); the
    kernel reads the tile lists, a scratch for the listed nodes' branch
    states and the sources' and mirrored receivers' (n, 3) coordinates
    instead of flat indices.  A slab's scene (`slab` set)
    holds local indices and coordinates: the nodes and sources within TB-1
    rows of its owned rows, and its owned receivers.  `abcq`: Q of each
    lossy node (0 off the ABC layers), or None where no node lies on one."""

    grid: GridSpec
    sc: object
    TB: int
    lists: TileLists
    adj: torch.Tensor
    bnl: torch.Tensor
    ssaf: torch.Tensor
    mat: torch.Tensor
    coef_table: torch.Tensor
    beta: torch.Tensor
    in_ixyz: torch.Tensor
    out_ixyz_f: torch.Tensor
    tl_rptr: torch.Tensor
    tl_node: torch.Tensor
    tl_yz: torch.Tensor
    tl_ring: torch.Tensor
    scratch: torch.Tensor     # (2 MMb, E): branch states between levels
    src_xyz: torch.Tensor
    rcv_xyz: torch.Tensor
    src_k2: bool              # a source sits on a lossy node
    slab: SlabSpec | None = None
    abcq: torch.Tensor | None = None   # (Nbl,) uint8: the ABC mode

    @property
    def shape(self):
        return tuple((self.grid if self.slab is None else self.slab).shape)

    @classmethod
    def make(cls, data, TB: int, *, adj, bnl, ssaf, mat, coef_table, beta,
             in_ixyz, out_ixyz_f, abcq=None,
             lists: TileLists | None = None):
        """From an `EngineData` and the engine's device tensors (abcq: the
        engine's Q array, or None); plans the tiles unless `lists` is
        given."""
        g = data.grid
        if lists is None:
            lists = plan_tiles(g, TB, data.dtype.itemsize, data.bnl_ixyz)
        if lists.TB != TB:
            raise ValueError(f"tile lists for TB={lists.TB}, want {TB}")
        dev = adj.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(grid=g, sc=data.sc, TB=TB, lists=lists, adj=adj, bnl=bnl,
                   ssaf=ssaf, mat=mat, coef_table=coef_table, beta=beta,
                   in_ixyz=in_ixyz, out_ixyz_f=out_ixyz_f,
                   **_list_tensors(lists, ssaf, up),
                   src_xyz=up(_xyz(data.in_ixyz, g)),
                   rcv_xyz=up(_xyz(mirror_index(data.out_ixyz, g), g)),
                   src_k2=bool(np.isin(data.in_ixyz, data.bnl_ixyz).any()),
                   abcq=abcq)

    @classmethod
    def make_slab(cls, slab: SlabSpec, sc, TB: int, itemsize: int, *, adj,
                  bnl, ssaf, mat, coef_table, beta, in_ixyz, out_ixyz_f,
                  abcq=None):
        """A slab's scene from its device tensors, all indices local to
        `slab.shape` (bnl and in_ixyz: the nodes and sources within TB-1 of
        the owned rows; out_ixyz_f: the owned receivers, mirrored; abcq:
        those nodes' Q on the global grid, or None); plans the tiles."""
        lists = plan_tiles(slab.grid, TB, itemsize, bnl.cpu().numpy(), slab)
        if slab.S < 2 * TB:
            raise ValueError(f"slab of S={slab.S} rows: K6 needs >= 2*TB")
        dev = adj.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(grid=slab.grid, sc=sc, TB=TB, lists=lists, adj=adj,
                   bnl=bnl, ssaf=ssaf, mat=mat, coef_table=coef_table,
                   beta=beta, in_ixyz=in_ixyz, out_ixyz_f=out_ixyz_f,
                   **_list_tensors(lists, ssaf, up),
                   src_xyz=up(_xyz(in_ixyz.cpu().numpy(), slab)),
                   rcv_xyz=up(_xyz(out_ixyz_f.cpu().numpy(), slab)),
                   src_k2=bool(np.isin(in_ixyz.cpu().numpy(),
                                       bnl.cpu().numpy()).any()),
                   slab=slab, abcq=abcq)


def _list_tensors(lists: TileLists, ssaf, up) -> dict:
    """The tile lists on the device, with the scratch of their entries."""
    return dict(tl_rptr=up(lists.rptr), tl_node=up(lists.node),
                tl_yz=up(lists.yz), tl_ring=up(lists.ring),
                scratch=torch.empty((2 * MMb, lists.node.size),
                                    dtype=ssaf.dtype, device=ssaf.device))


def _check(st: TBScene, u0, u1, out0, out1, vh_in, gh_in, vh_out, gh_out,
           sig, taps):
    TB = st.TB
    if not 2 <= TB <= 8:
        raise ValueError(f"TB={TB}: 2..8 steps per sweep")
    shape = st.shape
    dt = u1.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"u1: dtype {dt}, want float32/float64")
    nbl, ns, nr = st.bnl.numel(), st.in_ixyz.numel(), st.out_ixyz_f.numel()
    want = {"u0": (u0, shape), "u1": (u1, shape), "out0": (out0, shape),
            "out1": (out1, shape), "vh_in": (vh_in, (MMb, nbl)),
            "gh_in": (gh_in, (MMb, nbl)), "vh_out": (vh_out, (MMb, nbl)),
            "gh_out": (gh_out, (MMb, nbl)), "sig": (sig, (TB, ns)),
            "ssaf": (st.ssaf, (nbl,)), "coef_table": (st.coef_table, None),
            "beta": (st.beta, None)}
    if TB > 2:
        want["taps"] = (taps, (TB - 2, nr))
    elif taps is not None:
        raise ValueError("taps: a TB = 2 sweep has no intermediate rows")
    for name, (t, s) in want.items():
        if t.dtype != dt:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dt}")
        if s is not None and tuple(t.shape) != s:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {s}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    adt = torch.uint16 if st.grid.fcc_flag else torch.uint8
    if st.adj.dtype != adt or tuple(st.adj.shape) != shape:
        raise ValueError(f"adj: want a {shape} {adt} grid")
    tensors = [u0, u1, out0, out1, vh_in, gh_in, vh_out, gh_out, sig,
               st.adj, st.bnl, st.mat, st.in_ixyz, st.out_ixyz_f, st.tl_rptr,
               st.scratch]
    if st.abcq is not None:
        if (st.abcq.dtype != torch.uint8 or tuple(st.abcq.shape) != (nbl,)
                or not st.abcq.is_contiguous()):
            raise ValueError(f"abcq: want a contiguous ({nbl},) uint8 "
                             "tensor")
        tensors.append(st.abcq)
    if len({t.device for t in tensors + ([taps] if TB > 2 else [])}) != 1:
        raise ValueError("every tensor of a sweep must lie on one device")
    if len({t.data_ptr() for t in (u0, u1, out0, out1)}) != 4:
        raise ValueError("u0, u1, out0, out1 must be four distinct buffers")
    if nbl and len({t.data_ptr() for t in (vh_in, gh_in, vh_out,
                                            gh_out)}) != 4:
        raise ValueError("vh_in, gh_in, vh_out, gh_out must be distinct")
    tl = st.lists
    W = tl.box[0] + 2 * (TB - 1)
    if (st.tl_rptr.numel() != int(np.prod(tl.ntiles)) * (W + 1)
            or tuple(st.scratch.shape) != (2 * MMb, tl.node.size)
            or st.scratch.dtype != dt or not tile_threads(tl.box, TB)):
        raise ValueError("tile lists do not match the scene")


def tb_sweep(st: TBScene, u0, u1, out0, out1, vh_in, gh_in, vh_out, gh_out,
             sig, taps=None):
    """One sweep of st.TB steps; returns (out0, out1).

    sig: (TB, Ns) source samples already divided by infac; taps: the
    (TB-2, Nr) rows for u^{n+1} .. u^{n+TB-2}, or None when TB = 2."""
    if st.slab is not None:
        raise ValueError("a slab's scene: use tb_sweep_shard")
    _check(st, u0, u1, out0, out1, vh_in, gh_in, vh_out, gh_out, sig, taps)
    if u1.device.type == "cpu":
        return tb_sweep_plain(st, u0, u1, out0, out1, vh_in, gh_in, vh_out,
                              gh_out, sig, taps)
    if u1.device.type != "cuda":
        raise ValueError(f"device {u1.device}: cpu or cuda only")
    lib = _build.library()
    with _build.on_device(u1.device):
        rc = lib.pf_tb_sweep(
            *_launch_args(st, u0, u1, out0, out1, vh_in, gh_in, vh_out,
                          gh_out, sig, taps),
            torch.cuda.current_stream(u1.device).cuda_stream)
    _build.check(rc, "tb_sweep")
    tb_sweep.launches += 1
    return out0, out1


tb_sweep.launches = 0


def _launch_args(st, u0, u1, out0, out1, vh_in, gh_in, vh_out, gh_out, sig,
                 taps):
    """The arguments K3 and K6 share, up to the Q array."""
    g, sc, tl = st.grid, st.sc, st.lists
    Nx, Ny, Nz = g.shape
    return (
        0 if u1.dtype == torch.float32 else 1, 12 if g.fcc_flag else 6,
        st.TB, u0.data_ptr(), u1.data_ptr(), st.adj.data_ptr(),
        out0.data_ptr(), out1.data_ptr(), Nx, Ny, Nz, int(g.folded),
        *tl.box, tile_threads(tl.box, st.TB), sc.a2, sc.sl2, sc.l * 1,
        sc.l * 2, sc.l * 3, sc.l, sc.lo2, st.tl_rptr.data_ptr(),
        st.tl_node.data_ptr(), st.tl_yz.data_ptr(), st.tl_ring.data_ptr(),
        tl.node.size, st.scratch.data_ptr(), st.ssaf.data_ptr(),
        st.mat.data_ptr(), st.coef_table.data_ptr(), st.beta.data_ptr(),
        vh_in.data_ptr(), gh_in.data_ptr(), vh_out.data_ptr(),
        gh_out.data_ptr(), st.bnl.numel(), st.src_xyz.data_ptr(),
        sig.data_ptr(), st.in_ixyz.numel(), st.rcv_xyz.data_ptr(),
        taps.data_ptr() if taps is not None else None,
        st.out_ixyz_f.numel(), int(st.src_k2),
        None if st.abcq is None else st.abcq.data_ptr())


def tb_sweep_shard(st: TBScene, u0, u1, out0, out1, vh_in, gh_in, vh_out,
                   gh_out, sig, taps=None):
    """One K6 sweep of st.TB steps over a slab; returns (out0, out1).

    As `tb_sweep`, on a slab's scene: u0, u1 carry the neighbours' rows in
    their TB ghost rows a side; out0, out1 receive the owned rows of
    u^{n+TB-1}, u^{n+TB}; vh_out, gh_out the owned nodes' states (the
    ghost-band slots are not written)."""
    if st.slab is None:
        raise ValueError("not a slab's scene: use tb_sweep")
    _check(st, u0, u1, out0, out1, vh_in, gh_in, vh_out, gh_out, sig, taps)
    if u1.device.type == "cpu":
        return tb_sweep_shard_plain(st, u0, u1, out0, out1, vh_in, gh_in,
                                    vh_out, gh_out, sig, taps)
    if u1.device.type != "cuda":
        raise ValueError(f"device {u1.device}: cpu or cuda only")
    sl = st.slab
    lib = _build.library()
    with _build.on_device(u1.device):
        rc = lib.pf_tb_sweep_shard(
            *_launch_args(st, u0, u1, out0, out1, vh_in, gh_in, vh_out,
                          gh_out, sig, taps),
            *sl.owned, *sl.computable, sl.xo,
            torch.cuda.current_stream(u1.device).cuda_stream)
    _build.check(rc, "tb_sweep_shard")
    tb_sweep_shard.launches += 1
    return out0, out1


tb_sweep_shard.launches = 0


def tb_sweep_plain(st: TBScene, u0, u1, out0, out1, vh_in, gh_in, vh_out,
                   gh_out, sig, taps=None):
    """TB repeats of the plain single step (same signature and result).

    The last two steps write out0 and out1; earlier ones a scratch grid,
    so the buffers cycle (out1, out0, scratch) counted from the last step
    and no step overwrites a field it reads."""
    TB = st.TB
    vh_out.copy_(vh_in)
    gh_out.copy_(gh_in)
    bufs = (out1, out0, torch.empty_like(u1) if TB > 2 else None)
    prev, cur = u0, u1
    for s in range(TB):
        dst = bufs[(TB - 1 - s) % 3]
        stencil_step_plain(prev, cur, st.adj, dst, st.grid, st.sc)
        boundary_update_plain(dst, prev, st.bnl, st.ssaf, st.mat,
                              st.coef_table, st.beta, vh_out, gh_out, st.sc,
                              st.abcq)
        dst.view(-1).index_add_(0, st.in_ixyz, sig[s])
        if s < TB - 2:
            torch.index_select(dst.view(-1), 0, st.out_ixyz_f, out=taps[s])
        prev, cur = cur, dst
    return out0, out1


def tb_sweep_shard_plain(st: TBScene, u0, u1, out0, out1, vh_in, gh_in,
                         vh_out, gh_out, sig, taps=None):
    """PyTorch version of K6 (same signature and result).

    Step s computes the rows within TB-1-s of the owned ones (clamped to
    the computable rows), as the kernel's shrinking step boxes do along x,
    with the lossy nodes and sources on those rows; the buffers cycle as in
    `tb_sweep_plain`.  Only the owned nodes' states reach vh_out, gh_out."""
    TB, sl = st.TB, st.slab
    xa, xb = sl.owned
    xl, xh = sl.computable
    plane = sl.grid.Ny * sl.grid.Nz
    node_x = st.bnl // plane
    src_x = st.in_ixyz // plane
    vh, gh = vh_in.clone(), gh_in.clone()
    bufs = (out1, out0, torch.empty_like(u1) if TB > 2 else None)
    prev, cur = u0, u1
    for s in range(TB):
        r0, r1 = max(xa - (TB - 1 - s), xl), min(xb + TB - 1 - s, xh)
        dst = bufs[(TB - 1 - s) % 3]
        stencil_rows_plain(prev, cur, st.adj, dst, st.grid, st.sc, sl.xo, r0,
                           r1)
        i = torch.nonzero((node_x >= r0) & (node_x < r1))[:, 0]
        v, g = vh[:, i].contiguous(), gh[:, i].contiguous()
        boundary_update_plain(dst, prev, st.bnl[i], st.ssaf[i], st.mat[i],
                              st.coef_table, st.beta, v, g, st.sc,
                              None if st.abcq is None else st.abcq[i])
        vh[:, i], gh[:, i] = v, g
        m = (src_x >= r0) & (src_x < r1)
        dst.view(-1).index_add_(0, st.in_ixyz[m], sig[s][m])
        if s < TB - 2:
            torch.index_select(dst.view(-1), 0, st.out_ixyz_f, out=taps[s])
        prev, cur = cur, dst
    own = (node_x >= xa) & (node_x < xb)
    vh_out[:, own] = vh[:, own]
    gh_out[:, own] = gh[:, own]
    return out0, out1
