"""Demo rooms, synthetic box scenes and the in-memory sim-folder transforms,
numpy only.

Counterparts, held array-for-array equal to the originals:
- `make_shoebox_room`   pffdtd_tpu/demo.py `make_shoebox_room`
- `make_sloped_room`    `_sloped_room` of tests/test_pallas_pair.py, with the
                        floor in a second material
- `synthetic_box_sim`   pffdtd_tpu/demo.py `synthetic_box_sim`
- `mats_from_DEF_list`  pffdtd_tpu/scene_setup.py `mats_from_DEF_list`
- `rotate_sim`, `fold_fcc_sim`, `sort_sim`, `pad_x_interior`
                        pffdtd_tpu/prep.py

The originals import `h5py` at module level (through `pffdtd_tpu.io.h5`),
which the card's machine may lack.  The grid, constants and source/receiver
helpers they build on are the port's own copies (`voxelizer.grid.CartGrid`,
`consts.SimConsts`, `comms.SimComms`).  `boundary_face_counts` is
pffdtd_tpu/prep.py's.  `rotate_sim` rotates by "auto" by default, as the
original does, by an explicit `tr`, or by the reference's "descending"
rule; "auto" is the port's own rule (`orientation_scores`, `auto_tr`): the
original's prices TPU tilings, this one the port's step route on the H100.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from pffdtd_tpu_torch.comms import SimComms
from pffdtd_tpu_torch.consts import SimConsts
from pffdtd_tpu_torch.geometry.room import RoomGeo
from pffdtd_tpu_torch.io.simdata import (MMb, MatsData, SimConstsData,
                                         SimData, VoxData)
from pffdtd_tpu_torch.spans import span
from pffdtd_tpu_torch.utils import ind2sub3d
from pffdtd_tpu_torch.voxelizer.grid import CartGrid
from pffdtd_tpu_torch.voxelizer.vox import CART_VECTORS, FCC_VECTORS

DEMO_DEF = np.array([[2.0, 5.0, 30.0],
                     [1.0, 10.0, 300.0],
                     [0.5, 8.0, 3000.0]])
# the 11-branch material of the root bench.py:60-63 (11 RLC branches a
# material, the reference's benchmark condition)
DEF11 = np.array([[d, e, f] for d, e, f in zip(
    np.geomspace(0.4, 40.0, 11),
    np.geomspace(2.0, 80.0, 11),
    np.geomspace(20.0, 2.0e5, 11))])
# the headline box's receivers, offsets from its source (1.6 and 2.1 m)
HEADLINE_RX = np.array([[1.3, -0.8, 0.6], [-1.3, 1.4, -0.9]])


def headline_rxyz(Lx, Ly, Lz):
    """Receivers 1.6 and 2.1 m from a box's source (at 0.45, 0.55, 0.5 of
    it, where `synthetic_box_sim` puts it)."""
    return np.array([0.45 * Lx, 0.55 * Ly, 0.5 * Lz]) + HEADLINE_RX


def mats_from_DEF_list(DEF_list) -> MatsData:
    Nmat = len(DEF_list)
    Mb = np.array([np.atleast_2d(d).shape[0] for d in DEF_list], np.int8)
    DEF = np.zeros((Nmat, MMb, 3))
    for i, d in enumerate(DEF_list):
        d = np.atleast_2d(d)
        if d.shape[1] != 3 or d.shape[0] > MMb:
            raise ValueError(f"material {i}: DEF must be (<= {MMb}, 3)")
        DEF[i, : d.shape[0]] = d
    return MatsData(Nmat=Nmat, Mb=Mb, DEF=DEF)


def make_shoebox_room(Lx=2.0, Ly=3.0, Lz=2.5, mats=None, sides=None) -> RoomGeo:
    """A 12-triangle box room with outward normals.

    mats: list of 6 material names per face pair (-x,+x,-y,+y,-z,+z) or None
    for all-rigid; sides: per-face sidedness flags (default 1 = interior live).
    """
    v = np.array([[0, 0, 0], [Lx, 0, 0], [0, Ly, 0], [Lx, Ly, 0],
                  [0, 0, Lz], [Lx, 0, Lz], [0, Ly, Lz], [Lx, Ly, Lz]],
                 np.float64)
    faces = {
        "xm": [(0, 4, 6), (0, 6, 2)],
        "xp": [(1, 3, 7), (1, 7, 5)],
        "ym": [(0, 1, 5), (0, 5, 4)],
        "yp": [(2, 6, 7), (2, 7, 3)],
        "zm": [(0, 2, 3), (0, 3, 1)],
        "zp": [(4, 5, 7), (4, 7, 6)],
    }
    tris = np.array([t for key in faces for t in faces[key]], np.int64)

    if mats is None:
        mat_names = ["_RIGID"]
        mat_ind = np.full(12, -1, np.int8)
        mat_side = np.zeros(12, np.int8)
    else:
        names = sorted(set(m for m in mats if m != "_RIGID"))
        mat_names = names + (["_RIGID"] if "_RIGID" in mats else [])
        lookup = {m: i for i, m in enumerate(names)}
        lookup["_RIGID"] = -1
        mat_ind = np.array([lookup[mats[i // 2]] for i in range(12)], np.int8)
        if sides is None:
            sides = [1] * 6
        mat_side = np.array([sides[i // 2] if mat_ind[i] >= 0 else 0
                             for i in range(12)], np.int8)

    Sxyz = np.array([[0.55 * Lx, 0.6 * Ly, 0.5 * Lz]])
    Rxyz = np.array([[0.3 * Lx, 0.3 * Ly, 0.4 * Lz],
                     [0.7 * Lx, 0.45 * Ly, 0.6 * Lz]])
    return RoomGeo.from_arrays(v, tris, mat_ind, mat_side, mat_names,
                               Sxyz, Rxyz)


def make_sloped_room(Lx=2.0, Ly=3.0, Lz1=1.6, Lz2=2.5, Sxyz=None,
                     Rxyz=None) -> RoomGeo:
    """A shoebox whose ceiling rises from Lz1 at y = 0 to Lz2 at y = Ly
    (8 vertices, 12 triangles with outward normals, live on the inside):
    the voxelizer staircases the sloped face into off-plane lossy nodes.
    The floor is material 0 ("floor"), every other face material 1
    ("walls")."""
    v = np.array([[0, 0, 0], [Lx, 0, 0], [0, Ly, 0], [Lx, Ly, 0],
                  [0, 0, Lz1], [Lx, 0, Lz1], [0, Ly, Lz2], [Lx, Ly, Lz2]],
                 np.float64)
    tris = np.array([(0, 4, 6), (0, 6, 2), (1, 3, 7), (1, 7, 5),
                     (0, 1, 5), (0, 5, 4), (2, 6, 7), (2, 7, 3),
                     (0, 2, 3), (0, 3, 1), (4, 5, 7), (4, 7, 6)], np.int64)
    mat_ind = np.ones(12, np.int8)
    mat_ind[8:10] = 0
    if Sxyz is None:
        Sxyz = np.array([[0.55 * Lx, 0.6 * Ly, 0.5 * Lz1]])
    if Rxyz is None:
        Rxyz = np.array([[0.3 * Lx, 0.3 * Ly, 0.4 * Lz1],
                         [0.7 * Lx, 0.6 * Ly, 0.6 * Lz1]])
    return RoomGeo.from_arrays(v, tris, mat_ind, np.ones(12, np.int8),
                               ["floor", "walls"], Sxyz, Rxyz)


@span("scene.box")
def synthetic_box_sim(Lx=8.0, Ly=6.0, Lz=5.0, h=0.02, duration=None, Nt=None,
                      fcc=False, lossy=True, Tc=20.0, rh=50.0,
                      insig_type="impulse", diff_source=None,
                      pad_x_to: int | None = None,
                      DEF: np.ndarray | None = None,
                      open_top: bool = False,
                      Rxyz: np.ndarray | None = None) -> SimData:
    """Analytic axis-aligned box sim data at arbitrary scale.

    A leg from an in-room grid point is cut iff the neighbour leaves the
    open box (0,Lx)x(0,Ly)x(0,Lz); for FCC only even-parity points count.
    pad_x_to appends air rows past the high-x wall until Nx is a multiple
    of it.  open_top=True removes the z = Lz wall: the field escapes through
    the opening into the Engquist-Majda ABCs, and the side walls' lossy
    nodes reach the top ABC layer.
    Rxyz (Nr, 3) replaces the two default receiver positions (an addition
    of the port, for runs too short to reach the defaults).
    """
    sc = SimConsts(Tc=Tc, rh=rh, h=h, fcc=fcc)
    cg = CartGrid(h=h, offset=3.5, bmin=np.zeros(3),
                  bmax=np.array([Lx, Ly, Lz]), fcc=fcc)
    Nx, Ny, Nz = cg.Nx, cg.Ny, cg.Nz
    if pad_x_to and Nx % pad_x_to:
        add = pad_x_to - Nx % pad_x_to
        Nx += add
        cg.xv = np.r_[cg.xv, cg.xv[-1] + h * np.arange(1, add + 1)]
        cg.Nx = Nx
        cg.Nxyz = np.array([Nx, Ny, Nz])
        cg.Npts = int(Nx * Ny * Nz)
    VV = (FCC_VECTORS if fcc else CART_VECTORS).astype(np.int64)
    NN = VV.shape[0]

    eps = 1e-9 * h
    xv, yv, zv = cg.xv, cg.yv, cg.zv
    inx = (xv > eps) & (xv < Lx - eps)
    iny = (yv > eps) & (yv < Ly - eps)
    inz = (zv > eps) & ((zv < Lz - eps) | open_top)

    # candidates: points within one step of a wall plane (either side),
    # excluding the outermost grid layer
    def near_wall(vals, L):
        return (np.abs(vals) <= h + eps) | (np.abs(vals - L) <= h + eps)

    nx_, ny_, nz_ = near_wall(xv, Lx), near_wall(yv, Ly), near_wall(zv, Lz)
    nx_[[0, -1]] = ny_[[0, -1]] = nz_[[0, -1]] = False

    bn_rows, adj_rows, in_rows = [], [], []
    iy_all = np.arange(1, Ny - 1)
    iz_all = np.arange(1, Nz - 1)
    yg, zg = np.meshgrid(iy_all, iz_all, indexing="ij")
    near_yz = nz_[None, iz_all] | ny_[iy_all, None]
    for ix in range(1, Nx - 1):
        sel = np.ones_like(yg, bool) if nx_[ix] else near_yz
        iy, iz = yg[sel], zg[sel]
        if fcc:
            par = (ix + iy + iz) % 2 == 0
            iy, iz = iy[par], iz[par]
        if iy.size == 0:
            continue
        px, py, pz = xv[ix], yv[iy], zv[iz]
        inside_p = inx[ix] & iny[iy] & inz[iz]
        adj = np.ones((iy.size, NN), bool)
        for k, (dx, dy, dz) in enumerate(VV):
            qx, qy, qz = px + dx * h, py + dy * h, pz + dz * h
            inside_q = ((qx > eps) & (qx < Lx - eps)
                        & (qy > eps) & (qy < Ly - eps)
                        & (qz > eps) & ((qz < Lz - eps) | open_top))
            adj[:, k] = inside_p == inside_q
        is_bn = (~adj).any(-1)
        if not is_bn.any():
            continue
        bn_rows.append((ix * Ny + iy[is_bn]) * Nz + iz[is_bn])
        adj_rows.append(adj[is_bn])
        in_rows.append(inside_p[is_bn])

    bn_ixyz = np.concatenate(bn_rows) if bn_rows else np.zeros(0, np.int64)
    adj_bn = np.concatenate(adj_rows) if adj_rows else np.zeros((0, NN), bool)
    in_bn = np.concatenate(in_rows) if in_rows else np.zeros(0, bool)
    order = np.argsort(bn_ixyz)
    bn_ixyz, adj_bn, in_bn = bn_ixyz[order], adj_bn[order], in_bn[order]

    ncut = (~adj_bn).sum(-1).astype(np.float64)
    if lossy:
        # only in-room (right-side) nodes carry the material
        mat_bn = np.where(in_bn, np.int8(0), np.int8(-1))
        mats = mats_from_DEF_list([DEMO_DEF if DEF is None else DEF])
    else:
        mat_bn = np.full(bn_ixyz.size, -1, np.int8)
        mats = mats_from_DEF_list([])
    # axis-aligned walls: |v_k . n| = 1 per cut face pair (Cartesian); for
    # FCC each cut leg sees the wall at 1/sqrt(2)
    saf_bn = ncut if not fcc else ncut / np.sqrt(2.0)

    vox = VoxData(Nx=Nx, Ny=Ny, Nz=Nz, bn_ixyz=bn_ixyz, adj_bn=adj_bn,
                  mat_bn=mat_bn, saf_bn=saf_bn, xv=cg.xv, yv=cg.yv, zv=cg.zv,
                  h=h)

    comms = SimComms(cg.xv, cg.yv, cg.zv, h, sc.Ts, sc.l2, fcc=fcc)
    comms.prepare_source_pts(np.array([0.45 * Lx, 0.55 * Ly, 0.5 * Lz]))
    if Rxyz is None:
        Rxyz = np.array([[0.25 * Lx, 0.3 * Ly, 0.4 * Lz],
                         [0.7 * Lx, 0.6 * Ly, 0.55 * Lz]])
    comms.prepare_receiver_pts(np.asarray(Rxyz, np.float64))
    if Nt is not None:
        duration = Nt * sc.Ts
    if duration is None:
        raise ValueError("give duration or Nt")
    comms.prepare_source_signals(duration, sig_type=insig_type)
    if diff_source is None:
        diff_source = insig_type == "impulse"
    if diff_source:
        comms.diff_source()

    consts = SimConstsData(c=sc.c, h=sc.h, Ts=sc.Ts, SR=sc.SR, l=sc.l,
                           l2=sc.l2, fcc_flag=sc.fcc_flag, Tc=Tc, rh=rh)
    return SimData(consts=consts, vox=vox, comms=comms.to_comms_data(),
                   mats=mats)


# ------------------------------------------------------------- transforms
def _permute_indices(ixyz, tr, N, Nt_dims):
    subs = ind2sub3d(ixyz, *N)
    subs_t = [subs[t] for t in tr]
    _, Nyt, Nzt = Nt_dims
    return (subs_t[0] * Nyt + subs_t[1]) * Nzt + subs_t[2]


def _adj_column_perm(tr, NN):
    """Column permutation of adj_bn under a dim permutation tr."""
    VV = (FCC_VECTORS if NN == 12 else CART_VECTORS).astype(np.int64)
    jj = np.array([np.flatnonzero((VV == v[list(tr)]).all(-1))[0]
                   for v in VV])
    return np.argsort(jj)


def boundary_face_counts(vox) -> np.ndarray:
    """Cut boundary legs per axis (x, y, z): the staircase area profile."""
    cut = ~np.asarray(vox.adj_bn, bool)
    if cut.shape[1] == 6:  # cart leg order: +x -x +y -y +z -z
        ax = np.array([0, 0, 1, 1, 2, 2])
        return np.array([int(cut[:, ax == k].sum()) for k in range(3)])
    # FCC: 12 diagonal legs, each spans two axes equally
    return (cut @ np.abs(FCC_VECTORS)).sum(0).astype(np.int64)


# The port's step route on the H100, ns a step (`orientation_scores`),
# fitted to the best CUDA-event windows of K1 and K2 in
# `python -m pffdtd_tpu_torch.probes.orient` (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md): K1 a point of the interior, by stencil (7-point
# Cartesian, 13-point FCC), and a lane K1's blocks leave idle past the end
# of a z-run on Cartesian grids (on FCC grids the idle lanes measured
# -0.00008 ns each, within the windows' spread: no term); K2 a lossy node,
# and again for each on a wall normal to z, whose nodes lie Nz apart in
# flat order, so that each u access takes a sector of its own.
K1_NS_PER_POINT = {False: 0.00561, True: 0.00821}
K1_NS_PER_IDLE_LANE = 0.00162
K2_NS_PER_NODE = 0.0809
K2_NS_PER_Z_NODE = 0.0784
# "auto" leaves "descending"'s layout only for a score lower by more than
# this share of its own: the step route's best of 3 moved by up to 0.58%
# (1.02% at 1.049 Gvox) between two engines on one layout in one run
ORIENT_MARGIN = 0.01
LANES = 128  # K1's threads a block: one z-run of a (y, x) row


def tr_for(N, z: int, fcc: int) -> tuple:
    """The permutation that puts axis z on z: of the other two, the longer
    goes on x; a folded grid (fcc 2) keeps its half-y axis on y."""
    rest = sorted((j for j in range(3) if j != z), key=lambda j: -N[j])
    if fcc == 2 and rest[1] != 1:
        rest = [j for j in range(3) if j not in (z, 1)] + [1]
    return (rest[0], rest[1], z)


def _wall_nodes(faces, fcc: int) -> tuple:
    """(boundary nodes, those on walls normal to each axis) from the cut
    legs per axis: a Cartesian node cuts one leg along its wall's normal;
    an FCC node cuts four, which span the normal four times and each other
    axis twice (faces[k] = 2 n_k + 2 n)."""
    f = np.asarray(faces, np.float64)
    if not fcc:
        return f.sum(), f
    n = f.sum() / 8
    return n, f / 2 - n


def orientation_scores(N, faces, fcc: int, lossy: bool = True) -> list:
    """ns a step of the port's step route (K1 + K2) with axis k on z, for
    k in 0..2, from the grid's dims N, its cut legs per axis `faces`
    (`boundary_face_counts`) and its fcc_flag (1: folded after the
    rotation); inf for the half-y axis of a folded grid (fcc 2).  K2 runs
    on the in-room half of the boundary nodes where `lossy`."""
    nodes, normal = _wall_nodes(faces, fcc)
    score = []
    for k in range(3):
        if fcc == 2 and k == 1:
            score.append(np.inf)
            continue
        nx, ny, nz = (N[j] for j in tr_for(N, k, fcc))
        if fcc == 1:
            ny = ny // 2 + 1   # the fold halves the axis that lands on y
        points = (nx - 2) * (ny - 2) * (nz - 2)
        s = K1_NS_PER_POINT[bool(fcc)] * points
        if not fcc:
            idle = -(-(nz - 2) // LANES) * LANES - (nz - 2)
            s += K1_NS_PER_IDLE_LANE * (nx - 2) * (ny - 2) * idle
        if lossy:
            s += (K2_NS_PER_NODE * nodes + K2_NS_PER_Z_NODE * normal[k]) / 2
        score.append(float(s))
    return score


def _descending(N) -> tuple:
    """The dims in descending order (the reference's rule,
    rotate_sim_data.py:30-130)."""
    return tuple(int(t) for t in np.argsort(N)[::-1])


def auto_tr(N, faces, fcc: int, lossy: bool = True) -> tuple:
    """The "auto" permutation: "descending"'s, unless another axis on z
    scores less by more than ORIENT_MARGIN of its score (or "descending"
    would move a folded grid's half-y axis off y), then `tr_for` of the
    axis that scores least."""
    desc = _descending(N)
    score = orientation_scores(N, faces, fcc, lossy)
    best = int(np.argmin(score))
    kept = score[desc[2]]
    if np.isfinite(kept) and score[best] >= (1 - ORIENT_MARGIN) * kept:
        if fcc != 2 or desc[1] == 1:
            return desc
        best = desc[2]
    return tr_for(N, best, fcc)


def rotation_of(sim: SimData, orient: str = "auto") -> tuple:
    """The permutation `rotate_sim(sim, orient=orient)` applies: the dims in
    descending order (orient="descending") or `auto_tr`'s choice on the
    port's step-route cost model; "auto" takes "descending" on a scene
    with no boundary node."""
    if orient not in ("auto", "descending"):
        raise ValueError(f"orient={orient!r}: 'auto' or 'descending'")
    vox = sim.vox
    N = (vox.Nx, vox.Ny, vox.Nz)
    if orient == "auto" and vox.Nb:
        return auto_tr(N, boundary_face_counts(vox), int(sim.consts.fcc_flag),
                       bool(np.any(np.asarray(vox.mat_bn) >= 0)))
    return _descending(N)


@span("scene.rotate")
def rotate_sim(sim: SimData, tr=None, orient: str = "auto") -> SimData:
    """Permute grid dims: by an explicit `tr`, else by `rotation_of(sim,
    orient)`."""
    vox, comms = sim.vox, sim.comms
    N = (vox.Nx, vox.Ny, vox.Nz)
    tr = rotation_of(sim, orient) if tr is None else tuple(tr)
    if tr == (0, 1, 2):
        return sim
    Nt_dims = tuple(N[t] for t in tr)
    vvecs = [vox.xv, vox.yv, vox.zv]
    ia = _adj_column_perm(tr, vox.NN)
    vox2 = replace(
        vox, Nx=Nt_dims[0], Ny=Nt_dims[1], Nz=Nt_dims[2],
        bn_ixyz=_permute_indices(vox.bn_ixyz, tr, N, Nt_dims),
        adj_bn=vox.adj_bn[:, ia],
        xv=vvecs[tr[0]], yv=vvecs[tr[1]], zv=vvecs[tr[2]])
    comms2 = replace(
        comms,
        in_ixyz=_permute_indices(comms.in_ixyz, tr, N, Nt_dims),
        out_ixyz=_permute_indices(comms.out_ixyz, tr, N, Nt_dims))
    return replace(sim, vox=vox2, comms=comms2)


@span("scene.fold")
def fold_fcc_sim(sim: SimData) -> SimData:
    """Fold the interleaved FCC grid (fcc_flag=1) across mid-y -> flag 2."""
    if sim.consts.fcc_flag != 1 or sim.vox.Ny % 2:
        raise ValueError("folding needs an unfolded FCC grid with even Ny")
    vox, comms = sim.vox, sim.comms
    Nx, Ny, Nz = vox.Nx, vox.Ny, vox.Nz
    Nyh = Ny // 2 + 1

    def fold(ixyz):
        ix, iy, iz = ind2sub3d(ixyz, Nx, Ny, Nz)
        hi = iy >= Ny // 2
        iy2 = np.where(hi, Ny - iy - 1, iy)
        return (ix * Nyh + iy2) * Nz + iz, hi

    bn2, hi = fold(vox.bn_ixyz)
    adj2 = vox.adj_bn.copy()
    # folded nodes flip their y direction: swap +y-ish and -y-ish legs
    for a, b in ((0, 6), (1, 7), (2, 9), (3, 8)):
        adj2[hi, a], adj2[hi, b] = vox.adj_bn[hi, b], vox.adj_bn[hi, a]
    in2, _ = fold(comms.in_ixyz)
    out2, _ = fold(comms.out_ixyz)
    vox2 = replace(vox, Ny=Nyh, bn_ixyz=bn2, adj_bn=adj2, yv=vox.yv[:Nyh])
    comms2 = replace(comms, in_ixyz=in2, out_ixyz=out2)
    consts2 = replace(sim.consts, fcc_flag=2)
    return replace(sim, vox=vox2, comms=comms2, consts=consts2)


@span("scene.sort")
def sort_sim(sim: SimData) -> SimData:
    """Sort boundary/io index arrays ascending; record out_reorder."""
    vox, comms = sim.vox, sim.comms
    ii = np.argsort(vox.bn_ixyz, kind="stable")
    vox2 = replace(vox, bn_ixyz=vox.bn_ixyz[ii], adj_bn=vox.adj_bn[ii],
                   mat_bn=vox.mat_bn[ii], saf_bn=vox.saf_bn[ii])
    jj = np.argsort(comms.in_ixyz, kind="stable")
    kk = np.argsort(comms.out_ixyz, kind="stable")
    comms2 = replace(
        comms,
        in_ixyz=comms.in_ixyz[jj], in_sigs=comms.in_sigs[jj],
        out_ixyz=comms.out_ixyz[kk],
        out_reorder=np.argsort(kk, kind="stable")[comms.out_reorder])
    return replace(sim, vox=vox2, comms=comms2)


def pad_x_interior(sim: SimData, D: int) -> SimData:
    """Pad the grid's x extent so its interior rows split into D equal
    x-slabs ((Nx - 2) % D == 0), with exterior air past the high-x wall:
    the new rows carry no boundary node and stay decoupled from the room
    (prep.py `pad_x_interior` with interior=True)."""
    vox = sim.vox
    rem = (vox.Nx - 2) % D
    if not rem:
        return sim
    add = D - rem
    return replace(sim, vox=replace(
        vox, Nx=vox.Nx + add,
        xv=np.r_[vox.xv, vox.xv[-1] + vox.h * np.arange(1, add + 1)]))
