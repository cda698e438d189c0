"""The CUDA kernels K1-K8 vs their plain PyTorch versions, on the card.

Marked `cuda`; each test skips, inside the `cuda` fixture, where
torch.cuda.is_available() is False (a CUDA kernel has no CPU mode; its plain
version is covered by the other test_torch_* files).  Run on the card with

    python3 -m pytest tests/test_torch_cuda.py -m cuda

Bounds: one fp32 call <= 1e-6 relative (the kernels are built without FMA
contraction, so only summation order may differ), fp64 <= 1e-12, and whole
runs on the kernel path vs the plain path <= 1e-12 in fp64.  K3 repeats K1
and K2's arithmetic per step, so one sweep is held to the same bounds; K4's
copy and fill are exact and its float64 sum agrees with PyTorch's to 1e-12
of the sum of |x|.  K5 and K6 (the shard modes of K1 and K3) are held to the
same bounds on every slab of a split, and the sharded engine's kernel
routes to the single-device plain path in fp64.  The K3/K6 sweeps run at
TB = 2, 3, 4, 8 (K6: 2, 3, 5), on planned chunks and on 7-row ones (a
partial last chunk, and a source on a lossy node), with sources and
receivers on chunk and tile edges; K4 on sizes that leave a tail after
whole float4s and after whole blocks.  K1e (K1's energy mode: the step
and K7's grid half in one launch), then K7's boundary pass (the energy
terms), from a random state: u^{n+1} and L u^n bitwise equal to the plain
versions, the energies <= 1e-12 in fp64 and, in fp32, no further from the
fp64 value than the fp32 plain versions; the energy route's resume
bitwise equal to the uninterrupted run; K8 (the modal recurrence)
<= 1e-12 of its numpy loop and of its design's plain version
(`modal_split_plain`), its loop modes bitwise equal to the numpy loop.
K1 on the adjacency's compact form (the step route's) bitwise equal to
K1 on the packed grid and to its plain version, on the same kinds of
grids, fp32 and fp64, both tile widths; the benchmark cells' 1.08e9-point
engines hold the compact form and no packed grid.
K1 and K5 bitwise equal to their plain versions on random fields and a
random adjacency (air and masked points) of ragged grids: Nx-2, Ny-2 and
Nz-2 no multiples of the tiles and chunks (planned, and forced to both
tile widths and to 1-3 rows a thread), every ABC face, edge and corner,
the folded high-y ghost, fp32 and fp64, Cartesian and FCC; the slabs of a
four-way split bitwise the whole grid's rows, and no halo written.
K2's and K3/K6's ABC modes (lossy nodes on an ABC layer, an open-top box)
bitwise equal to their plain versions (K3 at TB = 2, 3, 8, K6 at 2 and 3
on both slabs of a D = 2 split), the open-top box's kernel path within
1e-12 of its plain path in fp64, its tb, pair and x-slab tb/pair routes'
receivers bitwise equal to its step route's, and its energy route's
energies within 1e-12 of the plain path's (the balance is the reference's,
which does not close there).
Beside the kernels: the energy route (K1e, K2 and K7's boundary pass once
a step, K1 never) against the plain path, a resume at a step that is no
multiple of TB, and the modal filter on the card against its numpy loop,
<= 1e-12; the step, tb, pair and
energy routes with fp32_eps = 1e-3 in fp64 against the plain path with the
same shift, <= 1e-12; the air / boundary split's probe (K2 timed with CUDA
events) in a verbose chunked run, its results bitwise a quiet run's; the
spans' allocator readings over two runs, which hold one state at a time.
With two or more cards (the `cards` fixture skips otherwise): each x-slab
route with one slab per card (up to four) bitwise equal to the same
engine with every slab on cuda:0, in fp32 and fp64, closed and open at the
top; `TorchEngine` on cuda:1 bitwise its run on cuda:0; and K4, K5, K6 and
K8 called with tensors on cuda:1 while cuda:0 is current.
"""

import dataclasses
import gc
import time

import numpy as np
import pytest
import torch

from pffdtd_tpu_torch import spans
from pffdtd_tpu_torch.engine.torch_engine import BN_ITERS, TorchEngine
from pffdtd_tpu_torch.engine.coeffs import SchemeCoeffs
from pffdtd_tpu_torch.engine.data import GridSpec, SlabSpec
from pffdtd_tpu_torch.kernels import stencil as kstencil
from pffdtd_tpu_torch.kernels import tb as ktb
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels.boundary import (boundary_update,
                                               boundary_update_plain)
from pffdtd_tpu_torch.kernels.energy import (energy_boundary_pass,
                                             energy_boundary_pass_plain,
                                             scratch_size)
from pffdtd_tpu_torch.kernels.modal import modal_scan
from pffdtd_tpu_torch.kernels.stencil import (stencil_energy_step,
                                              stencil_energy_step_plain,
                                              stencil_step, stencil_step_plain)
from pffdtd_tpu_torch.kernels.stream import stream, stream_plain
from pffdtd_tpu_torch.kernels.stencil import (stencil_step_shard,
                                              stencil_step_shard_plain)
from pffdtd_tpu_torch.kernels.tb import (tb_sweep, tb_sweep_plain,
                                         tb_sweep_shard, tb_sweep_shard_plain)
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.scene import (fold_fcc_sim, pad_x_interior, sort_sim,
                                    synthetic_box_sim)

pytestmark = pytest.mark.cuda

CASES = {
    "cart": ((2.5, 2.0, 1.6), 0.1, False, False),
    "fcc": ((2.2, 1.8, 1.5), 0.12, True, False),
    "fcc-folded": ((2.2, 1.8, 1.5), 0.12, True, True),
}
TOL = {np.float32: 1e-6, np.float64: 1e-12}
MIB = 2**20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _sim(name):
    box, h, fcc, fold = CASES[name]
    sim = synthetic_box_sim(*box, h=h, Nt=30, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    return sort_sim(fold_fcc_sim(sim)) if fold else sim


def _engine(name, dtype, **kw):
    sim = _sim(name)
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=dtype, device="cuda", **kw)


def _sharded(name, dtype, D, **kw):
    sim = _sim(name)
    return make_sharded_engine(consts=sim.consts, vox=sim.vox,
                               comms=sim.comms, mats=sim.mats,
                               devices=["cuda"] * D, dtype=dtype, **kw)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_plain_one_call(cuda, name, dtype):
    eng = _engine(name, dtype)
    d = eng.data
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    u0, u1 = t(*d.grid.shape), t(*d.grid.shape)
    a, b = torch.zeros_like(u0), torch.zeros_like(u0)
    n1 = stencil_step.launches
    stencil_step(u0, u1, eng.adj, a, d.grid, d.sc)
    stencil_step_plain(u0, u1, eng.adj, b, d.grid, d.sc)
    torch.cuda.synchronize()
    assert stencil_step.launches == n1 + 1
    assert _rel(a, b) <= TOL[dtype]

    vh, gh = t(MMb, d.Nbl), t(MMb, d.Nbl)
    vh2, gh2, b2 = vh.clone(), gh.clone(), b.clone()
    k2 = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    n2 = boundary_update.launches
    boundary_update(b, u0, *k2, vh, gh, d.sc)
    boundary_update_plain(b2, u0, *k2, vh2, gh2, d.sc)
    torch.cuda.synchronize()
    assert boundary_update.launches == n2 + 1
    for x, y in ((b, b2), (vh, vh2), (gh, gh2)):
        assert _rel(x, y) <= TOL[dtype]


def _open_top_sim(fcc):
    """An open-top lossy box: its side walls' lossy nodes reach the top
    ABC layer, so K2, K3 and K6 run in their ABC modes."""
    sim = synthetic_box_sim(1.2, 1.0, 0.9, h=0.1 if fcc else 0.08, Nt=64,
                            fcc=fcc, lossy=True, insig_type="hann10",
                            diff_source=False, open_top=True)
    return sort_sim(fold_fcc_sim(sim)) if fcc else sim


def _open_top_engine(fcc, dtype, **kw):
    sim = _open_top_sim(fcc)
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=dtype, device="cuda", **kw)


def _open_top_sharded(fcc, dtype, D, **kw):
    sim = _open_top_sim(fcc)
    return make_sharded_engine(consts=sim.consts, vox=sim.vox,
                               comms=sim.comms, mats=sim.mats,
                               devices=["cuda"] * D, dtype=dtype, **kw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fcc", [False, True])
def test_k2_abc_mode_matches_plain_bitwise(cuda, fcc, dtype):
    eng = _open_top_engine(fcc, dtype)
    d = eng.data
    assert eng.abcq is not None and int((eng.abcq > 0).sum()) > 0
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    u0, un, vh, gh = t(*d.grid.shape), t(*d.grid.shape), t(MMb, d.Nbl), \
        t(MMb, d.Nbl)
    k2 = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    a, va, ga = un.clone(), vh.clone(), gh.clone()
    n2 = boundary_update.launches
    boundary_update(a, u0, *k2, va, ga, d.sc, eng.abcq)
    boundary_update_plain(un, u0, *k2, vh, gh, d.sc, eng.abcq)
    torch.cuda.synchronize()
    assert boundary_update.launches == n2 + 1
    for x, y in ((a, un), (va, vh), (ga, gh)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fcc", [False, True])
def test_open_top_kernel_path_matches_plain_path_fp64(cuda, fcc):
    uk = _open_top_engine(fcc, np.float64).run(verbose=False)
    up = _open_top_engine(fcc, np.float64,
                          use_kernels=False).run(verbose=False)
    assert np.abs(up).max() > 0
    assert np.abs(uk - up).max() / np.abs(up).max() <= 1e-12


@pytest.mark.parametrize("TB", [2, 3, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fcc", [False, True])
def test_k3_abc_mode_matches_plain_bitwise(cuda, fcc, dtype, TB):
    eng = _open_top_engine(fcc, dtype, backend="tb", tb=TB)
    st = eng.tb_scene
    assert st.abcq is not None and int((st.abcq > 0).sum()) > 0
    rng = np.random.default_rng(6)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    outs = _sweep_pair(tb_sweep, tb_sweep_plain, st, t, eng.data.Nbl, TB,
                       dtype, cuda)
    inner = (slice(1, -1),) * 3
    for i, (a, b) in enumerate(zip(*outs)):
        if i < 2:
            a, b = a[inner], b[inner]
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("TB", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fcc", [False, True])
def test_k6_abc_mode_matches_plain_bitwise(cuda, fcc, dtype, TB):
    eng = _open_top_sharded(fcc, dtype, 2, backend="tb", tb=TB)
    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    for sh in eng.shards:
        assert sh.tb_scene.abcq is not None
        outs = _sweep_pair(tb_sweep_shard, tb_sweep_shard_plain,
                           sh.tb_scene, t, sh.bnl.numel(), TB, dtype, cuda)
        own = (slice(*sh.slab.owned), slice(1, -1), slice(1, -1))
        mine = torch.from_numpy(sh.part.node_own).to(cuda)
        for i, (a, b) in enumerate(zip(*outs)):
            a, b = (a[own], b[own]) if i < 2 else \
                (a[:, mine], b[:, mine]) if i < 4 else (a, b)
            assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("fcc", [False, True])
def test_open_top_tb_routes_equal_step_route(cuda, fcc):
    u = _open_top_engine(fcc, np.float64).run(verbose=False)
    for kw in ({"backend": "tb", "tb": 3}, {"backend": "pair"},
               {"backend": "tb", "tb": 8}):
        n3 = tb_sweep.launches
        e = _open_top_engine(fcc, np.float64, **kw)
        assert np.array_equal(e.run(verbose=False), u)
        assert tb_sweep.launches == n3 + e.Nt // e.TB
    ps = pad_x_interior(_open_top_sim(fcc), 2)
    u2 = TorchEngine(consts=ps.consts, vox=ps.vox, comms=ps.comms,
                     mats=ps.mats, dtype=np.float64,
                     device="cuda").run(verbose=False)
    for backend in ("tb", "pair"):
        n6 = tb_sweep_shard.launches
        e = _open_top_sharded(fcc, np.float64, 2, backend=backend)
        assert np.array_equal(e.run(verbose=False), u2)
        assert tb_sweep_shard.launches == n6 + 2 * (e.Nt // e.TB)


@pytest.mark.parametrize("fcc", [False, True])
def test_open_top_energy_route_on_card(cuda, fcc):
    """The energy route on an open room: the energies within 1e-12 of the
    plain path's, the receivers bitwise equal to the energy-off run; the
    balance is the reference's and is not held under 1e-10 here."""
    k = _open_top_engine(fcc, np.float64, energy_on=True)
    u = k.run(verbose=False)
    p = _open_top_engine(fcc, np.float64, energy_on=True, use_kernels=False)
    p.run(verbose=False)
    for a in ("H_tot", "E_lost", "E_in"):
        ref = getattr(p, a)
        assert np.abs(getattr(k, a) - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(k.energy_balance() - p.energy_balance()).max() < 1e-12
    assert np.array_equal(u, _open_top_engine(fcc, np.float64).run(
        verbose=False))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_path_matches_plain_path_fp64(cuda, name):
    uk = _engine(name, np.float64).run(verbose=False)
    up = _engine(name, np.float64, use_kernels=False).run(verbose=False)
    assert np.abs(up).max() > 0
    assert np.abs(uk - up).max() / np.abs(up).max() <= 1e-12


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    eng = _engine("fcc-folded", np.float32)
    d = eng.data
    u0 = torch.zeros(d.grid.shape, device=cuda)
    u1, out = torch.zeros_like(u0), torch.zeros_like(u0)
    with pytest.raises(ValueError):      # mixed devices
        stencil_step(u0, u1.cpu(), eng.adj, out, d.grid, d.sc)
    with pytest.raises(ValueError):      # non-contiguous
        stencil_step(u0, u1.transpose(0, 1).contiguous().transpose(0, 1),
                     eng.adj, out, d.grid, d.sc)
    with pytest.raises(TypeError):       # wrong state dtype
        boundary_update(out, u0, eng.bnl, eng.ssaf, eng.mat, eng.coef_table,
                        eng.beta, torch.zeros((MMb, d.Nbl), device=cuda,
                                              dtype=torch.float64),
                        torch.zeros((MMb, d.Nbl), device=cuda), d.sc)


def _edge_points(st, src_rows, rcv_rows):
    """`st` with its sources and receivers moved onto the edges of the
    kernel's chunks and tiles: local rows `src_rows` and `rcv_rows`, each
    at the last owned and the first next column of the first y and z
    tiles."""
    _, By, Bz = st.lists.box
    Nx, Ny, Nz = st.shape
    ys = [min(y, Ny - 2) for y in (By, By + 1)]
    zs = [min(z, Nz - 2) for z in (Bz, Bz + 1)]

    def pts(rows):
        xyz = np.array([(x, y, z) for x in rows for y in ys for z in zs],
                       np.int64).reshape(-1, 3)
        flat = (xyz[:, 0] * Ny + xyz[:, 1]) * Nz + xyz[:, 2]
        return (torch.from_numpy(flat).to(st.adj.device),
                torch.from_numpy(xyz.astype(np.int32)).to(st.adj.device))

    (si, sc), (ri, rc) = pts(src_rows), pts(rcv_rows)
    return dataclasses.replace(
        st, in_ixyz=si, src_xyz=sc, out_ixyz_f=ri, rcv_xyz=rc,
        src_k2=bool(np.isin(si.cpu().numpy(), st.bnl.cpu().numpy()).any()))


def _with_node_source(st):
    """`st` with one more source, on its first lossy node (so the kernel
    adds the sources behind K2)."""
    node = st.bnl[:1]
    Nx, Ny, Nz = st.shape
    i = int(node[0])
    xyz = torch.tensor([[i // (Ny * Nz), i // Nz % Ny, i % Nz]],
                       dtype=torch.int32, device=node.device)
    return dataclasses.replace(
        st, in_ixyz=torch.cat([st.in_ixyz, node]),
        src_xyz=torch.cat([st.src_xyz, xyz]), src_k2=True)


def _sweep_pair(fn_k, fn_p, st, t, nbl, TB, dtype, cuda):
    """(kernel outputs, plain outputs) of one sweep from the same random
    state: out0, out1, vh_out, gh_out and the taps."""
    u0, u1 = t(*st.shape), t(*st.shape)
    vh, gh = t(MMb, nbl), t(MMb, nbl)
    sig = t(TB, st.in_ixyz.numel())
    nr = st.out_ixyz_f.numel()
    outs = []
    for fn in (fn_k, fn_p):
        o = [torch.full_like(u0, float("nan")) for _ in range(2)]
        s2 = [torch.full_like(vh, float("nan")) for _ in range(2)]
        taps = torch.full((TB - 2, nr), float("nan"), dtype=u0.dtype,
                          device=cuda) if TB > 2 else None
        n = fn_k.launches
        fn(st, u0, u1, *o, vh, gh, *s2, sig, taps)
        torch.cuda.synchronize()
        assert fn_k.launches == n + (fn is fn_k)
        outs.append(o + s2 + ([taps] if TB > 2 else []))
    return outs


# chunk 7: several chunks a grid, the last one partial (Nx - 2 = 31 or 26
# rows), and a source on a lossy node; the y and z extents are no
# multiples of the planned tiles
@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("TB", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_tb_sweep_matches_plain(cuda, monkeypatch, name, dtype, TB, chunk):
    if chunk:
        monkeypatch.setattr(ktb, "CHUNK", chunk)
    eng = _engine(name, dtype, backend="tb", tb=TB)
    Cx, Nx = eng.tb_scene.lists.box[0], eng.data.grid.Nx
    rows = [x for x in (Cx, Cx + 1) if x <= Nx - 2]
    st = _edge_points(eng.tb_scene, rows, rows)
    if chunk:
        st = _with_node_source(st)
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    outs = _sweep_pair(tb_sweep, tb_sweep_plain, st, t, eng.data.Nbl, TB,
                       dtype, cuda)
    inner = (slice(1, -1),) * 3
    for i, (a, b) in enumerate(zip(*outs)):
        if i < 2:
            a, b = a[inner], b[inner]
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("backend", ["pair", "tb"])
@pytest.mark.parametrize("name", list(CASES))
def test_tb_route_matches_plain_path_fp64(cuda, name, backend):
    uk = _engine(name, np.float64, backend=backend).run(nt=29,
                                                        verbose=False)
    up = _engine(name, np.float64, backend="step",
                 use_kernels=False).run(nt=29, verbose=False)
    assert np.abs(up).max() > 0
    assert np.abs(uk - up).max() / np.abs(up).max() <= 1e-12


# tails after whole float4s and after whole blocks of 8 float4 a thread,
# and a size under one float4
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 3, 4 * (8 * 256 * 7 + 5)
                               + 2, 4 * 8 * 256 * 3 + 1000, 17, 3])
def test_stream_matches_plain(cuda, n):
    x = torch.randn(n, device=cuda)
    y, y2 = torch.empty_like(x), torch.empty_like(x)
    n0 = stream.launches
    s = stream("read", x)
    assert abs(float(s) - float(stream_plain("read", x))) \
        <= 1e-12 * float(x.abs().sum(dtype=torch.float64))
    stream("copy", x, y)
    assert torch.equal(y, stream_plain("copy", x, y2))
    stream("write", y=y, value=2.5)
    assert torch.equal(y, stream_plain("write", y=y2, value=2.5))
    torch.cuda.synchronize()
    assert stream.launches == n0 + 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_stencil_step_shard_matches_plain(cuda, name, dtype):
    eng = _sharded(name, dtype, 4, backend="step")
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    for sh in eng.shards:          # first, middle and last slabs
        sl = sh.slab
        u0, u1 = t(*sl.shape), t(*sl.shape)
        a = torch.full_like(u0, float("nan"))
        b = a.clone()
        n = stencil_step_shard.launches
        stencil_step_shard(u0, u1, sh.adj, a, sl, eng.data.sc)
        stencil_step_shard_plain(u0, u1, sh.adj, b, sl, eng.data.sc)
        torch.cuda.synchronize()
        assert stencil_step_shard.launches == n + 1
        own = (slice(*sl.owned), slice(1, -1), slice(1, -1))
        assert torch.isfinite(a[own]).all()
        assert _rel(a[own], b[own]) <= TOL[dtype]
        assert torch.isnan(a[:sl.G]).all() and torch.isnan(a[-sl.G:]).all()


# ragged grids (Nx, Ny, Nz): the minimum; two y tiles and three z tiles of
# 32, each with a part-filled last one; fewer y rows than a block's teams;
# a long z and rows past a chunk of 64
RAGGED = [(5, 5, 5), (13, 45, 71), (9, 6, 133), (71, 11, 200)]
# tiles forced on the launch: (By, Bz, Cx), 1-3 rows a thread, both widths
FORCED = {"planned": None, "64-wide": (12, 64, 3), "32-wide": (8, 32, 2)}


@pytest.mark.parametrize("geometry", list(FORCED))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["cart", "fcc", "fcc-folded"])
@pytest.mark.parametrize("shape", RAGGED)
def test_k1_k5_bitwise_on_ragged_grids(cuda, monkeypatch, shape, kind,
                                       dtype, geometry):
    if FORCED[geometry] is not None:
        By, Bz, Cx = FORCED[geometry]
        monkeypatch.setattr(kstencil, "plan_k1", lambda *a: kstencil.
                            K1Geometry(By, Bz, Cx, (), 0))
    fcc = kind != "cart"
    g = GridSpec(*shape, 2 if kind == "fcc-folded" else int(fcc))
    sc = SchemeCoeffs.make(0.57 if fcc else 0.55, 0.33, fcc)
    rng = np.random.default_rng(sum(shape))
    nn = 12 if fcc else 6
    # air (every leg) at two points in three, random legs elsewhere
    bits = rng.integers(0, 1 << nn, shape)
    bits[rng.random(shape) < 0.67] = (1 << nn) - 1
    adj = torch.from_numpy(bits.astype(np.int32)).to(
        torch.uint16 if fcc else torch.uint8).to(cuda)
    t = lambda: torch.from_numpy(rng.standard_normal(shape).astype(
        dtype)).to(cuda)
    u0, u1 = t(), t()
    a = torch.full_like(u0, float("nan"))
    b = a.clone()
    n = stencil_step.launches
    stencil_step(u0, u1, adj, a, g, sc)
    stencil_step_plain(u0, u1, adj, b, g, sc)
    torch.cuda.synchronize()
    assert stencil_step.launches == n + 1
    inner = (slice(1, -1),) * 3
    assert torch.isfinite(a[inner]).all()
    assert torch.equal(a[inner], b[inner])
    halo = torch.ones(shape, dtype=torch.bool, device=cuda)
    halo[inner] = False
    assert torch.isnan(a[halo]).all()
    # K5 on the slabs of a four-way split (a slab of one or two rows on the
    # short grids), each bitwise its plain version and the whole grid's rows
    cuts = np.linspace(1, g.Nx - 1, 5).astype(int)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi <= lo:
            continue
        sl = SlabSpec(g, int(hi - lo), 1, int(lo - 1))
        rows = slice(lo - 1, hi + 1)
        ka = torch.full_like(u0[rows], float("nan"))
        kb = ka.clone()
        args = (u0[rows].contiguous(), u1[rows].contiguous(),
                adj[rows].contiguous())
        n = stencil_step_shard.launches
        stencil_step_shard(*args, ka, sl, sc)
        stencil_step_shard_plain(*args, kb, sl, sc)
        torch.cuda.synchronize()
        assert stencil_step_shard.launches == n + 1
        assert torch.equal(ka[1:-1, 1:-1, 1:-1], kb[1:-1, 1:-1, 1:-1])
        assert torch.equal(ka[1:-1, 1:-1, 1:-1], a[lo:hi, 1:-1, 1:-1])
        assert torch.isnan(ka[0]).all() and torch.isnan(ka[-1]).all()


# ragged grids and two whose Nz-2 is a whole number of 32-point words
COMPACT_SHAPES = RAGGED + [(9, 13, 66), (11, 40, 34)]


@pytest.mark.parametrize("geometry", list(FORCED))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["cart", "fcc", "fcc-folded"])
@pytest.mark.parametrize("shape", COMPACT_SHAPES)
def test_k1_on_the_compact_form_bitwise(cuda, monkeypatch, shape, kind,
                                        dtype, geometry):
    """K1 on the compact form, bitwise K1 on the packed grid and the plain
    version: air at nine points in ten, every point flagged at z = 1, 32,
    33 and Nz-2, a fully flagged row and an all-air row; tiles 64 and 32
    wide; the launch's geometry counts the form's flagged points and
    non-zero words."""
    if FORCED[geometry] is not None:
        By, Bz, Cx = FORCED[geometry]
        monkeypatch.setattr(kstencil, "plan_k1", lambda *a: kstencil.
                            K1Geometry(By, Bz, Cx, (), 0))
    fcc = kind != "cart"
    g = GridSpec(*shape, 2 if kind == "fcc-folded" else int(fcc))
    sc = SchemeCoeffs.make(0.57 if fcc else 0.55, 0.33, fcc)
    rng = np.random.default_rng(sum(shape))
    nn = 12 if fcc else 6
    full = (1 << nn) - 1
    bits = rng.integers(0, full, shape)
    bits[rng.random(shape) < 0.9] = full
    for z in (1, 32, 33, shape[2] - 2):
        if z <= shape[2] - 2:
            bits[:, :, z] = rng.integers(0, full, shape[:2])
    bits[:, 1, :] = rng.integers(0, full, (shape[0], shape[2]))
    bits[:, 2, :] = full
    adj = torch.from_numpy(bits.astype(np.int32)).to(
        torch.uint16 if fcc else torch.uint8).to(cuda)
    c = kstencil.CompactAdj.from_grid(adj)
    inner = (slice(1, -1),) * 3
    assert torch.equal(c.to_grid()[inner], adj[inner])
    t = lambda: torch.from_numpy(rng.standard_normal(shape).astype(
        dtype)).to(cuda)
    u0, u1 = t(), t()
    a, b, p = (torch.full_like(u0, float("nan")) for _ in range(3))
    n = stencil_step.launches
    stencil_step(u0, u1, c, a, g, sc)
    geo = stencil_step.geometry
    stencil_step(u0, u1, adj, b, g, sc)
    stencil_step_plain(u0, u1, c, p, g, sc)
    torch.cuda.synchronize()
    assert stencil_step.launches == n + 2
    assert (geo.flagged, geo.words) == (c.flagged, c.words) and c.words
    assert stencil_step.geometry.flagged is None
    assert torch.isfinite(a[inner]).all()
    assert torch.equal(a[inner], b[inner]) and torch.equal(a[inner],
                                                           p[inner])
    halo = torch.ones(shape, dtype=torch.bool, device=cuda)
    halo[inner] = False
    assert torch.isnan(a[halo]).all()


@pytest.mark.parametrize("cell", ["fcc_lossy_box.step",
                                  "cart_lossy_box.step"])
def test_cell_engines_hold_the_compact_form(cuda, cell):
    """The benchmark cells' 1.08e9-point engines hold the compact form and
    no packed grid: what the engine's uploads allocate is the compact
    form, the node tables and the signals (`engine_static_gib`)."""
    from rirbench import program, spec

    c = spec.load_cell(cell)
    cfg, traffic = c["config"], c["traffic"]
    sim = program.scene(cfg, traffic, *program.request(cfg, traffic, 1))
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    eng = program.engine(cfg, traffic, sim, "cuda")
    static = torch.cuda.memory_allocated() - m0
    g = eng.data.grid
    assert isinstance(eng.adj, kstencil.CompactAdj)
    assert eng.adj.nbytes < 0.28 * 2**30
    # the node tables and signals take 0.08-0.1 GiB; the grid 1.0-2.0
    assert static < eng.adj.nbytes + 0.2 * 2**30 < g.n_interior
    assert "adj_grid" not in vars(eng.data)     # nor on the host
    del eng, sim
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("TB", [2, 3, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_tb_sweep_shard_matches_plain(cuda, monkeypatch, name, dtype, TB,
                                      chunk):
    if chunk:
        monkeypatch.setattr(ktb, "CHUNK", chunk)
    eng = _sharded(name, dtype, 2, backend="tb", tb=TB)
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    for sh in eng.shards:
        sl = sh.slab
        Cx = sh.tb_scene.lists.box[0]
        # sources on the chunk edge and in the ghost bands; receivers, which
        # the owner alone writes, on owned rows
        lo, hi = sl.owned
        edge = [lo + Cx - 1, lo + Cx]
        st = _edge_points(sh.tb_scene, edge + [lo - 1, hi],
                          [x for x in edge if x < hi])
        if chunk and sh.bnl.numel():
            st = _with_node_source(st)
        outs = _sweep_pair(tb_sweep_shard, tb_sweep_shard_plain, st, t,
                           sh.bnl.numel(), TB, dtype, cuda)
        own = (slice(*sl.owned), slice(1, -1), slice(1, -1))
        mine = torch.from_numpy(sh.part.node_own).to(cuda)
        for b2 in outs[0][2:4]:      # the owners write the ghost-band slots
            assert torch.isnan(b2[:, ~mine]).all()
        for i, (a, b) in enumerate(zip(*outs)):
            a, b = (a[own], b[own]) if i < 2 else \
                (a[:, mine], b[:, mine]) if i < 4 else (a, b)
            assert torch.isfinite(a).all()
            if b.numel():
                assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("backend", ["step", "pair", "tb"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_routes_match_plain_path_fp64(cuda, name, backend):
    for D in (2, 4):
        sim = pad_x_interior(_sim(name), D)   # the grid the engine runs
        up = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                         mats=sim.mats, dtype=np.float64, device="cuda",
                         backend="step", use_kernels=False).run(
                             nt=29, verbose=False)
        uk = _sharded(name, np.float64, D, backend=backend).run(
            nt=29, verbose=False)
        assert np.abs(up).max() > 0
        assert np.abs(uk - up).max() / np.abs(up).max() <= 1e-12


# ---- energy route, resume and the modal filter on the card
@pytest.mark.parametrize("name", list(CASES))
def test_energy_route_on_card(cuda, name):
    """The energy route: K1e, K2 (on lossy scenes) and K7's boundary pass
    once a step and K1 never; the balance, the energies against the plain
    path on the card, the receivers bitwise equal to the energy-off
    run."""
    k = _engine(name, np.float64, energy_on=True)
    wrappers = (stencil_energy_step, stencil_step, boundary_update,
                energy_boundary_pass)
    n = [w.launches for w in wrappers]
    u = k.run(verbose=False)
    assert [w.launches - a for w, a in zip(wrappers, n)] == [
        k.Nt, 0, k.Nt if k.data.Nbl else 0, k.Nt]
    p = _engine(name, np.float64, energy_on=True, use_kernels=False)
    p.run(verbose=False)
    assert np.abs(k.energy_balance()).max() < 1e-10 and k.E_lost[-1] > 0
    for a in ("H_tot", "E_lost", "E_in"):
        ref = getattr(p, a)
        assert np.abs(getattr(k, a) - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.array_equal(u, _engine(name, np.float64).run(verbose=False))


@pytest.mark.parametrize("kw", [{"backend": "tb", "tb": 3},
                                {"backend": "pair"}])
def test_resume_off_a_sweep_boundary_on_card(cuda, kw, tmp_path):
    ck = tmp_path / "state.npz"
    a = _engine("fcc-folded", np.float64, **kw).run(nt=29, verbose=False)
    _engine("fcc-folded", np.float64, **kw).run(
        nt=23, verbose=False, chunk=5, checkpoint_every=2,
        checkpoint_path=ck)
    b = _engine("fcc-folded", np.float64, **kw).run(
        nt=29, verbose=False, chunk=5, checkpoint_path=ck, resume=True)
    assert np.array_equal(a, b)


def _energy_inputs(eng, cuda, dtype, seed):
    """A random state for K1e and K7 (L u^{n-1} with zero halos, as the
    engine keeps it) and fresh outputs for a kernel and a plain call."""
    d = eng.data
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(dtype)).to(cuda)
    g = d.grid.shape
    u0, u1, unew, Lu = t(*g), t(*g), t(*g), torch.zeros(g, dtype=eng.dtype,
                                                       device=cuda)
    Lu[1:-1, 1:-1, 1:-1] = t(*(n - 2 for n in g))
    vh, vh_prev, gh_prev = t(MMb, d.Nbl), t(MMb, d.Nbl), t(MMb, d.Nbl)
    sig = t(d.in_ixyz.size)

    def outs():
        z = lambda: torch.zeros((), dtype=eng.dtype, device=cuda)
        part = torch.zeros(scratch_size(d.grid, d.Nbl), dtype=torch.float64,
                           device=cuda)
        return Lu.clone(), part, z(), z(), z()

    return (u0, u1, unew, vh, vh_prev, gh_prev, sig), outs


KERNELS = (stencil_energy_step, energy_boundary_pass)
PLAIN = (stencil_energy_step_plain, energy_boundary_pass_plain)


def _energy_step(fns, eng, es, ins, outs):
    """K1e, then K7's boundary pass (fns: the kernels or their plain
    versions), from the inputs into fresh outputs: (u^{n+1}, L u^n, H,
    dE_lost, dE_in)."""
    u0, u1, unew, vh, vh_prev, gh_prev, sig = ins
    Lu, part, H, E_lost, E_in = outs()
    out = torch.zeros_like(u0)
    fns[0](u0, u1, eng.adj, out, Lu, part, eng.data.grid, eng.data.sc, es)
    fns[1](es, unew, u0, vh, vh_prev, gh_prev, sig, part, H, E_lost, E_in)
    torch.cuda.synchronize()
    return out, Lu, H, E_lost, E_in


def _assert_energies(k, p, eng, ins, outs, fp32_terms=3):
    """The energies k (the kernels') against p (the plain versions'):
    <= 1e-12 in fp64; in fp32 the first `fp32_terms` no further from the
    fp64 value of the same terms (the fp64 plain versions on the same
    inputs, with the fp32 run's constants) than the fp32 plain versions
    are (K1e and K7 sum in fp64)."""
    if eng.dtype == torch.float64:
        for a, b in zip(k, p):
            assert _rel(a, b) <= 1e-12
        return
    es = eng.energy_scene
    es64 = dataclasses.replace(es, ssaf=es.ssaf.double(),
                               def_table=es.def_table.double())
    r = _energy_step(PLAIN, eng, es64, tuple(x.double() for x in ins),
                     lambda: tuple(x.double() for x in outs()))[2:]
    for a, b, ref in list(zip(k, p, r))[:fp32_terms]:
        assert abs(float(a) - float(ref)) <= abs(float(b) - float(ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_energy_passes_match_plain(cuda, name, dtype):
    """K7's boundary pass, on the scratch K1e filled, vs the plain versions
    from a random state: H, dE_lost and dE_in as `_assert_energies` holds
    them."""
    eng = _engine(name, dtype, energy_on=True)
    ins, outs = _energy_inputs(eng, cuda, dtype, seed=7)
    n = energy_boundary_pass.launches
    k = _energy_step(KERNELS, eng, eng.energy_scene, ins, outs)
    p = _energy_step(PLAIN, eng, eng.energy_scene, ins, outs)
    assert energy_boundary_pass.launches == n + 1
    _assert_energies(k[2:], p[2:], eng, ins, outs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_energy_step_matches_plain(cuda, name, dtype):
    """K1e vs its plain version from a random state: u^{n+1} and L u^n
    bitwise; after K7's boundary pass H, dE_lost and dE_in <= 1e-12 of the
    plain versions' in fp64, and in fp32 H, the one that reads K1e's sums,
    no further from its fp64 value than the fp32 plain versions'."""
    eng = _engine(name, dtype, energy_on=True)
    ins, outs = _energy_inputs(eng, cuda, dtype, seed=11)
    n = stencil_energy_step.launches
    k = _energy_step(KERNELS, eng, eng.energy_scene, ins, outs)
    p = _energy_step(PLAIN, eng, eng.energy_scene, ins, outs)
    assert stencil_energy_step.launches == n + 1
    inner = (slice(1, -1),) * 3
    assert torch.equal(k[0][inner], p[0][inner]) and torch.equal(k[1], p[1])
    _assert_energies(k[2:], p[2:], eng, ins, outs, fp32_terms=1)


def test_energy_resume_on_card(cuda, tmp_path):
    ck = tmp_path / "state.npz"
    a = _engine("fcc-folded", np.float64, energy_on=True)
    a.run(nt=29, verbose=False)
    _engine("fcc-folded", np.float64, energy_on=True).run(
        nt=23, verbose=False, chunk=5, checkpoint_every=2,
        checkpoint_path=ck)
    b = _engine("fcc-folded", np.float64, energy_on=True)
    b.run(nt=29, verbose=False, chunk=5, checkpoint_path=ck, resume=True)
    for k in ("u_out", "H_tot", "E_lost", "E_in"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_modal_filter_on_card(cuda):
    from pffdtd_tpu_torch.analysis.air_abs import (apply_modal_filter,
                                                   apply_modal_filter_plain)

    x = np.random.default_rng(5).standard_normal((2, 960))
    y = apply_modal_filter(x, 48000.0, 20.0, 50.0, device="cuda")
    yn = apply_modal_filter_plain(x, 48000.0, 20.0, 50.0)
    assert np.abs(y - yn).max() <= 1e-12 * np.abs(yn).max()


@pytest.mark.parametrize("nt", [1, 130, 2049 + 3])
def test_modal_scan_matches_plain(cuda, nt):
    """K8 vs modal_recurrence_plain <= 1e-12, one launch a call; lengths
    below a block, past one, and past one staged chunk of u."""
    from pffdtd_tpu_torch.analysis.air_abs import (_modal_setup,
                                                   modal_recurrence,
                                                   modal_recurrence_plain)

    x = np.random.default_rng(nt).standard_normal((3, nt))
    setup = _modal_setup(x, 48000.0, 20.0, 50.0, 0.0)
    n = modal_scan.launches
    P = modal_recurrence(*setup, device="cuda")
    assert modal_scan.launches == n + 1
    Pn = modal_recurrence_plain(*setup)
    assert np.abs(P - Pn).max() <= 1e-12 * np.abs(Pn).max()


@pytest.mark.parametrize("nt, Fs, nch", [(4803, 48000.0, 2),
                                         (2052, 8000.0, 5),
                                         (1030, 48000.0, 8),
                                         (12000, 8000.0, 1),
                                         (3000, 48000.0, 3)])
def test_modal_scan_matches_split_plain(cuda, nt, Fs, nch):
    """K8 vs `modal_split_plain` on the card <= 1e-12 of max|P|, and K8's
    loop modes (q < q0, q >= Nt - q0) bitwise equal to the numpy loop; one
    to eight channels (channel groups of 1-4), lengths past one staged
    chunk of each path."""
    from pffdtd_tpu_torch.analysis.air_abs import (_modal_setup,
                                                   modal_recurrence,
                                                   modal_recurrence_plain)
    from pffdtd_tpu_torch.kernels.modal import loop_modes, modal_split_plain

    x = np.random.default_rng(nt + nch).standard_normal((nch, nt))
    setup = _modal_setup(x, Fs, 20.0, 50.0, 0.0)
    P = modal_recurrence(*setup, device="cuda")
    ts = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in setup]
    Ps = modal_split_plain(*ts, torch.arange(nt, device="cuda"))
    Ps = Ps.cpu().numpy()
    assert np.abs(P - Ps).max() <= 1e-12 * np.abs(Ps).max()
    loop = loop_modes(np.arange(nt), nt)
    Pn = modal_recurrence_plain(*setup)
    assert np.array_equal(P[:, loop], Pn[:, loop])


@pytest.mark.parametrize("backend", ["step", "tb"])
@pytest.mark.parametrize("fcc", [False, True])
def test_voxelized_sloped_room_matches_plain_path(cuda, fcc, backend):
    """A room built by the port's own setup (sloped ceiling, two lossy
    materials, staircased off-plane nodes; FCC folded and sorted) on the
    kernel routes vs the plain path on the card, fp64 <= 1e-12 and fp32
    <= 1e-5 of max |u_out|."""
    from pffdtd_tpu_torch.scene import make_sloped_room, mats_from_DEF_list
    from pffdtd_tpu_torch.scene_setup import sim_setup_from_room

    DEF3 = np.array([[2.0, 5.0, 30.0], [1.0, 10.0, 300.0],
                     [0.5, 8.0, 3000.0]])
    sim = sim_setup_from_room(
        make_sloped_room(), mats_from_DEF_list([DEF3, 2.0 * DEF3]),
        duration=0.008, insig_type="hann10", h=0.1, fcc_flag=fcc,
        vox_backend="numpy")
    if fcc:
        sim = sort_sim(fold_fcc_sim(sim))
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms, mats=sim.mats,
              device="cuda")
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        up = TorchEngine(**kw, dtype=dtype, use_kernels=False).run(
            verbose=False)
        uk = TorchEngine(**kw, dtype=dtype, backend=backend).run(
            verbose=False)
        scale = np.abs(up).max()
        assert scale > 0 and np.isfinite(uk).all()
        assert np.abs(uk - up).max() / scale <= tol, dtype


@pytest.mark.parametrize("kw", [{"backend": "step"},
                                {"backend": "tb", "tb": 3},
                                {"backend": "pair"}, {"energy_on": True}],
                         ids=["step", "tb", "pair", "energy"])
def test_fp32_eps_routes_match_plain(cuda, kw):
    """fp32_eps set by hand in fp64 on the kernel routes vs the plain path
    with the same shift, <= 1e-12 (energies too)."""
    k = _engine("fcc-folded", np.float64, fp32_eps=1e-3, **kw)
    p = _engine("fcc-folded", np.float64, fp32_eps=1e-3, use_kernels=False,
                **{"energy_on": kw.get("energy_on", False)})
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert rel(k.run(verbose=False), p.run(verbose=False)) <= 1e-12
    if k.energy_on:
        for a in ("H_tot", "E_lost", "E_in"):
            assert rel(getattr(k, a), getattr(p, a)) <= 1e-12, a


def test_split_probe_on_card(cuda, capsys):
    """bn_ms_per_step times K2 with CUDA events on the step route; a
    verbose chunked run prints the split and keeps its results bitwise."""
    quiet = _engine("fcc-folded", np.float32)
    u_q = quiet.run(chunk=7, verbose=False)
    loud = _engine("fcc-folded", np.float32)
    n0 = boundary_update.launches
    u_v = loud.run(chunk=7)
    assert boundary_update.launches - n0 == 30 + 1 + BN_ITERS
    assert " / bn " in capsys.readouterr().out
    bn = loud.bn_ms_per_step()
    assert isinstance(bn, float) and 0 < bn < 100
    assert np.array_equal(u_v, u_q)
    for k in (0, 1, 3, 4):
        assert torch.equal(loud.state[k], quiet.state[k])



def test_spans_read_the_peak_of_two_runs(cuda):
    """A run drops the last run's state before it allocates its own: the
    second run's `run.state` enters with what the first entered with
    (within 1 MiB) and reads the first run's peak at its exit (within 1%),
    and the peak of both runs is what the engine held before them, one
    state and the receiver rows (within 1 MiB)."""
    eng = _engine("fcc-folded", np.float32)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()    # the engine's uploads
    since = time.perf_counter_ns()
    eng.run(nt=8, verbose=False)
    eng.run(nt=8, verbose=False)
    first, second = [r for r in spans.records(since)
                     if r.name == "run.state"]
    peak = torch.cuda.max_memory_allocated()
    state = sum(t.numel() * t.element_size() for t in eng.state)
    rows = 8 * eng.data.out_ixyz.size * eng.state[0].element_size()
    assert first.mem_out - first.mem_in >= state
    assert abs(second.mem_in - first.mem_in) <= MIB
    assert second.mem_peak - second.mem_in >= state
    assert abs(second.mem_peak - first.mem_peak) <= 0.01 * peak
    assert abs(second.mem_peak - peak) <= 0.01 * peak
    assert peak <= base + state + rows + MIB
    assert abs(second.mem_out - first.mem_out) <= 0.01 * peak

# ---- more than one card: one slab per card, and kernels on another card
@pytest.fixture
def cards(cuda):
    """cuda:0 .. cuda:{D-1}, D = min(4, the cards present): one slab a
    card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards, this machine has {n}")
    return [f"cuda:{i}" for i in range(min(4, n))]


def _card_sim(scene):
    return _open_top_sim(False) if scene == "cart-open" else _sim(scene)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("backend", ["step", "pair", "tb"])
@pytest.mark.parametrize("scene", ["cart", "fcc-folded", "cart-open"])
def test_one_slab_per_card_equals_slabs_on_one_card(cards, scene, backend,
                                                    dtype):
    """Each x-slab route with one slab per card (K5, K6 and K2, in their ABC
    modes on the open-top box, launched on cards 1-3) against the same
    engine with every slab on cuda:0: receivers and final state bitwise,
    launches counted, the exchange timed on every card."""
    sim, D = _card_sim(scene), len(cards)
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
              mats=sim.mats, dtype=dtype, backend=backend, tb=3)
    many = make_sharded_engine(**kw, devices=cards)
    assert [sh.dev for sh in many.shards] == list(map(torch.device, cards))
    n5, n6 = stencil_step_shard.launches, tb_sweep_shard.launches
    u = many.run(nt=29, verbose=False, time_exchange=True)
    TB = many.TB or 1
    assert stencil_step_shard.launches - n5 == D * (29 % TB if TB > 1
                                                    else 29)
    assert tb_sweep_shard.launches - n6 == (D * (29 // TB) if TB > 1
                                             else 0)
    assert set(many.exchange_ms_by_card) == set(cards)
    assert many.exchange_ms == max(many.exchange_ms_by_card.values()) >= 0
    one = make_sharded_engine(**kw, devices=["cuda:0"] * D)
    u_one = one.run(nt=29, verbose=False)
    assert np.abs(u_one).max() > 0 and np.array_equal(u, u_one)
    for a, b in zip(many.global_state(), one.global_state()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [{"backend": "step"},
                                {"backend": "tb", "tb": 3},
                                {"backend": "pair"}, {"energy_on": True}],
                         ids=["step", "tb", "pair", "energy"])
def test_engine_on_another_card_equals_cuda0(cards, kw):
    """TorchEngine on cuda:1 (K1, K2, K3 in their ABC modes, K1e, K7,
    launched from a thread whose current card is cuda:0) bitwise its run
    on cuda:0."""
    sim = _open_top_sim(False)
    runs = []
    for dev in ("cuda:0", cards[1]):
        e = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                        mats=sim.mats, dtype=np.float64, device=dev, **kw)
        runs.append((e.run(verbose=False), e))
    (u0, e0), (u1, e1) = runs
    assert np.abs(u0).max() > 0 and np.array_equal(u0, u1)
    for a, b in zip(e0.state, e1.state):
        if torch.is_tensor(a):
            assert torch.equal(a, b.to(a.device))
    if e0.energy_on:
        for a in ("H_tot", "E_lost", "E_in"):
            assert np.array_equal(getattr(e0, a), getattr(e1, a))


def test_wrappers_launch_on_their_tensors_card(cards):
    """K4, K5, K6 and K8 called with tensors on cuda:1 while cuda:0 is the
    current card: each launches there (one launch counted) and equals its
    plain version."""
    from pffdtd_tpu_torch.analysis.air_abs import (_modal_setup,
                                                   modal_recurrence,
                                                   modal_recurrence_plain)

    dev = torch.device(cards[1])
    assert torch.cuda.current_device() == 0
    x = torch.randn(4099, device=dev)
    y = torch.empty_like(x)
    n = stream.launches
    stream("copy", x, y)
    assert stream.launches == n + 1 and torch.equal(y, x)
    eng = make_sharded_engine(
        **{k: getattr(_sim("fcc-folded"), k)
           for k in ("consts", "vox", "comms", "mats")},
        devices=["cuda:0", dev], dtype=np.float64, backend="tb", tb=3)
    sh = eng.shards[1]
    rng = np.random.default_rng(9)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dev)
    u0, u1 = t(*sh.slab.shape), t(*sh.slab.shape)
    a, b = torch.zeros_like(u0), torch.zeros_like(u0)
    n = stencil_step_shard.launches
    stencil_step_shard(u0, u1, sh.adj, a, sh.slab, eng.data.sc)
    stencil_step_shard_plain(u0, u1, sh.adj, b, sh.slab, eng.data.sc)
    assert stencil_step_shard.launches == n + 1
    own = (slice(*sh.slab.owned), slice(1, -1), slice(1, -1))
    assert _rel(a[own], b[own]) <= TOL[np.float64]
    outs = _sweep_pair(tb_sweep_shard, tb_sweep_shard_plain, sh.tb_scene, t,
                       sh.bnl.numel(), 3, np.float64, dev)
    mine = torch.from_numpy(sh.part.node_own).to(dev)
    for i, (k, p) in enumerate(zip(*outs)):
        k, p = (k[own], p[own]) if i < 2 else \
            (k[:, mine], p[:, mine]) if i < 4 else (k, p)
        assert torch.isfinite(k).all() and _rel(k, p) <= TOL[np.float64]
    setup = _modal_setup(rng.standard_normal((2, 130)), 48000.0, 20.0,
                         50.0, 0.0)
    n = modal_scan.launches
    P = modal_recurrence(*setup, device=str(dev))
    assert modal_scan.launches == n + 1
    Pn = modal_recurrence_plain(*setup)
    assert np.abs(P - Pn).max() <= 1e-12 * np.abs(Pn).max()
    assert torch.cuda.current_device() == 0
