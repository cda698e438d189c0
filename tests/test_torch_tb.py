"""The port's TB route (K3's plain version on the CPU) vs the JAX TB kernel
`build_fused_tb` in interpret mode, vs the port's own single-step route,
and the tile lists K3 reads.

- TorchEngine(backend="tb") vs the JAX `pallas_tb` route, run as
  tests/test_pallas_tb.py:18-68 runs it: TB = 3 lossy Cartesian, TB = 4
  lossy FCC, TB = 4 folded FCC; fp32 <= 1e-5 of max |u_out| (the bound the
  JAX TB tests hold it to against the XLA engine);
- backend "tb" and "pair" vs "step", bit for bit in fp32 and fp64, with
  Nt not a multiple of TB (the tail steps run), receivers and final state;
- `build_tile_lists`: every lossy node is owned by exactly one tile, and
  each tile's list holds exactly the nodes within TB-1 of its owned box,
  with their offsets and rings, against a brute-force scan (the rows,
  row pointers and y-z offsets K3 reads: tests/test_torch_data.py);
- `plan_tiles`: a block for every TB 2..8, fp32/fp64 and 6/12-pt stencil
  within the H100's 227 KB of shared memory, raising only where nothing
  fits; `plan_chunk`: evened-out chunks, shorter on a slab than on the
  whole grid.
"""

import numpy as np
import pytest
import torch

from pffdtd_tpu.demo import synthetic_box_sim as jax_box
from pffdtd_tpu.prep import fold_fcc_sim, rotate_sim, sort_sim

import test_pallas_tb as tpt
from pffdtd_tpu_torch import scene
from pffdtd_tpu_torch.engine.data import EngineData, GridSpec, \
    build_tile_lists, tile_bounds
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine, pick_route
from pffdtd_tpu_torch.kernels import tb as ktb

torch.set_num_threads(2)


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _jax_cases(monkeypatch, name):
    """(sim, TB) as tests/test_pallas_tb.py builds them."""
    if name == "tb3-lossy-cart":
        monkeypatch.setenv("PFFDTD_ZPLANE_MIN_COUNT", "1")
        monkeypatch.setenv("PFFDTD_ZPLANE_MIN_DENSITY", "0.3")
        return jax_box(2.5, 2.0, 1.6, h=0.1, Nt=30, lossy=True,
                       insig_type="hann10", diff_source=False), 3
    if name == "tb4-lossy-fcc":
        monkeypatch.setenv("PFFDTD_ZPLANE_MIN_COUNT", "1")
        monkeypatch.setenv("PFFDTD_ZPLANE_MIN_DENSITY", "0.12")
        return jax_box(2.2, 1.8, 1.5, h=0.12, Nt=30, lossy=True, fcc=True,
                       insig_type="hann10", diff_source=False), 4
    sim = jax_box(2.2, 1.8, 1.5, h=0.12, Nt=24, lossy=False, fcc=True,
                  insig_type="hann10", diff_source=False)
    return sort_sim(fold_fcc_sim(rotate_sim(sim))), 4


@pytest.mark.parametrize("name", ["tb3-lossy-cart", "tb4-lossy-fcc",
                                  "tb4-folded-fcc"])
def test_tb_route_matches_jax_tb_kernel(monkeypatch, name):
    sim, TB = _jax_cases(monkeypatch, name)
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device="cpu",
                      backend="tb", tb=TB)
    u = eng.run(verbose=False)
    u_j = tpt._run_tb_interpret(sim, eng.Nt, TB)
    scale = np.abs(u_j).max()
    assert scale > 0 and u.shape == u_j.shape
    assert np.abs(u - u_j).max() / scale < 1e-5


SCENES = {
    "cart": ((2.5, 2.0, 1.6), 0.1, False, False),
    "fcc-folded": ((2.2, 1.8, 1.5), 0.12, True, True),
}


def _port_sim(name, Nt):
    box, h, fcc, fold = SCENES[name]
    sim = scene.synthetic_box_sim(*box, h=h, Nt=Nt, fcc=fcc, lossy=True,
                                  insig_type="hann10", diff_source=False)
    return scene.sort_sim(scene.fold_fcc_sim(sim)) if fold else sim


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(SCENES))
def test_tb_and_pair_equal_step_bitwise(name, dtype):
    sim = _port_sim(name, Nt=23)
    ref = TorchEngine(**_kw(sim), dtype=dtype, device="cpu",
                      backend="step")
    u_ref = ref.run(verbose=False)
    assert np.abs(u_ref).max() > 0
    for backend, tb in (("pair", 3), ("tb", 3), ("tb", 4)):
        eng = TorchEngine(**_kw(sim), dtype=dtype, device="cpu",
                          backend=backend, tb=tb)
        assert 23 % eng.TB   # the tail runs
        u = eng.run(verbose=False)
        assert np.array_equal(u, u_ref), (backend, tb)
        for i in (0, 1, 3, 4):   # u^{n-1}, u^n, vh, gh
            assert torch.equal(eng.state[i], ref.state[i]), (backend, i)


def test_route_rules():
    # the measured rule on the H100: K3 at its best TB is slower per step
    # than K1 + K2, so "auto" takes the single step (pick_route's docstring)
    assert pick_route("auto") == ("step", None)
    assert pick_route("auto", 8) == ("step", None)
    assert pick_route("step", 5) == ("step", None)
    assert pick_route("pair", 5) == ("tb", 2)
    assert pick_route("tb") == ("tb", 3)
    assert pick_route("tb", 8) == ("tb", 8)
    for backend, tb in (("tb", 1), ("tb", 9), ("nope", 3)):
        with pytest.raises(ValueError):
            pick_route(backend, tb)


@pytest.mark.parametrize("TB,box", [(2, (8, 8, 32)), (3, (4, 8, 16)),
                                    (5, (3, 2, 7))])
@pytest.mark.parametrize("name", list(SCENES))
def test_tile_lists_cover_regions(name, TB, box):
    sim = _port_sim(name, Nt=4)
    d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats)
    tl = build_tile_lists(d.bnl_ixyz, d.grid, box, TB)
    N = d.grid.shape
    nt = [-(-(n - 2) // b) for n, b in zip(N, box)]
    assert tl.ntiles == tuple(nt) and tl.ptr[-1] == tl.node.size
    bnl = d.bnl_ixyz
    c = [bnl // (N[1] * N[2]), (bnl // N[2]) % N[1], bnl % N[2]]
    owners = np.zeros(d.Nbl, np.int64)
    for t in np.ndindex(*nt):
        tid = (t[0] * nt[1] + t[1]) * nt[2] + t[2]
        sl = slice(tl.ptr[tid], tl.ptr[tid + 1])
        inside = np.ones(d.Nbl, bool)
        ring = np.zeros(d.Nbl, np.int64)
        off = np.zeros(d.Nbl, np.int64)
        for a in range(3):
            lo, hi = tile_bounds(t[a], box[a], N[a], TB - 1)
            inside &= (c[a] >= lo) & (c[a] < hi)
            o0, o1 = tile_bounds(t[a], box[a], N[a], 0)
            ring = np.maximum(ring, np.maximum(o0 - c[a], c[a] - o1 + 1))
            r0, r1 = tile_bounds(t[a], box[a], N[a], TB)
            off = off * (r1 - r0) + c[a] - r0
        want = np.flatnonzero(inside)
        assert np.array_equal(tl.node[sl], want)
        assert np.array_equal(tl.ring[sl], ring[want])
        assert np.array_equal(tl.off[sl], off[want])
        owners[tl.node[sl][tl.owned[sl]]] += 1
    assert (owners == 1).all()


GRIDS = {"headline": (792, 310, 510), "small": (20, 14, 12)}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("fcc", [0, 2])
@pytest.mark.parametrize("TB", range(2, 9))
def test_planner_fits_the_card(TB, fcc, itemsize):
    """Every TB, dtype and stencil plans a block that fits 227 KB of shared
    memory, with a row width the kernel is built for and its rows in
    kMaxRows a thread."""
    for shape in GRIDS.values():
        g = GridSpec(*shape, fcc_flag=fcc)
        tl = ktb.plan_tiles(g, TB, itemsize, np.zeros(0, np.int64))
        Cx, By, Bz = tl.box
        Rz, Ry = Bz + 2 * TB, By + 2 * TB
        assert Rz in ktb.ROW_WIDTHS[itemsize]
        rows = shape[0] - 2
        # MIN_CHUNK .. CHUNK rows, evened out over the chunks
        assert min(ktb.MIN_CHUNK, rows) <= 2 * Cx and Cx <= ktb.CHUNK
        assert -(-rows // -(-rows // Cx)) == Cx
        assert ktb.smem_bytes(By, Bz, TB, itemsize, 2 if fcc else 1) \
            <= ktb.SMEM_LIMIT
        nthr = ktb.tile_threads(tl.box, TB)
        assert 0 < nthr <= ktb.MAX_THREADS and nthr % Rz == 0
        assert nthr // Rz * ktb.MAX_ROWS >= Ry


@pytest.mark.parametrize("TB", [2, 3, 8])
def test_plan_chunk_shortens_chunks_on_short_extents(TB):
    """Chunks are evened out over the extent within MIN_CHUNK .. CHUNK, and
    shorter on a 198-row slab than on the 790 rows of the whole grid."""
    for per_sm in (1, 2):
        whole = ktb.plan_chunk(790, 198, TB, per_sm)
        slab = ktb.plan_chunk(198, 198, TB, per_sm)
        assert slab < whole
        for rows, cx in ((790, whole), (198, slab)):
            n = -(-rows // cx)
            assert ktb.MIN_CHUNK <= 2 * cx and cx <= ktb.CHUNK
            assert n * cx - rows < n
    assert ktb.plan_chunk(5, 1, TB, 2) == 5
    assert ktb.plan_chunk(10 ** 5, 10 ** 4, TB, 1) == ktb.CHUNK


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("TB", [2, 8])
def test_planner_raises_only_where_nothing_fits(monkeypatch, TB, itemsize):
    """The smallest tile (one row of a warp's width) plans at exactly its
    bytes and not one byte under; TB out of 2..8 raises."""
    g = GridSpec(*GRIDS["small"], fcc_flag=2)
    least = ktb.smem_bytes(1, 32 - 2 * TB, TB, itemsize, 2)
    monkeypatch.setattr(ktb, "SMEM_SM", 2 * (least + 1024) - 2)
    monkeypatch.setattr(ktb, "SMEM_LIMIT", least)
    assert ktb.plan_tiles(g, TB, itemsize, np.zeros(0, np.int64)).box[1:] \
        == (1, 32 - 2 * TB)
    monkeypatch.setattr(ktb, "SMEM_LIMIT", least - 1)
    with pytest.raises(ValueError):
        ktb.plan_tiles(g, TB, itemsize, np.zeros(0, np.int64))
    for bad in (1, 9):
        with pytest.raises(ValueError):
            ktb.plan_tiles(g, bad, itemsize, np.zeros(0, np.int64))
