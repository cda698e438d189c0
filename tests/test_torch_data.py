"""The port's host side vs the JAX package's, array for array.

Coefficients, scenes (synthetic box + rotate/fold/sort), the engine's
static arrays and the port's own copies of the JAX package's numpy-only
modules (consts, comms, utils, voxelizer.grid/vox, io.h5) must be EQUAL to
the originals (no tolerance: the arithmetic is the same numpy code).  The
import-isolation test checks that the port's chip path runs with jax,
jaxlib, h5py and the JAX package itself blocked, as the port must.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hs

import pffdtd_tpu.comms as jcomms
import pffdtd_tpu.consts as jconsts
import pffdtd_tpu.io.h5 as jh5
import pffdtd_tpu.utils as jutils
import pffdtd_tpu.voxelizer.grid as jgrid
import pffdtd_tpu.voxelizer.vox as jvox
from pffdtd_tpu import demo, prep
from pffdtd_tpu.engine import coeffs as jcoeffs
from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.scene_setup import mats_from_DEF_list as jmats
from pffdtd_tpu.scene_setup import save_sim_data

from pffdtd_tpu_torch import comms, consts, scene, utils
from pffdtd_tpu_torch.engine import coeffs
from pffdtd_tpu_torch.io import h5, simdata
from pffdtd_tpu_torch.voxelizer import grid, vox
from pffdtd_tpu_torch.engine.data import EngineData, abc_q

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _assert_dc_equal(a, b):
    """Dataclasses with the same field names hold equal values."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _assert_dc_equal(va, vb)
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=f.name)


@pytest.mark.parametrize("fcc", [False, True])
@pytest.mark.parametrize("eps", [0.0, coeffs.FP32_EPS])
def test_scheme_coeffs_equal(fcc, eps):
    l = np.sqrt(1.0 if fcc else 1.0 / 3.0) * 0.999
    a = coeffs.SchemeCoeffs.make(l, l * l, fcc, eps=eps)
    b = jcoeffs.SchemeCoeffs.make(l, l * l, fcc, eps=eps)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert coeffs.FP32_EPS == jcoeffs.FP32_EPS


def test_mat_coeffs_equal():
    defs = [demo.DEMO_DEF, scene.DEF11]
    a = coeffs.MatCoeffs.from_mats(scene.mats_from_DEF_list(defs), Ts=1e-4)
    b = jcoeffs.MatCoeffs.from_mats(jmats(defs), Ts=1e-4)
    _assert_dc_equal(a, b)
    np.testing.assert_array_equal(a.table(np.float64)[:, 2], b.bDh)


SCENES = {
    # (box dims, h, fcc, rotation: None = descending, or an explicit tr,
    #  fold)
    "cart-desc": ((1.6, 2.5, 2.0), 0.1, False, None, False),
    "cart-tr": ((2.5, 2.0, 1.6), 0.1, False, (1, 2, 0), False),
    "fcc-fold-desc": ((1.5, 2.2, 1.8), 0.12, True, None, True),
    "fcc-fold-tr": ((2.2, 1.8, 1.5), 0.12, True, (2, 1, 0), True),
}


def _both_scenes(name):
    dims, h, fcc, tr, fold = SCENES[name]
    kw = dict(h=h, Nt=20, fcc=fcc, lossy=True, insig_type="hann10",
              diff_source=False, DEF=scene.DEF11)
    out = []
    for mod, pr in ((scene, scene), (demo, prep)):
        sim = mod.synthetic_box_sim(*dims, **kw)
        sim = pr.rotate_sim(sim, tr=tr, orient="descending")
        if fold:
            sim = pr.fold_fcc_sim(sim)
        out.append(pr.sort_sim(sim))
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_equal(name):
    a, b = _both_scenes(name)
    _assert_dc_equal(a, b)
    if SCENES[name][3] is None:
        N = (a.vox.Nx, a.vox.Ny, a.vox.Nz)
        assert N[0] >= N[1] or a.consts.fcc_flag == 2


@pytest.mark.parametrize("name", ["cart-desc", "fcc-fold-desc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_engine_data_equal(name, dtype):
    sim, jsim = _both_scenes(name)
    d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats, dtype=dtype)
    j = JaxEngineData(jsim.consts, jsim.vox, jsim.comms, jsim.mats,
                      dtype=dtype, pad_z=None, pad_y=None)
    assert d.grid.shape == j.grid.shape and d.grid.folded == j.grid.folded
    assert dataclasses.astuple(d.sc) == dataclasses.astuple(j.sc)
    for k in ("adj_grid", "bnl_ixyz", "ssaf_bnl", "mat_bnl", "in_ixyz",
              "out_ixyz", "in_sigs", "out_reorder"):
        a, b = getattr(d, k), np.asarray(getattr(j, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert d.infac == j.infac and d.Nt == j.Nt and d.Nbl == j.Nbl > 0
    # the per-material table gathers to JAX's per-node rows exactly
    for q, k in enumerate(("b", "bd", "bDh", "bFh")):
        np.testing.assert_array_equal(d.coef_table[d.mat_bnl, q],
                                      j.mat_rows[k], err_msg=k)
    np.testing.assert_array_equal(d.beta[d.mat_bnl], j.mat_rows["beta"])
    # a closed box puts no lossy node on an ABC layer: K2 runs without its
    # ABC mode
    assert not abc_q(d.bnl_ixyz, d.grid).any() and d.abcq_bnl is None


_ISOLATED = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "h5py", "pffdtd_tpu"):
            raise ImportError("blocked on the card's machine: " + name)
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import torch
torch.set_num_threads(2)
import chip_smoke
import pffdtd_tpu_torch.analysis.air_abs
import pffdtd_tpu_torch.analysis.modal_accuracy
import pffdtd_tpu_torch.analysis.process_outputs
import pffdtd_tpu_torch.bench
import pffdtd_tpu_torch.cli
import pffdtd_tpu_torch.convert
import pffdtd_tpu_torch.engine.energy
import pffdtd_tpu_torch.engine.torch_engine
import pffdtd_tpu_torch.viz
import pffdtd_tpu_torch.io.h5
import pffdtd_tpu_torch.kernels.stream
import pffdtd_tpu_torch.kernels.tb
import pffdtd_tpu_torch.parallel.partition
import pffdtd_tpu_torch.scene
import pffdtd_tpu_torch.engine.numpy_ref
import pffdtd_tpu_torch.geometry
import pffdtd_tpu_torch.geometry.exporter
import pffdtd_tpu_torch.geometry.scene_io
import pffdtd_tpu_torch.io
import pffdtd_tpu_torch.materials
import pffdtd_tpu_torch.prep
import pffdtd_tpu_torch.probes.kernel_ab
import pffdtd_tpu_torch.probes.orient
import pffdtd_tpu_torch.scene_setup
import pffdtd_tpu_torch.voxelizer.native
import pffdtd_tpu_torch.examples
import pffdtd_tpu_torch.examples.bench_mv
import pffdtd_tpu_torch.examples.build_material_library
import pffdtd_tpu_torch.examples.ctk_cart_rir
import pffdtd_tpu_torch.examples.ctk_cart_viz
import pffdtd_tpu_torch.examples.mv_fcc_rir
import pffdtd_tpu_torch.examples.mv_fcc_viz
import pffdtd_tpu_torch.examples.setup_1e9
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.scene import fold_fcc_sim, synthetic_box_sim

# plotting, HDF5, filter design and fitting are imported inside functions
lazy = [m for m in ("matplotlib", "h5py", "scipy.signal", "scipy.optimize")
        if m in sys.modules]
assert not lazy, lazy

sim = fold_fcc_sim(synthetic_box_sim(1.2, 1.0, 0.9, h=0.1, Nt=10, fcc=True,
                                     insig_type="hann10"))
for backend in ("step", "tb"):
    eng = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, device="cpu", backend=backend)
    u = eng.run(verbose=False)
    assert u.shape == (sim.comms.Nr, 10) and np.isfinite(u).all()
    assert float(eng.state[1].abs().max()) > 0
assert eng.TB == 3
# the JAX package's last surface: fp32_eps, the split, SimFolder (h5py is
# imported only when a property is read)
import contextlib, io
from pffdtd_tpu_torch.engine.data import EngineData
from pffdtd_tpu_torch.io import SimFolder
assert SimFolder(sys.argv[1]).folder.name and callable(EngineData.from_folder)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    eng = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, device="cpu", fp32_eps=1e-3)
    eng.run(chunk=4)
assert "/ bn " in buf.getvalue() and eng.bn_ms_per_step() > 0
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.scene import pad_x_interior
ps = pad_x_interior(sim, 2)          # the grid the two slabs run
for backend in ("step", "tb"):
    ref = TorchEngine(consts=ps.consts, vox=ps.vox, comms=ps.comms,
                      mats=ps.mats, device="cpu", backend=backend).run(
                          verbose=False)
    sh = make_sharded_engine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                             mats=sim.mats, devices=["cpu"] * 2,
                             backend=backend)
    assert sh.D == 2 and np.array_equal(sh.run(verbose=False), ref)
eng = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                  mats=sim.mats, device="cpu", dtype=np.float64,
                  energy_on=True)
eng.run(verbose=False, chunk=4, checkpoint_every=1,
        checkpoint_path=sys.argv[1] + "/state.npz")
assert np.abs(eng.energy_balance()).max() < 1e-10
from pffdtd_tpu_torch.analysis.air_abs import apply_modal_filter
assert np.isfinite(apply_modal_filter(np.ones((1, 64)), 8000.0, 20.0, 50.0,
                                      device="cpu")).all()
# a room to receivers with the port's own setup, in memory: a fitted
# material, the native voxelizer, prep, the NumPy oracle and the engine
from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
from pffdtd_tpu_torch.materials import fit_to_Sabs_oct_11
from pffdtd_tpu_torch.scene import (make_sloped_room, mats_from_DEF_list,
                                    rotate_sim, sort_sim)
from pffdtd_tpu_torch.scene_setup import sim_setup_from_room
DEF = fit_to_Sabs_oct_11(np.full(11, 0.2))
sim = sim_setup_from_room(make_sloped_room(), mats_from_DEF_list([DEF, DEF]),
                          duration=0.004, insig_type="hann10", h=0.12,
                          fcc_flag=True, vox_backend="native")
sim = sort_sim(fold_fcc_sim(rotate_sim(sim, orient="descending")))
kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms, mats=sim.mats)
o = NumpyEngine(**kw, energy_on=True)
o.run_all()
live = o.E_in[:o.n] > 0
assert live.any() and np.abs(o.energy_balance()[live]).max() < 1e-10
u = TorchEngine(**kw, device="cpu", dtype=np.float64).run(verbose=False)
assert np.abs(u - o.u_out).max() <= 1e-12 * np.abs(o.u_out).max()
# setup_1e9 --quick: the box set up natively at 0.102 Gvox, two steps
from pffdtd_tpu_torch.examples import setup_1e9
rec, outs = setup_1e9.main(["--quick", "--device", "cpu", "--steps", "2",
                            "--routes", "step"])
assert rec["grid"] == [592, 464, 373] and rec["Nbl"] > 0
assert outs["step"].shape == (8, 2) and np.isfinite(outs["step"]).all()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "h5py", "pffdtd_tpu")]
assert not bad, bad
print("ISOLATED-OK")
"""


def test_import_isolation(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _ISOLATED, str(tmp_path)],
                       cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ISOLATED-OK" in r.stdout, \
        r.stdout + r.stderr


@pytest.mark.parametrize("kw", [dict(h=0.1), dict(h=0.05, fcc=True),
                                dict(SR=48000.0, Tc=25.0, rh=40.0),
                                dict(fmax=1000.0, PPW=10.5, fcc=True)])
def test_consts_copy_equal(kw):
    a, b = consts.SimConsts(**kw), jconsts.SimConsts(**kw)
    for k in ("c", "h", "Ts", "SR", "l", "l2", "fcc_flag"):
        assert getattr(a, k) == getattr(b, k), k
    assert consts.speed_of_sound(13.0) == jconsts.speed_of_sound(13.0)


@pytest.mark.parametrize("fcc", [False, True])
def test_grid_utils_vox_copies_equal(fcc):
    kw = dict(h=0.07, offset=3.5, bmin=np.array([0.1, -0.2, 0.0]),
              bmax=np.array([1.3, 0.9, 0.7]), fcc=fcc)
    a, b = grid.CartGrid(**kw), jgrid.CartGrid(**kw)
    for k in ("Nx", "Ny", "Nz", "Npts", "xv", "yv", "zv", "Nxyz", "xyzmin",
              "xyzmax", "h"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    ii = np.arange(0, a.Npts, 7)
    sub = utils.ind2sub3d(ii, a.Nx, a.Ny, a.Nz)
    for x, y in zip(sub, jutils.ind2sub3d(ii, a.Nx, a.Ny, a.Nz)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(utils.sub2ind3d(*sub, a.Nx, a.Ny, a.Nz),
                                  ii)
    assert utils.iceil(2.1) == jutils.iceil(2.1) == 3
    np.testing.assert_array_equal(vox.CART_VECTORS, jvox.CART_VECTORS)
    np.testing.assert_array_equal(vox.FCC_VECTORS, jvox.FCC_VECTORS)


@pytest.mark.parametrize("sig", ["impulse", "hann10", "hann20", "dhann30",
                                 "hann5ms"])
@pytest.mark.parametrize("fcc", [False, True])
def test_comms_copy_equal(sig, fcc):
    c = jconsts.SimConsts(h=0.1, fcc=fcc)
    g = jgrid.CartGrid(h=0.1, offset=3.5, bmin=np.zeros(3),
                       bmax=np.array([2.0, 1.6, 1.2]), fcc=fcc)
    out = []
    for mod in (comms, jcomms):
        sc = mod.SimComms(g.xv, g.yv, g.zv, c.h, c.Ts, c.l2, fcc=fcc)
        sc.prepare_source_pts(np.array([0.9, 0.7, 0.55]))
        sc.prepare_receiver_pts(np.array([[0.3, 0.4, 0.5], [1.5, 1.1, 0.8]]))
        sc.prepare_source_signals(0.01, sig_type=sig)
        sc.diff_source()
        out.append(sc.to_comms_data())
    _assert_dc_equal(*out)


def test_h5_copy_reads_and_writes_like_the_original(tmp_path):
    sim = demo.synthetic_box_sim(1.2, 1.0, 0.9, h=0.1, Nt=6, fcc=True,
                                 insig_type="hann10", DEF=scene.DEF11)
    save_sim_data(sim, tmp_path)
    for name in ("consts", "vox", "comms", "mats"):
        a = getattr(h5, "read_" + name)(tmp_path)
        b = getattr(jh5, "read_" + name)(tmp_path)
        assert type(a).__module__ == simdata.__name__
        _assert_dc_equal(a, b)
    u = np.random.default_rng(3).standard_normal((sim.comms.Nr, 6))
    ro = np.arange(sim.comms.Nr)[::-1].copy()
    h5.write_outputs(tmp_path, u, ro)
    np.testing.assert_array_equal(jh5.read_outputs(tmp_path), u[ro])
    np.testing.assert_array_equal(h5.read_outputs(tmp_path), u[ro])
    simdata.write_outputs(tmp_path, u)
    np.testing.assert_array_equal(jh5.read_outputs(tmp_path), u)


# ---- K3's tile lists: rows, per-row pointers, y-z offsets, rings
def _list_scene(name, TB, D=None):
    """(EngineData, node indices, SlabSpec or None, lists) of a scene, for
    the whole grid or (D given) for slab 1 of D x-slabs."""
    from pffdtd_tpu_torch.kernels.tb import plan_tiles
    from pffdtd_tpu_torch.parallel.partition import partition, x_slabs
    from pffdtd_tpu_torch.scene import pad_x_interior
    dims, h, fcc, _, fold = SCENES[name]
    sim = scene.synthetic_box_sim(*dims, h=h, Nt=4, fcc=fcc, lossy=True,
                                  insig_type="hann10", diff_source=False)
    if fold:
        sim = scene.sort_sim(scene.fold_fcc_sim(sim))
    if D is None:
        d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats)
        return d, d.bnl_ixyz, None, plan_tiles(d.grid, TB, 4, d.bnl_ixyz)
    sim = pad_x_interior(sim, D)
    d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats)
    part = partition(d, x_slabs(d.grid, D, TB))[1]
    return d, part.bnl, part.slab, plan_tiles(d.grid, TB, 4, part.bnl,
                                              part.slab)


def check_tile_lists(tl, bnl, shape, TB, slab=None):
    """Every invariant K3 relies on, against a brute-force scan of the
    nodes at local flat indices `bnl` of a grid of `shape`."""
    from pffdtd_tpu_torch.engine.data import tile_bounds
    N = np.array(shape, np.int64)
    spans = [(1, n - 1, 1, n - 1) for n in N]
    if slab is not None:
        spans[0] = (*slab.owned, *slab.computable)
    box, nt = tl.box, tl.ntiles
    W = box[0] + 2 * (TB - 1)
    Rz = box[2] + 2 * TB
    c = np.stack([bnl // (N[1] * N[2]), (bnl // N[2]) % N[1], bnl % N[2]])
    ntot = int(np.prod(nt))
    assert tl.ptr[0] == 0 and tl.ptr[-1] == tl.node.size
    assert (np.diff(tl.ptr) >= 0).all()
    assert tl.rptr.size == ntot * (W + 1)
    owners = np.zeros(bnl.size, np.int64)
    for t in np.ndindex(*nt):
        tid = (t[0] * nt[1] + t[1]) * nt[2] + t[2]
        e0, e1 = tl.ptr[tid], tl.ptr[tid + 1]
        rp = tl.rptr[tid * (W + 1):(tid + 1) * (W + 1)]
        # per-row pointers: monotone, covering the tile's entries, each
        # range holding exactly its row
        assert rp[0] == e0 and rp[-1] == e1 and (np.diff(rp) >= 0).all()
        o = [tile_bounds(t[a], box[a], N[a], 0, spans[a]) for a in range(3)]
        for k in range(W):
            assert (tl.row[rp[k]:rp[k + 1]] == o[0][0] - (TB - 1) + k).all()
        # the entries are the nodes within TB-1 of the owned box
        inside = np.ones(bnl.size, bool)
        ring = np.zeros(bnl.size, np.int64)
        for a in range(3):
            lo, hi = tile_bounds(t[a], box[a], N[a], TB - 1, spans[a])
            inside &= (c[a] >= lo) & (c[a] < hi)
            ring = np.maximum(ring, np.maximum(o[a][0] - c[a],
                                               c[a] - o[a][1] + 1))
        sl = slice(e0, e1)
        assert np.array_equal(np.sort(tl.node[sl]), np.flatnonzero(inside))
        # ring: the step reach (step s takes ring <= TB-1-s)
        assert np.array_equal(tl.ring[sl], ring[tl.node[sl]])
        assert (tl.ring[sl] <= TB - 1).all()
        # row and y-z offset give back the flat index
        y = tl.yz[sl] // Rz + o[1][0] - TB
        z = tl.yz[sl] % Rz + o[2][0] - TB
        assert np.array_equal((tl.row[sl] * N[1] + y) * N[2] + z,
                              bnl[tl.node[sl]])
        assert (tl.yz[sl] >= 0).all()
        assert (tl.yz[sl] < (box[1] + 2 * TB) * Rz).all()
        owners[tl.node[sl][tl.owned[sl]]] += 1
    # every node on an owned row is owned by exactly one tile
    own_rows = ((c[0] >= spans[0][0]) & (c[0] < spans[0][1]))
    assert (owners == own_rows).all()


@pytest.mark.parametrize("D", [None, 2])
@pytest.mark.parametrize("TB", range(2, 9))
@pytest.mark.parametrize("name", ["cart-tr", "fcc-fold-desc"])
def test_tile_lists_rows_offsets_rings(name, TB, D):
    d, bnl, slab, tl = _list_scene(name, TB, D)
    assert tl.TB == TB and bnl.size > 0
    shape = d.grid.shape if slab is None else slab.shape
    check_tile_lists(tl, np.asarray(bnl, np.int64), shape, TB, slab)


@settings(max_examples=25, deadline=None)
@given(dims=hs.tuples(*[hs.floats(0.6, 1.6)] * 3),
       fcc=hs.booleans(), TB=hs.integers(2, 8),
       box=hs.tuples(hs.integers(1, 9), hs.integers(1, 9),
                     hs.integers(1, 5)),
       slabs=hs.sampled_from([None, 2, 3]))
def test_tile_lists_random_boxes(dims, fcc, TB, box, slabs):
    """Random box scenes, tiles (By, Bz = 32m - 2TB) and chunks, on the
    whole grid or a middle slab."""
    from pffdtd_tpu_torch.engine.data import build_tile_lists
    from pffdtd_tpu_torch.parallel.partition import partition, x_slabs
    from pffdtd_tpu_torch.scene import pad_x_interior
    sim = scene.synthetic_box_sim(*dims, h=0.1, Nt=4, fcc=fcc,
                                  lossy=True, insig_type="hann10",
                                  diff_source=False)
    Cx, By, m = box
    Bz = 32 * m - 2 * TB
    if slabs is None:
        d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats)
        tl = build_tile_lists(d.bnl_ixyz, d.grid, (Cx, By, Bz), TB)
        check_tile_lists(tl, d.bnl_ixyz, d.grid.shape, TB)
        return
    sim = pad_x_interior(sim, slabs)
    d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats)
    sls = x_slabs(d.grid, slabs, TB)
    if sls[0].S < 2 * TB:
        return
    part = partition(d, sls)[slabs // 2]
    tl = build_tile_lists(part.bnl, d.grid, (Cx, By, Bz), TB, part.slab)
    check_tile_lists(tl, part.bnl, part.slab.shape, TB, part.slab)
