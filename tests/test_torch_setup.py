"""The port's setup stages vs the JAX package's, array for array.

Geometry (TriPre, the ray and box predicates, Box, RoomGeo from arrays and
from model JSON written by `write_model_json`, `room_to_model_json` and
`export_box_room`), the voxelizer on both backends (the shoebox, the
sloped room and a rotated shoebox, Cartesian and FCC), `sim_setup_from_room`
field by field, and a written sim folder (`save_sim_data` + cart_grid.h5,
and the file-based `sim_setup`) dataset by dataset: names, dtypes and
values.  The copies run the same numpy code, and the native backend the
same C++ source, so every comparison is exact (no tolerance).  The port's
native build goes to pffdtd_tpu_torch/_build/ and leaves the JAX package's
native/build/libpffdtd_vox.so as it was.
"""

import dataclasses
from pathlib import Path

import h5py
import numpy as np
import pytest

from pffdtd_tpu import demo as jdemo
from pffdtd_tpu import scene_setup as jsetup
from pffdtd_tpu import utils as jutils
from pffdtd_tpu.geometry import box as jbox
from pffdtd_tpu.geometry import exporter as jexporter
from pffdtd_tpu.geometry import predicates as jpred
from pffdtd_tpu.geometry import room as jroom
from pffdtd_tpu.geometry import scene_io as jscene_io
from pffdtd_tpu.geometry import tris as jtris
from pffdtd_tpu.voxelizer import grid as jgrid
from pffdtd_tpu.voxelizer import vox as jvox

from pffdtd_tpu_torch import scene, scene_setup, utils
from pffdtd_tpu_torch.geometry import (box, exporter, predicates, room,
                                       scene_io, tris)
from pffdtd_tpu_torch.io import simdata
from pffdtd_tpu_torch.voxelizer import grid, native, vox

REPO = Path(__file__).resolve().parent.parent
DEF3 = np.array([[2.0, 5.0, 30.0], [1.0, 10.0, 300.0], [0.5, 8.0, 3000.0]])


def _assert_equal(a, b, what=""):
    """Equal values, recursing into dataclasses, dicts and lists."""
    if dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            _assert_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{what}.{f.name}")
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), what
        for k in b:
            _assert_equal(a[k], b[k], f"{what}[{k}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what


# ---- geometry primitives
def _random_tris(rng, n=40):
    pts = rng.uniform(-1.0, 1.0, (3 * n, 3))
    return pts, np.arange(3 * n).reshape(n, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_primitives_equal(seed):
    rng = np.random.default_rng(seed)
    pts, t = _random_tris(rng)
    a, b = tris.tris_precompute(pts, t), jtris.tris_precompute(pts, t)
    _assert_equal(a, b, "TriPre")
    _assert_equal(a.select(slice(3, 9)), b.select(slice(3, 9)), "select")
    ro = rng.uniform(-1.5, 1.5, (200, 3))
    rd = rng.standard_normal((200, 3))
    for d_eps in (1e-6, 1e-2):
        _assert_equal(predicates.tri_ray_intersect(ro, rd, a, d_eps=d_eps),
                      jpred.tri_ray_intersect(ro, rd, b, d_eps=d_eps),
                      f"tri_ray d_eps={d_eps}")
    for _ in range(20):
        lo = rng.uniform(-1.0, 0.8, 3)
        hi = lo + rng.uniform(0.01, 0.6, 3)
        _assert_equal(predicates.tri_box_intersect(lo, hi, a),
                      jpred.tri_box_intersect(lo, hi, b), "tri_box")
    bx = box.Box().randomise(seed)
    jb = jbox.Box().randomise(seed)
    for k in ("A", "b", "verts", "bmin", "bmax", "edges", "tris", "quads",
              "L"):
        _assert_equal(getattr(bx, k), getattr(jb, k), k)
    q = rng.uniform(-8.0, 8.0, (300, 3))
    _assert_equal(bx.contains(q, eps=1e-9), jb.contains(q, eps=1e-9))
    _assert_equal(box.rotmatrix_ax_ang((1, 2, 3), 37.0),
                  jbox.rotmatrix_ax_ang((1, 2, 3), 37.0))
    v = rng.standard_normal((7, 3))
    for fn in ("vecnorm", "normalise"):
        _assert_equal(getattr(utils, fn)(v), getattr(jutils, fn)(v), fn)
    _assert_equal(utils.dotv(v, v[::-1]), jutils.dotv(v, v[::-1]))
    ang = rng.uniform(-180.0, 180.0, 3)
    _assert_equal(utils.rotate_xyz_deg(*ang), jutils.rotate_xyz_deg(*ang))
    _assert_equal(utils.rotate_az_el_deg(*ang[:2]),
                  jutils.rotate_az_el_deg(*ang[:2]))


# ---- rooms
def _room_pair(kind, tmp_path):
    """(port RoomGeo, JAX RoomGeo) of one scene description."""
    if kind == "sloped-arrays":
        p = scene.make_sloped_room()
        j = jroom.RoomGeo.from_arrays(p.pts, p.tris, p.mat_ind, p.mat_side,
                                      p.mat_str, p.Sxyz, p.Rxyz)
        return p, j
    if kind == "shoebox-arrays":
        mats = ["a", "a", "b", "b", "_RIGID", "c"]
        return (scene.make_shoebox_room(mats=mats, sides=[1, 1, 2, 3, 0, 1]),
                jdemo.make_shoebox_room(mats=mats, sides=[1, 1, 2, 3, 0, 1]))
    if kind == "room_to_model_json":
        src = scene.make_sloped_room(Lz2=2.8)
        pj, jj = tmp_path / "port.json", tmp_path / "jax.json"
        scene_io.room_to_model_json(pj, src)
        jscene_io.room_to_model_json(jj, jroom.RoomGeo.from_arrays(
            src.pts, src.tris, src.mat_ind, src.mat_side, src.mat_str,
            src.Sxyz, src.Rxyz))
        assert pj.read_text() == jj.read_text()
        return (room.RoomGeo(pj, az_el=(20.0, 10.0)),
                jroom.RoomGeo(jj, az_el=(20.0, 10.0)))
    # export_box_room, sources from a CSV (";" delimited, with a header)
    csv = tmp_path / "src.csv"
    csv.write_text("x;y;z\n0.4;0.5;0.6\n1.1;1.2;0.9\n")
    walls = dict(x0="wood", x1="wood", y0=None, y1="plaster", z0="carpet",
                 z1="plaster")
    pj, jj = tmp_path / "port.json", tmp_path / "jax.json"
    sp = exporter.export_box_room(pj, (2.0, 1.8, 1.5), walls, csv,
                                  [[1.0, 0.9, 0.7]], unit_scale=1.0)
    sj = jexporter.export_box_room(jj, (2.0, 1.8, 1.5), walls, csv,
                                   [[1.0, 0.9, 0.7]], unit_scale=1.0)
    assert sp == sj and pj.read_text() == jj.read_text()
    _assert_equal(scene_io.read_positions_csv(csv),
                  jscene_io.read_positions_csv(csv))
    return room.RoomGeo(pj), jroom.RoomGeo(jj)


ROOM_FIELDS = ("pts", "tris", "mat_ind", "mat_side", "mat_str", "Nmat",
               "Sxyz", "Rxyz", "bmin", "bmax", "R", "mat_area", "vol",
               "area", "colors", "tris_pre")


@pytest.mark.parametrize("kind", ["sloped-arrays", "shoebox-arrays",
                                  "room_to_model_json", "export_box_room"])
def test_room_geo_equal(kind, tmp_path, capsys):
    p, j = _room_pair(kind, tmp_path)
    for k in ROOM_FIELDS:
        _assert_equal(getattr(p, k), getattr(j, k), k)
    p.print_stats()
    a = capsys.readouterr().out
    j.print_stats()
    assert a == capsys.readouterr().out and "--ROOM_GEO" in a


# ---- the voxelizer, both backends
def _rotated(mod_room, rg):
    R, _, _ = (utils if mod_room is room else jutils).rotate_az_el_deg(
        30.0, 15.0)
    return mod_room.RoomGeo.from_arrays(rg.pts @ R, rg.tris, rg.mat_ind,
                                        rg.mat_side, rg.mat_str,
                                        rg.Sxyz @ R, rg.Rxyz @ R)


def _vox_room(name, mod_room):
    """The scene `name` built through the room module `mod_room`."""
    if name in ("shoebox", "rotated"):
        rg = scene.make_shoebox_room(mats=["a", "a", "b", "b", "c", "c"])
    else:
        rg = scene.make_sloped_room()
    rg = mod_room.RoomGeo.from_arrays(rg.pts, rg.tris, rg.mat_ind,
                                      rg.mat_side, rg.mat_str, rg.Sxyz,
                                      rg.Rxyz)
    return _rotated(mod_room, rg) if name == "rotated" else rg


def _voxelize(name, fcc, backend, port):
    mod_room, mod_grid, mod_vox = ((room, grid, vox) if port
                                   else (jroom, jgrid, jvox))
    rg = _vox_room(name, mod_room)
    cg = mod_grid.CartGrid(h=0.22 if name == "rotated" else 0.2,
                           offset=3.5, bmin=rg.bmin, bmax=rg.bmax, fcc=fcc)
    vs = mod_vox.VoxScene(rg, cg, fcc=fcc)
    vs.calc_adj(block_size=16, backend=backend)
    vs.check_adj_full()
    return vs


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("fcc", [False, True])
@pytest.mark.parametrize("name", ["shoebox", "sloped", "rotated"])
def test_voxscene_equal(name, fcc, backend):
    a = _voxelize(name, fcc, backend, port=True)
    b = _voxelize(name, fcc, backend, port=False)
    assert a.bn_ixyz.size > 0 and (a.mat_bn >= 0).any()
    for k in ("bn_ixyz", "adj_bn", "mat_bn", "saf_bn", "tidx_bn",
              "ndist_bn"):
        _assert_equal(getattr(a, k), getattr(b, k), k)


def test_native_build_stays_in_the_port():
    """The port's g++ build reads native/voxelizer.cpp, writes only under
    pffdtd_tpu_torch/_build/, and leaves native/ (the JAX package's
    tracked library included) byte for byte and mtime as it was."""
    ref = REPO / "native" / "build" / "libpffdtd_vox.so"
    before = {p: (p.stat().st_mtime_ns, p.read_bytes())
              for p in (REPO / "native").rglob("*") if p.is_file()}
    assert ref in before
    path = native.lib_path()
    assert path.parent == REPO / "pffdtd_tpu_torch" / "_build"
    native.build(path)            # a fresh build, even where one exists
    after = {p: (p.stat().st_mtime_ns, p.read_bytes())
             for p in (REPO / "native").rglob("*") if p.is_file()}
    assert after == before
    assert path.is_file()
    a = _voxelize("sloped", True, "native", port=True)
    b = _voxelize("sloped", True, "numpy", port=True)
    for k in ("bn_ixyz", "adj_bn", "mat_bn", "saf_bn"):
        _assert_equal(getattr(a, k), getattr(b, k), k)


def test_native_backend_raises_where_auto_falls_back(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no library")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="no library"):
        _voxelize("shoebox", False, "native", port=True)
    a = _voxelize("shoebox", False, "auto", port=True)
    b = _voxelize("shoebox", False, "numpy", port=False)
    _assert_equal(a.adj_bn, b.adj_bn, "adj_bn")


# ---- setup and the sim folder
SETUPS = {
    # (room, mats, fcc, insig, diff, h)
    "shoebox-cart": ("shoebox", 1, False, "impulse", True, 0.2),
    "sloped-fcc": ("sloped", 2, True, "hann10", False, 0.12),
}


def _setup(name, port, **kw):
    rname, nmat, fcc, insig, diff, h = SETUPS[name]
    mods = (room, scene_setup) if port else (jroom, jsetup)
    if rname == "shoebox":
        rg = scene.make_shoebox_room(mats=["w"] * 6)
    else:
        rg = scene.make_sloped_room()
    rg = mods[0].RoomGeo.from_arrays(rg.pts, rg.tris, rg.mat_ind,
                                     rg.mat_side, rg.mat_str, rg.Sxyz,
                                     rg.Rxyz)
    mats = mods[1].mats_from_DEF_list([DEF3, 2.0 * DEF3][:nmat])
    return mods[1].sim_setup_from_room(
        rg, mats, duration=0.01, insig_type=insig, h=h, fcc_flag=fcc,
        diff_source=diff, vox_backend="numpy", block_size=16, **kw)


@pytest.mark.parametrize("name", list(SETUPS))
def test_sim_setup_from_room_equal(name):
    a, b = _setup(name, port=True), _setup(name, port=False)
    assert isinstance(a, simdata.SimData)
    assert isinstance(a.vox, simdata.VoxData)
    _assert_equal(a, b, "SimData")
    assert scene_setup.mats_from_DEF_list is scene.mats_from_DEF_list


def _h5_tree(folder):
    """{file: {dataset: (dtype, shape, values)}} of every .h5 in folder."""
    out = {}
    for p in sorted(Path(folder).glob("*.h5")):
        with h5py.File(p, "r") as f:
            out[p.name] = {k: (f[k].dtype, f[k].shape, f[k][()])
                           for k in f.keys()}
    return out


def assert_folders_equal(a, b):
    ta, tb = _h5_tree(a), _h5_tree(b)
    assert ta.keys() == tb.keys() and len(ta) >= 5
    for fname in tb:
        assert ta[fname].keys() == tb[fname].keys(), fname
        for k, (dt, shape, val) in tb[fname].items():
            da, sa, va = ta[fname][k]
            assert (da, sa) == (dt, shape), f"{fname}:{k}"
            np.testing.assert_array_equal(va, val, err_msg=f"{fname}:{k}")


@pytest.mark.parametrize("name", list(SETUPS))
def test_sim_folder_equal(name, tmp_path):
    _setup(name, port=True, save_folder=tmp_path / "port", compress=3)
    _setup(name, port=False, save_folder=tmp_path / "jax", compress=3)
    assert_folders_equal(tmp_path / "port", tmp_path / "jax")
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        "sim_consts.h5", "cart_grid.h5", "vox_out.h5", "comms_out.h5",
        "sim_mats.h5"}


def test_file_based_sim_setup_equal(tmp_path):
    """sim_setup from a model JSON and material files (pack_mats,
    read_mat_file) writes the same folder as the JAX package's."""
    from pffdtd_tpu.materials import write_freq_dep_mat

    rg = scene.make_sloped_room()
    model = tmp_path / "model.json"
    scene_io.room_to_model_json(model, rg)
    write_freq_dep_mat(DEF3, tmp_path / "floor.h5")
    write_freq_dep_mat(2.0 * DEF3, tmp_path / "walls.h5")
    files = {"floor": "floor.h5", "walls": "walls.h5"}
    kw = dict(duration=0.01, insig_type="hann10", fmax=400.0, PPW=10.5,
              fcc_flag=True, vox_backend="numpy", block_size=16)
    for mod, out in ((scene_setup, "port"), (jsetup, "jax")):
        mod.sim_setup(model, tmp_path, files, save_folder=tmp_path / out,
                      **kw)
    assert_folders_equal(tmp_path / "port", tmp_path / "jax")
    from pffdtd_tpu_torch.comms import SimComms
    from pffdtd_tpu_torch.io.h5 import read_cart_grid

    folder = tmp_path / "port"
    xv, yv, zv, h = read_cart_grid(folder)
    v = simdata.read_sim_folder(folder).vox
    for a, b in ((xv, v.xv), (yv, v.yv), (zv, v.zv), (h, v.h)):
        _assert_equal(a, b)
    sc = SimComms.from_folder(folder)
    assert sc.fcc and sc.h == h and sc.l2 == 1.0 * 0.999 ** 2
