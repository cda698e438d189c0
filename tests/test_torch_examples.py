"""The port's `examples` workflows vs the JAX package's pipelines, on the CPU.

Every example runs with device="cpu" (the kernels' plain versions), in
fp64 where an engine runs, at a small size:
- build_material_library: the same SABS_TABLES as examples/, and DEF
  arrays (and files) equal to the JAX `fit_to_Sabs_oct_11`'s for three
  materials, array for array;
- ctk_cart_rir / mv_fcc_rir on a 3 x 2.5 x 2 m box (the model JSON from
  the port's `export_box_room`, the materials from its
  `build_material_library`), 30 ms (the JAX visco filter fails below its
  22.9 ms start time): receivers against `sim_setup` -> `JaxEngine(xla)`
  -> `ProcessOutputs` on the same files <= 1e-12 relative, the processed
  RIRs likewise (the bar of tests/test_torch_process.py);
- bench_mv: its JSON line parses and names the metric as the original's;
- the viz scripts write as many frames as the JAX `render_animation`;
- setup_1e9 at h = 0.5: SimData equal to the JAX `sim_setup_from_room`'s,
  step-route receivers against `JaxEngine(xla)` <= 1e-12, the tb and x4
  routes' receivers equal to the step route's;
- each script that reads the data folder raises FileNotFoundError naming
  what is missing, and each entry point defaults to the card and raises
  without one.
"""

import dataclasses
import json
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from pffdtd_tpu.analysis.process_outputs import ProcessOutputs as JaxPO
from pffdtd_tpu.engine.jax_engine import JaxEngine
from pffdtd_tpu.geometry.room import RoomGeo as JaxRoomGeo
from pffdtd_tpu.materials.admittance import (
    convert_R_to_Yn, convert_Sabs_to_Yn, fit_to_Sabs_oct_11,
    write_freq_dep_mat, write_freq_ind_mat_from_Yn)
from pffdtd_tpu.prep import _load, _store, fold_fcc_sim, rotate_sim, sort_sim
from pffdtd_tpu.scene_setup import mats_from_DEF_list as jax_mats
from pffdtd_tpu.scene_setup import sim_setup as jax_sim_setup
from pffdtd_tpu.scene_setup import sim_setup_from_room as jax_setup_room
from pffdtd_tpu.viz import render_animation as jax_render

from pffdtd_tpu_torch.examples import (CTK_MATS, CTK_MODEL, MV_MATS,
                                       MV_MODEL, bench_mv,
                                       build_material_library, ctk_cart_rir,
                                       ctk_cart_viz, mv_fcc_rir, mv_fcc_viz,
                                       setup_1e9)
from pffdtd_tpu_torch.geometry.exporter import export_box_room
from pffdtd_tpu_torch.io.simdata import read_sim_folder
from pffdtd_tpu_torch.scene import rotation_of

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
BOX = (3.0, 2.5, 2.0)
WALLS = ("x0", "x1", "y0", "y1", "z0", "z1")
# the CTK box carries six of the eight CTK materials (a box has six faces)
CTK_BOX = dict(list(CTK_MATS.items())[:6])
SOURCES = [[1.0, 1.0, 0.8], [2.0, 1.5, 1.2], [1.2, 1.6, 1.0]]
RECEIVERS = [[1.9, 1.2, 1.1], [1.4, 0.9, 1.3]]
DURATION = 0.03


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


def _read(path, key):
    with h5py.File(path, "r") as f:
        return f[key][...]


def _assert_dc_equal(a, b):
    """Dataclasses with the same field names hold equal values."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _assert_dc_equal(va, vb)
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=f.name)


@pytest.fixture(scope="module")
def ref_data(tmp_path_factory):
    """A data folder laid out as the reference's: the CTK and Musikverein
    models as boxes painted with their materials' names, and materials/
    written by the port's build_material_library."""
    ref = tmp_path_factory.mktemp("ref_data")
    for model, names in ((CTK_MODEL, list(CTK_BOX)),
                         (MV_MODEL, list(MV_MATS) + ["Wood"])):
        path = ref / model
        path.parent.mkdir(parents=True)
        export_box_room(path, BOX, dict(zip(WALLS, names)), SOURCES,
                        RECEIVERS)
    files = {**CTK_BOX, **MV_MATS}.values()
    build_material_library.build_library(
        ref / "materials", names=[Path(f).stem for f in files])
    return ref


# ------------------------------------------------------------ materials
def test_sabs_tables_equal_the_originals():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        from build_material_library import SABS_TABLES
    finally:
        sys.path.remove(str(REPO / "examples"))
    assert build_material_library.SABS_TABLES == SABS_TABLES


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    out = tmp_path_factory.mktemp("materials")
    names = ["mv_wood", "ctk_carpet", "mv_window"]
    return out, build_material_library.build_library(out, names=names)


@pytest.mark.parametrize("name", ["mv_wood", "ctk_carpet", "mv_window"])
def test_material_fits_equal_jax(library, name, tmp_path):
    out, fits = library
    DEF = fit_to_Sabs_oct_11(
        np.asarray(build_material_library.SABS_TABLES[name], float),
        filename=tmp_path / f"{name}.h5")
    np.testing.assert_array_equal(fits[name], DEF)
    with h5py.File(out / f"{name}.h5", "r") as a, \
            h5py.File(tmp_path / f"{name}.h5", "r") as b:
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)


def test_material_examples_equal_jax(library, tmp_path):
    out, _ = library
    write_freq_ind_mat_from_Yn(convert_R_to_Yn(0.90), tmp_path / "R90_mat.h5")
    write_freq_ind_mat_from_Yn(convert_R_to_Yn(0.5), tmp_path / "R50.h5")
    write_freq_ind_mat_from_Yn(convert_Sabs_to_Yn(0.5), tmp_path / "a50.h5")
    write_freq_dep_mat(np.array([[0, 1.0, 0], [2, 3, 4]]),
                       tmp_path / "ex_mat.h5")
    for f in ("R90_mat.h5", "R50.h5", "a50.h5", "ex_mat.h5"):
        with h5py.File(out / f, "r") as a, h5py.File(tmp_path / f, "r") as b:
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k][()], b[k][()],
                                              err_msg=f"{f}: {k}")


# ------------------------------------------------------------------ RIRs
def _jax_rir(ref, out, model, mats, source_num, fcc, fmax, ppw, modal):
    """The original's pipeline on the JAX package, fp64, xla; FCC folders
    rotated by the port's "auto" choice (`rotation_of` of the folder),
    folded and sorted."""
    jax_sim_setup(model_json_file=ref / model, mat_folder=ref / "materials",
                  mat_files_dict=mats, source_num=source_num,
                  insig_type="impulse", diff_source=True, duration=DURATION,
                  Tc=20, rh=50, fcc_flag=fcc, PPW=ppw, fmax=fmax,
                  save_folder=out)
    if fcc:
        _store(out, sort_sim(fold_fcc_sim(rotate_sim(
            _load(out), tr=rotation_of(read_sim_folder(out))))))
    eng = JaxEngine(out, dtype=np.float64, backend="xla")
    eng.run(verbose=False)
    eng.save_outputs(out)
    po = JaxPO(out)
    po.initial_process(fcut=10.0, N_order=4)
    po.resample(48e3)
    po.apply_lowpass(fcut=fmax, N_order=8, symmetric=True)
    po.apply_modal_filter() if modal else po.apply_stokes_filter()
    po.save_h5()
    po.save_wav()


@pytest.mark.parametrize("script", ["ctk_cart_rir", "mv_fcc_rir"])
def test_rir_matches_jax_pipeline(script, ref_data, tmp_path):
    fmax = 500.0
    a, b = tmp_path / "jax", tmp_path / "torch"
    if script == "ctk_cart_rir":
        _jax_rir(ref_data, a, CTK_MODEL, CTK_BOX, 1, False, fmax, 10.5, True)
        eng, po = ctk_cart_rir.rir(ref_data, b, fmax=fmax, duration=DURATION,
                                   device="cpu", dtype=np.float64,
                                   mats=CTK_BOX)
    else:
        _jax_rir(ref_data, a, MV_MODEL, MV_MATS, 3, True, fmax, 5.6, False)
        eng, po = mv_fcc_rir.rir(ref_data, b, fmax=fmax, duration=DURATION,
                                 device="cpu", dtype=np.float64)
        assert _read(b / "sim_consts.h5", "fcc_flag") == 2   # folded
    assert eng.Nt > 80
    names = lambda d: sorted(p.name for p in d.iterdir())
    assert names(a) == names(b)
    u = _read(b / "sim_outs.h5", "u_out")
    assert np.isfinite(u).all()
    assert _rel(u, _read(a / "sim_outs.h5", "u_out")) < 1e-12
    pa, pb = a / "sim_outs_processed.h5", b / "sim_outs_processed.h5"
    assert _read(pa, "Fs_f") == _read(pb, "Fs_f") == 48e3
    ra, rb = _read(pa, "r_out_f"), _read(pb, "r_out_f")
    assert ra.shape == rb.shape and ra.shape[0] == len(RECEIVERS)
    assert ra.shape[1] >= DURATION * 48e3
    assert _rel(rb, ra) < 1e-12
    np.testing.assert_array_equal(po.r_out_f, rb)


def test_bench_mv_json_line(ref_data, capsys):
    bench_mv.main(["500", "20", "1", "--ref", str(ref_data),
                   "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "mv_fcc_fmax500"
    assert rec["unit"] == "Mvox/s" and rec["device"] == "cpu"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 52512.6, 4)


# ------------------------------------------------------------------ viz
@pytest.mark.parametrize("script", ["ctk_cart_viz", "mv_fcc_viz"])
def test_viz_frames_as_jax(script, ref_data, tmp_path):
    out = tmp_path / "torch"
    if script == "ctk_cart_viz":
        files = ctk_cart_viz.viz(ref_data, out, fmax=400.0, duration=0.01,
                                 frames=4, device="cpu", mats=CTK_BOX)
        assert (out / "sim_outs.h5").exists()
    else:
        files = mv_fcc_viz.viz(ref_data, out, fmax=400.0, duration=0.01,
                               frames=4, device="cpu")
        assert (out / "voxelization.png").stat().st_size > 1000
    want = jax_render(JaxEngine(out, dtype=np.float32), frames=4,
                      out_dir=tmp_path / "jax_frames")
    assert len(files) == len(want) > 4      # Nt % frames != 0: a last one
    assert all(Path(f).stat().st_size > 1000 for f in files)


# ------------------------------------------------------------- setup_1e9
def _jax_box_sim(h):
    rg = setup_1e9.box_room()
    jrg = JaxRoomGeo.from_arrays(rg.pts, rg.tris, rg.mat_ind, rg.mat_side,
                                 rg.mat_str, rg.Sxyz, rg.Rxyz)
    return jax_setup_room(jrg, jax_mats([np.array(setup_1e9.DEF)]),
                          duration=setup_1e9.DURATION, insig_type="impulse",
                          h=h, check_adj=True, vox_backend="native")


def test_setup_1e9_sim_equals_jax():
    h = setup_1e9.nudge_h(0.5, setup_1e9.box_room())
    assert h == 0.5
    sim, secs = setup_1e9.setup(h)
    assert (sim.vox.Nx, sim.vox.Ny, sim.vox.Nz) == (72, 58, 48)
    assert sim.vox.Nx % 8 == 0 and secs["total"] > 0
    _assert_dc_equal(sim, _jax_box_sim(h))


def test_setup_1e9_routes_match_jax(capsys):
    rec, outs = setup_1e9.main(["--h", "0.5", "--device", "cpu", "--f64",
                                "--check"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["setup_1e9"]["grid"] == [72, 58, 48] == rec["grid"]
    assert list(outs) == ["step", "tb", "x4"]
    assert rec["routes"]["x4"]["grid"] == [74, 58, 48]   # padded to 4 slabs
    for r in rec["routes"].values():   # CPU tensors launch no kernel
        assert set(r["launches"].values()) == {0}
        assert all(c["max_rel_err"] == 0 for c in r["checks"].values())
    js = _jax_box_sim(rec["h"])
    u_ref = JaxEngine(consts=js.consts, vox=js.vox, comms=js.comms,
                      mats=js.mats, dtype=np.float64,
                      backend="xla").run(verbose=False)
    assert outs["step"].shape == u_ref.shape == (8, rec["Nt"])   # 8 taps
    assert _rel(outs["step"], u_ref) <= 1e-12
    for route in ("tb", "x4"):
        assert np.array_equal(outs[route], outs["step"]), route


@pytest.mark.parametrize("f64", [True, False])
def test_setup_1e9_energy_route(capsys, f64):
    """The energy route (fp64 whatever --f64 says) after the step route:
    its balance below 1e-9, its receivers bitwise equal to the fp64 step
    route's; against the fp32 step route the difference is fp32's rounding
    of the impulse response (2.5e-5 of max |u_out| here), far below the
    O(1) of another simulation; no plain check."""
    argv = ["--h", "0.5", "--device", "cpu", "--routes", "step,energy",
            "--check"]
    rec, outs = setup_1e9.main(argv + (["--f64"] if f64 else []))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    en = last["setup_1e9"]["routes"]["energy"]
    assert list(outs) == ["step", "energy"]
    assert en["balance"] < 1e-9 and en["E_lost"] > 0
    assert en["checks"] == {} and set(en["launches"].values()) == {0}
    assert en["peak_gb"] is None and en["reckoned_gb"] > 0
    if f64:
        assert np.array_equal(outs["energy"], outs["step"])
        assert rec["receivers_vs_first"] == {"step": 0.0, "energy": 0.0}
    else:
        assert outs["energy"].dtype == np.float64
        assert 0 < rec["energy_fp64_vs_first"] <= 1e-3
        assert rec["receivers_vs_first"] == {"step": 0.0}


def test_setup_1e9_refuses_unknown_routes():
    with pytest.raises(ValueError, match="--routes"):
        setup_1e9.main(["--h", "0.5", "--device", "cpu", "--routes", "pair"])


# ---------------------------------------------- missing data, the card
@pytest.mark.parametrize("what", ["data", "materials"])
@pytest.mark.parametrize("script", ["ctk_cart_rir", "mv_fcc_rir",
                                    "ctk_cart_viz", "mv_fcc_viz",
                                    "bench_mv"])
def test_missing_data_raises_naming_it(script, what, tmp_path, ref_data):
    ref = tmp_path / "data"
    if what == "materials":     # the models are there, materials/ is not
        model = CTK_MODEL if script.startswith("ctk") else MV_MODEL
        (ref / model).parent.mkdir(parents=True)
        (ref / model).write_bytes((ref_data / model).read_bytes())
        missing = ref / "materials"
    else:
        missing = ref / (CTK_MODEL if script.startswith("ctk") else MV_MODEL)
    mod = globals()[script]
    argv = (["--ref", str(ref)] if script == "bench_mv"
            else [str(ref), str(tmp_path / "out")])
    with pytest.raises(FileNotFoundError, match=str(missing)):
        mod.main(argv + ["--device", "cpu"])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("script", ["setup_1e9", "build_material_library",
                                    "ctk_cart_rir", "mv_fcc_rir",
                                    "ctk_cart_viz", "mv_fcc_viz",
                                    "bench_mv"])
def test_default_device_is_the_card(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = {"setup_1e9": ["--h", "0.5"],
            "build_material_library": [str(tmp_path / "lib")],
            "bench_mv": ["--ref", str(tmp_path)]}.get(
                script, [str(tmp_path), str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="cuda"):
        globals()[script].main(argv)
    assert not (tmp_path / "lib").exists()
