"""The last of the JAX package's surface on the port (CPU, plain versions).

- `fp32_eps` on every engine: `EngineData`'s scheme coefficients `==`
  JAX's for None, 0.0 and 1e-3 in fp32 and fp64, Cartesian and FCC; in
  fp64 at 1e-3 the step, tb (TB = 3), pair and energy routes within 1e-12
  of `JaxEngine(backend="xla")` (and H, E_lost, E_in on the energy route,
  whose balance JAX's reproduces, not closing: the functional keeps l2
  unshifted), the x-slab step route at D = 2 within 1e-12 of JAX's
  `ShardedEngine`; 1e-3 moves the receivers off the 0.0 run's by more
  than 1e-9; fp32 at 0.0 within 1e-5 of JAX's fp32; None bitwise the
  value it stands for; a resume at another fp32_eps refused;
- `SimFolder` on a folder the port's setup wrote: each property field-equal
  to JAX's `SimFolder`, and `write_outputs` writing what JAX's writes;
  `EngineData.from_folder` array-equal to `EngineData(*read_sim_folder())`;
- `TorchEngine.bn_ms_per_step`: None where JAX's is (TB routes, energy on,
  no lossy node), else a positive float, measured once; the progress
  lines carry the air / boundary split on the step route only (the CLI's
  `sim` too), and the run's receivers and final state are bitwise those
  of a quiet run;
- the CLI's `sim --fp32_eps`, the option's caller; a checkpoint written
  without the key resumes at the dtype's default shift only; the folded
  FCC box unshifted in fp32 within its rounding bar.
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

from pffdtd_tpu import demo, prep as jprep
from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.jax_engine import JaxEngine
from pffdtd_tpu.io.h5 import SimFolder as JaxSimFolder
from pffdtd_tpu.parallel.sharded_engine import ShardedEngine, make_mesh

import pffdtd_tpu_torch.engine.torch_engine as torch_engine
from pffdtd_tpu_torch import cli
from pffdtd_tpu_torch.engine.coeffs import FP32_EPS
from pffdtd_tpu_torch.engine.data import EngineData
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.io import SimFolder, read_outputs, read_sim_folder
from pffdtd_tpu_torch.parallel.sharded_engine import ShardedTorchEngine
from pffdtd_tpu_torch.prep import fold_fcc_sim_data, sort_sim_data
from pffdtd_tpu_torch.scene import (fold_fcc_sim, make_sloped_room,
                                    mats_from_DEF_list, pad_x_interior,
                                    sort_sim, synthetic_box_sim)
from pffdtd_tpu_torch.scene_setup import sim_setup_from_room

torch.set_num_threads(2)

EPS = 1e-3
SCENES = {
    # name: (box, h, fcc, fold)
    "cart": ((2.5, 2.0, 1.6), 0.1, False, False),
    "fcc-folded": ((2.2, 1.8, 1.5), 0.12, True, True),
}
DEF3 = np.array([[2.0, 5.0, 30.0], [1.0, 10.0, 300.0], [0.5, 8.0, 3000.0]])


@functools.lru_cache(maxsize=None)
def _sim(name, lossy=True, Nt=40):
    box, h, fcc, fold = SCENES[name]
    sim = synthetic_box_sim(*box, h=h, Nt=Nt, fcc=fcc, lossy=lossy,
                            insig_type="hann10", diff_source=False)
    return sort_sim(fold_fcc_sim(sim)) if fold else sim


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(np.asarray(a) - np.asarray(ref)).max() / scale


@functools.lru_cache(maxsize=None)
def _jax_run(name, dtype, eps, energy_on=False):
    """JaxEngine(backend="xla") over the scene's Nt steps: (u_out, the
    engine)."""
    j = JaxEngine(**_kw(_sim(name)), dtype=dtype, backend="xla",
                  fp32_eps=eps, energy_on=energy_on)
    return j.run(verbose=False), j


# ---- fp32_eps
@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eps", [None, 0.0, EPS])
def test_scheme_coeffs_follow_jax_rule(eps, dtype, name):
    sim = _sim(name)
    d = EngineData(**_kw(sim), dtype=dtype, fp32_eps=eps)
    j = JaxEngineData(**_kw(sim), dtype=dtype, fp32_eps=eps, pad_z=None,
                      pad_y=None)
    assert dataclasses.asdict(d.sc) == dataclasses.asdict(j.sc)
    want = {None: FP32_EPS if dtype == np.float32 else 0.0}.get(eps, eps)
    assert d.fp32_eps == want


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("route", ["step", "tb", "pair", "energy"])
def test_eps_routes_match_jax_fp64(route, name):
    energy = route == "energy"
    u_j, j = _jax_run(name, np.float64, EPS, energy_on=energy)
    t = TorchEngine(**_kw(_sim(name)), dtype=np.float64, device="cpu",
                    backend="step" if energy else route, tb=3,
                    energy_on=energy, fp32_eps=EPS)
    assert t.TB == {"step": None, "energy": None, "tb": 3, "pair": 2}[route]
    assert _rel(t.run(verbose=False), u_j) <= 1e-12
    if energy:
        for k in ("H_tot", "E_lost", "E_in"):
            assert _rel(getattr(t, k), getattr(j, k)) <= 1e-12, k
        # JAX's functional keeps l2 unshifted: the balance does not close,
        # and the port's is JAX's
        bal, jbal = t.energy_balance(), j.energy_balance()
        assert np.abs(bal).max() > 1e-3
        assert np.abs(bal - jbal).max() <= 1e-12


def test_eps_x_slab_matches_jax_sharded_engine():
    sim = pad_x_interior(_sim("cart"), 2)
    jsim = jprep.pad_x_interior(demo.synthetic_box_sim(
        *SCENES["cart"][0], h=SCENES["cart"][1], Nt=40, fcc=False,
        lossy=True, insig_type="hann10", diff_source=False), 2)
    assert jsim.vox.Nx == sim.vox.Nx
    u_j = ShardedEngine(**_kw(jsim), mesh=make_mesh(2), dtype=np.float64,
                        pad_z=None, fp32_eps=EPS).run(verbose=False)
    eng = ShardedTorchEngine(**_kw(sim), devices=["cpu"] * 2,
                             dtype=np.float64, backend="step", fp32_eps=EPS)
    assert eng.data.fp32_eps == EPS
    assert _rel(eng.run(verbose=False), u_j) <= 1e-12


@pytest.mark.parametrize("name", list(SCENES))
def test_eps_moves_the_receivers(name):
    kw = dict(**_kw(_sim(name)), dtype=np.float64, device="cpu")
    u0 = TorchEngine(**kw, fp32_eps=0.0).run(verbose=False)
    u1 = TorchEngine(**kw, fp32_eps=EPS).run(verbose=False)
    assert _rel(u1, u0) > 1e-9


def test_eps_zero_fp32_matches_jax():
    # the Cartesian box; the folded FCC one has its own bar (next test)
    u_j, _ = _jax_run("cart", np.float32, 0.0)
    t = TorchEngine(**_kw(_sim("cart")), dtype=np.float32, device="cpu",
                    fp32_eps=0.0)
    assert t.data.sc.sl2 == t.data.sc.a2
    assert _rel(t.run(verbose=False), u_j) <= 1e-5


def test_eps_zero_fp32_fcc_within_rounding():
    """The folded FCC box unshifted in fp32: each engine's rounding grows
    on its own path (ROADMAP C), so the two are held to their fp64 runs
    and to each other at FCC_ROUNDING, about twice the largest reading
    (port 1.27e-5 and JAX 4.8e-6 off fp64, 1.60e-5 apart, over 40 steps
    on the CPU)."""
    FCC_ROUNDING = 3e-5
    u_j32, _ = _jax_run("fcc-folded", np.float32, 0.0)
    u_j64, _ = _jax_run("fcc-folded", np.float64, 0.0)
    kw = dict(**_kw(_sim("fcc-folded")), device="cpu", fp32_eps=0.0)
    u_t32 = TorchEngine(**kw, dtype=np.float32).run(verbose=False)
    u_t64 = TorchEngine(**kw, dtype=np.float64).run(verbose=False)
    assert _rel(u_t64, u_j64) <= 1e-12
    assert _rel(u_t32, u_t64) <= FCC_ROUNDING
    assert _rel(u_j32, u_j64) <= FCC_ROUNDING
    assert _rel(u_t32, u_j32) <= FCC_ROUNDING


@pytest.mark.parametrize("dtype,value", [(np.float32, FP32_EPS),
                                         (np.float64, 0.0)])
def test_eps_none_is_the_default_bitwise(dtype, value):
    kw = dict(**_kw(_sim("cart")), dtype=dtype, device="cpu")
    a = TorchEngine(**kw)
    b = TorchEngine(**kw, fp32_eps=value)
    assert a.data.sc == b.data.sc
    assert np.array_equal(a.run(verbose=False), b.run(verbose=False))
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


def test_resume_refuses_another_eps(tmp_path):
    kw = dict(**_kw(_sim("cart")), dtype=np.float64, device="cpu")
    path = tmp_path / "s.npz"
    TorchEngine(**kw, fp32_eps=EPS).run(nt=10, chunk=5, checkpoint_every=1,
                                        checkpoint_path=path, verbose=False)
    with pytest.raises(ValueError, match="fp32_eps"):
        TorchEngine(**kw).run(nt=20, checkpoint_path=path, resume=True,
                              verbose=False)
    u = TorchEngine(**kw, fp32_eps=EPS).run(
        nt=20, checkpoint_path=path, resume=True, verbose=False)
    assert np.array_equal(
        u, TorchEngine(**kw, fp32_eps=EPS).run(nt=20, verbose=False))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resume_of_a_checkpoint_without_eps(tmp_path, dtype):
    """A checkpoint from before fp32_eps was in the key holds the dtype's
    default shift: it resumes at None (or that value) and no other."""
    kw = dict(**_kw(_sim("cart")), dtype=dtype, device="cpu")
    path = tmp_path / "s.npz"
    TorchEngine(**kw).run(nt=10, chunk=5, checkpoint_every=1,
                          checkpoint_path=path, verbose=False)
    with np.load(path) as z:
        old = {k: z[k] for k in z.files if k != "fp32_eps"}
    assert len(old) > 0
    np.savez(path, **old)
    full = TorchEngine(**kw).run(nt=20, verbose=False)
    for eps in (None, EngineData.default_fp32_eps(dtype)):
        u = TorchEngine(**kw, fp32_eps=eps).run(
            nt=20, checkpoint_path=path, resume=True, verbose=False)
        assert np.array_equal(u, full)
    with pytest.raises(ValueError, match="fp32_eps"):
        TorchEngine(**kw, fp32_eps=EPS).run(
            nt=20, checkpoint_path=path, resume=True, verbose=False)


# ---- SimFolder and EngineData.from_folder
@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A folded, sorted FCC sim folder written by the port's setup."""
    path = tmp_path_factory.mktemp("sim")
    sim_setup_from_room(make_sloped_room(), mats_from_DEF_list([DEF3,
                                                                2 * DEF3]),
                        duration=0.005, insig_type="hann10", h=0.1,
                        fcc_flag=True, vox_backend="native",
                        save_folder=path)
    fold_fcc_sim_data(path)
    sort_sim_data(path)
    return path


def _assert_fields_equal(a, b):
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert type(x) is type(y) or np.asarray(x).dtype == \
            np.asarray(y).dtype, f.name
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f.name)


@pytest.mark.parametrize("prop", ["consts", "comms", "vox", "mats"])
def test_sim_folder_matches_jax(folder, prop):
    sf = SimFolder(folder)
    assert getattr(sf, "_" + prop) is None          # nothing read yet
    a = getattr(sf, prop)
    assert getattr(sf, prop) is a                   # read once
    _assert_fields_equal(a, getattr(JaxSimFolder(folder), prop))


def test_sim_folder_write_outputs_matches_jax(folder, tmp_path):
    sf, jf = SimFolder(folder), JaxSimFolder(folder)
    ro = sf.comms.out_reorder
    assert not np.array_equal(ro, np.arange(ro.size))   # a real reorder
    u = np.random.default_rng(5).standard_normal((ro.size, 7))
    jf.write_outputs(u)
    want = read_outputs(folder)
    sf.write_outputs(u)
    got = read_outputs(folder)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, u[ro])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_engine_data_from_folder(folder, dtype):
    a = EngineData.from_folder(folder, dtype=dtype, fp32_eps=EPS)
    s = read_sim_folder(folder)
    b = EngineData(s.consts, s.vox, s.comms, s.mats, dtype=dtype,
                   fp32_eps=EPS)
    assert a.sc == b.sc and a.grid == b.grid and a.Nbl == b.Nbl > 0
    assert a.infac == b.infac and a.fp32_eps == EPS
    for k in ("adj_grid", "bnl_ixyz", "ssaf_bnl", "mat_bnl", "coef_table",
              "beta", "def_table", "in_ixyz", "out_ixyz", "in_sigs",
              "out_reorder"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert (a.abcq_bnl is None) == (b.abcq_bnl is None)


# ---- the air / boundary split
@pytest.mark.parametrize("kw", [dict(backend="tb"), dict(backend="pair"),
                                dict(energy_on=True)],
                         ids=["tb", "pair", "energy"])
def test_bn_ms_is_none_where_jax_has_none(kw):
    e = TorchEngine(**_kw(_sim("cart")), dtype=np.float64, device="cpu",
                    **kw)
    assert e.bn_ms_per_step() is None


def test_bn_ms_is_none_on_a_rigid_scene():
    e = TorchEngine(**_kw(_sim("cart", lossy=False)), device="cpu")
    assert e.data.Nbl == 0 and e.bn_ms_per_step() is None


def test_bn_ms_measured_once(monkeypatch):
    calls = []
    k2 = torch_engine.boundary_update

    def counted(*a):
        calls.append(1)
        return k2(*a)

    monkeypatch.setattr(torch_engine, "boundary_update", counted)
    monkeypatch.setattr(torch_engine, "BN_ITERS", 4)
    e = TorchEngine(**_kw(_sim("fcc-folded")), device="cpu")
    bn = e.bn_ms_per_step()
    assert isinstance(bn, float) and bn > 0
    assert len(calls) == 5                      # one warm + BN_ITERS
    assert e.bn_ms_per_step() == bn and len(calls) == 5


@pytest.mark.parametrize("backend", ["step", "tb"])
def test_split_on_the_progress_lines(backend, capsys):
    kw = dict(**_kw(_sim("fcc-folded")), dtype=np.float32, device="cpu",
              backend=backend)
    quiet = TorchEngine(**kw)
    u_q = quiet.run(chunk=9, verbose=False)
    loud = TorchEngine(**kw)
    capsys.readouterr()
    u_v = loud.run(chunk=9)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "MVPS inst" in ln]
    assert len(lines) == 4                      # after 9, 18, 27, 36 of 40
    split = [" air " in ln and "% / bn " in ln for ln in lines]
    assert all(split) if backend == "step" else not any(split)
    assert (loud._bn_ms is not None) == (backend == "step")
    assert np.array_equal(u_v, u_q)
    for k in (0, 1, 3, 4):                      # u^{n-1}, u^n, vh, gh
        assert torch.equal(loud.state[k], quiet.state[k])


def test_cli_sim_prints_the_split(folder, tmp_path, capsys):
    d = tmp_path / "sim"
    shutil.copytree(folder, d)
    cli.main(["sim", "--data_dir", str(d), "--device", "cpu", "--f64",
              "--nsteps", "5"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "MVPS inst" in ln]
    assert lines and all(" air " in ln and "% / bn " in ln for ln in lines)
    u = TorchEngine(d, dtype=np.float64, device="cpu").run(verbose=False)
    np.testing.assert_array_equal(read_outputs(d),
                                  u[SimFolder(d).comms.out_reorder])


def test_cli_sim_takes_fp32_eps(folder, tmp_path):
    """`sim --fp32_eps` runs the engine with that shift."""
    d = tmp_path / "sim"
    shutil.copytree(folder, d)
    cli.main(["sim", "--data_dir", str(d), "--device", "cpu", "--f64",
              "--fp32_eps", str(EPS)])
    e = TorchEngine(d, dtype=np.float64, device="cpu", fp32_eps=EPS)
    u = e.run(verbose=False)
    ro = SimFolder(d).comms.out_reorder
    np.testing.assert_array_equal(read_outputs(d), u[ro])
    u0 = TorchEngine(d, dtype=np.float64, device="cpu").run(verbose=False)
    assert _rel(u, u0) > 1e-9
