"""TorchEngine (CPU, the kernels' plain versions) vs the JAX package.

- fp64 vs the NumPy oracle and JaxEngine(backend="xla") to 1e-12 relative
  (tests/test_jax_engine.py's bar): rigid and lossy Cartesian, lossy FCC on
  the interleaved grid (fcc_flag 1) and folded (fcc_flag 2);
- fp32 vs fp64 to 1e-3 (fp32 rounding accumulation, as test_jax_engine);
- fp32 vs the JAX single-step Pallas route in interpret mode to 1e-5
  (test_pallas_stencil.py's bar), Cartesian and folded FCC;
- one step from a random state carried across by convert.state_from_jax_xla,
  vs the JAX XLA step, fp64, to 1e-12;
- the CLI `sim` writes a sim_outs.h5 equal (1e-12) to the JAX CLI's;
- back-to-back runs of one engine: the last run's state is dropped before
  the next one allocates, and the results are bitwise a fresh engine's.
"""

import shutil
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.jax_engine import JaxEngine, build_step
from pffdtd_tpu.engine.numpy_ref import NumpyEngine
from pffdtd_tpu.io.h5 import read_outputs
from pffdtd_tpu.prep import fold_fcc_sim as jax_fold
from pffdtd_tpu.scene_setup import (mats_from_DEF_list, save_sim_data,
                                    sim_setup_from_room)

from conftest import make_shoebox
from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.scene import fold_fcc_sim, sort_sim, synthetic_box_sim

torch.set_num_threads(2)

DEF3 = np.array([[2.0, 5.0, 30.0],
                 [1.0, 10.0, 300.0],
                 [0.5, 8.0, 3000.0]])


def _shoebox(fcc=False, lossy=True, sig="hann10", duration=0.02, h=0.25):
    rg = make_shoebox(mats=["w"] * 6 if lossy else None)
    md = mats_from_DEF_list([DEF3] if lossy else [])
    return sim_setup_from_room(rg, md, duration=duration, insig_type=sig,
                               h=h, fcc_flag=fcc, vox_backend="numpy",
                               block_size=16)


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


SCENES = {
    "rigid-cart": lambda: _shoebox(lossy=False),
    "lossy-cart": lambda: _shoebox(),
    "lossy-fcc": lambda: _shoebox(fcc=True, h=0.2),
    "lossy-fcc-folded": lambda: jax_fold(_shoebox(fcc=True, h=0.2)),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_fp64_matches_oracle_and_xla(name):
    sim = SCENES[name]()    # the JAX package's own scene objects
    o = NumpyEngine(**_kw(sim))
    o.run_all()
    j = JaxEngine(**_kw(sim), dtype=np.float64, backend="xla")
    j.run(verbose=False)
    t = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu")
    u = t.run(verbose=False)
    assert u.shape == o.u_out.shape
    assert _rel(u, o.u_out) < 1e-12
    assert _rel(u, j.u_out) < 1e-12


def test_fp32_tracks_fp64():
    sim = _shoebox(sig="hann20", duration=0.03)
    o = NumpyEngine(**_kw(sim))
    o.run_all()
    t = TorchEngine(**_kw(sim), dtype=np.float32, device="cpu")
    u = t.run(verbose=False)
    assert np.isfinite(u).all()
    assert _rel(u, o.u_out) < 1e-3


def _pallas_interpret(sim, nt):
    """The JAX backend="pallas" route, as tests/test_pallas_stencil.py runs
    it: fused stencil kernel + windowed boundary kernels, interpret mode."""
    from pffdtd_tpu.io.h5 import MMb

    data = JaxEngineData(sim.consts, sim.vox, sim.comms, sim.mats,
                         dtype=np.float32, pad_z=128, tile_x=8,
                         boundary_kernel=True)
    step, C = build_step(data, backend="pallas", interpret=True)
    g = data.grid
    if data.bhyb is not None:
        vhs, u2s = data.bhyb.state_shapes()
        vh = {k: jnp.zeros(s, np.float32) for k, s in vhs.items()}
        gh = {k: jnp.zeros(s, np.float32) for k, s in vhs.items()}
        z = lambda: {k: jnp.zeros(s, np.float32) for k, s in u2s.items()}
        u2 = (z(), z())
    else:
        vh = jnp.zeros((data.Nbl_state, MMb), np.float32)
        gh = jnp.zeros((data.Nbl_state, MMb), np.float32)
        u2 = (jnp.zeros((1,), np.float32), jnp.zeros((1,), np.float32))
    carry = (jnp.zeros(g.shape, np.float32), jnp.zeros(g.shape, np.float32),
             vh, gh, u2)
    sigs = (data.in_sigs[:, :nt] / data.infac).T.astype(np.float32)
    C = jax.tree.map(jnp.asarray, C)
    carry, ys = jax.lax.scan(lambda c, x: step(c, x, C), carry,
                             jnp.asarray(sigs))
    return np.float64(np.asarray(ys).T) * data.infac


@pytest.mark.parametrize("name", ["cart", "fcc-folded"])
def test_fp32_matches_pallas_route(name):
    if name == "cart":
        sim = synthetic_box_sim(2.5, 2.0, 1.6, h=0.1, Nt=40, lossy=True,
                                insig_type="hann10", diff_source=False)
    else:
        # the TPU boundary kernels need the sorted node list (sort_sim)
        sim = sort_sim(fold_fcc_sim(synthetic_box_sim(
            2.2, 1.8, 1.5, h=0.12, Nt=30, lossy=True, fcc=True,
            insig_type="hann10", diff_source=False)))
    t = TorchEngine(**_kw(sim), dtype=np.float32, device="cpu")
    u = t.run(verbose=False)
    assert _rel(u, _pallas_interpret(sim, t.Nt)) < 1e-5


@pytest.mark.parametrize("fcc", [False, True])
def test_one_step_from_random_state(fcc):
    box, h = ((2.2, 1.8, 1.5), 0.12) if fcc else ((2.5, 2.0, 1.6), 0.1)
    sim = synthetic_box_sim(*box, h=h, Nt=4, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    if fcc:
        sim = fold_fcc_sim(sim)
    # the JAX side keeps its TPU padding: the conversion must crop it
    jd = JaxEngineData(sim.consts, sim.vox, sim.comms, sim.mats,
                       dtype=np.float64)
    g = jd.grid
    assert g.shape != (g.Nx, g.Ny, g.Nz)
    rng = np.random.default_rng(4)
    u0, u1 = (np.zeros(g.shape) for _ in range(2))
    for u in (u0, u1):
        u[:g.Nx, :g.Ny, :g.Nz] = rng.standard_normal((g.Nx, g.Ny, g.Nz))
    vh, gh = (rng.standard_normal((jd.Nbl, 12)) for _ in range(2))
    sig = rng.standard_normal(len(jd.in_ixyz))

    step, C = build_step(jd, backend="xla")
    (_, unew_j, vh_j, gh_j), out_j = step(
        tuple(jnp.asarray(a) for a in (u0, u1, vh, gh)), jnp.asarray(sig),
        jax.tree.map(jnp.asarray, C))

    eng = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu")
    for k, v in convert.data_from_jax(jd).items():
        np.testing.assert_array_equal(getattr(eng.data, k), v, err_msg=k)
    state = convert.state_from_jax_xla((u0, u1, vh, gh), jd, eng.data)
    out = torch.zeros(len(eng.data.out_ixyz), dtype=torch.float64)
    eng.step(state, torch.from_numpy(sig), out)
    inner = (slice(1, g.Nx - 1), slice(1, g.Ny - 1), slice(1, g.Nz - 1))
    assert _rel(state[1].numpy()[inner], np.asarray(unew_j)[inner]) < 1e-12
    assert _rel(state[3].numpy().T, np.asarray(vh_j)) < 1e-12
    assert _rel(state[4].numpy().T, np.asarray(gh_j)) < 1e-12
    assert _rel(out.numpy(), np.asarray(out_j)) < 1e-12
    # the new u^{n-1} is the old u^n
    assert np.array_equal(state[0].numpy(), u1[:g.Nx, :g.Ny, :g.Nz])


def test_cli_sim_matches_jax_cli(tmp_path):
    from pffdtd_tpu.cli import main as jax_main
    from pffdtd_tpu_torch.cli import main as torch_main

    # folded + sorted: out_reorder is not the identity
    sim = sort_sim(fold_fcc_sim(synthetic_box_sim(
        2.2, 1.8, 1.5, h=0.12, Nt=24, fcc=True, lossy=True,
        insig_type="hann10", diff_source=False,
        Rxyz=[[1.5, 1.4, 0.6], [0.5, 0.4, 1.0], [1.0, 1.2, 0.8]])))
    assert not np.array_equal(sim.comms.out_reorder,
                              np.arange(sim.comms.Nr))
    a, b = tmp_path / "jax", tmp_path / "torch"
    save_sim_data(sim, a)
    shutil.copytree(a, b)
    jax_main(["sim", "--data_dir", str(a), "--f64"])
    torch_main(["sim", "--data_dir", str(b), "--f64", "--nsteps", "8",
                "--device", "cpu"])
    ua, ub = read_outputs(a), read_outputs(b)
    assert ua.shape == ub.shape == (sim.comms.Nr, 24)
    assert _rel(ub, ua) < 1e-12


@pytest.mark.parametrize("route", ["step", "tb", "energy"])
def test_back_to_back_runs_hold_one_state(route):
    """A second run of one engine allocates its state only once the first
    run's five tensors are gone; each run leaves its final state on
    `eng.state`; both runs give receivers and a final state bitwise those
    of a fresh engine's single run (fp64, folded FCC, 31 steps: the tb
    route runs its tail steps too)."""
    sim = sort_sim(fold_fcc_sim(synthetic_box_sim(
        2.2, 1.8, 1.5, h=0.12, Nt=31, fcc=True, lossy=True,
        insig_type="hann10", diff_source=False)))
    kw = dict(**_kw(sim), dtype=np.float64, device="cpu",
              backend="tb" if route == "tb" else "step", tb=3,
              energy_on=route == "energy")
    eng = TorchEngine(**kw)
    held, alive = [], []    # weak references to each run's tensors
    init = eng.init_state

    def init_state():
        if held:    # the last run's, when the next one allocates
            alive.append(sum(r() is not None for r in held))
        state = init()
        held[:] = [weakref.ref(t) for t in state]
        return state

    eng.init_state = init_state
    runs = []
    for _ in range(2):
        u = eng.run(verbose=False)
        assert eng.state is not None and len(eng.state) == 5
        held += [weakref.ref(t) for t in eng.state]     # the final state
        runs.append((u, [t.clone() for t in eng.state]))
    assert alive == [0]
    fresh = TorchEngine(**kw)
    u_ref = fresh.run(verbose=False)
    for u, state in runs:
        assert np.array_equal(u, u_ref)
        for a, b in zip(state, fresh.state):
            assert torch.equal(a, b)
    if route == "energy":
        assert np.array_equal(eng.H_tot, fresh.H_tot)
