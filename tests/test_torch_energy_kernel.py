"""K7's plain passes and K8's plain recurrence (CPU) vs the JAX package.

- `energy_grid_pass_plain` + one step + `energy_boundary_pass_plain` from a
  seeded random state with random halos vs JAX's `step_energy`
  (build_step(energy=True, backend="xla")) on the cart, fcc and folded fcc
  small scenes: L u^n, H, E_lost and E_in <= 1e-12 of their magnitude in
  fp64; in fp32 against JAX's fp32 step <= 1e-5 (the repo's fp32 bar of a
  kernel against a composed path, tests/test_pallas_stencil.py:50: sums
  over the grid in another order);
- the engine's rewired `step_energy` (`TorchEngine(device="cpu",
  energy_on=True)`) vs `NumpyEngine` <= 1e-12, balance < 1e-10, and the
  plain pair through `use_kernels=False` giving the same bits;
- the wrappers' argument checks (dtype, shape, device mixing, L u aliasing
  u^{n-1} or u^n, a device neither cpu nor cuda) and K8's;
- the CPU `modal_recurrence` (K8's plain version) equal to
  `modal_recurrence_plain` bit for bit and to JAX's
  `apply_modal_filter(use_jax=True)` recurrence <= 1e-12.
K7 and K8 themselves run on the card: tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pffdtd_tpu.analysis import air_abs as jair
from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.jax_engine import build_step

from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.analysis import air_abs
from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.kernels.energy import (energy_boundary_pass,
                                             energy_boundary_pass_plain,
                                             energy_grid_pass_plain,
                                             scratch_size)
from pffdtd_tpu_torch.kernels.modal import modal_scan, modal_scan_plain
from pffdtd_tpu_torch.kernels.stencil import stencil_energy_step
from pffdtd_tpu_torch.scene import fold_fcc_sim, synthetic_box_sim

torch.set_num_threads(2)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _sim(scene, nt=4):
    fcc = scene != "cart"
    box, h = ((2.2, 1.8, 1.5), 0.12) if fcc else ((2.5, 2.0, 1.6), 0.1)
    sim = synthetic_box_sim(*box, h=h, Nt=nt, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    return fold_fcc_sim(sim) if scene == "fcc-folded" else sim


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("scene", ["cart", "fcc", "fcc-folded"])
def test_plain_passes_match_jax_step_energy(scene, dtype):
    sim = _sim(scene)
    jd = JaxEngineData(sim.consts, sim.vox, sim.comms, sim.mats, dtype=dtype)
    g = jd.grid
    rng = np.random.default_rng(23)
    true = (slice(0, g.Nx), slice(0, g.Ny), slice(0, g.Nz))
    u0, u1, Lu = (np.zeros(g.shape, dtype) for _ in range(3))
    for u in (u0, u1):          # random halos too
        u[true] = rng.standard_normal((g.Nx, g.Ny, g.Nz))
    inner = (slice(1, g.Nx - 1), slice(1, g.Ny - 1), slice(1, g.Nz - 1))
    Lu[inner] = rng.standard_normal((g.Nx - 2, g.Ny - 2, g.Nz - 2))
    vh, gh = (rng.standard_normal((jd.Nbl, 12)).astype(dtype)
              for _ in range(2))
    E_lost, E_in = rng.uniform(0.5, 1.5, 2).astype(dtype)
    sig = rng.standard_normal(len(jd.in_ixyz)).astype(dtype)

    step, C = build_step(jd, energy=True, backend="xla")
    carry = tuple(jnp.asarray(a) for a in (u0, u1, vh, gh, Lu, E_lost,
                                           E_in))
    (_, _, _, _, Lu_j, _, _), (_, H_j, El_j, Ei_j) = step(
        carry, jnp.asarray(sig), jax.tree.map(jnp.asarray, C))

    eng = TorchEngine(**_kw(sim), dtype=dtype, device="cpu", energy_on=True)
    es, d = eng.energy_scene, eng.data
    state = convert.state_from_jax_xla((u0, u1, vh, gh), jd, d)
    u0_t = state[0]
    Lu_t = torch.from_numpy(convert.crop(Lu, g))
    part = torch.zeros(scratch_size(d.grid, d.Nbl), dtype=torch.float64)
    energy_grid_pass_plain(es, u0_t, state[1], Lu_t, part)
    vh_prev, gh_prev = state[3].clone(), state[4].clone()
    sig_t = torch.from_numpy(sig)
    eng.step(state, sig_t)
    H = torch.empty((), dtype=eng.dtype)
    El, Ei = torch.tensor(E_lost), torch.tensor(E_in)
    energy_boundary_pass_plain(es, state[1], u0_t, state[3], vh_prev,
                               gh_prev, sig_t, part, H, El, Ei)
    assert H.dtype == El.dtype == Ei.dtype == Lu_t.dtype == eng.dtype
    tol = TOL[dtype]
    assert _rel(Lu_t.numpy(), convert.crop(np.asarray(Lu_j), g)) <= tol
    assert _rel(float(H), float(H_j)) <= tol
    assert _rel(float(El), float(El_j)) <= tol
    assert _rel(float(Ei), float(Ei_j)) <= tol


@pytest.mark.parametrize("scene", ["cart", "fcc", "fcc-folded"])
def test_engine_energy_matches_oracle(scene):
    sim = _sim(scene, nt=30)
    o = NumpyEngine(**_kw(sim), energy_on=True)
    o.run_all()
    t = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu",
                    energy_on=True)
    u = t.run(verbose=False)
    n = o.n
    assert _rel(u, o.u_out) <= 1e-12
    assert _rel(t.H_tot, o.H_tot[:n]) <= 1e-12
    assert _rel(t.E_lost, o.E_lost[1:n + 1]) <= 1e-12
    assert _rel(t.E_in, o.E_in[1:n + 1]) <= 1e-12
    assert np.abs(t.energy_balance()).max() < 1e-10 and t.E_lost[-1] > 0
    p = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu",
                    energy_on=True, use_kernels=False)
    p.run(verbose=False)
    for k in ("u_out", "H_tot", "E_lost", "E_in"):
        assert np.array_equal(getattr(p, k), getattr(t, k)), k


def _grid_args(eng):
    """K1e's arguments (`stencil_energy_step`, whose grid half runs K7's
    checks): u0, u1, adj, out, Lu, part, grid, sc, es."""
    d, es = eng.data, eng.energy_scene
    z = lambda: torch.zeros(d.grid.shape, dtype=eng.dtype)
    part = torch.zeros(scratch_size(d.grid, d.Nbl), dtype=torch.float64)
    return [z(), z(), es.adj, z(), z(), part, d.grid, d.sc, es]


def _boundary_args(eng):
    d = eng.data
    es, z = eng.energy_scene, lambda *s: torch.zeros(s, dtype=eng.dtype)
    part = torch.zeros(scratch_size(d.grid, d.Nbl), dtype=torch.float64)
    return [es, z(*d.grid.shape), z(*d.grid.shape), z(12, d.Nbl),
            z(12, d.Nbl), z(12, d.Nbl), z(d.in_ixyz.size), part, z(), z(),
            z()]


def test_energy_wrappers_refuse_bad_arguments():
    sim = _sim("fcc")
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device="cpu",
                      energy_on=True)
    g = _grid_args(eng)
    stencil_energy_step(*g)                       # well-formed: runs
    bad = list(g)
    bad[0] = g[0].double()                        # u0 in another dtype
    with pytest.raises(TypeError, match="u0"):
        stencil_energy_step(*bad)
    bad = list(g)
    bad[4] = g[4][:, :, :-1].contiguous()         # Lu of another shape
    with pytest.raises(ValueError, match="Lu"):
        stencil_energy_step(*bad)
    bad = list(g)
    bad[5] = g[5][:-1]                            # scratch too small
    with pytest.raises(ValueError, match="part"):
        stencil_energy_step(*bad)
    for alias in (0, 1):                          # Lu is u^{n-1} or u^n
        bad = list(g)
        bad[4] = g[alias]
        with pytest.raises(ValueError, match="distinct"):
            stencil_energy_step(*bad)
    bad = list(g)
    bad[1] = g[1].to("meta")                      # one tensor elsewhere
    with pytest.raises(ValueError, match="one device"):
        stencil_energy_step(*bad)
    b = _boundary_args(eng)
    energy_boundary_pass(*b)
    bad = list(b)
    bad[6] = b[6].double()                        # sig in another dtype
    with pytest.raises(TypeError, match="sig"):
        energy_boundary_pass(*bad)
    bad = list(b)
    bad[2] = b[1]                                 # unew is u^{n-1}
    with pytest.raises(ValueError, match="distinct"):
        energy_boundary_pass(*bad)
    bad = list(b)
    bad[9] = b[8]                                 # E_lost is H
    with pytest.raises(ValueError, match="distinct"):
        energy_boundary_pass(*bad)
    bad = list(b)
    bad[8] = torch.zeros(1, dtype=eng.dtype)      # H not 0-d
    with pytest.raises(ValueError, match="H"):
        energy_boundary_pass(*bad)


def test_energy_wrappers_refuse_a_device_neither_cpu_nor_cuda():
    """Every tensor, the scene's too, on the meta device."""
    sim = _sim("cart")
    eng = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu",
                      energy_on=True)
    es = eng.energy_scene
    meta = dataclasses.replace(es, **{k: getattr(es, k).to("meta") for k in (
        "adj", "ssaf", "mat", "def_table", "in_ixyz")})
    g = [t.to("meta") for t in _grid_args(eng)[:6]] + [eng.data.grid,
                                                        eng.data.sc, meta]
    with pytest.raises(ValueError, match="cpu or cuda only"):
        stencil_energy_step(*g)
    b = [meta] + [t.to("meta") for t in _boundary_args(eng)[1:]]
    with pytest.raises(ValueError, match="cpu or cuda only"):
        energy_boundary_pass(*b)


@pytest.mark.parametrize("Fs, T, nch, pad_t", [(8000.0, 0.04, 1, 0.0),
                                               (48000.0, 0.02, 2, 0.005)])
def test_modal_recurrence_cpu_matches_plain_and_jax(Fs, T, nch, pad_t):
    rng = np.random.default_rng(int(Fs) + nch)
    x = rng.standard_normal((nch, int(T * Fs)))
    setup = air_abs._modal_setup(x, Fs, 20.0, 50.0, pad_t)
    P = air_abs.modal_recurrence(*setup, device="cpu")
    Pn = air_abs.modal_recurrence_plain(*setup)
    assert P.shape == Pn.shape == (nch, setup[2].shape[1])
    assert np.array_equal(P, Pn)
    kw = dict(Tc=20.0, rh=50.0, pad_t=pad_t)
    y = air_abs.apply_modal_filter(x, Fs, device="cpu", **kw)
    yj = jair.apply_modal_filter(x, Fs, use_jax=True, **kw)
    assert _rel(y, yj) <= 1e-12


def test_modal_scan_refuses_bad_arguments():
    nch, nt = 2, 16
    f = lambda *s: torch.zeros(s, dtype=torch.float64)
    args = [f(nt), f(nt), f(nch, nt), f(nch, nt), f(nch, nt + 1),
            f(nch, nt)]
    modal_scan(*args)
    assert np.array_equal(modal_scan_plain(*args).numpy(), np.zeros((2, 16)))
    bad = list(args)
    bad[4] = f(nch, nt)                            # u one sample short
    with pytest.raises(ValueError, match="u"):
        modal_scan(*bad)
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(TypeError, match="a1"):
        modal_scan(*bad)
    bad = list(args)
    bad[5] = args[2]                               # out is F1
    with pytest.raises(ValueError, match="own"):
        modal_scan(*bad)
    bad = list(args)
    bad[3] = args[3].to("meta")
    with pytest.raises(ValueError, match="one device"):
        modal_scan(*bad)
    with pytest.raises(ValueError, match="cpu or cuda only"):
        modal_scan(*[a.to("meta") for a in args])
