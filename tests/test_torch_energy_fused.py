"""K1's energy mode (K1e, `stencil_energy_step`) on the CPU: its plain
version and the engine's energy route against K7's plain passes and JAX.

- `stencil_energy_step_plain` (and the wrapper on CPU tensors) bit for bit
  equal to `energy_grid_pass_plain` followed by `stencil_step_plain`, from
  a seeded random state with random halos on the cart, fcc and folded fcc
  small scenes, in fp64 and fp32: L u^n, H[n]'s grid terms and u^{n+1};
- one energy step of the engine (`TorchEngine.step_energy`, which runs
  K1e and K7's boundary pass) from such a state vs JAX's `step_energy`
  (build_step(energy=True, backend="xla")): u^{n+1}, the branch states,
  L u^n, the receivers, H, E_lost and E_in <= 1e-12 of their magnitude in
  fp64, <= 1e-5 in fp32 (the bar of tests/test_torch_energy_kernel.py);
- whole runs of the engine's energy route bit for bit equal to the
  two-pass route (K7's plain grid half, the step, K7's plain boundary
  pass), and the route calling K1e once a step and K1
  never;
- the wrapper refusing other dtypes, shapes, devices, a scene of another
  grid or adjacency, a short scratch and `out` aliasing L u.
K1e itself runs on the card: tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.jax_engine import build_step

from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.engine import torch_engine
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.kernels import stencil
from pffdtd_tpu_torch.kernels.energy import (energy_boundary_pass_plain,
                                             energy_grid_pass_plain,
                                             scratch_size)
from pffdtd_tpu_torch.kernels.stencil import (stencil_energy_step,
                                              stencil_energy_step_plain,
                                              stencil_step_plain)
from pffdtd_tpu_torch.scene import fold_fcc_sim, synthetic_box_sim

torch.set_num_threads(2)

SCENES = ["cart", "fcc", "fcc-folded"]
DTYPES = [np.float64, np.float32]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _sim(scene, nt=4):
    fcc = scene != "cart"
    box, h = ((2.2, 1.8, 1.5), 0.12) if fcc else ((2.5, 2.0, 1.6), 0.1)
    sim = synthetic_box_sim(*box, h=h, Nt=nt, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    return fold_fcc_sim(sim) if scene == "fcc-folded" else sim


def _engine(sim, dtype, **kw):
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=dtype, device="cpu",
                       energy_on=True, **kw)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


def _random_fields(eng, seed):
    """u^{n-1}, u^n (random halos too) and L u^{n-1} (zero halos, as the
    engine keeps it), from numpy's seeded generator."""
    g = eng.data.grid.shape
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(eng.data.dtype))
    u0, u1 = t(rng.standard_normal(g)), t(rng.standard_normal(g))
    Lu = torch.zeros(g, dtype=eng.dtype)
    Lu[1:-1, 1:-1, 1:-1] = t(rng.standard_normal([n - 2 for n in g]))
    return u0, u1, Lu


def _part(eng):
    return torch.zeros(scratch_size(eng.data.grid, eng.data.Nbl),
                       dtype=torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scene", SCENES)
def test_plain_equals_grid_pass_then_step(scene, dtype):
    eng = _engine(_sim(scene), dtype)
    d, es = eng.data, eng.energy_scene
    u0, u1, Lu = _random_fields(eng, seed=31)
    u0c, u1c = u0.clone(), u1.clone()
    Lu_ref, part_ref = Lu.clone(), _part(eng)
    out_ref = torch.full_like(u0, 7.0)       # halos are never written
    energy_grid_pass_plain(es, u0, u1, Lu_ref, part_ref)
    stencil_step_plain(u0, u1, eng.adj, out_ref, d.grid, d.sc)
    for fn in (stencil_energy_step_plain, stencil_energy_step):
        L, part, out = Lu.clone(), _part(eng), torch.full_like(u0, 7.0)
        assert fn(u0, u1, eng.adj, out, L, part, d.grid, d.sc, es) is out
        assert torch.equal(out, out_ref) and torch.equal(L, Lu_ref)
        assert torch.equal(part, part_ref) and part[0] != 0
    assert torch.equal(u0, u0c) and torch.equal(u1, u1c)
    assert stencil_energy_step.launches == 0    # CPU tensors: the plain one


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scene", SCENES)
def test_engine_energy_step_matches_jax_step_energy(scene, dtype):
    sim = _sim(scene)
    jd = JaxEngineData(sim.consts, sim.vox, sim.comms, sim.mats, dtype=dtype)
    g = jd.grid
    rng = np.random.default_rng(37)
    true = (slice(0, g.Nx), slice(0, g.Ny), slice(0, g.Nz))
    inner = (slice(1, g.Nx - 1), slice(1, g.Ny - 1), slice(1, g.Nz - 1))
    u0, u1, Lu = (np.zeros(g.shape, dtype) for _ in range(3))
    for u in (u0, u1):          # random halos too
        u[true] = rng.standard_normal((g.Nx, g.Ny, g.Nz))
    Lu[inner] = rng.standard_normal((g.Nx - 2, g.Ny - 2, g.Nz - 2))
    vh, gh = (rng.standard_normal((jd.Nbl, 12)).astype(dtype)
              for _ in range(2))
    E_lost, E_in = rng.uniform(0.5, 1.5, 2).astype(dtype)
    sig = rng.standard_normal(len(jd.in_ixyz)).astype(dtype)

    step, C = build_step(jd, energy=True, backend="xla")
    carry = tuple(jnp.asarray(a) for a in (u0, u1, vh, gh, Lu, E_lost,
                                           E_in))
    (_, un_j, vh_j, gh_j, Lu_j, _, _), (out_j, H_j, El_j, Ei_j) = step(
        carry, jnp.asarray(sig), jax.tree.map(jnp.asarray, C))

    eng = _engine(sim, dtype)
    d = eng.data
    state = convert.state_from_jax_xla((u0, u1, vh, gh), jd, d)
    en = eng._energy_carry(1)
    en.Lu.copy_(torch.from_numpy(convert.crop(Lu, g)))
    en.E_lost.fill_(float(E_lost))
    en.E_in.fill_(float(E_in))
    out = torch.zeros(d.out_ixyz.size, dtype=eng.dtype)
    H = eng.step_energy(state, torch.from_numpy(sig), out, en)
    assert H.dtype == en.E_lost.dtype == en.Lu.dtype == eng.dtype
    tol = TOL[dtype]
    crop = lambda a: convert.crop(np.asarray(a), g)
    assert _rel(state[1][1:-1, 1:-1, 1:-1].numpy(),
                crop(un_j)[1:-1, 1:-1, 1:-1]) <= tol
    assert _rel(state[3].numpy().T, np.asarray(vh_j)) <= tol
    assert _rel(state[4].numpy().T, np.asarray(gh_j)) <= tol
    assert _rel(en.Lu.numpy(), crop(Lu_j)) <= tol
    assert _rel(out.numpy(), np.asarray(out_j)) <= tol
    assert _rel(float(H), float(H_j)) <= tol
    assert _rel(float(en.E_lost), float(El_j)) <= tol
    assert _rel(float(en.E_in), float(Ei_j)) <= tol


def _two_pass_step_energy(eng, state, sig_n, out_row, en):
    """The energy step as two K7 passes around K1's step, from the plain
    wrappers: what the engine ran before K1's energy mode."""
    es = eng.energy_scene
    u0, u1, _, vh, gh = state
    energy_grid_pass_plain(es, u0, u1, en.Lu, en.part)
    en.vh_prev.copy_(vh)
    en.gh_prev.copy_(gh)
    eng.step(state, sig_n, out_row, k1=stencil_step_plain)
    H = torch.empty((), dtype=eng.dtype)
    return energy_boundary_pass_plain(es, state[1], u0, state[3],
                                      en.vh_prev, en.gh_prev, sig_n, en.part,
                                      H, en.E_lost, en.E_in)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scene", SCENES)
def test_energy_route_equals_two_pass_route(monkeypatch, scene, dtype,
                                            use_kernels):
    sim = _sim(scene, nt=12)
    calls = {"k1e": 0, "k1": 0}

    def counted(name, fn):
        def f(*a):
            calls[name] += 1
            return fn(*a)
        return f

    monkeypatch.setattr(torch_engine, "stencil_energy_step",
                        counted("k1e", stencil_energy_step))
    monkeypatch.setattr(torch_engine, "stencil_energy_step_plain",
                        counted("k1e", stencil_energy_step_plain))
    monkeypatch.setattr(torch_engine, "stencil_step",
                        counted("k1", stencil.stencil_step))
    monkeypatch.setattr(torch_engine, "stencil_step_plain",
                        counted("k1", stencil_step_plain))
    e = _engine(sim, dtype, use_kernels=use_kernels)
    e.run(verbose=False)
    assert calls == {"k1e": e.Nt, "k1": 0}
    t = _engine(sim, dtype)
    t.step_energy = lambda *a: _two_pass_step_energy(t, *a)
    t.run(verbose=False)
    for k in ("u_out", "H_tot", "E_lost", "E_in"):
        assert np.array_equal(getattr(e, k), getattr(t, k)), k
    assert np.abs(e.u_out).max() > 0 and e.E_in[-1] > 0
    for a, b in zip(e.state, t.state):
        assert torch.equal(a, b)


def _args(eng):
    d = eng.data
    z = lambda: torch.zeros(d.grid.shape, dtype=eng.dtype)
    return [z(), z(), eng.adj, z(), z(), _part(eng), d.grid, d.sc,
            eng.energy_scene]


def test_energy_step_refuses_bad_arguments():
    eng = _engine(_sim("fcc"), np.float32)
    a = _args(eng)
    stencil_energy_step(*a)                        # well-formed: runs

    def refuses(i, value, err, match):
        bad = list(a)
        bad[i] = value
        with pytest.raises(err, match=match):
            stencil_energy_step(*bad)

    refuses(0, a[0].double(), TypeError, "u0")     # another dtype
    refuses(4, a[4].double(), TypeError, "Lu")
    refuses(3, a[3][:, :, :-1].contiguous(), ValueError, "out")
    refuses(4, a[4][:, :-1].contiguous(), ValueError, "Lu")
    refuses(5, a[5][:-1], ValueError, "part")      # scratch too short
    refuses(5, a[5].float(), TypeError, "part")
    refuses(2, a[2].to(torch.uint8), ValueError, "adj")
    refuses(2, a[2].clone(), ValueError, "adjacency")  # not the scene's
    refuses(4, a[3], ValueError, "distinct")       # out is L u
    for i in (0, 1):                               # L u is u^{n-1}, u^n
        refuses(4, a[i], ValueError, "distinct")
    refuses(1, a[1].to("meta"), ValueError, "one device")
    es = eng.energy_scene                          # not the scene's grid
    refuses(6, dataclasses.replace(es.grid, fcc_flag=2), ValueError, "grid")
    meta = dataclasses.replace(es, **{k: getattr(es, k).to("meta") for k in (
        "adj", "ssaf", "mat", "def_table", "in_ixyz")})
    m = [t.to("meta") for t in a[:6]] + [a[6], a[7], meta]
    with pytest.raises(ValueError, match="cpu or cuda only"):
        stencil_energy_step(*m)
