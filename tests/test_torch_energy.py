"""The port's energy accounting (CPU, the plain versions) vs the JAX package.

- fp64 `H_tot`, `E_lost`, `E_in` of TorchEngine(energy_on=True) vs
  JaxEngine(energy_on=True) and NumpyEngine(energy_on=True), <= 1e-12 of
  each series' largest magnitude; the balance < 1e-10 (the bar of
  tests/test_jax_engine.py) and E_lost[-1] > 0 on the lossy scenes: rigid
  and lossy Cartesian, lossy FCC (fcc_flag 1) and folded (fcc_flag 2);
- the receivers of an energy run bitwise equal to the same run without;
- one energy step from a random state with random halos, carried across by
  convert.state_from_jax_xla plus the energy carry, vs JAX's `step_energy`
  (build_step(energy=True)), fp64, <= 1e-12: H, L u^n, E_lost, E_in,
  u^{n+1}, the branch states and the receivers.  The halos are random, so
  a Laplacian that does not read them through the mirror flips fails;
- energy on the TB routes is refused, as JAX asserts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.jax_engine import JaxEngine, build_step
from pffdtd_tpu.engine.numpy_ref import NumpyEngine
from pffdtd_tpu.prep import fold_fcc_sim as jax_fold
from pffdtd_tpu.scene_setup import mats_from_DEF_list, sim_setup_from_room

from conftest import make_shoebox
from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.scene import fold_fcc_sim, synthetic_box_sim

torch.set_num_threads(2)

DEF3 = np.array([[2.0, 5.0, 30.0],
                 [1.0, 10.0, 300.0],
                 [0.5, 8.0, 3000.0]])


def _shoebox(fcc=False, lossy=True, h=0.25):
    rg = make_shoebox(mats=["w"] * 6 if lossy else None)
    md = mats_from_DEF_list([DEF3] if lossy else [])
    return sim_setup_from_room(rg, md, duration=0.02, insig_type="hann10",
                               h=h, fcc_flag=fcc, vox_backend="numpy",
                               block_size=16)


SCENES = {
    "rigid-cart": lambda: _shoebox(lossy=False),
    "lossy-cart": lambda: _shoebox(),
    "lossy-fcc": lambda: _shoebox(fcc=True, h=0.2),
    "lossy-fcc-folded": lambda: jax_fold(_shoebox(fcc=True, h=0.2)),
}


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(np.asarray(a) - np.asarray(ref)).max() / scale


@pytest.mark.parametrize("name", list(SCENES))
def test_energy_matches_jax_and_oracle(name):
    sim = SCENES[name]()
    o = NumpyEngine(**_kw(sim), energy_on=True)
    o.run_all()
    j = JaxEngine(**_kw(sim), dtype=np.float64, energy_on=True)
    j.run(verbose=False)
    t = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu",
                    energy_on=True)
    u = t.run(verbose=False)
    n = o.n
    assert t.H_tot.shape == t.E_lost.shape == t.E_in.shape == (n,)
    # the oracle's E rows are pre-step (E[0] = 0), the engines' post-step
    for mine, jax_, ora in ((t.H_tot, j.H_tot, o.H_tot[:n]),
                            (t.E_in, j.E_in, o.E_in[1:n + 1])):
        assert _rel(mine, jax_) < 1e-12
        assert _rel(mine, ora) < 1e-12
    assert np.abs(t.energy_balance()).max() < 1e-10
    if name == "rigid-cart":
        assert not t.E_lost.any() and not o.E_lost.any()
    else:
        assert t.E_lost[-1] > 0
        assert _rel(t.E_lost, j.E_lost) < 1e-12
        assert _rel(t.E_lost, o.E_lost[1:n + 1]) < 1e-12
    assert _rel(u, o.u_out) < 1e-12
    off = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu").run(
        verbose=False)
    assert np.array_equal(u, off)


@pytest.mark.parametrize("scene", ["cart", "fcc", "fcc-folded"])
def test_energy_step_from_random_state(scene):
    fcc = scene != "cart"
    box, h = ((2.2, 1.8, 1.5), 0.12) if fcc else ((2.5, 2.0, 1.6), 0.1)
    sim = synthetic_box_sim(*box, h=h, Nt=4, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    if scene == "fcc-folded":
        sim = fold_fcc_sim(sim)
    jd = JaxEngineData(sim.consts, sim.vox, sim.comms, sim.mats,
                       dtype=np.float64)
    g = jd.grid
    rng = np.random.default_rng(11)
    true = (slice(0, g.Nx), slice(0, g.Ny), slice(0, g.Nz))
    u0, u1, Lu = (np.zeros(g.shape) for _ in range(3))
    for u in (u0, u1):          # random halos too
        u[true] = rng.standard_normal((g.Nx, g.Ny, g.Nz))
    inner = (slice(1, g.Nx - 1), slice(1, g.Ny - 1), slice(1, g.Nz - 1))
    Lu[inner] = rng.standard_normal((g.Nx - 2, g.Ny - 2, g.Nz - 2))
    vh, gh = (rng.standard_normal((jd.Nbl, 12)) for _ in range(2))
    E_lost, E_in = rng.uniform(0.5, 1.5, 2)
    sig = rng.standard_normal(len(jd.in_ixyz))

    step, C = build_step(jd, energy=True, backend="xla")
    carry = tuple(jnp.asarray(a) for a in (u0, u1, vh, gh, Lu, E_lost,
                                           E_in))
    (_, unew_j, vh_j, gh_j, Lu_j, _, _), (out_j, H_j, El_j, Ei_j) = step(
        carry, jnp.asarray(sig), jax.tree.map(jnp.asarray, C))

    eng = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, dtype=np.float64, device="cpu",
                      energy_on=True)
    state = convert.state_from_jax_xla((u0, u1, vh, gh), jd, eng.data)
    en = eng._energy_carry(1)
    en.Lu.copy_(torch.from_numpy(convert.crop(Lu, g)))
    en.E_lost.fill_(E_lost)
    en.E_in.fill_(E_in)
    out = torch.zeros(len(eng.data.out_ixyz), dtype=torch.float64)
    H = eng.step_energy(state, torch.from_numpy(sig), out, en)

    assert _rel(float(H), float(H_j)) < 1e-12
    assert _rel(float(en.E_lost), float(El_j)) < 1e-12
    assert _rel(float(en.E_in), float(Ei_j)) < 1e-12
    crop = lambda a: convert.crop(np.asarray(a), g)
    assert _rel(en.Lu.numpy(), crop(Lu_j)) < 1e-12
    assert _rel(state[1].numpy()[inner], np.asarray(unew_j)[inner]) < 1e-12
    assert _rel(state[3].numpy().T, np.asarray(vh_j)) < 1e-12
    assert _rel(state[4].numpy().T, np.asarray(gh_j)) < 1e-12
    assert _rel(out.numpy(), np.asarray(out_j)) < 1e-12


@pytest.mark.parametrize("backend", ["tb", "pair"])
def test_energy_on_tb_routes_is_refused(backend):
    sim = synthetic_box_sim(1.2, 1.0, 0.9, h=0.1, Nt=4, lossy=True,
                            insig_type="hann10")
    with pytest.raises(ValueError, match="step route"):
        TorchEngine(**_kw(sim), device="cpu", backend=backend,
                    energy_on=True)
    eng = TorchEngine(**_kw(sim), device="cpu")
    eng.run(verbose=False)
    with pytest.raises(ValueError, match="energy_on"):
        eng.energy_balance()
