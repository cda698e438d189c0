"""The port's pair route (K3 with TB = 2, plain version on the CPU) vs the
JAX pair kernel `build_fused_pair` in interpret mode.

- whole runs, as tests/test_pallas_pair.py:17-76 runs the JAX kernel: lossy
  axis planes on FCC and an all-strays Cartesian box, fp32 <= 1e-5 of max
  |u_out| (the JAX kernel sums stencil legs grouped by dz: fp32
  association drift, the bound tests/test_pallas_pair.py sets);
- one sweep from the same random non-zero fields and branch states, carried
  into the JAX plane/stray layouts by `convert.state_to_planes` and back by
  `convert.state_from_planes`, fp32 <= 1e-5;
- `state_from_planes` and `state_to_planes` invert each other exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.jax_engine import build_step

import test_pallas_pair as tpp
from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.engine.data import EngineData
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.scene import synthetic_box_sim

torch.set_num_threads(2)

CASES = {
    # name: (box, h, fcc, PFFDTD_ZPLANE_MIN_COUNT, _DENSITY): thresholds as
    # tests/test_pallas_pair.py sets them
    "planes-fcc": ((2.2, 1.8, 1.5), 0.12, True, "1", "0.12"),
    "planes-cart": ((2.5, 2.0, 1.6), 0.1, False, "1", "0.3"),
    "strays-cart": ((2.5, 2.0, 1.6), 0.1, False, "1000000000", "0.05"),
}


def _case(monkeypatch, name, Nt=30):
    box, h, fcc, count, density = CASES[name]
    monkeypatch.setenv("PFFDTD_ZPLANE_MIN_COUNT", count)
    monkeypatch.setenv("PFFDTD_ZPLANE_MIN_DENSITY", density)
    return synthetic_box_sim(*box, h=h, Nt=Nt, fcc=fcc, lossy=True,
                             insig_type="hann10", diff_source=False)


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


def _jax_pair_data(sim):
    """The JAX pair kernel's data: axis planes, strays when some are left,
    and no u2b carry (its carried sheets would have to agree with the
    random field)."""
    data = JaxEngineData(sim.consts, sim.vox, sim.comms, sim.mats,
                         dtype=np.float32, pad_z=128, tile_x=4)
    if data.attach_planes():
        data.attach_strays()
    data.u2b_carry = False
    return data, getattr(data, "strays", None)


@pytest.mark.parametrize("name", ["planes-fcc", "strays-cart"])
def test_pair_route_matches_jax_pair_kernel(monkeypatch, name):
    sim = _case(monkeypatch, name)
    jd, strays = _jax_pair_data(sim)
    if name == "strays-cart":
        assert jd.planes.z is None and strays is not None
    else:
        assert jd.planes.n_stray == 0 and jd.planes.z is not None
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device="cpu",
                      backend="pair")
    assert eng.TB == 2
    u = eng.run(verbose=False)
    u_j = tpp._run_pair_interpret(sim, eng.Nt, tile_x=4)
    assert _rel(u, u_j) < 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_state_planes_roundtrip(monkeypatch, name):
    sim = _case(monkeypatch, name, Nt=4)
    jd, strays = _jax_pair_data(sim)
    d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats)
    rng = np.random.default_rng(5)
    vh, gh = rng.standard_normal((2, MMb, d.Nbl)).astype(np.float32)
    vhp, ghp = convert.state_to_planes(vh, gh, jd.planes, strays, d)
    want = {f for f in "zyx" if getattr(jd.planes, f) is not None}
    assert set(vhp) == want | ({"s"} if strays is not None else set())
    back = convert.state_from_planes(vhp, ghp, jd.planes, strays, d)
    assert np.array_equal(back[0], vh) and np.array_equal(back[1], gh)
    again = convert.state_to_planes(*back, jd.planes, strays, d)
    for a, b in zip((vhp, ghp), again):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_one_sweep_from_random_state(monkeypatch):
    sim = _case(monkeypatch, "planes-cart", Nt=4)
    jd, strays = _jax_pair_data(sim)
    pl = jd.planes
    assert pl.z is not None and pl.y is not None and pl.x is not None
    g = jd.grid
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device="cpu",
                      backend="pair")
    d = eng.data
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    u0, u1 = f32(g.Nx, g.Ny, g.Nz), f32(g.Nx, g.Ny, g.Nz)
    vh, gh = f32(MMb, d.Nbl), f32(MMb, d.Nbl)
    sig = f32(2, d.in_ixyz.size)

    pad = [(0, p - n) for p, n in zip(g.shape, (g.Nx, g.Ny, g.Nz))]
    vhp, ghp = convert.state_to_planes(vh, gh, pl, strays, d)
    step, C = build_step(jd, backend="pallas_pair", interpret=True)
    carry = (jnp.asarray(np.pad(u0, pad)), jnp.asarray(np.pad(u1, pad)),
             jax.tree.map(jnp.asarray, vhp), jax.tree.map(jnp.asarray, ghp),
             jnp.zeros(d.out_ixyz.size, np.float32))
    (uN, uN1, vh_j, gh_j, _), rows = step(carry, jnp.asarray(sig),
                                          jax.tree.map(jnp.asarray, C))
    vh_j, gh_j = convert.state_from_planes(vh_j, gh_j, pl, strays, d)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    state = [t(u0), t(u1), torch.zeros(d.grid.shape), t(vh), t(gh)]
    spare = [torch.zeros(d.grid.shape), torch.zeros_like(state[3]),
             torch.zeros_like(state[4])]
    out = torch.zeros((2, d.out_ixyz.size))
    eng.sweep(state, spare, t(sig), out, 0)
    inner = (slice(1, g.Nx - 1), slice(1, g.Ny - 1), slice(1, g.Nz - 1))
    assert _rel(state[0].numpy()[inner], convert.crop(uN, g)[inner]) < 1e-5
    assert _rel(state[1].numpy()[inner], convert.crop(uN1, g)[inner]) < 1e-5
    assert _rel(state[3].numpy(), vh_j) < 1e-5
    assert _rel(state[4].numpy(), gh_j) < 1e-5
    assert _rel(out[1].numpy(), np.asarray(rows)[1]) < 1e-5
    # the inputs are untouched and the spare buffers took the old state
    assert np.array_equal(spare[0].numpy(), u1)
    assert np.array_equal(spare[1].numpy(), vh)
