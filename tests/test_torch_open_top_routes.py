"""Open rooms on the port's TB, pair, x-slab and energy routes (CPU, fp64).

The open-top boxes of test_torch_open_top.py put lossy boundary nodes on
the top ABC layer.  The reference's step (`_step_core`, jax_engine.py:664-
685) runs the stencil, the lossy ODE, then the ABC; K1 and K3's stencil
apply the ABC first, so the ODE takes the scene's Q array (`abcq`) and
undoes the stencil's ABC at those nodes (K2's and K3/K6's ABC modes; here
their plain versions).  Held here, scenes from `OPEN`, seeded numpy:
- the tb route at TB = 2, 3 and 8 within 1e-12 of JaxEngine(backend="xla")
  and of the port's NumpyEngine, and bitwise equal to the step route (253
  steps, 254 on the folded FCC box: TB = 3 and 8 leave tail steps on both);
- the x-slab tb and pair routes at D = 2 within 1e-12 of the JAX
  ShardedEngine and bitwise equal to the single device's step route on the
  same padded grid;
- one `tb_sweep_plain` (TB = 3) and one `tb_sweep_shard_plain` on each slab
  of a D = 2 split (TB = 2), from a random state with random branch states
  and source samples, bitwise equal to TB single steps of K1 + K2 in its
  ABC mode (the engine's `step`); without the Q array they differ;
- the energy route: H_tot, E_lost, E_in and the receivers within 1e-12 of
  JAX's energy_on XLA route, and `energy_balance()` within 1e-12 of JAX's.
  That balance does not close on these scenes (JAX's own functional has no
  term for a node both lossy and on an ABC layer: about 6e-4 Cartesian,
  8e-3 folded FCC, the reference's property, reproduced and not mended);
  on a rigid open box it stays under 1e-10;
- a checkpoint of the tb route at a step that is no multiple of TB, resumed
  bitwise; a closed scene's sweeps carry no Q array, and the wrapper
  refuses a Q array of another dtype or length.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from pffdtd_tpu import demo, prep
from pffdtd_tpu.engine.jax_engine import JaxEngine
from pffdtd_tpu.parallel.sharded_engine import ShardedEngine, make_mesh

from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels.tb import tb_sweep, tb_sweep_plain, \
    tb_sweep_shard_plain
from pffdtd_tpu_torch.parallel.partition import split_rows
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.scene import (DEF11, fold_fcc_sim, pad_x_interior,
                                    synthetic_box_sim)

torch.set_num_threads(2)

# test_torch_open_top.py's scenes: (box, h, fcc, fold)
OPEN = {
    "cart": ((1.2, 1.0, 0.8), 0.08, False, False),
    "fcc-folded": ((1.2, 1.0, 0.9), 0.1, True, True),
}
NT = 253        # 253 % TB != 0 for TB = 2, 3, 8: the tail steps run
NT_SLAB = 96


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _scene(name, Nt, jax_side=False, lossy=True, open_top=True):
    """An `OPEN` box (open_top=False: closed; lossy=False: rigid)."""
    box, h, fcc, fold = OPEN[name]
    box_sim, fold_sim = ((demo.synthetic_box_sim, prep.fold_fcc_sim)
                         if jax_side else (synthetic_box_sim, fold_fcc_sim))
    sim = box_sim(*box, h=h, Nt=Nt, fcc=fcc, lossy=lossy,
                  insig_type="hann10", diff_source=False,
                  DEF=DEF11 if lossy else None, open_top=open_top)
    return fold_sim(sim) if fold else sim


def _engine(sim, **kw):
    return TorchEngine(**_kw(sim), dtype=np.float64, device="cpu", **kw)


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


@functools.lru_cache(maxsize=None)
def _refs(name):
    """(JAX XLA receivers, the port's NumpyEngine's, the port's step
    route's) over NT steps."""
    j = JaxEngine(**_kw(_scene(name, NT, jax_side=True)), dtype=np.float64,
                  backend="xla")
    j.run(verbose=False)
    sim = _scene(name, NT)
    o = NumpyEngine(**_kw(sim))
    o.run_all()
    t = _engine(sim)
    assert t.abcq is not None and t.backend == "step"
    return j.u_out, o.u_out, t.run(verbose=False)


@pytest.mark.parametrize("TB", [2, 3, 8])
@pytest.mark.parametrize("name", list(OPEN))
def test_tb_route_matches_jax_oracle_and_step_route(name, TB):
    u_j, u_o, u_step = _refs(name)
    t = _engine(_scene(name, NT), backend="tb", tb=TB)
    assert t.tb_scene.abcq is t.abcq and t.abcq is not None
    u = t.run(verbose=False)
    assert u.shape == u_j.shape == u_o.shape and u.shape[1] >= NT
    assert _rel(u, u_j) < 1e-12
    assert _rel(u, u_o) < 1e-12
    assert np.array_equal(u, u_step)


@functools.lru_cache(maxsize=None)
def _slab_refs(name):
    """(the JAX ShardedEngine's receivers at D = 2, the port's single-device
    step route's on the same padded grid) over NT_SLAB steps."""
    jsim = prep.pad_x_interior(_scene(name, NT_SLAB, jax_side=True), 2)
    jx = ShardedEngine(**_kw(jsim), mesh=make_mesh(2), dtype=np.float64,
                       pad_z=None)
    u_j = jx.run(verbose=False)
    u_step = _engine(pad_x_interior(_scene(name, NT_SLAB), 2)).run(
        verbose=False)
    return u_j, u_step


@pytest.mark.parametrize("backend", ["tb", "pair"])
@pytest.mark.parametrize("name", list(OPEN))
def test_x_slab_tb_routes_match_jax_sharded_engine(name, backend):
    u_j, u_step = _slab_refs(name)
    e = make_sharded_engine(**_kw(_scene(name, NT_SLAB)),
                            devices=["cpu"] * 2, dtype=np.float64,
                            backend=backend, tb=3)
    assert e.TB == (2 if backend == "pair" else 3)
    assert all(sh.tb_scene.abcq is sh.abcq and sh.abcq is not None
               for sh in e.shards)
    u = e.run(verbose=False)
    assert _rel(u, u_j) < 1e-12
    assert np.array_equal(u, u_step)


def _random_sweep_inputs(rng, shape, nbl, ns, TB):
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))
    return t(*shape), t(*shape), t(MMb, nbl), t(MMb, nbl), t(TB, ns)


def _steps(eng, u0, u1, vh, gh, sig):
    """len(sig) single steps of `eng` (K1, K2 with the engine's Q array,
    the sources): (u^{n+TB-1}, u^{n+TB}, vh, gh, the receiver rows of
    u^{n+1} .. u^{n+TB-2})."""
    TB = len(sig)
    state = [u0.clone(), u1.clone(), torch.zeros_like(u0), vh.clone(),
             gh.clone()]
    rows = torch.zeros((TB, eng.out_ixyz_f.numel()), dtype=u0.dtype)
    for s in range(TB):
        eng.step(state, sig[s], out_row=rows[s])
    return state[0], state[1], state[3], state[4], rows[1:TB - 1]


def _sweep_buffers(like, nbl, TB, nr):
    o = [torch.full_like(like, float("nan")) for _ in range(2)]
    s = [torch.full((MMb, nbl), float("nan"), dtype=like.dtype)
         for _ in range(2)]
    taps = torch.zeros((TB - 2, nr), dtype=like.dtype) if TB > 2 else None
    return o, s, taps


@pytest.mark.parametrize("name", list(OPEN))
def test_tb_sweep_plain_is_steps_in_the_abc_mode(name):
    TB = 3
    eng = _engine(_scene(name, 8), backend="tb", tb=TB)
    st, d = eng.tb_scene, eng.data
    rng = np.random.default_rng(21)
    u0, u1, vh, gh, sig = _random_sweep_inputs(rng, d.grid.shape, d.Nbl,
                                               d.in_ixyz.size, TB)
    want = _steps(eng, u0, u1, vh, gh, sig)
    inner = (slice(1, -1),) * 3
    outs = {}
    for key, scene in (("abc", st), ("off", dataclasses.replace(
            st, abcq=None))):
        o, s, taps = _sweep_buffers(u0, d.Nbl, TB, st.out_ixyz_f.numel())
        tb_sweep_plain(scene, u0, u1, *o, vh, gh, *s, sig, taps)
        outs[key] = (o[0], o[1], s[0], s[1], taps)
    for a, b in zip(outs["abc"], want):
        if a.dim() == 3:
            a, b = a[inner], b[inner]
        assert torch.equal(a, b)
    # the flagged nodes are where the Q array counts
    flagged = eng.bnl[eng.abcq > 0]
    diff = outs["off"][1].view(-1) != outs["abc"][1].view(-1)
    assert diff[flagged].any()


@pytest.mark.parametrize("name", list(OPEN))
def test_tb_sweep_shard_plain_is_steps_in_the_abc_mode(name):
    """Each slab of a D = 2 split against TB single steps on the global
    grid: the owned rows of both fields, the owned nodes' branch states,
    the owned receivers' taps (TB = 2 has none: TB = 3 checks them)."""
    sim = _scene(name, 8)
    g_eng = {TB: _engine(pad_x_interior(sim, 2), backend="tb", tb=TB)
             for TB in (2, 3)}
    for TB, geng in g_eng.items():
        e = make_sharded_engine(**_kw(sim), devices=["cpu"] * 2,
                                dtype=np.float64, backend="tb", tb=TB)
        d = geng.data
        assert d.grid.shape == e.data.grid.shape
        rng = np.random.default_rng(22 + TB)
        u0, u1, vh, gh, sig = _random_sweep_inputs(
            rng, d.grid.shape, d.Nbl, d.in_ixyz.size, TB)
        w0, w1, wvh, wgh, wtaps = _steps(geng, u0, u1, vh, gh, sig)
        slabs = [sh.slab for sh in e.shards]
        u0s, u1s = (split_rows(u.numpy(), slabs) for u in (u0, u1))
        for k, sh in enumerate(e.shards):
            p, sl = sh.part, sh.slab
            assert sh.tb_scene.abcq is not None
            nbl = sh.bnl.numel()
            o, s, taps = _sweep_buffers(torch.from_numpy(u0s[k]), nbl, TB,
                                        sh.rcv.numel())
            tb_sweep_shard_plain(
                sh.tb_scene, torch.from_numpy(u0s[k]),
                torch.from_numpy(u1s[k]), *o, vh[:, p.nodes].contiguous(),
                gh[:, p.nodes].contiguous(), *s,
                sig[:, p.srcs].contiguous(), taps)
            lo, hi = sl.owned
            rows = slice(sl.x0, sl.x0 + sl.S)
            cols = (slice(1, -1), slice(1, -1))
            assert torch.equal(o[0][lo:hi][(...,) + cols],
                               w0[rows][(...,) + cols])
            assert torch.equal(o[1][lo:hi][(...,) + cols],
                               w1[rows][(...,) + cols])
            own = torch.from_numpy(p.node_own)
            mine = torch.from_numpy(p.nodes[p.node_own])
            assert torch.equal(s[0][:, own], wvh[:, mine])
            assert torch.equal(s[1][:, own], wgh[:, mine])
            if TB > 2:
                assert torch.equal(taps, wtaps[:, p.rcvs])


@functools.lru_cache(maxsize=None)
def _jax_energy(name):
    j = JaxEngine(**_kw(_scene(name, NT, jax_side=True)), dtype=np.float64,
                  backend="xla", energy_on=True)
    j.run(verbose=False)
    return j


@pytest.mark.parametrize("name", list(OPEN))
def test_energy_route_matches_jax_energy_route(name):
    j = _jax_energy(name)
    t = _engine(_scene(name, NT), energy_on=True)
    assert t.abcq is not None
    u = t.run(verbose=False)
    assert _rel(u, j.u_out) < 1e-12
    for a in ("H_tot", "E_lost", "E_in"):
        assert _rel(getattr(t, a), getattr(j, a)) < 1e-12, a
    assert t.E_lost[-1] > 0
    bal_t, bal_j = t.energy_balance(), j.energy_balance()
    assert bal_t.shape == bal_j.shape and bal_t.size > 0
    assert np.abs(bal_t - bal_j).max() < 1e-12
    # the reference's functional does not close where a lossy node lies on
    # an ABC layer (6.0e-4 Cartesian, 8.3e-3 folded FCC over 253 steps)
    assert np.abs(bal_j).max() > 1e-5


def test_energy_balance_closes_on_a_rigid_open_room():
    """No lossy node on the ABC layer: the balance closes, as on the closed
    lossy boxes of test_torch_energy.py."""
    sim = _scene("cart", 128, lossy=False)
    t = _engine(sim, energy_on=True)
    assert t.abcq is None
    t.run(verbose=False)
    assert np.abs(t.energy_balance()).max() < 1e-10


def test_tb_route_checkpoint_resume_on_an_open_room(tmp_path):
    sim = _scene("fcc-folded", 40)
    ck = tmp_path / "state.npz"
    a = _engine(sim, backend="tb", tb=3)
    a.run(verbose=False)
    _engine(sim, backend="tb", tb=3).run(
        nt=23, verbose=False, chunk=5, checkpoint_every=2,
        checkpoint_path=ck)
    with np.load(ck) as z:
        assert int(z["n"]) == 23
    c = _engine(sim, backend="tb", tb=3)
    u = c.run(verbose=False, checkpoint_path=ck, resume=True)
    assert c.abcq is not None
    assert np.array_equal(u, a.u_out)
    assert np.array_equal(c.state[1].numpy(), a.state[1].numpy())


def test_closed_scene_sweeps_carry_no_q_array():
    sim = _scene("cart", 8, open_top=False)
    t = _engine(sim, backend="tb", tb=3)
    assert t.data.Nbl > 0 and t.abcq is None and t.tb_scene.abcq is None
    e = make_sharded_engine(**_kw(sim), devices=["cpu"] * 2,
                            dtype=np.float64, backend="pair")
    assert all(sh.tb_scene.abcq is None for sh in e.shards)


@pytest.mark.parametrize("bad", ["dtype", "length"])
def test_tb_sweep_refuses_a_bad_q_array(bad):
    eng = _engine(_scene("cart", 8), backend="pair")
    st, d = eng.tb_scene, eng.data
    q = st.abcq.to(torch.int32) if bad == "dtype" else st.abcq[:-1]
    rng = np.random.default_rng(5)
    u0, u1, vh, gh, sig = _random_sweep_inputs(rng, d.grid.shape, d.Nbl,
                                               d.in_ixyz.size, 2)
    o, s, _ = _sweep_buffers(u0, d.Nbl, 2, 0)
    with pytest.raises(ValueError, match="abcq"):
        tb_sweep(dataclasses.replace(st, abcq=q), u0, u1, *o, vh, gh, *s,
                 sig)
