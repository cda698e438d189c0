"""The port's x-slab path (K5, K6 plain versions, the sharded engine) on the
CPU, against the single-device engine and the JAX package.

- K5's plain version vs `pallas_stencil.build_fused_stencil_sharded` in
  interpret mode on one slab of a D = 4 split from the same random state,
  carried into the JAX layout by `convert.slabs_to_jax`, for the first, a
  middle and the last slab: fp32 <= 1e-6 (the JAX kernel multiplies by a
  precomputed 1/(1 + l*Q) where the port divides, as for K1), fp64 <=
  1e-12;
- `ShardedTorchEngine` on every route at D = 1, 2, 4, fp32 and fp64,
  bitwise equal to `TorchEngine` on the same route and padded grid, final
  state included, over an nt that is not a multiple of TB;
- fp64 vs the JAX `ShardedEngine` (XLA, a 2-device mesh of the conftest's
  8 CPU devices): <= 1e-12;
- K5's and K6's plain versions on every slab from a random state (ghost
  bands and their nodes' states included) vs one whole-grid step or sweep:
  bitwise on the owned rows, nodes and receivers, and the ghost-band state
  slots left as they were;
- the partition: pad, split and assemble round trips, one owner per node
  and receiver, and grafts that cover every ghost-band node;
- the exchange timer without a card: no card to time, None, and the
  results of a timed run bitwise an untimed one's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pffdtd_tpu import demo, prep
from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.pallas_stencil import (build_fused_stencil_sharded,
                                              pick_tile_x)
from pffdtd_tpu.parallel.sharded_engine import ShardedEngine, make_mesh

from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.engine.data import EngineData
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels.stencil import (stencil_step_plain,
                                              stencil_step_shard,
                                              stencil_step_shard_plain)
from pffdtd_tpu_torch.kernels.tb import tb_sweep_plain, tb_sweep_shard
from pffdtd_tpu_torch.parallel.partition import (grafts, partition,
                                                 split_rows, x_slabs)
from pffdtd_tpu_torch.parallel.sharded_engine import (ShardedTorchEngine,
                                                      make_sharded_engine)
from pffdtd_tpu_torch.scene import (fold_fcc_sim, pad_x_interior, sort_sim,
                                    synthetic_box_sim)

torch.set_num_threads(2)

SCENES = {
    # name: (box, h, fcc, fold)
    "cart": ((3.1, 2.0, 1.7), 0.12, False, False),
    "fcc-folded": ((2.2, 1.8, 1.5), 0.12, True, True),
}


def _sim(name, Nt=40, mod=None):
    box, h, fcc, fold = SCENES[name]
    mod = mod or (synthetic_box_sim, fold_fcc_sim, sort_sim)
    sim = mod[0](*box, h=h, Nt=Nt, fcc=fcc, lossy=True,
                 insig_type="hann10", diff_source=False)
    return mod[2](mod[1](sim)) if fold else sim


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(SCENES))
def test_k5_plain_matches_pallas_sharded(name, dtype, k):
    D = 4
    sim = pad_x_interior(_sim(name, Nt=4), D)
    d = EngineData(*_kw(sim).values(), dtype=dtype)
    jd = JaxEngineData(*_kw(sim).values(), dtype=dtype, pad_z=128,
                       boundary_kernel=False)
    slabs = x_slabs(d.grid, D, 1)
    S = slabs[0].S
    TX = pick_tile_x(jd.grid.Nyp, jd.grid.Nzp)
    while TX > S:
        TX //= 2
    fused, nxp = build_fused_stencil_sharded(
        jd.grid, S, jd.sc, jd.fcc, dtype=jnp.dtype(dtype), TX=TX,
        interpret=True)
    rng = np.random.default_rng(11 + k)
    u0, u1 = (split_rows(rng.standard_normal(d.grid.shape).astype(dtype),
                         slabs) for _ in range(2))
    adj = split_rows(d.adj_grid, slabs)
    j0, j1, ja = (convert.slabs_to_jax(a, slabs, jd.grid, nxp, 1)
                  for a in (u0, u1, adj))
    rows = slice(k * nxp, (k + 1) * nxp)
    scal = jnp.asarray([1 + k * S, k == 0, k == D - 1], jnp.int32)
    out = np.zeros_like(j0)
    out[rows] = np.asarray(fused(jnp.asarray(j1[rows]), jnp.asarray(j0[rows]),
                                 jnp.asarray(ja[rows]), scal))
    ref = convert.slabs_from_jax(out, jd.grid, slabs, 1)[k]

    sl = slabs[k]
    t = lambda a: torch.from_numpy(a)
    got = torch.zeros(sl.shape, dtype=t(u1[k]).dtype)
    stencil_step_shard_plain(t(u0[k]), t(u1[k]), t(adj[k]), got, sl, d.sc)
    own = (slice(*sl.owned), slice(1, -1), slice(1, -1))
    ref, got = ref[own], got.numpy()[own]
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= (1e-6 if dtype == np.float32 else 1e-12), err


ROUTES = [("step", {}), ("pair", {}), ("tb", {"tb": 3})]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("route", ROUTES, ids=[r for r, _ in ROUTES])
@pytest.mark.parametrize("name", list(SCENES))
def test_sharded_routes_bitwise_equal_single_device(name, route, D, dtype):
    backend, kw = route
    sim = _sim(name)
    eng = make_sharded_engine(**_kw(sim), devices=["cpu"] * D, dtype=dtype,
                              backend=backend, **kw)
    assert eng.D == D and eng.backend == ("tb" if backend != "step"
                                          else "step")
    u = eng.run(nt=29, verbose=False)
    ps = pad_x_interior(sim, D)
    ref = TorchEngine(**_kw(ps), dtype=dtype, device="cpu", backend=backend,
                      **kw)
    u_ref = ref.run(nt=29, verbose=False)
    assert np.abs(u_ref).max() > 0
    assert np.array_equal(u, u_ref)
    u0, u1, vh, gh = eng.global_state()
    for a, b in ((u0, ref.state[0]), (u1, ref.state[1]), (vh, ref.state[3]),
                 (gh, ref.state[4])):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("route", ROUTES, ids=[r for r, _ in ROUTES])
def test_sharded_matches_jax_sharded_engine_fp64(route):
    backend, kw = route
    sim = pad_x_interior(_sim("cart"), 4)
    jsim = prep.pad_x_interior(
        _sim("cart", mod=(demo.synthetic_box_sim, prep.fold_fcc_sim,
                          prep.sort_sim)), 4)
    assert jsim.vox.Nx == sim.vox.Nx and jsim.vox.Nx % 2 == 0
    jx = ShardedEngine(**_kw(jsim), mesh=make_mesh(2), dtype=np.float64,
                       pad_z=None)
    u_j = jx.run(verbose=False)
    scale = np.abs(u_j).max()
    assert scale > 0
    for D in (2, 4):
        eng = ShardedTorchEngine(**_kw(sim), devices=["cpu"] * D,
                                 dtype=np.float64, backend=backend, **kw)
        u = eng.run(verbose=False)
        assert np.abs(u - u_j).max() / scale <= 1e-12


@pytest.mark.parametrize("TB", [None, 2, 3])
@pytest.mark.parametrize("D", [2, 4])
def test_slab_kernels_match_whole_grid_from_random_state(D, TB):
    sim = _sim("fcc-folded", Nt=4)
    kw = {} if TB is None else {"backend": "tb", "tb": TB}
    eng = make_sharded_engine(**_kw(sim), devices=["cpu"] * D,
                              dtype=np.float64, **kw)
    ref = TorchEngine(**_kw(pad_x_interior(sim, D)), dtype=np.float64,
                      device="cpu", **kw)
    d, g = ref.data, ref.data.grid
    rng = np.random.default_rng(D * 10 + (TB or 1))
    u0, u1 = rng.standard_normal((2,) + g.shape)
    vh, gh = rng.standard_normal((2, MMb, d.Nbl))
    sig = rng.standard_normal((TB or 1, d.in_ixyz.size))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    nr = d.out_ixyz.size
    if TB is None:
        whole = torch.zeros(g.shape, dtype=torch.float64)
        stencil_step_plain(t(u0), t(u1), ref.adj, whole, g, d.sc)
    else:
        o0, o1 = (torch.zeros(g.shape, dtype=torch.float64) for _ in "ab")
        s0, s1 = (torch.zeros(MMb, d.Nbl, dtype=torch.float64) for _ in "ab")
        taps = torch.zeros((TB - 2, nr), dtype=torch.float64) \
            if TB > 2 else None
        tb_sweep_plain(ref.tb_scene, t(u0), t(u1), o0, o1, t(vh), t(gh),
                       s0, s1, t(sig), taps)
    for sh in eng.shards:
        sl, p = sh.slab, sh.part
        own = (slice(*sl.owned), slice(1, -1), slice(1, -1))
        a, b = split_rows(u0, [sl])[0], split_rows(u1, [sl])[0]
        if TB is None:
            out = torch.zeros(sl.shape, dtype=torch.float64)
            stencil_step_shard(t(a), t(b), sh.adj, out, sl, d.sc)
            want = split_rows(whole.numpy(), [sl])[0]
            assert np.array_equal(out.numpy()[own], want[own])
            continue
        outs = [torch.full(sl.shape, np.nan, dtype=torch.float64)
                for _ in "ab"]
        st2 = [torch.full((MMb, p.nodes.size), np.nan, dtype=torch.float64)
               for _ in "ab"]
        tp = torch.full((TB - 2, p.rcvs.size), np.nan,
                        dtype=torch.float64) if TB > 2 else None
        tb_sweep_shard(sh.tb_scene, t(a), t(b), *outs, t(vh[:, p.nodes]),
                       t(gh[:, p.nodes]), *st2, t(sig[:, p.srcs]), tp)
        for x, y in zip(outs, (o0, o1)):
            assert np.array_equal(x.numpy()[own],
                                  split_rows(y.numpy(), [sl])[0][own])
        for x, y in zip(st2, (s0, s1)):
            x = x.numpy()
            assert np.array_equal(x[:, p.node_own],
                                  y.numpy()[:, p.nodes[p.node_own]])
            assert np.isnan(x[:, ~p.node_own]).all()   # owner's slots only
        assert (~p.node_own).any() or D == 1
        if TB > 2:
            assert np.array_equal(tp.numpy(), taps.numpy()[:, p.rcvs])


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_pad_split_assemble_round_trip(D, G):
    sim = pad_x_interior(_sim("fcc-folded", Nt=4), D)
    assert (sim.vox.Nx - 2) % D == 0
    d = EngineData(*_kw(sim).values())
    slabs = x_slabs(d.grid, D, G)
    rng = np.random.default_rng(D + 10 * G)
    x = rng.standard_normal(d.grid.shape)
    parts = split_rows(x, slabs)
    assert all(p.shape == sl.shape for p, sl in zip(parts, slabs))
    assert np.array_equal(convert.slabs_to_global(parts, slabs), x)
    # the JAX layouts: ShardedPallasEngine (1 ghost) and ShardedPairEngine
    # (2 ghosts), with y/z padding
    jd = JaxEngineData(*_kw(sim).values(), pad_z=128)
    for ghosts in (1, 2):
        nxp = slabs[0].S + 2 * ghosts + 3
        j = convert.slabs_to_jax(parts, slabs, jd.grid, nxp, ghosts)
        assert j.shape == (D * nxp, jd.grid.Nyp, jd.grid.Nzp)
        back = convert.slabs_from_jax(j, jd.grid, slabs, ghosts)
        assert np.array_equal(convert.slabs_to_global(back, slabs), x)


@pytest.mark.parametrize("G", [1, 2, 3])
def test_partition_owners_and_grafts(G):
    D = 4
    sim = pad_x_interior(_sim("cart", Nt=4), D)
    d = EngineData(*_kw(sim).values())
    parts = partition(d, x_slabs(d.grid, D, G))
    own = np.concatenate([p.nodes[p.node_own] for p in parts])
    assert np.array_equal(np.sort(own), np.arange(d.Nbl))
    rcv = np.concatenate([p.rcvs for p in parts])
    assert np.array_equal(np.sort(rcv), np.arange(d.out_ixyz.size))
    srcs = np.concatenate([p.srcs[p.src_own] for p in parts])
    assert np.array_equal(np.sort(srcs), np.arange(d.in_ixyz.size))
    n_ghost = sum(int((~p.node_own).sum()) for p in parts)
    gr = grafts(parts)
    assert sum(g.dst_slots.size for g in gr) == n_ghost
    assert (n_ghost > 0) == (G > 1)
    for g in gr:
        assert abs(g.src - g.dst) == 1
        assert np.array_equal(parts[g.dst].nodes[g.dst_slots],
                              parts[g.src].nodes[g.src_slots])
        assert parts[g.src].node_own[g.src_slots].all()
    for p in parts:      # local indices name the same global points
        sl = p.slab
        plane = sl.grid.Ny * sl.grid.Nz
        np.testing.assert_array_equal(p.bnl + sl.xo * plane,
                                      d.bnl_ixyz[p.nodes])


def test_engine_refuses_what_it_cannot_run():
    sim = _sim("fcc-folded", Nt=4)
    with pytest.raises(ValueError):      # (Nx - 2) % D != 0: needs padding
        ShardedTorchEngine(**_kw(pad_x_interior(sim, 4)),
                           devices=["cpu"] * 3)
    ps = pad_x_interior(sim, 4)
    with pytest.raises(ValueError):      # slabs of 6 rows < 2 * TB
        ShardedTorchEngine(**_kw(ps), devices=["cpu"] * 4, backend="tb",
                           tb=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):   # no CPU fallback
            make_sharded_engine(**_kw(sim), devices=["cuda"] * 2)
        with pytest.raises(RuntimeError):
            make_sharded_engine(**_kw(sim))
    d = EngineData(*_kw(ps).values())
    sl = x_slabs(d.grid, 4, 1)[1]
    u = torch.zeros(sl.shape)
    with pytest.raises(ValueError):      # a slab-shaped grid is refused
        stencil_step_shard(u, u.clone(), torch.from_numpy(
            split_rows(d.adj_grid, x_slabs(d.grid, 4, 1))[0]),
            torch.zeros(3, 3, 3), sl, d.sc)


def test_exchange_timer_without_a_card():
    """`time_exchange` times each card's stream; a device list that holds
    no card has none: exchange_ms None, no card's total, and the results
    bitwise those of a run without the timer."""
    sim = _sim("fcc-folded", Nt=12)
    eng = make_sharded_engine(**_kw(sim), devices=["cpu"] * 2,
                              dtype=np.float64, backend="tb", tb=3)
    assert eng.cards == []
    u = eng.run(nt=11, verbose=False, time_exchange=True)
    assert eng.exchange_ms is None and eng.exchange_ms_by_card == {}
    state = eng.global_state()
    assert np.array_equal(u, eng.run(nt=11, verbose=False))
    for a, b in zip(state, eng.global_state()):
        assert np.array_equal(a, b)
