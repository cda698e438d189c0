"""Open rooms on the port: lossy boundary nodes on an ABC layer (CPU).

An open-top box (`synthetic_box_sim(open_top=True)`) puts the side walls'
lossy nodes on the top ABC layer, where the reference's order (stencil,
lossy ODE, ABC, jax_engine.py:664-685) and the kernels' (K1 applies the ABC
before K2) differ.  The step route passes those nodes' Q to K2, which undoes
K1's ABC and applies it after the ODE (the TB, x-slab TB and energy routes:
test_torch_open_top_routes.py).  Held here, fp64, seeded numpy:
- `synthetic_box_sim` with `open_top` and `pad_x_to` array-equal to the JAX
  package's, for the argument sets of bench.py's items at reduced sizes;
- one step from a random state (branch states included) within 1e-12 of
  the JAX XLA step at every node, which the kernels' order (ABC before the
  ODE) misses at the flagged nodes by the order of the values themselves;
- 256-step receivers within 1e-12 of the port's NumpyEngine and of
  JaxEngine(backend="xla"), and the x-slab step route at D = 2 within 1e-12
  of the JAX ShardedEngine; in fp32, 64 steps within 1e-5 of max |u_out|
  of the JAX XLA route in fp32;
- a closed box keeps no flagged node, and K2's plain update there is the
  parent's, its branch sum now in the kernel's order: bitwise that, within
  a rounding of torch.sum's order, and an all-zero Q changes no bit;
- `probes.kernel_ab` (K1, K1e, K2 and K3 against another checkout's, on
  the card) refuses a base older than K1's march or the ABC modes, a
  kernel it does not know, and to run without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pffdtd_tpu import demo, prep
from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.jax_engine import JaxEngine, build_step
from pffdtd_tpu.parallel.sharded_engine import ShardedEngine, make_mesh

from pffdtd_tpu_torch import convert
from pffdtd_tpu_torch.engine.data import EngineData, abc_q
from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels.boundary import boundary_update, \
    boundary_update_plain
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.scene import (DEF11, fold_fcc_sim, pad_x_interior,
                                    rotate_sim, sort_sim, synthetic_box_sim)

torch.set_num_threads(2)

# bench.py's synthetic_box_sim arguments, item by item, at a reduced h
BENCH_ARGS = {
    "fcc_lossy": ((36.0, 28.0, 23.0), dict(
        h=1.0, Nt=8, fcc=True, lossy=True, insig_type="impulse",
        DEF=DEF11)),
    "sharded_pair": ((21.0, 16.0, 12.6), dict(
        h=0.6, Nt=8, lossy=False, insig_type="impulse")),
    "fp32_spectral": ((3.0, 2.3, 2.0), dict(
        h=0.12, Nt=8, lossy=True, insig_type="hann10", diff_source=False,
        DEF=DEF11, open_top=True)),
    "sharded_pallas": ((12.0, 9.0, 7.0), dict(
        h=0.35, Nt=8, lossy=True, insig_type="impulse", DEF=DEF11,
        pad_x_to=8)),
    "fp32_drift": ((4.0, 3.1, 2.6), dict(
        h=0.15, Nt=8, lossy=False, insig_type="hann10", diff_source=False,
        DEF=None, open_top=False)),
    "fp32_drift_lossy": ((4.0, 3.1, 2.6), dict(
        h=0.15, Nt=8, lossy=True, insig_type="hann10", diff_source=False,
        DEF=DEF11, open_top=True)),
    # the two new arguments together, on the FCC grid
    "fcc_open_top_pad": ((2.0, 1.6, 1.4), dict(
        h=0.12, Nt=8, fcc=True, lossy=True, insig_type="hann10",
        open_top=True, pad_x_to=8)),
}

# the open-top scenes of the order tests: (box, h, fcc, fold)
OPEN = {
    "cart": ((1.2, 1.0, 0.8), 0.08, False, False),
    "fcc-folded": ((1.2, 1.0, 0.9), 0.1, True, True),
}


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _open_top(name, Nt, mod=None):
    box, h, fcc, fold = OPEN[name]
    box_sim, fold_sim = mod or (synthetic_box_sim, fold_fcc_sim)
    sim = box_sim(*box, h=h, Nt=Nt, fcc=fcc, lossy=True, insig_type="hann10",
                  diff_source=False, DEF=DEF11, open_top=True)
    return fold_sim(sim) if fold else sim


def _rel(a, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return np.abs(a - ref).max() / scale


def _assert_dc_equal(a, b):
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _assert_dc_equal(va, vb)
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=f.name)


@pytest.mark.parametrize("item", list(BENCH_ARGS))
def test_synthetic_box_matches_jax(item):
    box, kw = BENCH_ARGS[item]
    a = synthetic_box_sim(*box, **kw)
    b = demo.synthetic_box_sim(*box, **kw)
    _assert_dc_equal(a, b)
    if kw.get("pad_x_to"):
        assert a.vox.Nx % kw["pad_x_to"] == 0 and a.vox.xv.size == a.vox.Nx


@pytest.mark.parametrize("name", list(OPEN))
def test_open_top_puts_lossy_nodes_on_abc_layers(name):
    d = EngineData(**_kw(_open_top(name, 4)), dtype=np.float64)
    assert d.abcq_bnl is not None and d.abcq_bnl.dtype == np.uint8
    np.testing.assert_array_equal(d.abcq_bnl, abc_q(d.bnl_ixyz, d.grid))
    iz = d.bnl_ixyz % d.grid.Nz
    # the top layer, iz = Nz - 2, is where the open box meets the ABC
    assert ((d.abcq_bnl > 0) == (iz == d.grid.Nz - 2)).all()


@pytest.mark.parametrize("name", list(OPEN))
def test_one_step_from_random_state_matches_jax(name):
    sim = _open_top(name, 4)
    jd = JaxEngineData(**_kw(sim), dtype=np.float64)
    g = jd.grid
    rng = np.random.default_rng(12)
    u0, u1 = (np.zeros(g.shape) for _ in range(2))
    for u in (u0, u1):
        u[:g.Nx, :g.Ny, :g.Nz] = rng.standard_normal((g.Nx, g.Ny, g.Nz))
    vh, gh = (rng.standard_normal((jd.Nbl, MMb)) for _ in range(2))
    sig = rng.standard_normal(len(jd.in_ixyz))
    step, C = build_step(jd, backend="xla")
    (_, unew_j, vh_j, gh_j), _ = step(
        tuple(jnp.asarray(a) for a in (u0, u1, vh, gh)), jnp.asarray(sig),
        jax.tree.map(jnp.asarray, C))
    unew_j, vh_j, gh_j = (np.asarray(a) for a in (unew_j, vh_j, gh_j))

    eng = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu")
    d = eng.data
    flagged = d.bnl_ixyz[d.abcq_bnl > 0]
    assert flagged.size > 0
    inner = (slice(1, g.Nx - 1), slice(1, g.Ny - 1), slice(1, g.Nz - 1))

    def one_step(abcq):
        eng.abcq = abcq
        state = convert.state_from_jax_xla((u0, u1, vh, gh), jd, d)
        eng.step(state, torch.from_numpy(sig))
        return state[1].numpy(), state[3].numpy().T, state[4].numpy().T

    unew, vh_t, gh_t = one_step(torch.from_numpy(d.abcq_bnl))
    ref = convert.crop(unew_j, g)
    assert _rel(unew[inner], ref[inner]) < 1e-12
    assert _rel(vh_t, vh_j) < 1e-12 and _rel(gh_t, gh_j) < 1e-12
    # the kernels' order without K2's ABC mode: right off the flagged
    # nodes, wrong on them by the order of the values
    unew_p, _, _ = one_step(None)
    off = np.ones(unew.size, bool)
    off[flagged] = False
    assert np.array_equal(unew_p.reshape(-1)[off], unew.reshape(-1)[off])
    err = (np.abs(unew_p.reshape(-1)[flagged] - ref.reshape(-1)[flagged])
           .max() / np.abs(ref[inner]).max())
    assert err > 1e-3


@pytest.mark.parametrize("name", list(OPEN))
def test_receivers_match_oracle_and_xla(name):
    sim = _open_top(name, 256)
    o = NumpyEngine(**_kw(sim))
    o.run_all()
    jsim = _open_top(name, 256, mod=(demo.synthetic_box_sim,
                                     prep.fold_fcc_sim))
    j = JaxEngine(**_kw(jsim), dtype=np.float64, backend="xla")
    j.run(verbose=False)
    t = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu")
    assert t.backend == "step" and t.abcq is not None
    u = t.run(verbose=False)
    assert u.shape == o.u_out.shape and u.shape[1] == 256
    assert _rel(u, o.u_out) < 1e-12
    assert _rel(u, j.u_out) < 1e-12


@pytest.mark.parametrize("name", list(OPEN))
def test_fp32_tracks_jax_fp32(name):
    """fp32 over tens of steps (test_pallas_stencil.py's bar): the port
    within 1e-5 of max |u_out| of the JAX XLA route in fp32 (measured 7.0e-6
    Cartesian, 4.4e-6 folded FCC at 64 steps), both within 1e-3 of fp64."""
    sim = _open_top(name, 64)
    jsim = _open_top(name, 64, mod=(demo.synthetic_box_sim,
                                    prep.fold_fcc_sim))
    j = JaxEngine(**_kw(jsim), dtype=np.float32, backend="xla")
    j.run(verbose=False)
    u = TorchEngine(**_kw(sim), dtype=np.float32,
                    device="cpu").run(verbose=False)
    o = NumpyEngine(**_kw(sim))
    o.run_all()
    assert np.isfinite(u).all()
    assert _rel(u, j.u_out) < 1e-5
    assert _rel(u, o.u_out) < 1e-3


def test_x_slabs_match_jax_sharded_engine():
    sim = pad_x_interior(_open_top("cart", 96), 4)
    jsim = prep.pad_x_interior(
        _open_top("cart", 96, mod=(demo.synthetic_box_sim,
                                   prep.fold_fcc_sim)), 4)
    assert jsim.vox.Nx == sim.vox.Nx and jsim.vox.Nx % 2 == 0
    jx = ShardedEngine(**_kw(jsim), mesh=make_mesh(2), dtype=np.float64,
                       pad_z=None)
    u_j = jx.run(verbose=False)
    eng = make_sharded_engine(**_kw(sim), devices=["cpu"] * 2,
                              dtype=np.float64, backend="step")
    assert all(sh.abcq is not None for sh in eng.shards)
    u = eng.run(verbose=False)
    assert _rel(u, u_j) < 1e-12
    # and bitwise the single device's step route on the same grid
    ref = TorchEngine(**_kw(sim), dtype=np.float64, device="cpu")
    assert np.array_equal(u, ref.run(verbose=False))


def _k2_parent(unew, u0, bnl, ssaf, mat, coef_table, beta, vh, gh, sc,
               ordered):
    """K2's plain update as it stood before the ABC mode, operation for
    operation; ordered: the branch sum in the kernel's order (as the plain
    version now adds it) instead of torch.sum's."""
    dt = unew.dtype
    uf = unew.view(-1)
    ub, u2b = uf[bnl], u0.view(-1)[bnl]
    rows = coef_table[mat.long()]
    b, bd, bDh, bFh = (rows[:, q, :].T for q in range(4))
    l = torch.full((), sc.l, dtype=dt)
    lo2 = torch.full((), sc.lo2, dtype=dt)
    lo2Kbg = lo2 * ssaf * beta[mat.long()]
    t = 2.0 * bDh * vh - bFh * gh
    if ordered:
        s = t[0]
        for j in range(1, MMb):
            s = s + t[j]
    else:
        s = torch.sum(t, 0)
    ub = ub - l * ssaf * s
    ub = (ub + lo2Kbg * u2b) / (1.0 + lo2Kbg)
    vh0 = b * (ub - u2b)[None, :] + bd * vh - 2.0 * bFh * gh
    gh.copy_(gh + 0.5 * (vh0 + vh))
    vh.copy_(vh0)
    uf[bnl] = ub
    return unew


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_closed_box_keeps_k2_as_it_was(dtype):
    """The headline's kind of scene (closed, lossy, folded FCC, rotated and
    sorted) has no flagged node.  K2's plain update there is bitwise the
    parent's operations with the branch sum in the kernel's order (on the
    card the kernel is bitwise its plain version in both modes), and
    within a rounding of the parent's torch.sum; an all-zero Q changes no
    bit."""
    sim = sort_sim(fold_fcc_sim(rotate_sim(synthetic_box_sim(
        3.6, 2.8, 2.3, h=0.1, Nt=4, fcc=True, lossy=True,
        insig_type="impulse", DEF=DEF11), orient="descending")))
    eng = TorchEngine(**_kw(sim), dtype=dtype, device="cpu")
    d = eng.data
    assert d.Nbl > 0 and d.abcq_bnl is None and eng.abcq is None
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(dtype))
    u0, un, vh, gh = t(*d.grid.shape), t(*d.grid.shape), t(MMb, d.Nbl), \
        t(MMb, d.Nbl)
    args = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    outs = []
    for fn, extra in ((boundary_update, ()), (boundary_update_plain, (
            torch.zeros(d.Nbl, dtype=torch.uint8),)),
            (_k2_parent, (True,)), (_k2_parent, (False,))):
        x, v, w = un.clone(), vh.clone(), gh.clone()
        fn(x, u0, *args, v, w, d.sc, *extra)
        outs.append((x, v, w))
    for x, v, w in outs[1:3]:
        for a, b in zip((x, v, w), outs[0]):
            assert torch.equal(a, b)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for a, b in zip(outs[3], outs[0]):
        assert _rel(a.numpy(), b.numpy()) <= tol


def test_probe_refuses_without_a_card(monkeypatch, tmp_path):
    """probes.kernel_ab knows K1, K1e, K2 and K3; it refuses a kernel it
    does not know, a base whose K1 has no march or whose K2 or K3 has no
    ABC mode, and to run without a card."""
    from pffdtd_tpu_torch.kernels import _build
    from pffdtd_tpu_torch.probes import kernel_ab

    assert set(kernel_ab.PROBES) == {"K1", "K1e", "K2", "K3"}
    with pytest.raises(SystemExit):
        kernel_ab.main(["--base", ".", "--kernels", "K9"])
    names = ("stencil.cu", "energy.cu", "boundary.cu", "tb.cu", "tb_shard.cu")
    assert set(kernel_ab.sources(_build.CSRC, names)) == set(names)
    for name, marker in kernel_ab.NEEDS.items():
        src = (_build.CSRC / name).read_text()
        (tmp_path / name).write_text(src.replace(marker, "_"))
        with pytest.raises(SystemExit, match="built before"):
            kernel_ab.sources(tmp_path, (name,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="NVIDIA card only"):
        kernel_ab.main(["--base", "."])
