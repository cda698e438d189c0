"""The adjacency's compact form (`kernels.stencil.CompactAdj`), K1's input
on the step route, on the CPU.

- Its build from the node list round-trips bitwise to
  `EngineData.adj_grid` on the Cartesian, FCC and folded-FCC demo scenes,
  and its build from a grid round-trips on random grids with flagged
  points at z = 1, 32, 33 and Nz-2, fully flagged rows and all-air rows,
  where Nz-2 is a multiple of 32 and where it is not; its mask, bases and
  counts are those a plain count gives.
- `stencil_step_plain` (and `stencil_step`, which runs it on the CPU) on
  the compact form equals it on the grid, bitwise, in fp32 and fp64.
- `TorchEngine` holds the compact form on the step route only: the tb,
  pair and energy routes keep the grid.  A step-route run's receivers and
  final state are bitwise equal to the same run on the grid.
- The kernels that read the grid (K1e, K5) refuse the compact form, and K1
  refuses one of another grid.
"""

import numpy as np
import pytest
import torch

from pffdtd_tpu_torch.engine.data import EngineData, GridSpec, SlabSpec
from pffdtd_tpu_torch.engine.coeffs import SchemeCoeffs
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.kernels.stencil import (WORD, CompactAdj, adj_bytes,
                                              stencil_step,
                                              stencil_step_plain,
                                              stencil_step_shard)
from pffdtd_tpu_torch.scene import fold_fcc_sim, sort_sim, synthetic_box_sim

torch.set_num_threads(2)

SCENES = {
    "cart": ((2.5, 2.0, 1.6), 0.1, False, False),
    "fcc": ((2.2, 1.8, 1.5), 0.12, True, False),
    "fcc-folded": ((2.2, 1.8, 1.5), 0.12, True, True),
}
# (Nx, Ny, Nz): Nz-2 = 5, 32, 64 (whole words), 43, 69 and 198
SHAPES = [(5, 6, 7), (6, 7, 34), (7, 9, 66), (8, 7, 45), (6, 5, 71),
          (5, 8, 200)]


def _sim(name, Nt=30):
    box, h, fcc, fold = SCENES[name]
    sim = synthetic_box_sim(*box, h=h, Nt=Nt, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    return sort_sim(fold_fcc_sim(sim)) if fold else sim


def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _random_grid(shape, fcc, seed):
    """A packed grid with all-ones halos: air at nine points in ten, random
    legs elsewhere, every point flagged at z = 1, 32, 33 and Nz-2, a fully
    flagged row (y = 1) and an all-air row (y = 2)."""
    nn = 12 if fcc else 6
    full = (1 << nn) - 1
    rng = np.random.default_rng(seed)
    bits = np.full(shape, full, np.int64)
    inner = (slice(1, -1),) * 3
    b = rng.integers(0, full, [n - 2 for n in shape])
    b[rng.random(b.shape) < 0.9] = full
    for z in (1, 32, 33, shape[2] - 2):
        if z <= shape[2] - 2:
            b[:, :, z - 1] = rng.integers(0, full, b.shape[:2])
    b[:, 0, :] = rng.integers(0, full, (b.shape[0], b.shape[2]))
    b[:, 1, :] = full
    bits[inner] = b
    return torch.from_numpy(bits.astype(np.int32)).to(
        torch.uint16 if fcc else torch.uint8)


def _count(adj):
    """(mask words as uint32, each word's index of its first flagged point,
    flagged, non-zero words) by a plain count over the interior."""
    full = (1 << (12 if adj.dtype == torch.uint16 else 6)) - 1
    a = adj.to(torch.int32).numpy()
    Nx, Ny, Nz = a.shape
    W = -(-(Nz - 2) // WORD)
    words = np.zeros((Nx, Ny, W), np.uint64)
    for z in range(1, Nz - 1):
        on = (a[:, :, z] != full).astype(np.uint64)
        on[[0, -1], :] = 0
        on[:, [0, -1]] = 0
        words[:, :, (z - 1) // WORD] |= on << np.uint64((z - 1) % WORD)
    pop = np.array([bin(int(w)).count("1") for w in words.ravel()])
    base = np.concatenate([[0], np.cumsum(pop)[:-1]]).reshape(words.shape)
    return words.astype(np.uint32), base, int(pop.sum()), int((pop > 0).sum())


@pytest.mark.parametrize("name", list(SCENES))
def test_build_from_nodes_round_trips_to_the_grid(name):
    d = EngineData(*_kw(_sim(name)).values())
    c = CompactAdj.from_nodes(d.bn_ixyz, d.bn_adj, d.grid.shape, d.NN)
    assert c.legs.dtype == (torch.uint16 if d.NN == 12 else torch.uint8)
    np.testing.assert_array_equal(c.to_grid().numpy(), d.adj_grid)
    words, base, flagged, nz = _count(torch.from_numpy(d.adj_grid))
    np.testing.assert_array_equal(c.mask.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(c.rows.numpy(), base[:, :, 0])
    np.testing.assert_array_equal(c.base.numpy(), base - base[:, :, :1])
    assert (c.flagged, c.words) == (flagged, nz)
    assert 0 < c.flagged == c.legs.numel() < d.grid.n_interior
    # listed in any order, or with air nodes among them, it is the same
    rng = np.random.default_rng(0)
    order = rng.permutation(d.bn_ixyz.size)
    air = np.setdiff1d(np.arange(d.adj_grid.size), d.bn_ixyz)[:50]
    c2 = CompactAdj.from_nodes(
        np.concatenate([d.bn_ixyz[order], air]),
        np.concatenate([d.bn_adj[order],
                        np.full(air.size, (1 << d.NN) - 1, d.bn_adj.dtype)]),
        d.grid.shape, d.NN)
    for f in ("mask", "rows", "base", "legs"):
        assert torch.equal(getattr(c, f), getattr(c2, f)), f


@pytest.mark.parametrize("fcc", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_build_from_a_random_grid_round_trips(shape, fcc):
    adj = _random_grid(shape, fcc, sum(shape))
    c = CompactAdj.from_grid(adj)
    assert torch.equal(c.to_grid(), adj)
    words, base, flagged, nz = _count(adj)
    assert c.mask.shape == (shape[0], shape[1], -(-(shape[2] - 2) // WORD))
    np.testing.assert_array_equal(c.mask.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(c.rows.numpy(), base[:, :, 0])
    np.testing.assert_array_equal(c.base.numpy(), base - base[:, :, :1])
    assert (c.flagged, c.words) == (flagged, nz)
    assert c.nbytes == (6 * c.mask.numel() + 4 * shape[0] * shape[1]
                        + flagged * adj.element_size())
    assert adj_bytes(c, 0) == c.read_bytes == (
        4 * c.mask.numel() + 6 * nz + flagged * adj.element_size())
    # the bits past Nz-2 of a row's last word stay clear
    tail = (shape[2] - 2) % WORD
    if tail:
        assert not (c.mask[:, :, -1].numpy().view(np.uint32)
                    >> np.uint32(tail)).any()


def test_nodes_off_the_interior_and_repeats():
    shape, nn = (6, 7, 40), 6
    Nx, Ny, Nz = shape
    halo = np.array([0, (Nx - 1) * Ny * Nz + 3 * Nz + 5, 2 * Ny * Nz + Nz - 1])
    inner = np.array([(2 * Ny + 3) * Nz + 33])
    c = CompactAdj.from_nodes(np.concatenate([halo, inner]),
                              np.array([5, 6, 7, 9], np.uint8), shape, nn)
    assert c.flagged == 1 and c.words == 1 and int(c.legs[0]) == 9
    g = c.to_grid().view(-1)
    assert int(g[inner[0]]) == 9 and int((g != 63).sum()) == 1
    with pytest.raises(ValueError):
        CompactAdj.from_nodes(np.concatenate([inner, inner]),
                              np.array([1, 2], np.uint8), shape, nn)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["cart", "fcc", "fcc-folded"])
@pytest.mark.parametrize("shape", [(13, 45, 71), (9, 6, 66)])
def test_plain_step_on_the_compact_form_equals_the_grid(shape, kind, dtype):
    fcc = kind != "cart"
    g = GridSpec(*shape, 2 if kind == "fcc-folded" else int(fcc))
    sc = SchemeCoeffs.make(0.57 if fcc else 0.55, 0.33, fcc)
    adj = _random_grid(shape, fcc, 7 + sum(shape))
    c = CompactAdj.from_grid(adj)
    rng = np.random.default_rng(3)
    u0, u1 = (torch.from_numpy(rng.standard_normal(shape).astype(dtype))
              for _ in range(2))
    a, b, k = (torch.full_like(u0, float("nan")) for _ in range(3))
    stencil_step_plain(u0, u1, c, a, g, sc)
    stencil_step_plain(u0, u1, adj, b, g, sc)
    stencil_step(u0, u1, c, k, g, sc)          # the plain version here
    inner = (slice(1, -1),) * 3
    assert torch.isfinite(a[inner]).all()
    assert torch.equal(a[inner], b[inner]) and torch.equal(k[inner],
                                                           b[inner])


@pytest.mark.parametrize("name", list(SCENES))
def test_engine_holds_the_compact_form_on_the_step_route_only(name):
    sim = _sim(name, Nt=8)
    d = EngineData(*_kw(sim).values())
    for kw, compact in (({}, True), ({"backend": "step"}, True),
                        ({"backend": "tb", "tb": 3}, False),
                        ({"backend": "pair"}, False),
                        ({"energy_on": True, "dtype": np.float64}, False)):
        eng = TorchEngine(**_kw(sim), device="cpu", **kw)
        assert isinstance(eng.adj, CompactAdj) == compact, kw
        if compact:
            np.testing.assert_array_equal(eng.adj.to_grid().numpy(),
                                          d.adj_grid)
        else:
            np.testing.assert_array_equal(eng.adj.numpy(), d.adj_grid)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(SCENES))
def test_step_route_run_equals_the_run_on_the_grid(name, dtype):
    sim = _sim(name)
    a = TorchEngine(**_kw(sim), dtype=dtype, device="cpu")
    b = TorchEngine(**_kw(sim), dtype=dtype, device="cpu")
    assert isinstance(a.adj, CompactAdj)
    b.adj = torch.from_numpy(b.data.adj_grid)
    ua, ub = a.run(verbose=False), b.run(verbose=False)
    assert np.abs(ub).max() > 0
    assert np.array_equal(ua, ub)
    assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))


def test_grid_readers_refuse_the_compact_form():
    sim = _sim("fcc-folded", Nt=8)
    eng = TorchEngine(**_kw(sim), device="cpu")
    d = eng.data
    u0 = torch.zeros(d.grid.shape)
    u1, out = torch.zeros_like(u0), torch.zeros_like(u0)
    sl = SlabSpec(d.grid, d.grid.Nx - 2, 1, 0)
    with pytest.raises(ValueError):          # K5 reads the grid
        stencil_step_shard(u0, u1, eng.adj, out, sl, d.sc)
    other = CompactAdj.from_grid(_random_grid((6, 7, 34), True, 1))
    with pytest.raises(ValueError):          # another grid's
        stencil_step(u0, u1, other, out, d.grid, d.sc)
    wrong = CompactAdj.from_nodes(d.bn_ixyz, d.bn_adj, d.grid.shape, 6)
    with pytest.raises(ValueError):          # 6 legs on an FCC grid
        stencil_step(u0, u1, wrong, out, d.grid, d.sc)
