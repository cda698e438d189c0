"""The rooflines' byte counts against the kernel table of PERF.md §6 (the
headline's "descending" grid, 792 x 310 x 510 folded FCC, 1,169,067 lossy
nodes, fp32): K1 1.731 GB, K2 257.3 MB, K3 2.477 GB a TB = 3 sweep.

The table counted the 12 branch rows the program stores; the benchmark
counts the material's 11 (the 12th is padding), and K3 without the
per-tile node lists that the kernel derives for itself."""

import pytest

from rirbench.roofline import PEAKS, interior, k1, k2, k3, least_seconds

HEADLINE = {"grid": (792, 310, 510), "fcc": True, "itemsize": 4,
            "Nbl": 1_169_067, "TB": 3}


def test_k1_bytes_are_the_tables():
    b, _ = k1.cost({**HEADLINE, "branches": 11})
    assert b == pytest.approx(1.731e9, rel=5e-4)


@pytest.mark.parametrize("branches, want", [(12, 257.3e6), (11, 238.5e6)])
def test_k2_bytes(branches, want):
    b, _ = k2.cost({**HEADLINE, "branches": branches})
    assert b == pytest.approx(want, rel=5e-4)


def test_k3_bytes_below_the_tables_by_the_tile_lists():
    b12, _ = k3.cost({**HEADLINE, "branches": 12})
    assert 0.99 * 2.477e9 < b12 < 2.477e9
    b11, _ = k3.cost({**HEADLINE, "branches": 11})
    assert b11 == pytest.approx(2.449e9, rel=5e-4)


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(3.35e12, 0.0, 4) == pytest.approx(1.0)
    assert least_seconds(0.0, PEAKS["fp32_flops_per_s"], 4) == \
        pytest.approx(1.0)
    assert least_seconds(0.0, PEAKS["fp64_flops_per_s"], 8) == \
        pytest.approx(1.0)


def test_cartesian_adjacency_is_one_byte():
    g = {"grid": (791, 617, 509), "fcc": False, "itemsize": 4,
         "branches": 11, "Nbl": 0, "TB": 3}
    assert k1.cost(g)[0] == 789 * 615 * 507 * 13
    assert k3.cost(g)[0] == 789 * 615 * 507 * 17


@pytest.mark.parametrize("name", ["fcc_lossy_box.step", "cart_lossy_box.step",
                                  "fcc_lossy_box.tb"])
def test_k1_counts_the_adjacency_the_route_reads(name, tiny):
    """On a small cell, K1's bytes are its three fields' and the
    adjacency's that the engine holds: on the step route the compact
    form's mask words of the interior rows, the base of each non-zero
    word and of each row holding one, and the flagged points' legs,
    counted here from the engine's host grid (`EngineData.adj_grid`), not
    from the form; on the tb route the packed grid."""
    import torch

    from rirbench import program
    cell = tiny(name)
    cfg, traffic = cell["config"], cell["traffic"]
    src, rx = program.request(cfg, traffic, 2**33 + 9)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        eng = program.engine(cfg, traffic,
                             program.scene(cfg, traffic, src, rx), "cpu")
    finally:
        torch.set_num_threads(n_threads)
    fcc = cfg["grid"] == "fcc"
    shape = tuple(eng.data.grid.shape)
    n = interior(shape)
    legs = 2 if fcc else 1
    if traffic["route"] == "tb":
        want = n * legs
    else:
        g = torch.from_numpy(eng.data.adj_grid[1:-1, 1:-1, 1:-1]
                             .astype("int32"))
        flag = g != (1 << (12 if fcc else 6)) - 1
        w = -(-flag.shape[2] // 32)
        words = torch.nn.functional.pad(flag, (0, 32 * w - flag.shape[2])) \
            .view(*flag.shape[:2], w, 32).any(-1)
        want = (4 * (shape[0] - 2) * (shape[1] - 2) * w
                + 2 * int(words.sum())
                + 4 * int(words.any(-1).sum()) + legs * int(flag.sum()))
        assert 0 < int(flag.sum()) < n
    run = {"grid": shape, "fcc": fcc, "itemsize": 4,
           "k1_adj_bytes": program.k1_adj_bytes(eng)}
    assert k1.cost(run)[0] == 3 * 4 * n + want
