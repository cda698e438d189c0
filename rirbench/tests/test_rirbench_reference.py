"""The plain reference against the port's plain path, and the benchmark's
run on small rooms on the CPU."""

import numpy as np
import pytest
import torch

from rirbench import run
from rirbench.reference.box_fdtd import BoxFDTD, Scheme

CELLS = ["fcc_lossy_box.step", "cart_lossy_box.step", "fcc_lossy_box.tb"]
SEED = 2**33 + 17


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_plain_path_in_fp64(name, tiny):
    """In fp64 the port's plain path (rotated by "auto", folded on FCC,
    sorted) and the reference (natural grid) agree to rounding: the
    receivers of every simulation, the final field and the walls' branch
    states."""
    out = run.run_cell(tiny(name, "float64"), SEED, 0.0, False, "cpu")
    for k in ("rx_err", "field_err", "branch_err"):
        assert out["compared"][k]["value"] < 1e-12, k
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_fp32_program_passes_the_cells_limits(name, tiny):
    out = run.run_cell(tiny(name), SEED + 1, 0.0, False, "cpu")
    assert out["correct"], out["compared"]
    assert 0 < out["compared"]["rx_err"]["value"]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_requests_keep_their_distance_from_the_walls(seed, tiny):
    from rirbench import program
    cell = tiny("fcc_lossy_box.step")
    cfg, tr = cell["config"], cell["traffic"]
    src, rx = program.request(cfg, tr, seed)
    L = np.array([cfg["room"][k] for k in ("Lx", "Ly", "Lz")])
    assert rx.shape == (tr["receivers"], 3)
    assert (rx >= tr["wall_margin_m"]).all()
    assert (rx <= L - tr["wall_margin_m"]).all()
    near = np.asarray(tr["source_at"]) * L
    assert (np.abs(src - near) <= tr["source_jitter_m"]).all()
    again = program.request(cfg, tr, seed)
    assert np.array_equal(src, again[0]) and np.array_equal(rx, again[1])


@pytest.mark.parametrize("name", ["fcc_lossy_box.step", "cart_lossy_box.step"])
def test_scheme_matches_the_cells_grid(name):
    """The reference derives the configurations' grids (PERF.md §4):
    1628 x 1268 x 1048 (FCC, before the fold) and 1296 x 1012 x 832, with
    1,794 and 2,553 steps in 0.1 s: the upstream's one-card rows of
    1.08e9 and 1.09e9 points."""
    import json
    from rirbench import spec
    cfg = json.loads((spec.PKG / "configs" / f"{name.split('.')[0]}.json"
                      ).read_text())
    sc = Scheme(cfg, 0.1)
    want = {"fcc_lossy_box.step": ((1628, 1268, 1048), 1794, 1_081_695_296),
            "cart_lossy_box.step": ((1296, 1012, 832), 2553, 1_091_211_264)}
    assert (sc.N, sc.Nt, sc.points) == want[name]


@pytest.mark.parametrize("name", ["fcc_lossy_box.step", "cart_lossy_box.step"])
def test_work_is_the_programs_grid(name, tiny):
    """`mvps` counts the scheme's points from the room: the program's grid
    on the Cartesian grid, and on FCC the program's folded grid less the
    fold's ghost row."""
    from rirbench import program
    cell = tiny(name)
    cfg, tr = cell["config"], cell["traffic"]
    src, rx = program.request(cfg, tr, SEED)
    g = program.scene(cfg, tr, src, rx).vox
    px, py, pz = g.Nx, g.Ny, g.Nz
    points = Scheme(cfg, tr["sim_seconds"]).points
    ghost = px * pz if cfg["grid"] == "fcc" else 0
    assert px * py * pz == points + ghost


def test_reference_walls_absorb(tiny):
    """Lossy walls take energy: the field at the end is smaller than with
    the same walls made rigid (no branch admits)."""
    cell = tiny("cart_lossy_box.step", seconds=0.03)
    cfg = cell["config"]
    src, rx = np.array([1.3, 1.0, 0.8]), np.array([[0.7, 0.6, 0.9]])
    lossy = BoxFDTD(cfg, src, rx, 0.03, "impulse", True).run()[1]
    rigid_cfg = dict(cfg, material_DEF=[[1e30, 1e30, 1e30]])
    rigid = BoxFDTD(rigid_cfg, src, rx, 0.03, "impulse", True).run()[1]
    assert float(lossy.abs().max()) < float(rigid.abs().max())
