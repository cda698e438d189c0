"""K1's plain version vs the TPU kernel it replaces.

`stencil_step_plain` from a random (u0, u1) against one call of
`pallas_stencil.build_fused_stencil(..., interpret=True)` on the padded grid
of `EngineData(tile_x=8)`, compared on the interior in fp32.  The two sum
the legs in the same k order; the TPU kernel applies the ABC as a multiply
by a precomputed 1/(1 + l*Q) where the port divides, and XLA may fuse the
leapfrog's products, so they differ by a rounding or two: measured max
error 1.0e-7 of max |unew| (cart), 7.3e-8 (FCC), 7.9e-8 (folded FCC),
bound 1e-6.  The folded case checks the mirror of the high y layer.

`plan_k1`, the tile geometry of K1's march, on shapes from the 5 x 5 x 5
minimum to the 1628 x 635 x 1048 FCC cell, the 1.049 Gvox Cartesian box and
thin slabs, in fp32 and fp64: its tiles and chunks, walked as the kernel
walks them, cover every interior point once, and its launch fits the
card's limits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pffdtd_tpu.engine.jax_engine import EngineData as JaxEngineData
from pffdtd_tpu.engine.pallas_stencil import build_fused_stencil

from pffdtd_tpu_torch.engine.data import EngineData
from pffdtd_tpu_torch.kernels import stencil as kstencil
from pffdtd_tpu_torch.kernels.stencil import (abc_regions, plan_k1,
                                              stencil_step,
                                              stencil_step_plain)
from pffdtd_tpu_torch.scene import fold_fcc_sim, synthetic_box_sim

torch.set_num_threads(2)

CASES = {
    "cart": ((2.5, 2.0, 1.6), 0.1, False, False),
    "fcc": ((2.2, 1.8, 1.5), 0.12, True, False),
    "fcc-folded": ((2.2, 1.8, 1.5), 0.12, True, True),
}


def _scene(name):
    box, h, fcc, fold = CASES[name]
    sim = synthetic_box_sim(*box, h=h, Nt=4, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    return fold_fcc_sim(sim) if fold else sim


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_kernel(name):
    sim = _scene(name)
    d = EngineData(sim.consts, sim.vox, sim.comms, sim.mats,
                   dtype=np.float32)
    jd = JaxEngineData(sim.consts, sim.vox, sim.comms, sim.mats,
                       dtype=np.float32, pad_z=128, tile_x=8)
    Nx, Ny, Nz = d.grid.shape
    rng = np.random.default_rng(1)
    u0 = rng.standard_normal(d.grid.shape).astype(np.float32)
    u1 = rng.standard_normal(d.grid.shape).astype(np.float32)

    def pad(a):
        p = np.zeros(jd.grid.shape, np.float32)
        p[:Nx, :Ny, :Nz] = a
        return jnp.asarray(p)

    fused = build_fused_stencil(jd.grid, jd.sc, jd.fcc, dtype=jnp.float32,
                                TX=8, interpret=True)
    ref = np.asarray(fused(pad(u1), pad(u0), jnp.asarray(jd.adj_grid)))
    ref = ref[1:Nx - 1, 1:Ny - 1, 1:Nz - 1]

    out = torch.zeros(d.grid.shape, dtype=torch.float32)
    stencil_step_plain(torch.from_numpy(u0), torch.from_numpy(u1),
                       torch.from_numpy(d.adj_grid), out, d.grid, d.sc)
    got = out[1:-1, 1:-1, 1:-1].numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-6, err


def test_abc_regions_cover_the_q_grid():
    """The disjoint ABC regions reproduce the oracle's per-node Q."""
    from pffdtd_tpu.engine.numpy_ref import abc_q_grid

    for name in CASES:
        g = EngineData(*_args(_scene(name))).grid
        Q = np.zeros(g.shape, np.int64)
        for sl, q in abc_regions(g):
            assert not Q[sl].any()          # disjoint
            Q[sl] = q
        np.testing.assert_array_equal(
            Q, abc_q_grid(*g.shape, folded_y=g.folded))


def _args(sim):
    return sim.consts, sim.vox, sim.comms, sim.mats


def test_wrapper_runs_plain_on_cpu_and_validates():
    sim = _scene("fcc-folded")
    d = EngineData(*_args(sim), dtype=np.float64)
    rng = np.random.default_rng(2)
    u0, u1 = (torch.from_numpy(rng.standard_normal(d.grid.shape))
              for _ in range(2))
    adj = torch.from_numpy(d.adj_grid)
    a, b = torch.zeros_like(u0), torch.zeros_like(u0)
    before = stencil_step.launches
    stencil_step(u0, u1, adj, a, d.grid, d.sc)
    stencil_step_plain(u0, u1, adj, b, d.grid, d.sc)
    assert torch.equal(a, b)
    assert stencil_step.launches == before      # no kernel on the CPU
    with pytest.raises(ValueError):             # out must be a third buffer
        stencil_step(u0, u1, adj, u0, d.grid, d.sc)
    with pytest.raises(ValueError):             # FCC adjacency is uint16
        stencil_step(u0, u1, adj.to(torch.uint8), a, d.grid, d.sc)
    with pytest.raises(TypeError):
        stencil_step(u0.float(), u1, adj, a, d.grid, d.sc)


# (rows, Ny, Nz): the minimum grid, the FCC cell (1628 x 635 x 1048), the
# Cartesian 1.049 Gvox box (1288 x 1008 x 808), a slab of four of the
# headline, a one-row slab of the cell, a thin y and a thin z, and the
# Cartesian cell as "auto" lays it out (1296 x 832 x 1012)
PLAN_SHAPES = [(3, 5, 5), (1626, 635, 1048), (1286, 1008, 808),
               (198, 310, 510), (1, 635, 1048), (40, 6, 1048),
               (790, 310, 7), (1294, 832, 1012)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_k1_covers_the_interior_once(shape, itemsize):
    rows, Ny, Nz = shape
    g = plan_k1(rows, Ny, Nz, itemsize)
    teams = kstencil.MARCH_THREADS // g.Bz
    assert g.Bz in kstencil.MARCH_WIDTHS
    assert g.By % teams == 0
    assert 1 <= g.By // teams <= kstencil.MARCH_MAX_ROWS
    assert 1 <= g.Cx <= kstencil.MARCH_CHUNK
    # each axis walked as the kernel walks it: z = oz0 + lane, y = oy0 +
    # team + j * teams, x in [X0, X0 + Cx), each kept inside the interior
    nz, ny = Nz - 2, Ny - 2
    hits = {"z": np.zeros(Nz, int), "y": np.zeros(Ny, int),
            "x": np.zeros(rows + 2, int)}
    for t in range(g.grid[0]):
        z = 1 + t * g.Bz + np.arange(g.Bz)
        np.add.at(hits["z"], z[z <= nz], 1)
    for t in range(g.grid[1]):
        y = (1 + t * g.By + np.arange(teams)[:, None]
             + teams * np.arange(g.By // teams)[None, :]).ravel()
        np.add.at(hits["y"], y[y <= ny], 1)
    for c in range(g.grid[2]):
        x0 = 1 + c * g.Cx
        hits["x"][x0:min(x0 + g.Cx, rows + 1)] += 1
    for axis, h in hits.items():
        assert (h[1:-1] == 1).all() and h[0] == 0 and h[-1] == 0, axis
    # the launch's limits: blocks along y and z, shared memory (the
    # launcher asks for no more than the default 48 KB, under the H100's
    # 227 KB), and the ring cells a thread loads a plane (kCells: 5 for
    # either width)
    assert g.grid == (-(-nz // g.Bz), -(-ny // g.By), -(-rows // g.Cx))
    assert g.grid[0] < 2**31 and max(g.grid[1:]) <= 65535
    assert g.smem == (kstencil.MARCH_RING * (g.By + 2) * (g.Bz + 2)
                      * itemsize) <= 48 * 1024
    assert (g.By + 2) * (g.Bz + 2) <= 5 * kstencil.MARCH_THREADS
    # a grid of 10^8 points or more fills the H100's 132 SMs, four blocks
    # each, for several waves
    if rows * ny * nz >= 10**8:
        assert g.blocks >= 8 * 132 * 4


def test_probe_tells_the_march_from_the_1d_kernels():
    """probes.kernel_ab keys K1's SASS on the march's instances (K1 and
    K5: dtype, adjacency, legs, tile width) and K1e's on the 1-D energy
    kernel, `stencil_energy_kernel` (dtype, adjacency, legs), neither on
    the other's."""
    import re

    from pffdtd_tpu_torch.probes import kernel_ab

    ns = "_ZN43_GLOBAL__N__901f37f3_10_stencil_cu_d2e80092"
    energy = f"{ns}21stencil_energy_kernelIdhLi6EEEvPKT_S3_"
    march = f"{ns}19stencil_step_kernelIftLi12ELi64EEEvNS_8StepArgsIT_T0_EE"

    def key(pattern, name):
        m = re.search(pattern[0], name)
        return m.group(*pattern[1]) if m else None

    assert key(kernel_ab.K1E_SASS, energy) == ("d", "h", "6")
    assert key(kernel_ab.K1E_SASS, march) is None
    assert key(kernel_ab.K1_SASS, march) == ("f", "t", "12", "64")
    assert key(kernel_ab.K1_SASS, energy) is None
