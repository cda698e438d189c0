"""The energy functionals of the energy-instrumented step, on tensors.

Counterpart of `step_energy` (pffdtd_tpu/engine/jax_engine.py:704-747) and of
the oracle's split formulation (pffdtd_tpu/engine/numpy_ref.py:183-225).  With
V = V_fac (2 on FCC grids, 1 Cartesian), h, c, Ts the scene's constants and
l, l2 the Courant number and its square, around step n:

    H[n]    = V h/2 sum_int((u^n - u^{n-1})^2 / l2 - u^n L u^{n-1})
              - V h/2 sum_abc((1 - 2^-Q)((u^n - u^{n-1})^2 / l2
                                         - u^n L u^{n-1}))
              + V c / (2 l2) sum_nodes ssaf (vh^2 D + (Ts gh)^2 F)
    dE_lost = V h / (4 l) sum_nodes ssaf (vh' + vh)^2 E
              + V h / (2 l) sum_abc(2^-Q Q (u^{n+1} - u^{n-1})^2)
    dE_in   = V h / (2 l2) sum_src((u^{n+1} - u^{n-1}) sig_n)

with vh, gh the branch states before the step and vh' after it, `int` the
interior, `abc` the ABC layers (Q > 0) and L the adjacency-masked Laplacian

    L u = lfac (sum_k bit_k u(x + v_k) - K_bits u),    K_bits = sum_k bit_k,

from the bits that `EngineData.adj_grid` holds (air nodes carry all of
them).  The JAX step forms it as the dense Laplacian plus a sparse
correction at the boundary nodes, lfac (ncut u - sum of the cut legs), from
(Nb, NN) cut-leg arrays; the two are equal, and round differently at the
1e-16 level.  The port's fields keep stale halo cells (its flips are
virtual), so L reads the neighbours through the mirror flips that K1 applies
(`kernels.stencil.mirrored`), as the JAX step reads its flipped field, and
sums the legs as K1's plain version does (`kernels.stencil.masked_legs`).

The ABC weights 2^-Q and Q are taken per region (`abc_regions`: 6 face
interiors, 12 edges, 8 corners, on a folded grid without the fold-ghost
face): no Q, V or mask grids.  The D, E, F rows of a lossy node are its
material's (`EngineData.def_table`, indexed by `mat` as K2 indexes
`coef_table`).  Every term runs in the state's dtype, as JAX's does; each
function returns a 0-d tensor on the state's device, so a run never waits
for the device.

These functions are the plain building blocks of K7
(`kernels.energy.energy_grid_pass_plain`, `energy_boundary_pass_plain`);
on the card the engine computes the grid terms and L u in K1's launch (its
energy mode, `kernels.stencil.stencil_energy_step`) and the rest in K7's
pass over the boundary (`csrc/energy.cu`), with no grid but L u.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pffdtd_tpu_torch.engine.data import GridSpec
from pffdtd_tpu_torch.kernels.stencil import (abc_regions, masked_legs,
                                              mirrored)
from pffdtd_tpu_torch.utils import as_dtype


@dataclass
class EnergyScene:
    """What the functionals and K7 read: the adjacency, the lossy nodes'
    ssaf and material rows with the (Nmat+1, 3, MMb) D | E | F table, the
    sources, the ABC regions (K7 finds Q from a point's indices and the
    grid's extents) and the constants, rounded to the state's dtype.  No
    per-voxel grid: L u lives in the engine's carry."""

    grid: GridSpec
    adj: torch.Tensor        # packed adjacency grid
    ssaf: torch.Tensor       # (Nbl,)
    mat: torch.Tensor        # (Nbl,) int32
    def_table: torch.Tensor  # (Nmat+1, 3, MMb): D | E | F
    in_ixyz: torch.Tensor    # (Ns,) int64
    regions: list            # [(slices, Q)] of the ABC layers
    lfac: float
    l: float
    l2: float
    inv_l2: float            # 1/l2 in the state's dtype (see hamiltonian_grid)
    V_fac: float
    h: float
    c: float
    Ts: float

    @classmethod
    def make(cls, data, *, adj, ssaf, mat, in_ixyz):
        """From an `EngineData` and the engine's device tensors."""
        dt = torch.float32 if data.dtype == np.float32 else torch.float64
        r = lambda x: as_dtype(x, dt)
        sc = data.sc
        return cls(grid=data.grid, adj=adj, ssaf=ssaf, mat=mat,
                   def_table=torch.from_numpy(data.def_table).to(adj.device),
                   in_ixyz=in_ixyz, regions=abc_regions(data.grid),
                   lfac=r(sc.lfac), l=r(sc.l), l2=r(sc.l2),
                   inv_l2=r(1.0 / r(sc.l2)),
                   V_fac=r(data.V_fac), h=r(data.e_h), c=r(data.e_c),
                   Ts=r(data.e_Ts))


def _interior(grid):
    Nx, Ny, Nz = grid.shape
    return (slice(1, Nx - 1), slice(1, Ny - 1), slice(1, Nz - 1))


def laplacian(es: EnergyScene, u, out):
    """out = L u on the interior, zero on the halos; returns `out`."""
    g = es.grid
    inner = _interior(g)
    uf = mirrored(u, g)
    acc, K = masked_legs(uf, es.adj, g, 1, g.Nx - 1)
    acc -= K * uf[inner]
    del K, uf
    out.zero_()
    out[inner] = es.lfac * acc
    return out


def _lossy_rows(es: EnergyScene, q):
    """(MMb, Nbl) rows of D (q = 0), E (1) or F (2) per lossy node."""
    return es.def_table[es.mat.long(), q].T


def hamiltonian_grid(es: EnergyScene, u0, u1, Lu):
    """H[n]'s grid terms, the interior sum less the ABC correction, from
    u0 = u^{n-1}, u1 = u^n and Lu = L u^{n-1}.

    (u^n - u^{n-1})^2 / l2 is taken as a product with 1/l2 rounded to the
    state's dtype (K7 does the same): an fp64 division a point made K7's
    grid pass several times slower on the H100, and the product differs
    from JAX's quotient by at most an ulp a term."""
    inner = _interior(es.grid)
    du = u1[inner] - u0[inner]
    H = es.V_fac * 0.5 * es.h * (du * du * es.inv_l2
                                 - u1[inner] * Lu[inner]).sum()
    del du
    corr = None
    for sl, Q in es.regions:
        d = u1[sl] - u0[sl]
        s = (1.0 - 2.0 ** -Q) * (d * d * es.inv_l2 - u1[sl] * Lu[sl]).sum()
        corr = s if corr is None else corr + s
    return H - es.V_fac * 0.5 * es.h * corr


def hamiltonian_lossy(es: EnergyScene, vh, gh):
    """H[n]'s lossy-branch term from the branch states vh, gh (MMb, Nbl)
    before the step (a scene with lossy nodes only)."""
    D, F = _lossy_rows(es, 0), _lossy_rows(es, 2)
    ts = es.Ts * gh
    return es.V_fac * 0.5 * es.c / es.l2 * (
        es.ssaf * (vh * vh * D + ts * ts * F)).sum()


def loss_increment(es: EnergyScene, unew, u0, vh_new, vh_old):
    """dE_lost of one step: the lossy branches' dissipation from the branch
    states after (vh_new) and before (vh_old) it, and the ABC losses from
    unew = u^{n+1} and u0 = u^{n-1}."""
    dE = None
    for sl, Q in es.regions:
        d = unew[sl] - u0[sl]
        s = (2.0 ** -Q * Q) * (d * d).sum()
        dE = s if dE is None else dE + s
    dE = 0.5 * es.V_fac * es.h / es.l * dE
    if es.ssaf.numel():
        v = vh_new + vh_old
        dE = dE + es.V_fac * 0.25 * es.h / es.l * (
            es.ssaf * (v * v * _lossy_rows(es, 1))).sum()
    return dE


def input_increment(es: EnergyScene, unew, u0_in, sig):
    """dE_in of one step from unew = u^{n+1}, u0_in = u^{n-1} at the
    sources (read before the step) and the source samples sig (Ns,)."""
    u_in = unew.reshape(-1).index_select(0, es.in_ixyz)
    return (es.V_fac * es.h / es.l2) * 0.5 * ((u_in - u0_in) * sig).sum()
