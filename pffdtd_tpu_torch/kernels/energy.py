"""K7, the energy functionals of the energy-instrumented step, and their
plain versions.

Counterpart of what XLA fuses out of `pffdtd_tpu/engine/jax_engine.py`
`step_energy` (:704-747).  Two halves bracket one step (K1 + K2 + sources):

- the grid half, from u0 = u^{n-1}, u1 = u^n and Lu = L u^{n-1}: L u^n
  over Lu (in place, halos untouched) and H[n]'s grid terms (interior sum
  less the ABC correction) into the fp64 scratch `part`.  On the card K1's
  energy mode computes it in the step's own launch
  (`kernels.stencil.stencil_energy_step`, K1e); `energy_grid_pass_plain`
  is its plain version, K1e's plain half;
- `energy_boundary_pass(es, unew, u0, vh, vh_prev, gh_prev, sig, part, H,
  E_lost, E_in)`, after the step, from unew = u^{n+1}, u0 = u^{n-1} (which
  the step leaves as it was), the branch states after (vh) and before
  (vh_prev, gh_prev) the step and the source samples sig: writes H[n] into
  the 0-d `H` and adds dE_lost and dE_in to the 0-d accumulators.

On CUDA tensors the boundary pass launches `csrc/energy.cu`, whose sums
are fp64 per block, then reduced in a fixed order by a stage of its own
(no atomics, no `torch.sum`): a run and its resume give the same bits.  On
CPU tensors it runs `energy_boundary_pass_plain`.  The plain versions are
composed from `engine.energy`'s `hamiltonian_grid`, `laplacian`,
`hamiltonian_lossy`, `loss_increment` and `input_increment` in the state's
dtype, with H[n]'s grid terms carried in `part[0]`.  Node, material and
source indices are not range-checked per call (a device sync each step);
`EngineData` builds them in range.
"""

from __future__ import annotations

import torch

from pffdtd_tpu_torch.engine.energy import (hamiltonian_grid,
                                            hamiltonian_lossy,
                                            input_increment, laplacian,
                                            loss_increment)
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels import _build

# the launch geometry that sets the scratch's size: K1e's blocks of
# GRID_THREADS z points, MID_BLOCKS blocks in K7's middle stage,
# boundary-pass blocks of THREADS items
GRID_THREADS, MID_BLOCKS, THREADS = 128, 1024, 256


def shell_points(grid) -> int:
    """Interior points on an ABC layer (Q > 0), which the boundary pass
    visits: the two x faces, and per other x row its y faces (one on a
    folded grid, whose high-y layer is the fold ghost) and the z = 1, Nz-2
    points of its other rows."""
    Nx, Ny, Nz = grid.shape
    nym = Ny - 3 if grid.folded else Ny - 4
    per_x = (1 if grid.folded else 2) * (Nz - 2) + 2 * nym
    return 2 * (Ny - 2) * (Nz - 2) + (Nx - 4) * per_x


def scratch_size(grid, nbl: int) -> int:
    """Doubles of fp64 scratch K1e and the boundary pass need: two partial
    sums a K1e block (a z-run of GRID_THREADS points of one (x, y) row) and
    a middle-stage block, four a boundary-pass block (THREADS ABC-shell
    points or lossy nodes each, plus one block for the sources)."""
    Nx, Ny, Nz = grid.shape
    na = -(-(Nz - 2) // GRID_THREADS) * (Ny - 2) * (Nx - 2)
    nb = -(-shell_points(grid) // THREADS) + -(-nbl // THREADS) + 1
    return 2 * na + 2 * MID_BLOCKS + 4 * nb


def _device(ts, names):
    """The one device of tensors `ts`, which must be cpu or cuda."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{', '.join(names)} must share one device, got "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {dev}: cpu or cuda only")
    return dev


def _want(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _distinct(named):
    ptrs = [t.data_ptr() for _, t in named]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError(f"{', '.join(n for n, _ in named)} must be "
                         f"distinct buffers")


def _check_scene(es, dt):
    nbl = es.ssaf.numel()
    _want("ssaf", es.ssaf, dt, (nbl,))
    _want("mat", es.mat, torch.int32, (nbl,))
    _want("def_table", es.def_table, dt, (es.def_table.shape[0], 3, MMb))
    _want("in_ixyz", es.in_ixyz, torch.int64, (es.in_ixyz.numel(),))
    nn = 12 if es.grid.fcc_flag else 6
    _want("adj", es.adj, torch.uint16 if nn == 12 else torch.uint8,
          es.grid.shape)
    if min(es.grid.shape) < 5:
        raise ValueError(f"grid {es.grid.shape}: every extent must be >= 5")
    return nbl, nn


def _check_grid(es, u0, u1, Lu, part):
    dt = u1.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"u1: dtype {dt}, want float32/float64")
    for name, t in (("u0", u0), ("u1", u1), ("Lu", Lu)):
        _want(name, t, dt, es.grid.shape)
    nbl, nn = _check_scene(es, dt)
    _want("part", part, torch.float64, (scratch_size(es.grid, nbl),))
    dev = _device((u0, u1, Lu, part, es.adj, es.ssaf, es.mat, es.def_table,
                   es.in_ixyz), ("u0", "u1", "Lu", "part", "the scene"))
    Ny, Nz = es.grid.Ny, es.grid.Nz
    if Ny * Nz + Nz + 1 > 2**31 - 1:
        raise ValueError(f"grid {es.grid.shape}: a (y, z) plane must hold "
                         "< 2**31 points (K1e's offsets are 32-bit)")
    _distinct((("Lu", Lu), ("u0", u0)))
    _distinct((("Lu", Lu), ("u1", u1)))
    return dev, nn


def energy_grid_pass_plain(es, u0, u1, Lu, part):
    """PyTorch version of K7's grid half, which K1e computes on the card:
    L u^n over Lu, H[n]'s grid terms, in the state's dtype, to part[0];
    returns Lu."""
    part[0] = hamiltonian_grid(es, u0, u1, Lu)
    laplacian(es, u1, Lu)
    return Lu


def _check_boundary(es, unew, u0, vh, vh_prev, gh_prev, sig, part, H,
                    E_lost, E_in):
    dt = unew.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unew: dtype {dt}, want float32/float64")
    nbl, _ = _check_scene(es, dt)
    shapes = {"unew": es.grid.shape, "u0": es.grid.shape, "vh": (MMb, nbl),
              "vh_prev": (MMb, nbl), "gh_prev": (MMb, nbl),
              "sig": (es.in_ixyz.numel(),), "H": (), "E_lost": (),
              "E_in": ()}
    named = dict(unew=unew, u0=u0, vh=vh, vh_prev=vh_prev, gh_prev=gh_prev,
                 sig=sig, H=H, E_lost=E_lost, E_in=E_in)
    for name, t in named.items():
        _want(name, t, dt, shapes[name])
    _want("part", part, torch.float64, (scratch_size(es.grid, nbl),))
    dev = _device((*named.values(), part, es.ssaf, es.mat, es.def_table,
                   es.in_ixyz), (*named, "part", "the scene"))
    _distinct((("unew", unew), ("u0", u0)))
    if nbl:
        _distinct((("vh", vh), ("vh_prev", vh_prev), ("gh_prev", gh_prev)))
    _distinct((("H", H), ("E_lost", E_lost), ("E_in", E_in)))
    return dev, nbl


def energy_boundary_pass(es, unew, u0, vh, vh_prev, gh_prev, sig, part, H,
                         E_lost, E_in):
    """K7's boundary pass and second stage: H[n] into `H`, dE_lost and
    dE_in added to `E_lost` and `E_in` (0-d, the state's dtype); returns H.
    unew = u^{n+1}, u0 = u^{n-1}; vh (MMb, Nbl) after the step, vh_prev and
    gh_prev before it; sig (Ns,) the step's source samples; part: the
    scratch K1e filled."""
    dev, nbl = _check_boundary(es, unew, u0, vh, vh_prev, gh_prev, sig,
                               part, H, E_lost, E_in)
    if dev.type == "cpu":
        return energy_boundary_pass_plain(es, unew, u0, vh, vh_prev, gh_prev,
                                          sig, part, H, E_lost, E_in)
    lib = _build.library()
    g = es.grid
    with _build.on_device(dev):
        rc = lib.pf_energy_boundary(
            0 if unew.dtype == torch.float32 else 1, unew.data_ptr(),
            u0.data_ptr(), vh.data_ptr(), vh_prev.data_ptr(),
            gh_prev.data_ptr(), es.ssaf.data_ptr(), es.mat.data_ptr(),
            es.def_table.data_ptr(), es.in_ixyz.data_ptr(), sig.data_ptr(),
            nbl, es.in_ixyz.numel(), part.data_ptr(), part.numel(), g.Nx,
            g.Ny, g.Nz, int(g.folded), es.Ts,
            # the constants as the plain building blocks write them
            es.V_fac * 0.5 * es.h, es.V_fac * 0.5 * es.c / es.l2,
            0.5 * es.V_fac * es.h / es.l, es.V_fac * 0.25 * es.h / es.l,
            (es.V_fac * es.h / es.l2) * 0.5, H.data_ptr(), E_lost.data_ptr(),
            E_in.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "energy_boundary_pass")
    energy_boundary_pass.launches += 1
    return H


energy_boundary_pass.launches = 0


def energy_boundary_pass_plain(es, unew, u0, vh, vh_prev, gh_prev, sig, part,
                               H, E_lost, E_in):
    """PyTorch version of K7's boundary pass (same signature and result):
    H[n] = part[0] (the plain grid half's terms) + the lossy term, in the
    state's dtype."""
    Hn = part[0].to(H.dtype)
    if es.ssaf.numel():
        Hn = Hn + hamiltonian_lossy(es, vh_prev, gh_prev)
    H.copy_(Hn)
    E_lost += loss_increment(es, unew, u0, vh, vh_prev)
    u0_in = u0.reshape(-1).index_select(0, es.in_ixyz)
    E_in += input_increment(es, unew, u0_in, sig)
    return H
