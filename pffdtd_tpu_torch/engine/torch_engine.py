"""The single-device engine: the leapfrog loop on PyTorch tensors.

Counterpart of `JaxEngine` (pffdtd_tpu/engine/jax_engine.py:751-1317).  Two
routes compute the same steps:

- **step**, the single-step route (the JAX `backend="pallas"` route).  One
  step computes exactly the XLA `_step_core` with `rigid="dense"`
  (jax_engine.py:632-692):
  1. K1 (`kernels.stencil.stencil_step`): mirror halo flips, the adjacency-
     masked stencil with the leapfrog, and the Engquist-Majda ABC, into a
     third buffer;
  2. K2 (`kernels.boundary.boundary_update`): the lossy ODE at the Nbl
     nodes, reading u^{n-1} from the untouched u0;
  3. sources: unew[in_ixyz] += sig_n / infac;
  4. the receiver readout out_n = u1f[out_ixyz], u1 *after* the flips, read
     through mirrored indices since the flips are virtual.
  The buffers rotate (u0, u1, u2) -> (u1, u2, u0) after each step.
- **tb**, the temporally-blocked route (the JAX `pallas_pair` / `pallas_tb`
  routes, jax_engine.py:440-549): K3 (`kernels.tb.tb_sweep`) advances TB
  steps per sweep, each exactly the step above.  `pair` is this route with
  TB = 2.  A sweep from (u^{n-1}, u^n) yields receiver rows n .. n+TB-1:
  row n is read from u^n before the launch, rows n+1 .. n+TB-2 are the
  kernel's in-kernel taps, row n+TB-1 is read from the sweep's first output
  (the JAX scheme, jax_engine.py:530-541).  No output may alias an input,
  so the fields rotate among four buffers and the branch states
  double-buffer.

`_step_core` applies the lossy ODE before the ABC; K1 and K3 apply the ABC
first.  The two orders agree whenever no lossy node lies on an ABC layer,
which holds for every scene built with the grid offset of 3.5 h; the engine
checks it for every route and refuses a scene where it does not hold.

Receiver samples go into a preallocated (Nt, Nr) device tensor, so the time
loop has no host sync.  On CUDA tensors the wrappers launch the hand-written
kernels; on the CPU they run their plain PyTorch versions.
`use_kernels=False` calls the plain versions on any device (the card's
comparison path).  The engine runs on the card unless `device="cpu"` is
passed, and never falls back to the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pffdtd_tpu_torch.engine.data import EngineData, abc_layer_mask, \
    mirror_index
from pffdtd_tpu_torch.io.simdata import MMb, read_sim_folder, write_outputs
from pffdtd_tpu_torch.kernels.boundary import boundary_update, \
    boundary_update_plain
from pffdtd_tpu_torch.kernels.stencil import stencil_step, stencil_step_plain
from pffdtd_tpu_torch.kernels.tb import TBScene, tb_sweep, tb_sweep_plain

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
BACKENDS = ("auto", "step", "pair", "tb")


def pick_route(backend: str, tb: int = 3):
    """(route, TB): route "step" (TB None) or "tb" (TB steps per sweep).

    "auto" takes the single-step route.  The JAX engine's rule sends fp32
    scenes with <= 64 sources to its temporally-blocked kernels
    (jax_engine.py:776-980), but on the H100 K3 is still the slower route
    on the headline scene at every TB: its best, TB = 3, takes 1.4205 ms
    per step (4.2615 ms a sweep) and TB = 2 1.7658, against 1.1370 for
    K1 + K2 (NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py's TB scan;
    PERF.md).  The rule is static: nothing is timed at run time."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend in ("auto", "step"):
        return "step", None
    TB = 2 if backend == "pair" else int(tb)
    if not 2 <= TB <= 8:
        raise ValueError(f"tb={TB}: 2..8 steps per sweep")
    return "tb", TB


class TorchEngine:
    """Single-device FDTD engine on PyTorch tensors."""

    def __init__(self, folder=None, *, consts=None, vox=None, comms=None,
                 mats=None, dtype=np.float32, device="cuda",
                 backend: str = "auto", tb: int = 3,
                 use_kernels: bool = True):
        if folder is not None:
            sim = read_sim_folder(folder)
            consts, vox, comms, mats = sim.consts, sim.vox, sim.comms, \
                sim.mats
        self._folder = folder
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda: torch.cuda.is_available() is "
                               "False; pass device='cpu' to run the plain "
                               "PyTorch versions on the CPU")
        self.data = d = EngineData(consts, vox, comms, mats, dtype=dtype)
        self.dtype = _TORCH_DTYPE[d.dtype]
        self.Nt = d.Nt
        self.use_kernels = use_kernels
        self.backend, self.TB = pick_route(backend, tb)
        if d.Nbl and abc_layer_mask(d.bnl_ixyz, d.grid).any():
            raise ValueError("a lossy boundary node lies on an ABC layer: "
                             "the kernels apply the ABC before the lossy "
                             "update, which is exact only off those layers")
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.adj = up(d.adj_grid)
        self.bnl = up(d.bnl_ixyz)
        self.ssaf = up(d.ssaf_bnl)
        self.mat = up(d.mat_bnl)
        self.coef_table = up(d.coef_table)
        self.beta = up(d.beta)
        self.in_ixyz = up(d.in_ixyz)
        self.out_ixyz_f = up(mirror_index(d.out_ixyz, d.grid))
        self.tb_scene = None
        if self.TB is not None:
            self.tb_scene = TBScene.make(
                d, self.TB, adj=self.adj, bnl=self.bnl, ssaf=self.ssaf,
                mat=self.mat, coef_table=self.coef_table, beta=self.beta,
                in_ixyz=self.in_ixyz, out_ixyz_f=self.out_ixyz_f)

    # -------------------------------------------------------------- state
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def init_state(self):
        """Zero state (u0, u1, u2, vh, gh): u0 = u^{n-1}, u1 = u^n, u2 the
        output scratch; branch states (MMb, Nbl)."""
        g, nbl = self.data.grid.shape, self.data.Nbl
        return [self._zeros(*g), self._zeros(*g), self._zeros(*g),
                self._zeros(MMb, nbl), self._zeros(MMb, nbl)]

    def step(self, state, sig_n, out_row=None):
        """Advance `state` by one step in place (buffers rotate).

        sig_n: (Ns,) source samples already divided by infac, on device;
        out_row: optional (Nr,) view that receives u1f[out_ixyz]."""
        u0, u1, u2, vh, gh = state
        d = self.data
        if out_row is not None:
            torch.index_select(u1.view(-1), 0, self.out_ixyz_f, out=out_row)
        k1 = stencil_step if self.use_kernels else stencil_step_plain
        k2 = boundary_update if self.use_kernels else boundary_update_plain
        k1(u0, u1, self.adj, u2, d.grid, d.sc)
        if d.Nbl:
            k2(u2, u0, self.bnl, self.ssaf, self.mat, self.coef_table,
               self.beta, vh, gh, d.sc)
        u2.view(-1).index_add_(0, self.in_ixyz, sig_n)
        state[0], state[1], state[2] = u1, u2, u0
        return state

    def sweep(self, state, spare, sigs, out, n):
        """Advance `state` by TB steps from step n with one K3 sweep.

        spare: [a fourth grid, vh, gh buffers] that the sweep writes and
        swaps with the state's; sigs: (nt, Ns); out: (nt, Nr) receiver rows,
        of which rows n .. n+TB-1 are written."""
        TB = self.TB
        u0, u1, u2, vh, gh = state
        u3, vh2, gh2 = spare
        k3 = tb_sweep if self.use_kernels else tb_sweep_plain
        torch.index_select(u1.view(-1), 0, self.out_ixyz_f, out=out[n])
        k3(self.tb_scene, u0, u1, u2, u3, vh, gh, vh2, gh2,
           sigs[n:n + TB], out[n + 1:n + TB - 1] if TB > 2 else None)
        torch.index_select(u2.view(-1), 0, self.out_ixyz_f,
                           out=out[n + TB - 1])
        state[:] = [u2, u3, u0, vh2, gh2]
        spare[:] = [u1, vh, gh]
        return state

    # ---------------------------------------------------------------- run
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, nt: int | None = None, verbose: bool = True,
            chunk: int | None = None):
        """Run nt steps (default Nt) from the zero state; returns u_out
        (Nr, nt) float64, scaled back by infac; the final state stays in
        `self.state`.

        The TB route runs nt // TB sweeps, then the nt % TB remaining steps
        with K1 + K2.  (The JAX engine instead zero-pads the signal to whole
        sweeps and trims the output, jax_engine.py:1044-1056: u_out is the
        same either way, and here the final state is exactly step nt.)

        chunk: with verbose, print a progress line each time the step count
        passes a multiple of `chunk` (each line waits for the device;
        without chunk the loop never does)."""
        d = self.data
        g = d.grid
        npts = g.Nx * g.Ny * g.Nz
        nt = self.Nt if nt is None else nt
        sigs = torch.from_numpy(
            (d.in_sigs[:, :nt] / d.infac).T.astype(d.dtype).copy()).to(
                self.device)                                 # (nt, Ns)
        out = torch.zeros((nt, d.out_ixyz.size), dtype=self.dtype,
                          device=self.device)
        state = self.init_state()
        TB = self.TB or 1
        spare = None
        if TB > 1:   # the sweep's fourth grid and second vh, gh
            spare = [self._zeros(*g.shape), self._zeros(MMb, d.Nbl),
                     self._zeros(MMb, d.Nbl)]
        self._sync()
        t0 = tb = time.perf_counter()
        n = 0
        while n < nt:
            k = TB if n + TB <= nt else 1
            if k > 1:
                self.sweep(state, spare, sigs, out, n)
            else:
                self.step(state, sigs[n], out[n])
            n += k
            if verbose and chunk and n // chunk > (n - k) // chunk \
                    and n < nt:
                self._sync()
                t = time.perf_counter()
                print(f"--ENGINE(torch): {n}/{nt} [{100 * n / nt:.0f}%] "
                      f"{npts * chunk / (t - tb) / 1e6:.1f} MVPS inst, "
                      f"{npts * n / (t - t0) / 1e6:.1f} MVPS avg",
                      flush=True)
                tb = t
        self._sync()
        self.elapsed = time.perf_counter() - t0
        self.state = state
        self.u_out = np.float64(out.T.cpu().numpy()) * d.infac
        self.mvps = npts * nt / self.elapsed / 1e6
        if verbose:
            route = self.backend if self.TB is None else \
                f"{self.backend} TB={self.TB}"
            print(f"--ENGINE(torch): {nt} steps over {npts / 1e6:.2f} Mvox "
                  f"on {self.device} ({route}) in {self.elapsed:.3f}s -> "
                  f"{self.mvps:.1f} MVPS")
        return self.u_out

    def save_outputs(self, folder=None):
        write_outputs(folder or self._folder, self.u_out,
                      self.data.out_reorder)

    def print_last_samples(self, Np=5):
        ro = self.data.out_reorder
        nt = self.u_out.shape[1]
        for i in range(self.u_out.shape[0]):
            print(f"--ENGINE(torch): out {i}")
            for n in range(max(0, nt - Np), nt):
                print(f"--ENGINE(torch): sample {n}: "
                      f"{self.u_out[ro[i], n]:.16e}")
