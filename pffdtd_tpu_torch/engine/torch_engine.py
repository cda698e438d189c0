"""The single-device engine: the leapfrog loop on PyTorch tensors.

Counterpart of `JaxEngine` (pffdtd_tpu/engine/jax_engine.py:751-1317).  Two
routes compute the same steps:

- **step**, the single-step route (the JAX `backend="pallas"` route).  One
  step computes exactly the XLA `_step_core` with `rigid="dense"`
  (jax_engine.py:632-692):
  1. K1 (`kernels.stencil.stencil_step`): mirror halo flips, the adjacency-
     masked stencil with the leapfrog, and the Engquist-Majda ABC, into a
     third buffer, reading the adjacency's compact form (`self.adj`, a
     `kernels.stencil.CompactAdj`; the other routes hold the packed grid);
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

`_step_core` applies the lossy ODE before the ABC; K1 and K3's stencil
apply the ABC first.  The two orders agree whenever no lossy node lies on
an ABC layer, which holds for every closed room built with the grid offset
of 3.5 h.  An open room, or a surface that reaches the domain's edge, puts
lossy nodes on those layers: every route then passes their Q (`abcq`) to
its ODE, K2's ABC mode on the step and energy routes, K3's on the TB
routes, which undoes the stencil's ABC there and applies it after the
ODE, the reference's order.

Receiver samples go into a preallocated (Nt, Nr) device tensor, so the time
loop has no host sync.  On CUDA tensors the wrappers launch the hand-written
kernels; on the CPU they run their plain PyTorch versions.
`use_kernels=False` calls the plain versions on any device (the card's
comparison path).  The engine runs on the card unless `device="cpu"` is
passed, and never falls back to the CPU.

`energy_on=True` (the step route only, as the JAX engine asserts,
jax_engine.py:448, 554) evaluates the energy functionals with every step:
K1 runs in its energy mode (`kernels.stencil.stencil_energy_step`, K1e),
which also writes L u^n and H[n]'s grid sums in the step's launch, and
K7's boundary pass (`kernels.energy.energy_boundary_pass`) follows the
step; on the CPU their plain versions, composed from `engine.energy`.
`run()` then fills `H_tot`, `E_lost` and `E_in`, and `energy_balance()`
gives the balance the JAX engine's does.  On an open room the route
computes JAX's `step_energy` and its balance, which does not close there:
the functional has no term for a node both lossy and on an ABC layer
(the balance stays < 1e-10 wherever no such node lies).
`run()` also takes JAX's per-chunk hook and checkpoint/resume
(jax_engine.py:1181-1293): a checkpoint is an `.npz` of named arrays, the
state at a chunk's end with the receiver (and energy) rows so far, and the
scene's grid, dtype, route and `fp32_eps`, which a resume must match.  On
the step route its progress lines carry the reference dashboard's air /
boundary split (fdtd_common.h:106-190), from `bn_ms_per_step`, K2 timed
alone, as JAX's do (jax_engine.py:1133-1179, 1240-1249).

`fp32_eps` is the stencil's diagonal shift (`EngineData`): None takes
FP32_EPS in fp32 and 0 in fp64, as the JAX engines do.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from pffdtd_tpu_torch import spans
from pffdtd_tpu_torch.engine.data import EngineData, mirror_index
from pffdtd_tpu_torch.engine.energy import EnergyScene
from pffdtd_tpu_torch.io.simdata import MMb, read_sim_folder, write_outputs
from pffdtd_tpu_torch.utils import rel_diff
from pffdtd_tpu_torch.kernels.boundary import boundary_update, \
    boundary_update_plain
from pffdtd_tpu_torch.kernels.energy import (energy_boundary_pass,
                                             energy_boundary_pass_plain,
                                             scratch_size)
from pffdtd_tpu_torch.kernels.stencil import (CompactAdj,
                                              stencil_energy_step,
                                              stencil_energy_step_plain,
                                              stencil_step,
                                              stencil_step_plain)
from pffdtd_tpu_torch.kernels.tb import TBScene, tb_sweep, tb_sweep_plain

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
BACKENDS = ("auto", "step", "pair", "tb")
# K2 launches `bn_ms_per_step` times after its warm launch (JAX's 30)
BN_ITERS = 30


def pick_route(backend: str, tb: int = 3):
    """(route, TB): route "step" (TB None) or "tb" (TB steps per sweep).

    "auto" takes the single-step route.  The JAX engine's rule sends fp32
    scenes with <= 64 sources to its temporally-blocked kernels
    (jax_engine.py:776-980), but on the H100 K3 takes longer a step at
    every TB than K1 + K2 (chip_smoke.py's TB scan; the numbers are in
    PERF.md's kernel table and its section 5).  The rule is static:
    nothing is timed at run time."""
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
                 use_kernels: bool = True, energy_on: bool = False,
                 fp32_eps: float | None = None):
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
        with spans.span("engine.data"):
            self.data = d = EngineData(consts, vox, comms, mats, dtype=dtype,
                                       fp32_eps=fp32_eps)
        self.dtype = _TORCH_DTYPE[d.dtype]
        self.Nt = d.Nt
        self.use_kernels = use_kernels
        self.backend, self.TB = pick_route(backend, tb)
        self.state = None     # a run's state, from its start to the next's
        self._bn_ms = None    # bn_ms_per_step's value, once measured
        if energy_on and self.TB is not None:
            raise ValueError(f"energy_on: the step route only (backend "
                             f"{backend!r} takes TB={self.TB} steps a "
                             f"sweep)")
        self.energy_on = energy_on
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        with spans.span("engine.upload", mem=dev):
            # K1 alone reads the adjacency on the step route without
            # energy: it takes the compact form there, the grid elsewhere
            if self.TB is None and not energy_on:
                self.adj = CompactAdj.from_nodes(d.bn_ixyz, d.bn_adj,
                                                 d.grid.shape, d.NN, dev)
            else:
                self.adj = up(d.adj_grid)
            self.bnl = up(d.bnl_ixyz)
            self.ssaf = up(d.ssaf_bnl)
            self.mat = up(d.mat_bnl)
            self.coef_table = up(d.coef_table)
            self.beta = up(d.beta)
            self.abcq = None if d.abcq_bnl is None else up(d.abcq_bnl)
            self.in_ixyz = up(d.in_ixyz)
            self.out_ixyz_f = up(mirror_index(d.out_ixyz, d.grid))
            self.energy_scene = None
            if energy_on:
                self.energy_scene = EnergyScene.make(
                    d, adj=self.adj, ssaf=self.ssaf, mat=self.mat,
                    in_ixyz=self.in_ixyz)
        self.tb_scene = None
        if self.TB is not None:
            with spans.span("engine.tb_scene", mem=dev):
                self.tb_scene = TBScene.make(
                    d, self.TB, adj=self.adj, bnl=self.bnl, ssaf=self.ssaf,
                    mat=self.mat, coef_table=self.coef_table, beta=self.beta,
                    in_ixyz=self.in_ixyz, out_ixyz_f=self.out_ixyz_f,
                    abcq=self.abcq)

    # -------------------------------------------------------------- state
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def init_state(self):
        """Zero state (u0, u1, u2, vh, gh): u0 = u^{n-1}, u1 = u^n, u2 the
        output scratch; branch states (MMb, Nbl)."""
        g, nbl = self.data.grid.shape, self.data.Nbl
        return [self._zeros(*g), self._zeros(*g), self._zeros(*g),
                self._zeros(MMb, nbl), self._zeros(MMb, nbl)]

    def step(self, state, sig_n, out_row=None, k1=None):
        """Advance `state` by one step in place (buffers rotate).

        sig_n: (Ns,) source samples already divided by infac, on device;
        out_row: optional (Nr,) view that receives u1f[out_ixyz]; k1: the
        stencil call, k1(u0, u1, adj, out, grid, sc) (default K1, or its
        plain version with use_kernels=False)."""
        u0, u1, u2, vh, gh = state
        d = self.data
        if out_row is not None:
            torch.index_select(u1.view(-1), 0, self.out_ixyz_f, out=out_row)
        if k1 is None:
            k1 = stencil_step if self.use_kernels else stencil_step_plain
        k2 = boundary_update if self.use_kernels else boundary_update_plain
        k1(u0, u1, self.adj, u2, d.grid, d.sc)
        if d.Nbl:
            k2(u2, u0, self.bnl, self.ssaf, self.mat, self.coef_table,
               self.beta, vh, gh, d.sc, self.abcq)
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

    def step_energy(self, state, sig_n, out_row, en):
        """`step` with the energy terms; returns H[n] (0-d).

        en: the run's energy carry (`_energy_carry`): Lu = L u^{n-1} on
        entry and L u^n on return, the accumulators E_lost and E_in (0-d,
        updated in place), vh_prev and gh_prev, scratch for the branch
        states before the step (K2 updates them in place), and part, the
        fp64 scratch of the sums.  K1e takes K1's place in the step (K7's
        grid pass in the same launch), K7's boundary pass follows it (their
        plain versions with use_kernels=False)."""
        es = self.energy_scene
        u0, _, _, vh, gh = state
        if self.use_kernels:
            k1e, boundary_pass = stencil_energy_step, energy_boundary_pass
        else:
            k1e = stencil_energy_step_plain
            boundary_pass = energy_boundary_pass_plain
        en.vh_prev.copy_(vh)
        en.gh_prev.copy_(gh)
        self.step(state, sig_n, out_row,
                  k1=lambda u0, u1, adj, out, grid, sc: k1e(
                      u0, u1, adj, out, en.Lu, en.part, grid, sc, es))
        # the step rotated the buffers: u0 = u^{n-1} is untouched, state[1]
        # is u^{n+1} and state[3] the branch states after the step
        H = torch.empty((), dtype=self.dtype, device=self.device)
        return boundary_pass(es, state[1], u0, state[3], en.vh_prev,
                             en.gh_prev, sig_n, en.part, H, en.E_lost,
                             en.E_in)

    def _energy_carry(self, nt):
        """L u^{n-1}, the accumulators, the branch-state scratch, the fp64
        scratch of the passes and the (nt,) rows of H, E_lost and E_in
        (post-step accumulations), all on device."""
        g, nbl = self.data.grid, self.data.Nbl
        return SimpleNamespace(
            Lu=self._zeros(*g.shape), E_lost=self._zeros(),
            E_in=self._zeros(), vh_prev=self._zeros(MMb, nbl),
            gh_prev=self._zeros(MMb, nbl),
            part=torch.zeros(scratch_size(g, nbl), dtype=torch.float64,
                             device=self.device),
            H_rows=self._zeros(nt), E_lost_rows=self._zeros(nt),
            E_in_rows=self._zeros(nt))

    # ---------------------------------------------------------------- run
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bn_ms_per_step(self) -> float | None:
        """K2's time a step (ms), measured once and cached; None where the
        JAX engine's is (jax_engine.py:1133-1179): a TB route, whose sweep
        fuses the boundary, energy_on, or a scene without lossy nodes.

        On a card, `BN_ITERS` launches after one warm launch, between CUDA
        events on the current stream; on the CPU, the plain version under
        `perf_counter`.  K2 updates unew, vh and gh in place, so it runs on
        the output scratch of the next step, `self.state[2]`, whose
        interior K1 overwrites whole before anything reads it (the lossy
        nodes are interior points), reading u^{n-1} = `self.state[0]`, on
        copies of vh and gh: the run's results stay bitwise as they are,
        at 2 * MMb * Nbl extra values.  Before a run (no state) it runs on
        two zeroed grids and zeroed branch states, as JAX's does."""
        d = self.data
        if self.TB is not None or self.energy_on or not d.Nbl:
            return None
        if self._bn_ms is not None:
            return self._bn_ms
        if self.state is None:
            unew, u0 = self._zeros(*d.grid.shape), self._zeros(*d.grid.shape)
            vh, gh = self._zeros(MMb, d.Nbl), self._zeros(MMb, d.Nbl)
        else:
            unew, u0 = self.state[2], self.state[0]
            vh, gh = self.state[3].clone(), self.state[4].clone()
        k2 = boundary_update if self.use_kernels else boundary_update_plain
        args = (unew, u0, self.bnl, self.ssaf, self.mat, self.coef_table,
                self.beta, vh, gh, d.sc, self.abcq)
        k2(*args)                                # warm
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record(stream)
            for _ in range(BN_ITERS):
                k2(*args)
            e1.record(stream)
            e1.synchronize()
            self._bn_ms = e0.elapsed_time(e1) / BN_ITERS
        else:
            t0 = time.perf_counter()
            for _ in range(BN_ITERS):
                k2(*args)
            self._bn_ms = (time.perf_counter() - t0) / BN_ITERS * 1e3
        return self._bn_ms

    @spans.numbered_run
    def run(self, nt: int | None = None, verbose: bool = True,
            chunk: int | None = None, checkpoint_every: int | None = None,
            checkpoint_path=None, resume: bool = False, on_chunk=None):
        """Run to step nt (default Nt); returns u_out (Nr, nt) float64,
        scaled back by infac; the final state stays in `self.state`.

        The steps run in chunks of `chunk` steps (default: one chunk),
        rounded up to a whole number of sweeps on the TB route, so that a
        chunk ends on a sweep boundary (JAX aligns its chunks to its step
        group, jax_engine.py:1213-1215).  A TB-route chunk runs its whole
        sweeps, then its remaining steps with K1 + K2.  (The JAX engine
        instead zero-pads the signal to whole sweeps and trims the output,
        jax_engine.py:1044-1056: u_out is the same either way, and here
        the final state is exactly step nt.)  After each chunk:
        - on_chunk(n, state) is called, n the steps done, state[1] = u^n;
        - with verbose, a progress line is printed (except after the last),
          with the air / boundary split on the step route: bn = K2's share
          of the chunk's ms a step, `bn_ms_per_step` (measured at the first
          line) over it, at most 100%;
        - every `checkpoint_every` chunks the state is saved to
          `checkpoint_path` (`save_checkpoint`).
        Only these wait for the device: without them the loop never does.
        resume=True with an existing `checkpoint_path` restarts from the
        step it holds (`load_checkpoint`), keeping its receiver rows.

        `self.elapsed` times the loop without the hook, the checkpoint I/O
        and the split's K2 probe; `self.mvps` is over the steps this call
        ran.  Each call is a numbered run (`spans.numbered_run`) with the
        spans run.signals (the signals' upload), run.state (the receiver
        rows, the energy carry, the state and the TB route's spare
        buffers: what a run allocates on the device), run.checkpoint (each
        save) and run.receivers (the rows' download and scaling), none of
        them inside the step loop.  The last run's state is dropped before
        the first of them, so a run holds one state, never two (a caller
        that keeps its own reference to an old `self.state` keeps that
        memory)."""
        self.state = None     # the last run's fields go before new ones
        d = self.data
        g = d.grid
        npts = g.Nx * g.Ny * g.Nz
        nt = self.Nt if nt is None else nt
        with spans.span("run.signals"):
            sigs = torch.from_numpy(
                (d.in_sigs[:, :nt] / d.infac).T.astype(d.dtype).copy()).to(
                    self.device)                             # (nt, Ns)
        TB = self.TB or 1
        with spans.span("run.state", mem=self.device):
            out = torch.zeros((nt, d.out_ixyz.size), dtype=self.dtype,
                              device=self.device)
            en = self._energy_carry(nt) if self.energy_on else None
            self.state = state = self.init_state()
            spare = None
            if TB > 1:   # the sweep's fourth grid and second vh, gh
                spare = [self._zeros(*g.shape), self._zeros(MMb, d.Nbl),
                         self._zeros(MMb, d.Nbl)]
        n0 = 0
        if resume and checkpoint_path and Path(checkpoint_path).exists():
            n0 = self.load_checkpoint(checkpoint_path, state, out, en)
            if verbose:
                print(f"--ENGINE(torch): resumed at step {n0}")
        chunk = -(-(chunk or max(nt - n0, 1)) // TB) * TB
        self._sync()
        t0 = tb = time.perf_counter()
        t_out = 0.0       # the hook's and the checkpoints' host time
        n, blocks = n0, 0
        while n < nt:
            c0, end = n, min(n + chunk, nt)
            while n < end:
                if n + TB <= end and TB > 1:
                    self.sweep(state, spare, sigs, out, n)
                    n += TB
                elif en is not None:
                    en.H_rows[n] = self.step_energy(state, sigs[n], out[n],
                                                    en)
                    en.E_lost_rows[n] = en.E_lost
                    en.E_in_rows[n] = en.E_in
                    n += 1
                else:
                    self.step(state, sigs[n], out[n])
                    n += 1
            blocks += 1
            ckpt = (checkpoint_every and checkpoint_path
                    and blocks % checkpoint_every == 0)
            show = verbose and n < nt
            if not (on_chunk or ckpt or show):
                continue
            self._sync()
            t = time.perf_counter()
            if show:
                split = ""
                bn_ms = self.bn_ms_per_step()
                if bn_ms is not None:
                    bn = min(100.0, 100.0 * bn_ms / ((t - tb) / (n - c0)
                                                     * 1e3))
                    split = f", air {100 - bn:.0f}% / bn {bn:.0f}%"
                print(f"--ENGINE(torch): {n}/{nt} [{100 * n / nt:.0f}%] "
                      f"{npts * (n - c0) / (t - tb) / 1e6:.1f} MVPS inst, "
                      f"{npts * (n - n0) / (t - t0 - t_out) / 1e6:.1f} "
                      f"MVPS avg{split}", flush=True)
            if on_chunk is not None:
                on_chunk(n, state)
            if ckpt:
                with spans.span("run.checkpoint"):
                    self.save_checkpoint(checkpoint_path, n, state, out, en)
            tb = time.perf_counter()
            t_out += tb - t
        self._sync()
        self.elapsed = time.perf_counter() - t0 - t_out
        with spans.span("run.receivers"):
            self.u_out = np.float64(out.T.cpu().numpy()) * d.infac
            if en is not None:   # energies scale back by infac**2
                e = lambda t: np.float64(t.cpu().numpy()) * d.infac ** 2
                self.H_tot, self.E_lost, self.E_in = (
                    e(en.H_rows), e(en.E_lost_rows), e(en.E_in_rows))
        self.mvps = npts * (nt - n0) / self.elapsed / 1e6
        if verbose:
            route = self.backend if self.TB is None else \
                f"{self.backend} TB={self.TB}"
            print(f"--ENGINE(torch): {nt - n0} steps over {npts / 1e6:.2f} "
                  f"Mvox on {self.device} ({route}) in {self.elapsed:.3f}s "
                  f"-> {self.mvps:.1f} MVPS")
        return self.u_out

    def energy_balance(self):
        """(H_tot + E_lost - E_in) in units of E_in's binary exponent, at
        the steps with input energy; the JAX engine's `energy_balance`.

        The rows are post-step accumulations, and H_tot[n] pairs with the
        pre-step ones (the oracle's indexing), hence the shift."""
        if not self.energy_on:
            raise ValueError("energy_balance needs TorchEngine(energy_on="
                             "True)")
        e_in = np.r_[0.0, self.E_in[:-1]]
        e_lost = np.r_[0.0, self.E_lost[:-1]]
        live = e_in > 0
        return rel_diff((self.H_tot + e_lost)[live], e_in[live])

    # ------------------------------------------------------- checkpointing
    def _scene_key(self) -> dict:
        """What a checkpoint must match to be resumed by this engine."""
        d = self.data
        g = d.grid
        return {"grid": np.array([g.Nx, g.Ny, g.Nz, g.fcc_flag], np.int64),
                "dtype": np.array(d.dtype.name),
                "route": np.array(self.backend if self.TB is None
                                  else f"tb{self.TB}"),
                "energy": np.array(bool(self.energy_on)),
                "fp32_eps": np.array(float(d.fp32_eps)),
                "counts": np.array([d.Nbl, d.in_ixyz.size, d.out_ixyz.size],
                                   np.int64)}

    def save_checkpoint(self, path, n, state, out, en=None):
        """Write the state after step n to `path` (.npz of named arrays):
        n, u_prev = u^{n-1}, u_curr = u^n (halos as they are: the flips
        are virtual), vh, gh, the receiver rows out[:n], with energy on
        Lu_prev = L u^{n-1} and the rows of H, E_lost and E_in, and the
        scene key.  Each tensor is copied to the host once; the file is
        written beside `path` and renamed over it, so a run killed while
        writing keeps its previous checkpoint."""
        host = lambda t: t.cpu().numpy()
        arrays = {"n": np.array(n, np.int64), "u_prev": host(state[0]),
                  "u_curr": host(state[1]), "vh": host(state[3]),
                  "gh": host(state[4]), "out": host(out[:n]),
                  **self._scene_key()}
        if en is not None:
            arrays.update(Lu_prev=host(en.Lu), H=host(en.H_rows[:n]),
                          E_lost=host(en.E_lost_rows[:n]),
                          E_in=host(en.E_in_rows[:n]))
        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    def load_checkpoint(self, path, state, out, en=None) -> int:
        """Fill `state`, the receiver rows of `out` (and the energy carry
        `en`) from a checkpoint of `save_checkpoint`; returns its step n.
        Refuses (ValueError) a checkpoint of another grid, dtype, route,
        energy setting, fp32_eps (the dtype's default where the file has
        none) or node/source/receiver count, or one past the rows of
        `out`."""
        # a checkpoint written before fp32_eps was part of the key holds
        # the dtype's default shift, the only one the engines had then
        default = {"fp32_eps": np.array(float(
            EngineData.default_fp32_eps(self.data.dtype)))}
        with np.load(path, allow_pickle=False) as z:
            for k, v in self._scene_key().items():
                got = z[k] if k in z.files else default.get(k, "missing")
                if not np.array_equal(got, v):
                    raise ValueError(
                        f"checkpoint {path}: {k} {got}, this engine has "
                        f"{v}: refusing to resume another scene or route")
            n = int(z["n"])
            if n > out.shape[0]:
                raise ValueError(f"checkpoint {path} is at step {n}, past "
                                 f"the {out.shape[0]} steps of this run")
            dev = lambda k: torch.from_numpy(z[k]).to(self.device)
            for i, k in ((0, "u_prev"), (1, "u_curr"), (3, "vh"), (4, "gh")):
                state[i].copy_(dev(k))
            out[:n] = dev("out")
            if en is not None:
                en.Lu.copy_(dev("Lu_prev"))
                for k in ("H", "E_lost", "E_in"):
                    getattr(en, k + "_rows")[:n] = dev(k)
                if n:
                    en.E_lost.copy_(en.E_lost_rows[n - 1])
                    en.E_in.copy_(en.E_in_rows[n - 1])
        return n

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
