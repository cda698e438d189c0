"""The x-slab multi-device engine: one process drives a list of devices.

Counterpart of the JAX package's x-slab engines, `ShardedEngine`
(pffdtd_tpu/parallel/sharded_engine.py:141-414), `ShardedPallasEngine` and
`ShardedPairEngine` (sharded_pallas.py:55-919), with the design of the
reference they stand for: one host process drives every GPU and exchanges
halo planes with per-step peer copies (gpu_engine.h:1086-1126).  Each
x-slab (`partition.py`) is a set of tensors on its own device; the halo
exchange is a `copy_` of edge planes between slab tensors.  The device
list may repeat a device: `["cuda:0"] * 4` runs four slabs on one card,
where the exchange is a copy on the card, and `["cuda:0", ..., "cuda:3"]`
one slab per card, where it is a peer copy, ordered by PyTorch against the
current streams of both cards.  No host sync sits inside the time loop.

Routes, as `TorchEngine`'s (`pick_route`):
- **step** (G = 1 ghost row a side).  Per step: copy one plane of u^n each
  way into the neighbours' ghost rows; per slab, read its owned receivers,
  run K5 (`stencil_step_shard`, K1 on the owned rows), K2 on its owned
  lossy nodes and add its owned sources (`index_add_`).
- **tb** / **pair** (G = TB).  Per sweep: copy TB planes of u^{n-1} and of
  u^n each way; per slab, one K6 sweep (`tb_sweep_shard`) that recomputes
  the ghost bands' points, lossy nodes and sources as its halo ring; then
  copy each ghost-band node's end-of-sweep branch states from its owner
  (`index_select`, `copy_`, `index_copy_`), the counterpart of the state
  grafts at sharded_pallas.py:611-652 and :777-800.  The nt % TB remaining
  steps run K5 + K2 on the same layout.
Lossy nodes on an ABC layer (an open room) take K2's and K6's ABC modes on
every route, their Q from the global grid (a slab without such a node
launches the kernels without the mode), as on `TorchEngine`.

`fp32_eps` is the stencil's diagonal shift, as on `TorchEngine`
(`EngineData`; the JAX `ShardedEngine`'s keyword).

Each receiver has one owner, which writes its samples into a per-slab
(nt, Nr_k) tensor; `run` gathers them into one (nt, Nr) tensor on
devices[0], the counterpart of the JAX engines' psum of masked taps.  On
CPU tensors (`devices=["cpu"] * D`) every wrapper runs its plain PyTorch
version, as the tests do; a `cuda` device without a card raises.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from pffdtd_tpu_torch.convert import slabs_to_global
from pffdtd_tpu_torch.engine.data import EngineData
from pffdtd_tpu_torch.engine.torch_engine import _TORCH_DTYPE, pick_route
from pffdtd_tpu_torch.io.simdata import MMb, SimData, read_sim_folder, \
    write_outputs
from pffdtd_tpu_torch.kernels.boundary import boundary_update, \
    boundary_update_plain
from pffdtd_tpu_torch.kernels.stencil import stencil_step_shard, \
    stencil_step_shard_plain
from pffdtd_tpu_torch.kernels.tb import TBScene, tb_sweep_shard, \
    tb_sweep_shard_plain
from pffdtd_tpu_torch.parallel.partition import grafts, partition, x_slabs
from pffdtd_tpu_torch.scene import pad_x_interior


def _devices(devices):
    """The device list; default one slab per visible card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("devices=None takes the cards, and "
                               "torch.cuda.is_available() is False; pass "
                               "devices=['cpu'] * D for the plain versions")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices: at least one")
    for d in devs:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {d}: torch.cuda.is_available() "
                                   "is False")
            if (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"device {d}: only "
                                 f"{torch.cuda.device_count()} cards")
        elif d.type != "cpu":
            raise ValueError(f"device {d}: cpu or cuda only")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


class _Slab:
    """One slab's device tensors."""

    def __init__(self, part, data, dev, TB):
        self.slab = part.slab
        self.dev = dev
        self.ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                    else contextlib.nullcontext())

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.part = part
        self.adj = up(part.adj)
        self.bnl = up(part.bnl)
        self.ssaf = up(data.ssaf_bnl[part.nodes])
        self.mat = up(data.mat_bnl[part.nodes])
        self.coef_table = up(data.coef_table)
        self.beta = up(data.beta)
        # Q of the slab's lossy nodes on an ABC layer, from the global grid
        # (the x faces are the global edge rows), or None when it has none
        q = None if data.abcq_bnl is None else data.abcq_bnl[part.nodes]
        self.abcq = up(q) if q is not None and q.any() else None
        self.src_own = up(part.src_loc[part.src_own])
        self.rcv = up(part.rcv_loc)
        self.tb_scene = None
        if TB is not None:
            self.tb_scene = TBScene.make_slab(
                part.slab, data.sc, TB, data.dtype.itemsize, adj=self.adj,
                bnl=self.bnl, ssaf=self.ssaf, mat=self.mat,
                coef_table=self.coef_table, beta=self.beta,
                in_ixyz=up(part.src_loc), out_ixyz_f=self.rcv,
                abcq=self.abcq)


class ShardedTorchEngine:
    """x-slab engine over a list of devices (one process)."""

    def __init__(self, folder=None, *, consts=None, vox=None, comms=None,
                 mats=None, devices=None, dtype=np.float32,
                 backend: str = "auto", tb: int = 3,
                 use_kernels: bool = True, fp32_eps: float | None = None):
        if folder is not None:
            sim = read_sim_folder(folder)
            consts, vox, comms, mats = sim.consts, sim.vox, sim.comms, \
                sim.mats
        self._folder = folder
        self.devices = _devices(devices)
        self.D = D = len(self.devices)
        self.data = d = EngineData(consts, vox, comms, mats, dtype=dtype,
                                   fp32_eps=fp32_eps)
        self.dtype = _TORCH_DTYPE[d.dtype]
        self.Nt = d.Nt
        self.use_kernels = use_kernels
        self.backend, self.TB = pick_route(backend, tb)
        G = self.TB or 1
        self.slabs = x_slabs(d.grid, D, G)
        self.S = S = self.slabs[0].S
        if S < 2 * G:
            raise ValueError(f"{D} slabs of {S} rows: the {self.backend} "
                             f"route needs >= {2 * G} rows a slab")
        parts = partition(d, self.slabs)
        self.shards = [_Slab(p, d, dev, self.TB)
                       for p, dev in zip(parts, self.devices)]
        # (owner, recomputing slab, owner's slots, recomputing slab's slots)
        self.grafts = [
            (gr.src, gr.dst,
             torch.from_numpy(gr.src_slots).to(self.devices[gr.src]),
             torch.from_numpy(gr.dst_slots).to(self.devices[gr.dst]))
            for gr in (grafts(parts) if self.TB else [])]
        # the cards of the device list, each once, in order
        self.cards = list(dict.fromkeys(d for d in self.devices
                                        if d.type == "cuda"))
        self._events = None       # CUDA events around the exchanges
        self.exchange_ms = None
        self.exchange_ms_by_card = None

    # -------------------------------------------------------------- state
    def init_state(self):
        """Per slab [u0, u1, u2, b] of zeros: u0 = u^{n-1}, u1 = u^n, u2 the
        output scratch, b the (2, MMb, n) branch states (b[0] = vh, b[1] =
        gh: one copy carries both in a graft)."""
        return [[self._zeros(sh, *sh.slab.shape) for _ in range(3)]
                + [self._zeros(sh, 2, MMb, sh.bnl.numel())]
                for sh in self.shards]

    def _zeros(self, sh, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=sh.dev)

    def _exchange(self, states, fields, w):
        """Copy w planes of each state field in `fields` each way: a slab's
        ghost rows take its neighbours' owned edge rows."""
        G, S = self.slabs[0].G, self.S
        for left, right in zip(states, states[1:]):
            for f in fields:
                left[f][G + S:G + S + w].copy_(right[f][G:G + w])
                right[f][G - w:G].copy_(left[f][G + S - w:G + S])

    def _record(self):
        """A CUDA event on each card's current stream."""
        es = []
        for dev in self.cards:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(dev))
            es.append(e)
        return es

    def _exchange_timed(self, states, fields, w):
        if self._events is None:
            return self._exchange(states, fields, w)
        e0 = self._record()
        self._exchange(states, fields, w)
        self._events.append((e0, self._record()))

    def step(self, states, sigs, outs, n):
        """Advance every slab by one step (in place, buffers rotate).

        sigs: per slab (owned, recomputed) source samples, each (nt, ns);
        outs: per slab (nt, Nr_k) receiver rows, of which row n is
        written."""
        d = self.data
        self._exchange_timed(states, (1,), 1)
        k5 = stencil_step_shard if self.use_kernels \
            else stencil_step_shard_plain
        k2 = boundary_update if self.use_kernels else boundary_update_plain
        for sh, st, sig, out in zip(self.shards, states, sigs, outs):
            u0, u1, u2, b = st
            with sh.ctx:
                torch.index_select(u1.view(-1), 0, sh.rcv, out=out[n])
                k5(u0, u1, sh.adj, u2, sh.slab, d.sc)
                if sh.bnl.numel():
                    k2(u2, u0, sh.bnl, sh.ssaf, sh.mat, sh.coef_table,
                       sh.beta, b[0], b[1], d.sc, sh.abcq)
                u2.view(-1).index_add_(0, sh.src_own, sig[0][n])
            st[:3] = [u1, u2, u0]
        return states

    def sweep(self, states, spares, sigs, outs, n):
        """Advance every slab by TB steps with one K6 sweep each, then copy
        every ghost-band node's end-of-sweep branch states from its owner.

        spares: per slab [a fourth grid, (2, MMb, n) states] that the sweep
        writes and swaps with the state's; outs: rows n .. n+TB-1 are
        written."""
        TB = self.TB
        self._exchange_timed(states, (0, 1), TB)
        k6 = tb_sweep_shard if self.use_kernels else tb_sweep_shard_plain
        for sh, st, sp, sig, out in zip(self.shards, states, spares, sigs,
                                        outs):
            u0, u1, u2, b = st
            u3, b2 = sp
            with sh.ctx:
                torch.index_select(u1.view(-1), 0, sh.rcv, out=out[n])
                k6(sh.tb_scene, u0, u1, u2, u3, b[0], b[1], b2[0], b2[1],
                   sig[1][n:n + TB],
                   out[n + 1:n + TB - 1] if TB > 2 else None)
                torch.index_select(u2.view(-1), 0, sh.rcv,
                                   out=out[n + TB - 1])
            st[:] = [u2, u3, u0, b2]
            sp[:] = [u1, b]
        for src, dst, src_slots, dst_slots in self.grafts:
            b_src, b_dst = states[src][3], states[dst][3]
            vals = torch.index_select(b_src, 2, src_slots)
            b_dst.index_copy_(2, dst_slots, vals.to(b_dst.device))
        return states

    # ---------------------------------------------------------------- run
    def _sync(self):
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def run(self, nt: int | None = None, verbose: bool = True,
            time_exchange: bool = False):
        """Run nt steps (default Nt) from the zero state; returns u_out
        (Nr, nt) float64, scaled back by infac.  The final per-slab states
        stay in `self.states` (`global_state` assembles them).

        time_exchange (on cards): a CUDA event on each card's current
        stream before and after every exchange.  PyTorch runs a copy
        between cards on the source card's stream, behind a wait for the
        destination's stream, and makes the destination's stream wait for
        it; so on each card the span between the two events is what the
        exchange holds that card up: the copies it sends and receives and
        its waits for the neighbours' planes (their earlier work, and the
        host's issue where it lags).  `exchange_ms_by_card` is each card's
        total over the run ({} without a card), `exchange_ms` the largest
        of them (None without a card).  With every slab on one card, that
        card's span is the copies alone."""
        d = self.data
        g = d.grid
        npts = g.Nx * g.Ny * g.Nz
        nt = self.Nt if nt is None else nt
        sig_all = (d.in_sigs[:, :nt] / d.infac).T.astype(d.dtype)  # (nt, Ns)
        self.states = None      # the last run's fields go before new ones
        sigs, outs = [], []
        for sh in self.shards:
            p = sh.part

            def up(a, dev=sh.dev):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            sigs.append((up(sig_all[:, p.srcs[p.src_own]]),
                         up(sig_all[:, p.srcs])))
            outs.append(torch.zeros((nt, p.rcvs.size), dtype=self.dtype,
                                    device=sh.dev))
        states = self.init_state()
        TB = self.TB or 1
        spares = None
        if TB > 1:   # each sweep's fourth grid and second branch states
            spares = [[self._zeros(sh, *sh.slab.shape),
                       self._zeros(sh, 2, MMb, sh.bnl.numel())]
                      for sh in self.shards]
        timed = time_exchange and bool(self.cards)
        self._events = [] if timed else None
        self._sync()
        t0 = time.perf_counter()
        n = 0
        while n < nt:
            k = TB if n + TB <= nt else 1
            if k > 1:
                self.sweep(states, spares, sigs, outs, n)
            else:
                self.step(states, sigs, outs, n)
            n += k
        self._sync()
        self.elapsed = time.perf_counter() - t0
        self.exchange_ms_by_card = {
            str(dev): sum(e0[k].elapsed_time(e1[k])
                          for e0, e1 in self._events)
            for k, dev in enumerate(self.cards)} if timed else {}
        self.exchange_ms = max(self.exchange_ms_by_card.values(),
                               default=None)
        self._events = None
        self.states = states
        out = torch.zeros((nt, d.out_ixyz.size), dtype=self.dtype,
                          device=self.devices[0])
        for sh, o in zip(self.shards, outs):
            out[:, torch.from_numpy(sh.part.rcvs).to(out.device)] = \
                o.to(out.device)
        self.u_out = np.float64(out.T.cpu().numpy()) * d.infac
        self.mvps = npts * nt / self.elapsed / 1e6
        if verbose:
            route = self.backend if self.TB is None else \
                f"{self.backend} TB={self.TB}"
            where = sorted({str(dv) for dv in self.devices})
            print(f"--ENGINE(torch x{self.D}): {nt} steps over "
                  f"{npts / 1e6:.2f} Mvox in {self.D} slabs of {self.S} rows"
                  f" on {', '.join(where)} ({route}) in {self.elapsed:.3f}s"
                  f" -> {self.mvps:.1f} MVPS")
        return self.u_out

    def global_state(self):
        """The final state on the global grid as numpy: (u0, u1) (Nx, Ny,
        Nz) = u^{nt-1}, u^nt and (vh, gh) (MMb, Nbl), from the owned rows
        and nodes (the halo rows from the edge slabs)."""
        u0, u1 = (slabs_to_global([st[f] for st in self.states], self.slabs)
                  for f in (0, 1))
        vh = np.zeros((MMb, self.data.Nbl), self.data.dtype)
        gh = vh.copy()
        for sh, st in zip(self.shards, self.states):
            own = sh.part.node_own
            b = st[3].cpu().numpy()
            vh[:, sh.part.nodes[own]] = b[0][:, own]
            gh[:, sh.part.nodes[own]] = b[1][:, own]
        return u0, u1, vh, gh

    def save_outputs(self, folder=None):
        write_outputs(folder or self._folder, self.u_out,
                      self.data.out_reorder)


def make_sharded_engine(folder=None, *, consts=None, vox=None, comms=None,
                        mats=None, devices=None, dtype=np.float32,
                        backend: str = "auto", tb: int = 3,
                        use_kernels: bool = True,
                        fp32_eps: float | None = None) -> ShardedTorchEngine:
    """A `ShardedTorchEngine` over `devices`, the grid first padded with
    exterior air so its interior rows split evenly (`pad_x_interior`); the
    counterpart of sharded_pallas.py:922-959 `make_sharded_engine`.

    backend="auto" takes the single-step route, the measured rule of
    `TorchEngine.pick_route` on the H100, where K3 (and so K6) is slower
    per step than K1 + K2.  The JAX rule prefers the pair engine, because
    on the TPU two steps per sweep halve the bytes of the device memory and
    of the chip links; here the sweep's shared-memory stencil and its
    latency chains, not its bytes, set its time (PERF.md)."""
    if folder is not None:
        sim = read_sim_folder(folder)
    else:
        sim = SimData(consts=consts, vox=vox, comms=comms, mats=mats)
    devs = _devices(devices)
    sim = pad_x_interior(sim, len(devs))
    eng = ShardedTorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                             mats=sim.mats, devices=devs, dtype=dtype,
                             backend=backend, tb=tb, use_kernels=use_kernels,
                             fp32_eps=fp32_eps)
    eng._folder = folder
    return eng
