"""The system under test: the port's public set-up and engine, driven as
`cli sim` drives them.

Only this module imports the program (`pffdtd_tpu_torch`), and it does so
inside its functions, so that the harness's other modules, the reference
and the tests import without it."""

from __future__ import annotations

from dataclasses import replace

import numpy as np


def request(cfg: dict, traffic: dict, seed: int):
    """The request a seed draws: a source within `source_jitter_m` of
    `source_at` (fractions of the room's sides) on every axis, and
    `receivers` positions at least `wall_margin_m` from every wall.  Every
    seed gives the same grid and the same steps; the source stays near
    `source_at`, where the port's synthetic box puts its source."""
    rng = np.random.default_rng(seed)
    L = np.array([cfg["room"][k] for k in ("Lx", "Ly", "Lz")], float)
    j = float(traffic["source_jitter_m"])
    src = np.asarray(traffic["source_at"], float) * L + rng.uniform(-j, j, 3)
    m = float(traffic["wall_margin_m"])
    rx = rng.uniform(m, L - m, size=(int(traffic["receivers"]), 3))
    return src, rx


def scene(cfg: dict, traffic: dict, src, rx):
    """The port's sim data for the request: the analytic box, the request's
    source and receivers, rotated by the configuration's rule, folded on
    FCC, sorted (`prep --rotate --fold --sort`)."""
    from pffdtd_tpu_torch.comms import SimComms
    from pffdtd_tpu_torch.scene import (fold_fcc_sim, rotate_sim, sort_sim,
                                        synthetic_box_sim)
    from rirbench.spec import spacing
    fcc = cfg["grid"] == "fcc"
    r = cfg["room"]
    dur = float(traffic["sim_seconds"])
    sim = synthetic_box_sim(r["Lx"], r["Ly"], r["Lz"], h=spacing(cfg),
                            duration=dur, fcc=fcc, lossy=True, Tc=cfg["Tc"],
                            rh=cfg["rh"], insig_type=traffic["signal"],
                            diff_source=traffic["diff_source"],
                            DEF=np.asarray(cfg["material_DEF"], float))
    c = sim.consts
    comms = SimComms(sim.vox.xv, sim.vox.yv, sim.vox.zv, c.h, c.Ts, c.l2,
                     fcc=fcc)
    comms.prepare_source_pts(src)
    comms.prepare_receiver_pts(rx)
    comms.prepare_source_signals(dur, sig_type=traffic["signal"])
    if traffic["diff_source"]:
        comms.diff_source()
    sim = rotate_sim(replace(sim, comms=comms.to_comms_data()),
                     orient=cfg["orient"])
    if fcc:
        sim = fold_fcc_sim(sim)
    return sort_sim(sim)


def engine(cfg: dict, traffic: dict, sim, device):
    """The engine on the traffic's route, in the configuration's
    precision."""
    from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=np.dtype(cfg["precision"]),
                       device=device, backend=traffic["route"],
                       tb=int(traffic.get("tb", 3)),
                       fp32_eps=cfg.get("fp32_eps"))


def receivers(sim, u_out):
    """The receivers' signals (Nr, nt) as a user gets them: the taps put
    back in the request's order and weighted by their trilinear
    weights."""
    c = sim.comms
    taps = u_out[np.asarray(c.out_reorder)]
    nr = c.out_alpha.shape[0]
    return np.einsum("rk,rkn->rn", c.out_alpha,
                     taps.reshape(nr, 8, taps.shape[1]))


def k1_adj_bytes(eng) -> int:
    """Bytes of the adjacency that one K1 call must read on the engine's
    route, each read once.  On the step route K1 reads the compact form
    (`eng.adj`, `CompactAdj`) of the rows it steps, x and y off the
    halo: their mask words, the word base of each non-zero word, the row
    base of each row that holds one, and the legs of each flagged point.
    Elsewhere it reads the packed grid: a value an interior point."""
    import torch
    a = eng.adj
    if isinstance(a, torch.Tensor):
        nx, ny, nz = a.shape
        return (nx - 2) * (ny - 2) * (nz - 2) * a.element_size()
    mask = a.mask[1:-1, 1:-1]
    rows = int((mask != 0).any(dim=2).sum())
    return (mask.numel() * mask.element_size()
            + a.words * a.base.element_size()
            + rows * a.rows.element_size()
            + a.flagged * a.legs.element_size())


def _wrappers() -> dict:
    """The port's kernel wrappers by name; each counts its launches."""
    from pffdtd_tpu_torch.kernels.boundary import boundary_update
    from pffdtd_tpu_torch.kernels.stencil import stencil_step
    from pffdtd_tpu_torch.kernels.tb import tb_sweep
    return {"K1": stencil_step, "K2": boundary_update, "K3": tb_sweep}


def reset_launches():
    for w in _wrappers().values():
        w.launches = 0


def launches() -> dict:
    """The kernels launched since `reset_launches`, by name."""
    return {k: w.launches for k, w in _wrappers().items()}
