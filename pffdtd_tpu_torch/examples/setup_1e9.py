"""A billion-voxel room set up and run on the card (the counterpart of
examples/setup_1e9.py).

The real pipeline at >= 10^9 grid points: RoomGeo (a 32 x 25 x 20 m box,
one material) -> CartGrid at h = 0.025 m, nudged by 0.9995 until Nx % 8
== 0 (1288 x 1008 x 808 = 1.049 Gvox) -> the native voxelizer's calc_adj
-> check_adj_full -> the clash check, each stage timed, with the process's
peak RSS.  Then the routes, fp32 by default, each engine freed before the
next is built:
- step: `TorchEngine`, K1 + K2 a step;
- tb: `TorchEngine(backend="tb", tb=3)`, a K3 sweep every 3 steps;
- x4: `ShardedTorchEngine`, four x-slabs after `scene.pad_x_interior`
  (K5 + K2 a step), on the one card or on `--devices`;
- energy (asked for by name, after the others, on their setup):
  `TorchEngine(energy_on=True)` in fp64 whatever the other routes' dtype,
  K1e + K2 + K7's boundary pass a step, one run; the fp64 energy balance
  must stay below 1e-9.
The original voxelizes, then runs 2 steps on an 8-device CPU mesh.  Its
duration of 1 ms is 24 steps, too few for the direct sound to reach the
receiver 8.77 m from the source (c Ts = h / sqrt(3) = 0.0144 m a step:
about 608 steps); this runs 30 ms (715 steps at full size).

Printed per route: the host seconds of the engine build, MVPS and ms a
step over the time loop (host clock, ending in a synchronize; the best of
two runs, each run's seconds beside it), the peak device memory and the
kernel launches; then the receivers of each route against the first's,
which must agree within 1e-5 of max |u_out| (the energy route, in fp64,
bitwise when the others are fp64 too, else its difference is printed), and
u_out must be finite; for the energy route its balance and the device
memory its arrays take by count.  `--check` also holds K1 and K2 (step),
K3 (tb) and K5 (x4) against their plain versions, one call each from a
seeded random state, where the plain version's temporaries fit the
device's free memory (the energy route's plain passes never do at full
size, and are not run).  The last line is a JSON record of it all.

    python -m pffdtd_tpu_torch.examples.setup_1e9 [--quick] [--h H]
        [--steps N] [--routes step,tb,x4[,energy]] [--f64] [--check]
        [--device cuda|cpu] [--devices cuda:0,cuda:1,...]

`--quick` takes h = 0.055 (592 x 464 x 373 = 0.102 Gvox); `--h` sets h.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import time

import numpy as np
import torch

from pffdtd_tpu_torch import spans
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples import check_device
from pffdtd_tpu_torch.geometry.room import RoomGeo
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels import WRAPPERS, _build
from pffdtd_tpu_torch.kernels.boundary import boundary_update, \
    boundary_update_plain
from pffdtd_tpu_torch.kernels.energy import scratch_size
from pffdtd_tpu_torch.kernels.stencil import (stencil_step,
                                              stencil_step_plain,
                                              stencil_step_shard,
                                              stencil_step_shard_plain)
from pffdtd_tpu_torch.kernels.stream import time_ms
from pffdtd_tpu_torch.kernels.tb import tb_sweep, tb_sweep_plain
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.scene import mats_from_DEF_list
from pffdtd_tpu_torch.scene_setup import sim_setup_from_room
from pffdtd_tpu_torch.voxelizer import native
from pffdtd_tpu_torch.voxelizer.grid import CartGrid

L = (32.0, 25.0, 20.0)
SXYZ = (12.0, 11.0, 9.0)
RXYZ = (20.0, 14.0, 11.0)
DEF = ((2.0, 5.0, 30.0),)
H, H_QUICK = 0.025, 0.055
DURATION = 0.03
ROUTES = ("step", "tb", "x4", "energy")
DEFAULT_ROUTES = ("step", "tb", "x4")
SLABS = 4
REPS = 2            # runs a route, the best timed: the first may meet a
                    # card clocked down through the host setup
TOL = 1e-5          # receivers between routes, of max |u_out|
BALANCE = 1e-9      # the fp64 energy balance, the JAX package's bar for a
                    # real room
SEED = 0
# fp32 bars of one call against the plain version (chip_smoke.py phase 2)
CHECK_TOL = {"K1": 1e-6, "K2": 1e-6, "K3": 1e-5, "K5": 1e-6}
# device memory a check takes, in grids (slabs for K5) of the working
# dtype, beyond the engine's adjacency: the random fields, both outputs and
# the plain version's temporaries (`stencil_rows_plain`: the mirrored
# copy, the int32 adjacency, a leg's shifted, masked and summed terms;
# `tb_sweep_plain` adds its scratch grid)
# (K2: the two random fields, a copy and the gathers); each holds the
# peak measured at 1.049 Gvox on the card: 12.0, 4.4, 15.4 and 11.9 grids
CHECK_GRIDS = {"K1": 13, "K2": 5, "K3": 16, "K5": 13}
TIME_REPS = 10

# sim_setup_from_room's stages: label -> the spans it adds up
STAGES = {
    "voxelize": ("vox.adj",),
    "of which native": ("vox.native",),
    "of which symmetrize": ("vox.symmetrize",),
    "of which materials + SAF": ("vox.materials",),
    "check_adj_full": ("vox.check_adj_full",),
    "comms": ("comms.prepare", "comms.diff_source"),
    "of which diff_source": ("comms.diff_source",),
    "clash check": ("comms.clash_check",),
}


def stage_seconds(since_ns: int, total: float) -> dict:
    """Host seconds of each of STAGES, from the program's spans that
    started at or after `since_ns` (`time.perf_counter_ns`), "rest" (the
    `total` seconds outside every span not nested in another) and
    "total"."""
    recs = spans.records(since_ns)
    s = {label: sum(r.seconds for r in recs if r.name in names)
         for label, names in STAGES.items()}
    rest = total - sum(r.seconds for r in recs if r.parent is None)
    return {**s, "rest": rest, "total": total}


def peak_rss_gb():
    """The process's peak resident set in GB (Linux reports KiB).  A
    process keeps the peak of the one that started it across exec, so a
    subprocess reads at least its parent's RSS at the start."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def box_room() -> RoomGeo:
    """The 32 x 25 x 20 m box, every face of material 0, one source and
    one receiver."""
    Lx, Ly, Lz = L
    v = np.array([[0, 0, 0], [Lx, 0, 0], [0, Ly, 0], [Lx, Ly, 0],
                  [0, 0, Lz], [Lx, 0, Lz], [0, Ly, Lz], [Lx, Ly, Lz]], float)
    tris = np.array([(0, 4, 6), (0, 6, 2), (1, 3, 7), (1, 7, 5),
                     (0, 1, 5), (0, 5, 4), (2, 6, 7), (2, 7, 3),
                     (0, 2, 3), (0, 3, 1), (4, 5, 7), (4, 7, 6)])
    return RoomGeo.from_arrays(v, tris, np.zeros(12, np.int8),
                               np.ones(12, np.int8), ["walls"], [SXYZ],
                               [RXYZ])


def nudge_h(h, rg, mult=8):
    """h scaled by 0.9995 until the grid's Nx is a multiple of `mult`, at
    most 64 times (a change under 3.2%, inside the PPW tolerance; the
    original's rule for its 8-device mesh)."""
    for _ in range(64):
        if CartGrid(h=h, offset=3.5, bmin=rg.bmin, bmax=rg.bmax).Nx \
                % mult == 0:
            break
        h *= 0.9995
    return h


def setup(h):
    """`sim_setup_from_room` of the box with the native voxelizer and
    check_adj_full, in memory; returns (sim, host seconds per stage: the
    g++ build, then `stage_seconds`)."""
    rg = box_room()
    mats = mats_from_DEF_list([np.array(DEF)])
    t0 = time.perf_counter()
    native.load()
    t_build = time.perf_counter() - t0
    since = time.perf_counter_ns()
    t0 = time.perf_counter()
    sim = sim_setup_from_room(rg, mats, duration=DURATION,
                              insig_type="impulse", h=h, check_adj=True,
                              vox_backend="native")
    total = time.perf_counter() - t0
    return sim, {"g++ build": t_build, **stage_seconds(since, total)}


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches():
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def build_engine(sim, route, dtype, devices):
    """The engine of `route` on `devices`: TorchEngine on the one device
    for step, tb and energy (fp64 whatever `dtype`), the x-slab engine
    over the SLABS devices for x4."""
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms, mats=sim.mats,
              dtype=dtype)
    if route == "x4":
        return make_sharded_engine(**kw, devices=devices, backend="step")
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    if route == "energy":
        kw.update(dtype=np.float64, energy_on=True)
    return TorchEngine(**kw, device=devices[0],
                       **({"backend": "tb", "tb": 3} if route == "tb" else {}))


def energy_gb(eng):
    """GB of device memory the energy route's arrays take by count: four
    fields (u^{n-1}, u^n, u^{n+1}, L u), the adjacency, four branch-state
    arrays (vh, gh and their copies before the step) and K7's scratch."""
    d = eng.data
    g, isz = d.grid, d.dtype.itemsize
    npts = g.Nx * g.Ny * g.Nz
    return (4 * npts * isz + npts * eng.adj.element_size()
            + 4 * MMb * d.Nbl * isz + 8 * scratch_size(g, d.Nbl)) / 1e9


def run_route(sim, route, nt, dtype=np.float32, device="cuda", devices=None,
              check=False):
    """Build the route's engine (x4 over `devices`, default SLABS x
    `device`), run nt steps from zero REPS times (the energy route once;
    the launches counted over the last run alone), optionally check its
    kernels (`check_kernels`; not on the energy route), free it.

    Returns (u_out, record): the grid, Nbl, the build's seconds, the best
    and every run's loop seconds, MVPS and ms a step of the best, the
    peak device memory in GB, the largest of the cards' (None on the CPU)
    and each card's, the launches, max |u_out|,
    the checks, the seconds of it all (host clock) and, on the energy
    route, the balance, E_lost[-1] and the reckoned memory (`energy_gb`);
    raises where the balance is not below BALANCE."""
    t_all = time.perf_counter()
    devs = (devices or [device] * SLABS) if route == "x4" else [device]
    cards = sorted({d for d in map(torch.device, devs) if d.type == "cuda"},
                   key=str)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    eng = build_engine(sim, route, dtype, devs)
    for d in cards:
        torch.cuda.synchronize(d)
    t_build = time.perf_counter() - t0
    runs = []
    for _ in range(1 if route == "energy" else REPS):
        _drop_fields(eng)
        reset_launches()
        u = eng.run(nt=nt, verbose=False)
        runs.append(eng.elapsed)
    count = launches()
    by_card = {str(d): torch.cuda.max_memory_allocated(d) / 1e9
               for d in cards}
    peak = max(by_card.values()) if cards else None
    g = eng.data.grid
    best = min(runs)
    rec = {"grid": list(g.shape), "Nbl": eng.data.Nbl, "build_s": t_build,
           "seconds": best, "runs_s": runs,
           "mvps": g.Nx * g.Ny * g.Nz * nt / best / 1e6,
           "ms_step": 1e3 * best / nt, "peak_gb": peak,
           "peak_gb_by_device": by_card, "launches": count,
           "max_abs_u": float(np.abs(u).max())}
    if route == "energy":
        rec.update(balance=float(np.abs(eng.energy_balance()).max()),
                   E_lost=float(eng.E_lost[-1]), reckoned_gb=energy_gb(eng))
    if check:
        rec["checks"] = {} if route == "energy" else check_kernels(eng,
                                                                   route)
    del eng
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    rec["route_s"] = time.perf_counter() - t_all
    if route == "energy" and not rec["balance"] < BALANCE:
        raise AssertionError(f"energy route: balance {rec['balance']}, "
                             f"not below {BALANCE}")
    return u, rec


def _drop_fields(eng):
    """Free the fields an engine keeps from its last run (`state` of
    TorchEngine, `states` of the x-slab engine), so a new run or a check
    does not hold them beside its own."""
    eng.state = eng.states = None
    gc.collect()


def _rel(a, b, rows=64):
    """max |a - b| / max |b|, over blocks of `rows` leading rows (a
    full-grid difference would take two more grids)."""
    d = s = 0.0
    for i in range(0, a.shape[0], rows):
        d = max(d, float((a[i:i + rows] - b[i:i + rows]).abs().max()))
        s = max(s, float(b[i:i + rows].abs().max()))
    return d / s if s > 0 else d


def check_kernels(eng, route):
    """One call of each kernel of the route against its plain version from
    a seeded random state, after freeing the run's fields; on the card the
    kernel is then timed over TIME_REPS calls and the plain version over
    one (CUDA events, after a warm-up call each).  Returns {kernel:
    {max_rel_err, peak_gb (the check's own), need_gb, ms, plain_ms}} (no
    memory or times on the CPU), or {compared: False, need_gb, free_gb}
    where the check would not fit the device's free memory; raises where a
    kernel disagrees."""
    _drop_fields(eng)
    dev = eng.shards[1].dev if route == "x4" else eng.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = eng.data
    r = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=eng.dtype)
    if route == "step":
        todo = [("K1", d.grid.shape, lambda: _k1(eng, r)),
                ("K2", d.grid.shape, lambda: _k2(eng, r))]
    elif route == "tb":
        todo = [("K3", d.grid.shape, lambda: _k3(eng, r))]
    else:
        sh = eng.shards[1]
        todo = [("K5", sh.slab.shape, lambda: _k5(eng, sh, r))]
    out = {}
    for name, shape, make in todo:
        need = (CHECK_GRIDS[name] * float(np.prod(shape))
                * torch.empty((), dtype=eng.dtype).element_size() / 1e9)
        base = 0
        if cuda:
            free = torch.cuda.mem_get_info(dev)[0] / 1e9
            if need > free:
                out[name] = {"compared": False, "need_gb": need,
                             "free_gb": free}
                continue
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        pairs, kernel, plain = make()
        err = max(_rel(a, b) for a, b in pairs)
        out[name] = {"max_rel_err": err, "need_gb": need,
                     "bytes_gb": kernel_bytes(eng, name) / 1e9}
        if cuda:
            out[name]["peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                    - base) / 1e9
            with torch.cuda.device(dev):
                out[name]["ms"] = time_ms(kernel, TIME_REPS)
                out[name]["plain_ms"] = time_ms(plain, 1)
        del pairs, kernel, plain
        if cuda:
            torch.cuda.empty_cache()
        if not err <= CHECK_TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the {route} route: {err}")
    return out


def kernel_bytes(eng, name):
    """Bytes one call of the kernel must move on this engine's scene, each
    input read once and each output written once (chip_smoke.py's count):
    K1 the interior's u0, u1, adj and output; K2 per lossy node its branch
    states in and out, index, ssaf, material and three field values; K3
    (a sweep) four fields and adj over the interior, the states of every
    node and the tile lists; K5 as K1 on one slab's owned rows."""
    d = eng.data
    isz = d.dtype.itemsize
    if name == "K5":
        sh = eng.shards[1]
        sl = sh.slab
        return (sl.S * (sl.shape[1] - 2) * (sl.shape[2] - 2)
                * (3 * isz + sh.adj.element_size()))
    ni, asz = d.grid.n_interior, eng.adj.element_size()
    if name == "K1":
        return ni * (3 * isz + asz)
    if name == "K2":
        return d.Nbl * (4 * MMb * isz + 8 + isz + 4 + 3 * isz)
    tl = eng.tb_scene.lists
    return (ni * (4 * isz + asz) + d.Nbl * (4 * MMb * isz + isz + 4)
            + 4 * (tl.rptr.size + 3 * tl.node.size))


# each of these returns ([(kernel's output, plain version's)], a call of
# the kernel, a call of the plain version), both on the same buffers
def _k1(eng, r):
    """K1 and its plain version on the same random fields: interiors."""
    g, sc, adj = eng.data.grid, eng.data.sc, eng.adj
    u0, u1 = r(*g.shape), r(*g.shape)
    ok, op = torch.empty_like(u0), torch.empty_like(u0)
    kernel = lambda: stencil_step(u0, u1, adj, ok, g, sc)
    plain = lambda: stencil_step_plain(u0, u1, adj, op, g, sc)
    kernel(), plain()
    inner = (slice(1, -1),) * 3
    return [(ok[inner], op[inner])], kernel, plain


def _k2(eng, r):
    """K2 and its plain version from the same random fields and branch
    states: the updated nodes, vh and gh."""
    d = eng.data
    u0, unew = r(*d.grid.shape), r(*d.grid.shape)
    vh, gh = r(MMb, d.Nbl), r(MMb, d.Nbl)
    args = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    res = []
    for fn in (boundary_update, boundary_update_plain):
        un, v, gg = unew.clone(), vh.clone(), gh.clone()
        fn(un, u0, *args, v, gg, d.sc)
        res.append((un.view(-1)[eng.bnl], v, gg))
    del un
    v, gg = vh.clone(), gh.clone()
    call = lambda fn: lambda: fn(unew, u0, *args, v, gg, d.sc)
    return (list(zip(*res)), call(boundary_update),
            call(boundary_update_plain))


def _k3(eng, r):
    """One K3 sweep and tb_sweep_plain from the same random state: both
    output fields' interiors, vh, gh and the in-sweep taps."""
    st, d, TB = eng.tb_scene, eng.data, eng.TB
    u0, u1 = r(*d.grid.shape), r(*d.grid.shape)
    vh, gh = r(MMb, d.Nbl), r(MMb, d.Nbl)
    sig = r(TB, d.in_ixyz.size)
    inner = (slice(1, -1),) * 3
    res, calls = [], []
    for fn in (tb_sweep, tb_sweep_plain):
        o = [torch.empty_like(u0) for _ in range(2)]
        s = [torch.empty_like(vh) for _ in range(2)]
        taps = torch.zeros((TB - 2, d.out_ixyz.size), dtype=u0.dtype,
                           device=u0.device)
        calls.append(lambda fn=fn, o=o, s=s, taps=taps: fn(
            st, u0, u1, *o, vh, gh, *s, sig, taps))
        calls[-1]()
        res.append((o[0][inner], o[1][inner], *s, taps))
    return list(zip(*res)), *calls


def _k5(eng, sh, r):
    """K5 and its plain version on slab `sh` from the same random fields:
    the owned rows."""
    sl, sc, adj = sh.slab, eng.data.sc, sh.adj
    u0, u1 = r(*sl.shape), r(*sl.shape)
    ok, op = torch.empty_like(u0), torch.empty_like(u0)
    kernel = lambda: stencil_step_shard(u0, u1, adj, ok, sl, sc)
    plain = lambda: stencil_step_shard_plain(u0, u1, adj, op, sl, sc)
    kernel(), plain()
    own = (slice(*sl.owned), slice(1, -1), slice(1, -1))
    return [(ok[own], op[own])], kernel, plain


def compare_routes(outs):
    """{route: max |u - u_first| / max |u_first|} against the first route
    of `outs` ({route: u_out}); raises where u_out is not finite or a
    route disagrees beyond TOL."""
    for route, u in outs.items():
        if not np.isfinite(u).all():
            raise FloatingPointError(f"{route}: u_out is not finite")
    first, ref = next(iter(outs.items()))
    scale = np.abs(ref).max()
    errs = {}
    for route, u in outs.items():
        d = np.abs(u - ref).max()
        errs[route] = float(d / scale if scale > 0 else d)
        if not errs[route] <= TOL:
            raise AssertionError(f"{route} receivers vs {first}: "
                                 f"{errs[route]} of max |u_out| {scale}")
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"h = {H_QUICK} (0.102 Gvox) instead of {H}")
    ap.add_argument("--h", type=float, default=None, help="grid spacing (m)")
    ap.add_argument("--steps", type=int, default=None,
                    help=f"steps a route (default all of {DURATION} s)")
    ap.add_argument("--routes", default=",".join(DEFAULT_ROUTES),
                    help=f"comma-separated, of {', '.join(ROUTES)}")
    ap.add_argument("--f64", action="store_true", help="float64 fields")
    ap.add_argument("--check", action="store_true",
                    help="hold each route's kernels against their plain "
                         "versions (one call each)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--devices", default=None,
                    help=f"the {SLABS} devices of the x4 route, comma-"
                         f"separated (default {SLABS} x --device)")
    args = ap.parse_args(argv)
    check_device(args.device)
    devices = args.devices.split(",") if args.devices else None
    for d in devices or ():
        check_device(d)
    if devices is not None and len(devices) != SLABS:
        raise ValueError(f"--devices: {SLABS} devices, got {devices}")
    routes = args.routes.split(",")
    for r in routes:
        if r not in ROUTES:
            raise ValueError(f"--routes: {r!r} is not one of {ROUTES}")
    dtype = np.float64 if args.f64 else np.float32

    h = nudge_h(args.h or (H_QUICK if args.quick else H), box_room())
    rss0 = peak_rss_gb()
    sim, secs = setup(h)
    v = sim.vox
    npts = v.Nx * v.Ny * v.Nz
    rec = {"h": h, "grid": [v.Nx, v.Ny, v.Nz], "npts": npts, "Nb": v.Nb,
           "Nbl": int((v.mat_bn >= 0).sum()), "Nt": sim.comms.Nt,
           "setup_s": secs, "rss_gb": peak_rss_gb(),
           "rss_before_gb": rss0}
    print(f"[setup_1e9] h = {h:.6f}: {v.Nx} x {v.Ny} x {v.Nz} = "
          f"{npts / 1e9:.6f} Gvox, Nb {v.Nb}, Nbl {rec['Nbl']}, Nt "
          f"{sim.comms.Nt}; host seconds: "
          + ", ".join(f"{k} {t:.3f}" for k, t in secs.items())
          + f"; peak RSS {rec['rss_gb']:.2f} GB (before the setup "
          f"{rss0:.2f})", flush=True)

    nt = sim.comms.Nt if args.steps is None else min(args.steps,
                                                      sim.comms.Nt)
    dev = torch.device(args.device)
    rec["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    rec["nt"], rec["routes"], outs = nt, {}, {}
    if any(torch.device(d).type == "cuda" for d in devices or [dev]):
        since = time.perf_counter_ns()  # nvcc, or a load: outside the loops
        _build.library()
        rec["kernels_build_s"] = sum(r.seconds for r in spans.records(since)
                                     if r.name == "kernels.library")
        print(f"[setup_1e9] kernels built or loaded in "
              f"{rec['kernels_build_s']:.2f} s", flush=True)
    for route in routes:
        outs[route], r = run_route(sim, route, nt, dtype, args.device,
                                   devices, check=args.check)
        rec["routes"][route] = r
        by_card = r["peak_gb_by_device"]
        peak = ("not measured" if r["peak_gb"] is None
                else f"{r['peak_gb']:.2f} GB" if len(by_card) < 2
                else ", ".join(f"{d} {x:.2f} GB" for d, x in by_card.items()))
        where = rec["device"] + (f" ({', '.join(devices)})"
                                 if route == "x4" and devices else "")
        print(f"[setup_1e9] {route} on {where}, grid {r['grid']}: "
              f"{r['mvps']:.1f} MVPS, "
              f"{r['ms_step']:.4f} ms a step ({nt} steps in "
              f"{r['seconds']:.4f} s, the best of "
              + ", ".join(f"{t:.4f}" for t in r["runs_s"])
              + f" s; engine build {r['build_s']:.3f} s); "
              f"peak device memory {peak}; launches {r['launches']}; max "
              f"|u_out| {r['max_abs_u']:.6e}; peak RSS "
              f"{peak_rss_gb():.2f} GB", flush=True)
        for k, c in r.get("checks", {}).items():
            print(f"[setup_1e9] {route} {k} vs its plain version: {c}",
                  flush=True)
        if route == "energy":
            print(f"[setup_1e9] energy (fp64): balance {r['balance']:.3e} "
                  f"(bar {BALANCE:.0e}), E_lost[-1] {r['E_lost']:.6e}; "
                  f"peak device memory {peak} against {r['reckoned_gb']:.2f}"
                  f" GB reckoned from its arrays; {r['route_s']:.1f} s in "
                  f"all (engine build, run, free)"
                  + ("; no plain check: the plain passes' temporaries "
                     "would not fit the card at this size" if args.check
                     else ""), flush=True)
    # the energy route runs in fp64: held to the others only when they do
    same = {r: u for r, u in outs.items() if r != "energy" or args.f64}
    rec["receivers_vs_first"] = compare_routes(same) if same else {}
    if len(same) < len(outs):
        u, ref = outs["energy"], next(iter(same.values()), None)
        if not np.isfinite(u).all():
            raise FloatingPointError("energy: u_out is not finite")
        if ref is not None:
            rec["energy_fp64_vs_first"] = float(
                np.abs(u - ref).max() / np.abs(ref).max())
    rec["bitwise_equal"] = {r: bool(np.array_equal(u, outs[routes[0]]))
                            for r, u in outs.items()}
    rec["rss_gb"] = peak_rss_gb()
    print(f"[setup_1e9] receivers vs {routes[0]}: "
          f"{rec['receivers_vs_first']} of max |u_out|, bitwise equal "
          f"{rec['bitwise_equal']}"
          + (f"; the fp64 energy route vs {routes[0]} "
             f"{rec['energy_fp64_vs_first']:.3e}"
             if "energy_fp64_vs_first" in rec else ""), flush=True)
    print(json.dumps({"setup_1e9": rec}))
    return rec, outs


if __name__ == "__main__":
    main()
