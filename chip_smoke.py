#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pffdtd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no CPU fallback; exit code != 0):
1. Device and build: the card's name and power limit (nvidia-smi), then the
   build of the CUDA kernels K1 (csrc/stencil.cu), K2 (csrc/boundary.cu),
   K3 (csrc/tb.cu) and K4 (csrc/stream.cu) from this checkout's sources.
   K4, the streaming probe, is held against PyTorch's sum, fill_ and copy_
   and timed at 64 MB, 512 MB and 2 GB: GB/s per mode beside PyTorch's.
2. Per-kernel checks at the main path's shapes, from a seeded random state:
   each kernel vs its plain PyTorch version on the card, one call each.
   K1 and K2: fp32 max relative error <= 1e-6 (one call differs at most by
   summation order: the kernels are built without FMA contraction).  K3, one
   sweep of TB = 2 and TB = 3 (fields, vh/gh, taps): <= 1e-5 of the largest
   magnitude of each output.  Then fp64 on the small scenes of phase 3,
   <= 1e-12.  Kernels and plain versions are timed with CUDA events.
3. Small scenes, fp64, kernels vs plain versions: a lossy Cartesian box and
   a lossy FCC box, unfolded and folded.  The single-step route, and the
   TB = 3 and pair (TB = 2) routes over 29 steps (not a multiple of TB, so
   the tail steps run), vs the plain single-step path: receivers <= 1e-12.
4. The main path at full size: the bench's headline scene, a lossy folded-FCC
   box of 36 x 28 x 23 m at h = 0.046 (11-branch material), rotated
   "descending", folded and sorted: a 792 x 310 x 510 grid, about 125 Mvox,
   128 fp32 steps through TorchEngine(device="cuda"), best of 3 per route:
   backend="tb" (TB = 3: 42 K3 sweeps + 2 single steps), backend="pair"
   (64 K3 sweeps) and backend="step" (128 K1 + K2 steps), each with its
   launch counts checked; then the plain path, whose receivers every route
   must match to <= 1e-5 of max |u_out|.  Two receivers sit 1.6 m from the
   source: the bench's default positions lie beyond the 5.9 m that 128 steps
   can reach, and would read exact zeros.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  The work sits under `__main__`, so importing
this file runs nothing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.kernels.boundary import boundary_update, \
    boundary_update_plain
from pffdtd_tpu_torch.kernels.stencil import stencil_step, stencil_step_plain
from pffdtd_tpu_torch.kernels.stream import measure, stream, stream_plain, \
    time_ms
from pffdtd_tpu_torch.kernels.tb import tb_sweep, tb_sweep_plain
from pffdtd_tpu_torch.scene import fold_fcc_sim, rotate_sim, sort_sim, \
    synthetic_box_sim

SEED = 0
NT = 128
NT_SMALL = 29
# the bench's 11-branch material (bench.py:60-63)
DEF11 = np.array([[d, e, f] for d, e, f in zip(
    np.geomspace(0.4, 40.0, 11),
    np.geomspace(2.0, 80.0, 11),
    np.geomspace(20.0, 2.0e5, 11))])
HEADLINE = (36.0, 28.0, 23.0, 0.046)
SMALL = {  # name: (box, h, fcc, fold, Nt), the scenes of test_pallas_stencil
    "cart": ((2.5, 2.0, 1.6), 0.1, False, False, 40),
    "fcc": ((2.2, 1.8, 1.5), 0.12, True, False, 30),
    "fcc_folded": ((2.2, 1.8, 1.5), 0.12, True, True, 30),
}
STREAM_MB = (64, 512, 2048)
# NVIDIA's published H100 SXM peaks (dense, no sparsity)
HBM_BPS = 3.35e12
FP32_OPS, FP64_OPS = 67e12, 34e12
SRC = "pffdtd_tpu_torch/csrc/"
KERNELS = {  # name: (source, replaces)
    "K1 stencil_step": (SRC + "stencil.cu",
                        "pffdtd_tpu/engine/pallas_stencil.py:63"),
    "K2 boundary_update": (SRC + "boundary.cu",
                           "pffdtd_tpu/engine/pallas_boundary.py:407"),
    "K3 tb_sweep": (SRC + "tb.cu", "pffdtd_tpu/engine/pallas_tb.py:77"),
    "K4 stream": (SRC + "stream.cu", "probes/dma_plateau.py:105"),
}
WRAPPERS = (stencil_step, boundary_update, tb_sweep, stream)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel(a, b):
    """max |a - b| / max |b| and max |a - b|."""
    d = float((a - b).abs().max())
    s = float(b.abs().max())
    return (d / s if s > 0 else d), d


def small_scene(name):
    box, h, fcc, fold, nt = SMALL[name]
    sim = synthetic_box_sim(*box, h=h, Nt=nt, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False)
    return fold_fcc_sim(sim) if fold else sim


def headline_scene(nt):
    Lx, Ly, Lz, h = HEADLINE
    src = np.array([0.45 * Lx, 0.55 * Ly, 0.5 * Lz])
    rxyz = src + np.array([[1.3, -0.8, 0.6], [-1.3, 1.4, -0.9]])
    sim = synthetic_box_sim(Lx, Ly, Lz, h=h, Nt=nt, fcc=True, lossy=True,
                            insig_type="impulse", DEF=DEF11, Rxyz=rxyz)
    return sort_sim(fold_fcc_sim(rotate_sim(sim, orient="descending")))


def engine(sim, dtype, **kw):
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=dtype, device="cuda", **kw)


def random_state(eng, gen):
    d = eng.data
    r = lambda *s: torch.randn(s, generator=gen, device=eng.device,
                               dtype=eng.dtype)
    return r(*d.grid.shape), r(*d.grid.shape), r(MMb, d.Nbl), r(MMb, d.Nbl)


def kernel_checks(eng, gen, timing_reps=0):
    """One call of K1 and K2 vs their plain versions from a random state.

    Returns {name: (max rel err, max abs err, kernel ms, plain ms)}."""
    d = eng.data
    g, sc = d.grid, d.sc
    u0, u1, vh, gh = random_state(eng, gen)
    outk, outp = torch.zeros_like(u0), torch.zeros_like(u0)
    stencil_step(u0, u1, eng.adj, outk, g, sc)
    stencil_step_plain(u0, u1, eng.adj, outp, g, sc)
    torch.cuda.synchronize()
    inner = (slice(1, -1),) * 3
    k1 = rel(outk[inner], outp[inner])

    k2_args = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    unk, unp = outp.clone(), outp.clone()
    vhk, ghk, vhp, ghp = vh.clone(), gh.clone(), vh.clone(), gh.clone()
    boundary_update(unk, u0, *k2_args, vhk, ghk, sc)
    boundary_update_plain(unp, u0, *k2_args, vhp, ghp, sc)
    torch.cuda.synchronize()
    errs = [rel(unk, unp), rel(vhk, vhp), rel(ghk, ghp)]
    k2 = (max(e[0] for e in errs), max(e[1] for e in errs))

    t = {}
    if timing_reps:
        t["K1"] = (time_ms(lambda: stencil_step(u0, u1, eng.adj, outk, g, sc),
                           timing_reps),
                   time_ms(lambda: stencil_step_plain(u0, u1, eng.adj, outp,
                                                      g, sc), 3))
        t["K2"] = (time_ms(lambda: boundary_update(unk, u0, *k2_args, vhk,
                                                   ghk, sc), timing_reps),
                   time_ms(lambda: boundary_update_plain(unp, u0, *k2_args,
                                                         vhp, ghp, sc), 3))
    return {"K1": k1 + t.get("K1", (None, None)),
            "K2": k2 + t.get("K2", (None, None))}


def tb_check(eng, gen, timing_reps=0):
    """One K3 sweep vs tb_sweep_plain from a random state (fields, vh/gh,
    source samples).  Returns (max rel err over the outputs, max abs err,
    kernel ms, plain ms); each output's error is relative to its own
    largest magnitude."""
    st, d = eng.tb_scene, eng.data
    TB = st.TB
    u0, u1, vh, gh = random_state(eng, gen)
    sig = torch.randn((TB, d.in_ixyz.size), generator=gen,
                      device=eng.device, dtype=eng.dtype)
    nr = d.out_ixyz.size

    def buffers():
        o = [torch.zeros_like(u0) for _ in range(2)]
        s = [torch.zeros_like(vh) for _ in range(2)]
        taps = (torch.zeros((TB - 2, nr), dtype=eng.dtype, device=eng.device)
                if TB > 2 else None)
        return o, s, taps

    (ok_, sk, tk), (op, sp, tp) = buffers(), buffers()
    tb_sweep(st, u0, u1, *ok_, vh, gh, *sk, sig, tk)
    tb_sweep_plain(st, u0, u1, *op, vh, gh, *sp, sig, tp)
    torch.cuda.synchronize()
    inner = (slice(1, -1),) * 3
    pairs = [(ok_[0][inner], op[0][inner]), (ok_[1][inner], op[1][inner]),
             (sk[0], sp[0]), (sk[1], sp[1])] + ([(tk, tp)] if TB > 2 else [])
    errs = [rel(a, b) for a, b in pairs]
    t = (None, None)
    if timing_reps:
        t = (time_ms(lambda: tb_sweep(st, u0, u1, *ok_, vh, gh, *sk, sig,
                                      tk), timing_reps),
             time_ms(lambda: tb_sweep_plain(st, u0, u1, *op, vh, gh, *sp,
                                            sig, tp), 2))
    return (max(e[0] for e in errs), max(e[1] for e in errs)) + t


def reset_counts():
    for w in WRAPPERS:
        w.launches = 0


def counts():
    return tuple(w.launches for w in WRAPPERS)


def run_route(eng, want, reps=3):
    """Best of `reps` runs of NT steps; each run's launch counts (K1, K2,
    K3, K4) are reset just before it and must equal `want` just after."""
    runs = []
    for _ in range(reps):
        reset_counts()
        u = eng.run(nt=NT, verbose=False)
        runs.append((eng.elapsed, counts()))
    require(all(c == want for _, c in runs),
            f"{eng.backend} TB={eng.TB}: launches per run "
            f"{[c for _, c in runs]}, want {want}")
    require(np.isfinite(u).all() and np.abs(u).max() > 0,
            "main path: u_out not finite or all zero")
    return u, min(t for t, _ in runs), want


def bound_ms(nbytes, nops=0.0, fp64=False):
    """The least time for the work on this card: bytes over the published
    HBM rate vs operations over the published peak; (ms, "bytes"|...)."""
    tb = nbytes / HBM_BPS * 1e3
    to = nops / (FP64_OPS if fp64 else FP32_OPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "test runs on an NVIDIA card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # ---- 1. device, build, and the K4 bandwidth probe
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    lib = _build.library()
    print(f"[1] built {lib.path.name} in {lib.build_seconds:.2f} s",
          flush=True)
    entry = None
    for line in lib.log.splitlines():   # ptxas: registers, spills per kernel
        if "entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill stores" in line:
            print(f"[1] {entry}: {line.strip()}")
    x = torch.randn((1 << 24) + 3, generator=gen, device="cuda")
    y, y2 = torch.empty_like(x), torch.empty_like(x)
    s_err = abs(float(stream("read", x)) - float(stream_plain("read", x)))
    require(s_err <= 1e-12 * float(x.abs().sum(dtype=torch.float64)),
            f"K4 read disagrees with x.sum: {s_err}")
    stream("copy", x, y)
    require(torch.equal(y, stream_plain("copy", x, y2)), "K4 copy differs")
    stream("write", y=y, value=3.0)
    require(torch.equal(y, stream_plain("write", y=y2, value=3.0)),
            "K4 fill differs")
    del x, y, y2
    reset_counts()
    probe = measure(STREAM_MB, reps=10)
    k4_launches = counts()[3]
    require(k4_launches > 0, "the bandwidth probe launched no K4")
    for r in probe:
        print(f"[1] K4 {r['mode']:5s} {r['size_mb']:5d} MB: "
              f"{r['gbps']:.1f} GB/s ({r['ms']:.4f} ms); torch "
              f"{r['torch_gbps']:.1f} GB/s ({r['torch_ms']:.4f} ms)",
              flush=True)
    roof = max(r["gbps"] for r in probe if r["mode"] == "copy")
    k4 = max((r for r in probe if r["mode"] == "copy"),
             key=lambda r: r["size_mb"])
    print(f"[1] K4 read+write roof {roof:.1f} GB/s", flush=True)

    # ---- host setup of the main path's scene, one engine per route
    t0 = time.perf_counter()
    sim = headline_scene(NT)
    t_scene = time.perf_counter() - t0
    eng_tb = engine(sim, np.float32, backend="tb", tb=3)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    eng_pair = engine(sim, np.float32, backend="pair")
    eng = engine(sim, np.float32)    # the default route: auto -> step
    require(eng.backend == "step", f"auto picked {eng.backend}")
    g = eng.data.grid
    npts = g.Nx * g.Ny * g.Nz
    print(f"[4] headline scene {g.shape} = {npts / 1e6:.1f} Mvox, "
          f"Nbl {eng.data.Nbl}, host setup {t_setup:.2f} s (scene "
          f"{t_scene:.2f} s); K3 tiles {eng_tb.tb_scene.lists.box} x "
          f"{eng_tb.tb_scene.lists.ntiles}, lossy entries "
          f"{eng_tb.tb_scene.lists.node.size} (max "
          f"{eng_tb.tb_scene.lists.max_per_tile} a tile)", flush=True)

    # ---- 2. per-kernel checks at the main path's shapes (fp32), fp64 small
    main_chk = kernel_checks(eng, gen, timing_reps=20)
    for k, (r, a, ms, pms) in main_chk.items():
        print(f"[2] {k} fp32 main shapes: max rel err {r:.3e} (abs {a:.3e}),"
              f" kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
        require(r <= 1e-6, f"{k} fp32 disagrees with its plain version: {r}")
    tb_chk = {}
    for e in (eng_pair, eng_tb):
        r, a, ms, pms = tb_chk[e.TB] = tb_check(e, gen, timing_reps=10)
        print(f"[2] K3 TB={e.TB} fp32 main shapes: max rel err {r:.3e} (abs "
              f"{a:.3e}), kernel {ms:.4f} ms/sweep = {ms / e.TB:.4f} ms/step,"
              f" plain {pms:.4f} ms/sweep", flush=True)
        require(r <= 1e-5, f"K3 TB={e.TB} fp32 disagrees: {r}")
    small = {n: small_scene(n) for n in SMALL}
    for n, s in small.items():
        for k, (r, a, _, _) in kernel_checks(engine(s, np.float64),
                                             gen).items():
            print(f"[2] {k} fp64 {n}: max rel err {r:.3e}", flush=True)
            require(r <= 1e-12, f"{k} fp64 {n} disagrees: {r}")
        for TB in (2, 3):
            r = tb_check(engine(s, np.float64, backend="tb", tb=TB), gen)[0]
            print(f"[2] K3 TB={TB} fp64 {n}: max rel err {r:.3e}",
                  flush=True)
            require(r <= 1e-12, f"K3 TB={TB} fp64 {n} disagrees: {r}")

    # ---- 3. small scenes, fp64 kernel routes vs the plain path
    for n, s in small.items():
        up = engine(s, np.float64, backend="step",
                    use_kernels=False).run(nt=NT_SMALL, verbose=False)
        scale = np.abs(up).max()
        require(scale > 0, f"{n}: empty output")
        for kw in ({"backend": "step"}, {"backend": "tb", "tb": 3},
                   {"backend": "pair"}):
            uk = engine(s, np.float64, **kw).run(nt=NT_SMALL, verbose=False)
            err = np.abs(uk - up).max() / scale
            print(f"[3] {n} fp64 {kw} receivers vs plain: {err:.3e}",
                  flush=True)
            require(np.isfinite(uk).all(), f"{n} {kw}: not finite")
            require(err <= 1e-12, f"{n} {kw}: fp64 route disagrees: {err}")

    # ---- 4. the main path: 128 fp32 steps per route, best of 3
    tb3 = NT // 3, NT % 3
    u_tb, t_tb, c_tb = run_route(eng_tb, (tb3[1], tb3[1], tb3[0], 0))
    u_pr, t_pr, c_pr = run_route(eng_pair, (0, 0, NT // 2, 0))
    u_k, t_k, c_k = run_route(eng, (NT, NT, 0, 0))
    eng.use_kernels = False
    reset_counts()
    t_p = []
    for _ in range(3):
        u_p = eng.run(nt=NT, verbose=False)
        t_p.append(eng.elapsed)
    require(counts() == (0, 0, 0, 0), "the plain path launched a kernel")
    scale = np.abs(u_p).max()
    isz = eng.state[0].element_size()
    ni = g.n_interior
    k1_ms, k2_ms = main_chk["K1"][2], main_chk["K2"][2]
    k1_bytes = ni * (3 * isz + eng.adj.element_size())
    print(f"[4] launches (K1, K2, K3, K4) per {NT} steps: tb TB=3 {c_tb}, "
          f"pair {c_pr}, step {c_k}", flush=True)
    for name, u, t in (("tb TB=3", u_tb, t_tb), ("pair", u_pr, t_pr),
                       ("step", u_k, t_k), ("plain", u_p, min(t_p))):
        err = np.abs(u - u_p).max() / scale
        print(f"[4] {name}: {npts * NT / t / 1e6:.1f} MVPS (best "
              f"{t:.4f} s), receivers vs plain path {err:.3e} of max "
              f"|u_out| {scale:.3e}", flush=True)
        require(err <= 1e-5, f"main path {name} receivers disagree: {err}")
    print(f"[4] K1 {k1_ms:.4f} ms/step = {k1_bytes / k1_ms / 1e6:.1f} GB/s "
          f"at {k1_bytes / npts:.2f} B/voxel; K2 {k2_ms:.4f} ms/step",
          flush=True)
    k3_bytes = {}
    for TB, (_, _, ms, _) in tb_chk.items():
        st = (eng_tb if TB == 3 else eng_pair).tb_scene
        tl = st.lists
        k3_bytes[TB] = (ni * (4 * isz + eng.adj.element_size())
                        + eng.data.Nbl * (4 * MMb * isz + isz + 4)
                        + 4 * (tl.ptr.size + 3 * tl.node.size))
        print(f"[4] K3 TB={TB} {ms:.4f} ms/sweep, {ms / TB:.4f} ms/step, "
              f"{ni * (4 * isz + eng.adj.element_size()) / ms / 1e6:.1f} "
              f"GB/s at 18 B/voxel per sweep", flush=True)
    print(f"[4] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    k2_bytes = eng.data.Nbl * (4 * MMb * isz + 8 + isz + 4 + 3 * isz)
    k4_bytes = 2 * k4["size_mb"] * (1 << 20)
    rows = {
        "K1 stencil_step": (c_k[0], main_chk["K1"][1], k1_ms,
                            main_chk["K1"][3], k1_bytes, 29.0 * ni, None),
        "K2 boundary_update": (c_k[1], main_chk["K2"][1], k2_ms,
                               main_chk["K2"][3], k2_bytes,
                               80.0 * eng.data.Nbl, None),
        "K3 tb_sweep": (c_tb[2], tb_chk[3][1], tb_chk[3][2], tb_chk[3][3],
                        k3_bytes[3], 3 * 29.0 * ni
                        + 3 * 80.0 * eng.data.Nbl, None),
        "K4 stream": (k4_launches, s_err, k4["ms"], k4["torch_ms"], k4_bytes,
                      0.0, k4["torch_ms"]),
    }
    rec = {"kernels": []}
    for name, (n, err, ms, pms, nbytes, nops, lib_ms) in rows.items():
        b, by = bound_ms(nbytes, nops)
        rec["kernels"].append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": n,
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b,
            "bound_by": by, "library_ms": lib_ms,
            "bound_k4_roof_ms": nbytes / roof / 1e6})
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
