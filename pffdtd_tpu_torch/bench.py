"""The port's bench: fp32 voxel-update throughput (MVPS) on one NVIDIA card.

    python -m pffdtd_tpu_torch.bench

The counterpart of `bench.py` at the repository's root, which stays the JAX
bench: `python bench.py` runs the JAX package on a TPU and never reaches
this module.  The same items in the same order, on the same scenes, sizes,
step counts and checks, with the port's engines in place of the JAX ones,
against the same baseline: the reference's best published rate a GPU,
52,512.6 MVPS on an A100-40GB, folded FCC, 11 RLC branches a material
(bench.py:55).  MVPS = Nx*Ny*Nz * steps / seconds of the engine's time loop.

Kept from bench.py's design:
- the headline runs first; if it fails, a half-size run stands in and sets
  `headline_note`;
- every item runs in its own subprocess (BENCH_CHILD=<name>) and hands its
  result back on a `BENCH_RESULT` line, so a crashed or hung item cannot
  take finished ones down with it;
- timed runs are the best of 3, after a warm-up run at the same nt;
- the whole JSON line is re-printed (flushed) after every item, so a kill
  leaves the latest state at the end of the output; SIGTERM and SIGALRM
  dump it too (they cannot interrupt a blocked device call);
- an item whose estimate exceeds what the budget has left is skipped, and
  each item's time limit is min(remaining - 30, max(3 est, est + 600)).
Dropped, and why:
- `_prior_best` / `regressions_vs_best_prior`: BENCH_r*.json holds the JAX
  bench's TPU numbers, and the record of the port's runs is the ledger
  (PERF_LEDGER.jsonl);
- `BENCH_PARTIAL.json` at the repository's root: the re-printed line is
  the mechanism.
Added: `device` in the line (the card's name, its power limit from
nvidia-smi, the count of cards), and the `roof` item.  Each engine run of
an item is `counted`: the kernels' launch counts are set to 0 just before
it and read just after, and the child hands them back with its route, TB,
slab count, nt and its count of lossy nodes on an ABC layer; the runner
writes them to stderr, one line an item,
`BENCH_LAUNCHES <item> <json list>` (chip_smoke.py phase 9 holds them to
what each route must launch).

Where the scenes differ from bench.py's:
- the headline's two receivers sit 1.6 and 2.1 m from the source
  (chip_smoke.py's positions): 128 steps reach 5.9 m, and bench.py's defaults would read
  exact zeros.  No grid point or boundary node moves;
- FCC grids are rotated "descending", the reference's rule, where
  bench.py rotates by "auto": the port's own "auto" (scene.py) is newer
  than the bench's recorded numbers, which this keeps comparable.  The
  grid is the same with its axes permuted.

Items, in bench.py's order (bench.py's function -> this module's; keys):
- `fcc_lossy` (`run_synthetic`) -> `headline`: the 36 x 28 x 23 m lossy
  folded-FCC box, h = 0.046, 128 steps, on the step route (the default),
  then TB = 3 and pair on the same scene, each within 1e-5 of max |u_out|
  of the step route's receivers, which must be finite and nonzero;
  `voxel_update_rate_fp32_fcc_lossy` (the headline), `fcc_lossy_tb`,
  `fcc_lossy_pair`.  `fcc_lossy_half`: half size, the fallback only.
- `mv_fcc_lossy` (`run_real_mv`) -> `run_real_mv`: the Musikverein hall of
  `examples.bench_mv`, from the data folder `data/` of the working
  directory; skipped, with the reason on stderr, where it is absent.
- `sharded_pair` (`sharded_pair_tpu`) -> `sharded_check("pair")`: the
  x-slab engine at D = 1 against the single-device engine on the pair
  route, rigid 21 x 16 x 12.6 m Cartesian box, h = 0.03, 64 steps;
  `sharded_pair_mvps`, `sharded_pair_vs_single_err` (< 1e-4),
  `sharded_pair_vs_single_frac`.
- `energy_pair` (`energy_pair_check`) -> `energy_route_check`: the step
  route against the energy route (K1e + K2 + K7), fp32, 28 x 22 x 18 m
  FCC, 512 steps in chunks of 128, nonzero receivers asserted;
  `kernel_vs_energy_route_err`, `energy_balance_fp32`,
  `energy_route_mvps`.
- `fp32_spectral` (`fp32_vs_fp64_rir_db`): the port's NumpyEngine (fp64)
  against TorchEngine in fp32 over 8,192 steps on the open-top lossy box;
  `fp32_vs_fp64_rir_max_db`.
- `fcc_lossy_1e9`, `fcc_rigid`, `cart_rigid`, `cart_lossy`,
  `cart_rigid_1e9` (`run_synthetic`): bench.py's sizes, same keys.
- `sharded_pallas` (`sharded_pallas_tpu`) -> `sharded_check("step")`: the
  x-slab step route at D = 1 against the single device, 12 x 9 x 7 m lossy
  box padded to Nx % 8 == 0, h = 0.03, 64 steps; `sharded_step_mvps`,
  `sharded_step_vs_single_err` (< 1e-4).
- `fp32_drift`, `fp32_drift_lossy` (`fp32_energy_drift`): 50,000 fp32 steps
  in chunks of 10,000, the lossy one on the open-top box;
  `fp32_tail_to_head_rms_50k`, `fp32_tail_to_head_rms_50k_lossy`.
- `roof` (new): K4's copy and `copy_` on 2 GiB, each the median of 5
  windows (chip_smoke.py phase 1's method); `roof_gbps` (the faster),
  `k4_copy_gbps`, `copy__gbps`.
The two `*_vs_single_err` compare the receivers and the final field u^nt,
each relative to its largest magnitude: at 64 steps the receivers of those
boxes still read zeros.

Env knobs, as bench.py's:
  BENCH_BUDGET_S    wall-clock budget in seconds (default 3300)
  BENCH_ONLY=a,b    run only the named items (the headline always runs)
  BENCH_SKIP=a,b    skip the named items
  BENCH_NT, BENCH_H, BENCH_LX/LY/LZ  the headline scene's size

The command needs a card: `main()` raises RuntimeError when
torch.cuda.is_available() is False, before any child starts.  The item
functions take `device`; the tests run them on the CPU.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples import MV_MODEL, REF
from pffdtd_tpu_torch.kernels import WRAPPERS
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.scene import (DEF11, fold_fcc_sim, headline_rxyz,
                                    rotate_sim, sort_sim, synthetic_box_sim)

BASELINE_MVPS = 52512.6  # 2x A100-40GB per-GPU rate, FCC fmax=6.5kHz, lossy
METRIC = "voxel_update_rate_fp32_fcc_lossy"

# one record a counted run of this process (`counted`)
LAUNCHES: list = []


# ------------------------------------------------------------------ scenes
def synthetic_scene(fcc, lossy, Lx, Ly, Lz, h, nt, rxyz=None):
    """bench.py's `run_synthetic` scene: the analytic box, on FCC rotated,
    folded and sorted (the reference runs folded FCC)."""
    sim = synthetic_box_sim(Lx, Ly, Lz, h=h, Nt=nt, fcc=fcc, lossy=lossy,
                            insig_type="impulse",
                            DEF=DEF11 if lossy else None, Rxyz=rxyz)
    if fcc:
        sim = sort_sim(fold_fcc_sim(rotate_sim(sim, orient="descending")))
    return sim


def drift_scene(nsteps, lossy, h=0.04):
    """bench.py's `fp32_energy_drift` box; lossy: open at the top."""
    return synthetic_box_sim(4.0, 3.1, 2.6, h=h, Nt=nsteps, lossy=lossy,
                             insig_type="hann10", diff_source=False,
                             DEF=DEF11 if lossy else None, open_top=lossy)


def spectral_scene(nsteps, h=0.045):
    """bench.py's `fp32_vs_fp64_rir_db` box: lossy, open at the top."""
    return synthetic_box_sim(3.0, 2.3, 2.0, h=h, Nt=nsteps, lossy=True,
                             insig_type="hann10", diff_source=False,
                             DEF=DEF11, open_top=True)


def sharded_scene(route, nt, h=0.03):
    """bench.py's `sharded_pair_tpu` (route "pair": rigid) and
    `sharded_pallas_tpu` (route "step": lossy, Nx padded to a multiple of
    8) boxes."""
    if route == "pair":
        return synthetic_box_sim(21.0, 16.0, 12.6, h=h, Nt=nt, lossy=False,
                                 insig_type="impulse")
    return synthetic_box_sim(12.0, 9.0, 7.0, h=h, Nt=nt, lossy=True,
                             insig_type="impulse", DEF=DEF11, pad_x_to=8)


# ------------------------------------------------------------------- items
def _kw(sim):
    return dict(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                mats=sim.mats)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _free(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def counted(eng, tag, nt, **kw):
    """eng.run(nt, **kw) with every kernel's launch count set to 0 just
    before it; appends to LAUNCHES the run's route and the launches it made
    (the kernels it launched, by name).  x_slabs: 0 on `TorchEngine`, the
    slab count on the x-slab engine; abc_nodes: the lossy nodes on an ABC
    layer."""
    _reset_counts()
    u = eng.run(nt=nt, verbose=False, **kw)
    d = eng.data
    LAUNCHES.append({
        "tag": tag,
        "route": "energy" if getattr(eng, "energy_on", False)
        else eng.backend,
        "TB": eng.TB, "x_slabs": getattr(eng, "D", 0), "nt": nt,
        "lossy": bool(d.Nbl),
        "abc_nodes": 0 if d.abcq_bnl is None else int(
            np.count_nonzero(d.abcq_bnl)),
        "launches": {k: w.launches for k, w in WRAPPERS.items()
                     if w.launches}})
    return u


def timed(eng, nt, tag, **kw):
    """A warm-up run at nt steps, then the best MVPS of 3 runs, each
    `counted` under `tag`; returns (MVPS, u_out of the last run).  kw: the
    engine's run options."""
    counted(eng, tag, nt, **kw)
    best = 0.0
    for _ in range(3):
        counted(eng, tag, nt, **kw)
        best = max(best, eng.mvps)
    if not np.isfinite(eng.u_out).all():
        raise FloatingPointError("u_out is not finite")
    return best, eng.u_out


def rel_err(a, b):
    """max |a - b| / max |b| (max |a - b| where b is all zero)."""
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _synthetic(fcc, lossy, Lx, Ly, Lz, h, nt, tag, rxyz=None):
    t0 = time.perf_counter()
    sim = synthetic_scene(fcc, lossy, Lx, Ly, Lz, h, nt, rxyz)
    g = sim.vox
    _log(f"[{tag}] setup {time.perf_counter() - t0:.1f}s  grid "
         f"{g.Nx}x{g.Ny}x{g.Nz} = {g.Nx * g.Ny * g.Nz / 1e6:.1f} Mvox, "
         f"Nb={g.Nb}")
    return sim


def _timed_route(sim, nt, tag, device, backend="auto"):
    """Best-of-3 fp32 MVPS of `sim` on `backend`; (MVPS, u_out)."""
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device=device,
                      backend=backend)
    mvps, u = timed(eng, nt, tag)
    _log(f"  [{tag}] {eng.backend} TB={eng.TB}: {mvps:.1f} MVPS")
    del eng
    _free(device)
    return mvps, u


def run_synthetic(fcc, lossy, Lx, Ly, Lz, h, nt, tag=None, device="cuda"):
    """bench.py's `run_synthetic`: best-of-3 fp32 MVPS on the default
    route."""
    tag = tag or f"{'fcc' if fcc else 'cart'}_{'lossy' if lossy else 'rigid'}"
    sim = _synthetic(fcc, lossy, Lx, Ly, Lz, h, nt, tag)
    return _timed_route(sim, nt, tag, device)[0]


def headline(Lx, Ly, Lz, h, nt, tag="fcc_lossy", routes=True,
             device="cuda"):
    """The headline item: the lossy folded-FCC box on the step route, with
    its receivers near the source (finite and nonzero required); with
    `routes`, then TB = 3 and pair on the same scene, each within 1e-5 of
    max |u_out| of the step route's receivers."""
    sim = _synthetic(True, True, Lx, Ly, Lz, h, nt, tag,
                     rxyz=headline_rxyz(Lx, Ly, Lz))
    mvps, u = _timed_route(sim, nt, tag, device)
    if not np.abs(u).max() > 0:
        raise AssertionError("headline: the receivers read exact zeros")
    out = {"__headline__": mvps}
    if routes:
        for key in ("tb", "pair"):
            m, ur = _timed_route(sim, nt, f"{tag}_{key}", device, key)
            err = rel_err(ur, u)
            if not err <= 1e-5:
                raise AssertionError(f"headline {key}: receivers {err} of "
                                     "max |u_out| from the step route's")
            out[f"{tag}_{key}"] = m
    return out


def have_mv(ref=REF):
    """Whether the data folder holds the Musikverein model and materials."""
    return (Path(ref) / MV_MODEL).exists() and (Path(ref)
                                                / "materials").exists()


def run_real_mv(nt, fmax=2000.0, device="cuda", ref=REF):
    """bench.py's `run_real_mv`: the Musikverein hall (FCC, lossy) of
    `examples.bench_mv`, best-of-3 fp32 MVPS."""
    from pffdtd_tpu_torch.examples.bench_mv import mv_sim

    sim = mv_sim(ref, fmax, max(nt, 256), fcc=True)
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device=device)
    return timed(eng, min(nt, eng.Nt), "mv_fcc_lossy")[0]


def fp32_energy_drift(nsteps=50000, lossy=False, device="cuda"):
    """bench.py's `fp32_energy_drift`: the RMS of the last quarter of an
    fp32 receiver over that of the first.  The leapfrog is symplectic: a
    rigid box oscillates without growth; lossy walls and an open top (the
    ODE and the ABC together) make the tail decay, and it must not grow."""
    sim = drift_scene(nsteps, lossy)
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device=device)
    u = counted(eng, "fp32_drift" + "_lossy" * lossy, nsteps,
                chunk=min(nsteps, 10000))[0]
    if not np.isfinite(u).all():
        raise FloatingPointError("drift: u_out is not finite")
    a = np.sqrt(np.mean(u[: nsteps // 4] ** 2))
    b = np.sqrt(np.mean(u[-nsteps // 4:] ** 2))
    return float(b / a)


def fp32_vs_fp64_rir_db(nsteps=8192, device="cuda"):
    """bench.py's `fp32_vs_fp64_rir_db`: the largest |dB| between the fp32
    RIR and the fp64 oracle's over the rfft bins within 60 dB of the fp64
    peak, on the open-top lossy box."""
    sim = spectral_scene(nsteps)
    o = NumpyEngine(**_kw(sim))
    u64 = o.run_all()[0]
    eng = TorchEngine(**_kw(sim), dtype=np.float32, device=device)
    u32 = counted(eng, "fp32_spectral", nsteps, chunk=min(nsteps, 8192))[0]
    H64 = np.fft.rfft(u64)
    H32 = np.fft.rfft(u32[:u64.size])
    m = np.abs(H64) > np.abs(H64).max() * 1e-3   # within 60 dB of the peak
    return float(np.abs(20.0 * np.log10(
        np.abs(H32[m]) / np.abs(H64[m]))).max())


def energy_route_check(Lx, Ly, Lz, h, nt=512, device="cuda"):
    """bench.py's `energy_pair_check`: the step route and the energy route
    (K1e + K2 + K7's boundary pass) on the same fp32 scene, in chunks of
    128; returns (receivers' max difference over max |u_out|, the energy
    route's max |balance|, its best-of-3 MVPS).  nt must cover the source
    to receiver flight: the receivers must not read exact zeros."""
    sim = synthetic_scene(True, True, Lx, Ly, Lz, h, nt)
    step = TorchEngine(**_kw(sim), dtype=np.float32, device=device)
    u_step = counted(step, "energy_pair_step", nt, chunk=128)
    del step
    _free(device)
    en = TorchEngine(**_kw(sim), dtype=np.float32, device=device,
                     energy_on=True)
    mvps, u_en = timed(en, nt, "energy_pair", chunk=128)
    if not np.abs(u_en).max() > 0:
        raise AssertionError("vacuous: the wave never reached a receiver")
    return (rel_err(u_step, u_en), float(np.abs(en.energy_balance()).max()),
            mvps)


def sharded_check(route, nt=64, device="cuda"):
    """bench.py's `sharded_pair_tpu` (route "pair") and
    `sharded_pallas_tpu` (route "step"): the x-slab engine at D = 1 against
    `TorchEngine` on the same route, each best of 3; returns (MVPS, err,
    MVPS over the single device's), err the larger of the receivers' and
    the final field's difference over its largest magnitude (< 1e-4)."""
    sim = sharded_scene(route, nt)
    single = TorchEngine(**_kw(sim), dtype=np.float32, device=device,
                         backend=route)
    m1, u1 = timed(single, nt, f"sharded_{route}_single")
    f1 = single.state[1].cpu().numpy()
    del single
    _free(device)
    sp = make_sharded_engine(**_kw(sim), devices=[device], dtype=np.float32,
                             backend=route)
    m, u = timed(sp, nt, f"sharded_{route}")
    err = max(rel_err(u, u1), rel_err(sp.global_state()[1], f1))
    if not err < 1e-4:
        raise AssertionError(f"x-slab {route} route vs the single device: "
                             f"{err}")
    return m, err, m / m1


def roof():
    """K4's copy and copy_ on 2 GiB, the median of 5 windows each; GB/s."""
    from pffdtd_tpu_torch.kernels.stream import measure

    _reset_counts()
    row = next(r for r in measure((2048,)) if r["mode"] == "copy")
    LAUNCHES.append({"tag": "roof", "route": "stream", "launches": {
        k: w.launches for k, w in WRAPPERS.items() if w.launches}})
    return {"roof_gbps": max(row["gbps"], row["torch_gbps"]),
            "k4_copy_gbps": row["gbps"], "copy__gbps": row["torch_gbps"]}


def build_items():
    """Ordered (name, est_s, fn) table; fn() -> {key: value}, the key
    '__headline__' for the headline.  est_s: the seconds each item's child
    took in the bench's first full run on an H100 80GB HBM3 at 700.00 W
    (PERF.md §6), rounded up; the hall's, never run there, is
    bench.py's."""
    Lx = float(os.environ.get("BENCH_LX", "36"))
    Ly = float(os.environ.get("BENCH_LY", "28"))
    Lz = float(os.environ.get("BENCH_LZ", "23"))
    h = float(os.environ.get("BENCH_H", "0.046"))
    nt = int(os.environ.get("BENCH_NT", "128"))
    return [
        ("fcc_lossy", 30, lambda: headline(Lx, Ly, Lz, h, nt)),
        ("fcc_lossy_half", 0, lambda: headline(      # the fallback only
            Lx / 2, Ly / 2, Lz / 2, h, nt, tag="fcc_lossy_half",
            routes=False)),
        ("mv_fcc_lossy", 850 if have_mv() else 0,
         lambda: {"mv_fcc_lossy": run_real_mv(nt)}),
        ("sharded_pair", 20, lambda: dict(zip(
            ("sharded_pair_mvps", "sharded_pair_vs_single_err",
             "sharded_pair_vs_single_frac"), sharded_check("pair")))),
        ("energy_pair", 20, lambda: dict(zip(
            ("kernel_vs_energy_route_err", "energy_balance_fp32",
             "energy_route_mvps"),
            energy_route_check(28.0, 22.0, 18.0, h)))),
        ("fp32_spectral", 160,
         lambda: {"fp32_vs_fp64_rir_max_db": fp32_vs_fp64_rir_db()}),
        ("fcc_lossy_1e9", 25, lambda: {
            "fcc_lossy_1e9": run_synthetic(True, True, 108.0, 34.0, 28.0,
                                           h, nt, tag="fcc_lossy_1e9")}),
        ("fcc_rigid", 15, lambda: {
            "fcc_rigid": run_synthetic(True, False, Lx, Ly, Lz, h, nt)}),
        ("cart_rigid", 15, lambda: {
            "cart_rigid": run_synthetic(False, False, Lx, Ly, Lz, h, nt)}),
        ("cart_lossy", 15, lambda: {
            "cart_lossy": run_synthetic(False, True, Lx, Ly, Lz, h, nt)}),
        ("cart_rigid_1e9", 20, lambda: {
            "cart_rigid_1e9": run_synthetic(False, False, 150.0, 25.0,
                                            28.6, h, nt,
                                            tag="cart_rigid_1e9")}),
        ("sharded_pallas", 15, lambda: dict(zip(
            ("sharded_step_mvps", "sharded_step_vs_single_err"),
            sharded_check("step")[:2]))),
        ("fp32_drift", 15,
         lambda: {"fp32_tail_to_head_rms_50k": fp32_energy_drift()}),
        ("fp32_drift_lossy", 15, lambda: {
            "fp32_tail_to_head_rms_50k_lossy": fp32_energy_drift(
                lossy=True)}),
        ("roof", 10, roof),
    ]


# ------------------------------------------------------------------ runner
CHILD_CMD = [sys.executable, "-m", "pffdtd_tpu_torch.bench"]


def _fmt(v):
    # significant figures for small numbers: round(v, 4) would print an
    # error of 7.7e-6 as 0.0
    return round(v, 4) if abs(v) >= 1e-3 else float(f"{v:.3g}")


class _Run:
    """One bench run: its clock and budget, the results so far, and the
    live child process (killed on a deadline signal)."""

    def __init__(self, budget, device, cmd):
        self.t0 = time.perf_counter()
        self.budget, self.device, self.cmd = float(budget), device, cmd
        self.headline, self.note, self.secondary = None, None, {}
        self.child = None

    def remaining(self):
        return self.budget - (time.perf_counter() - self.t0)

    def line(self) -> dict:
        hl = self.headline
        out = {"metric": METRIC,
               "value": round(hl, 1) if hl is not None else None,
               "unit": "Mvox/s",
               "vs_baseline": (round(hl / BASELINE_MVPS, 4)
                               if hl is not None else None),
               "elapsed_s": round(time.perf_counter() - self.t0, 1),
               "secondary": {k: _fmt(v) for k, v in self.secondary.items()},
               "device": self.device}
        if self.note:
            out["headline_note"] = self.note
        return out

    def emit(self):
        """Print the whole result line as it stands (flushed)."""
        if self.headline is not None or self.secondary:
            print(json.dumps(self.line()), flush=True)

    def on_deadline(self, signum, frame):  # noqa: ARG002
        _log(f"  [bench] signal {signum}: dumping state")
        if self.child is not None:
            self.child.kill()
        self.emit()
        os._exit(0)

    def run_child(self, name, timeout_s):
        """Run the child command with BENCH_CHILD=name; returns its result
        dict or None.  stderr streams through, other stdout lines go to
        stderr."""
        proc = subprocess.Popen(self.cmd,
                                env=dict(os.environ, BENCH_CHILD=name),
                                stdout=subprocess.PIPE, text=True)
        self.child = proc
        try:
            out, _ = proc.communicate(timeout=max(timeout_s, 2))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            _log(f"  {name} TIMED OUT after {timeout_s:.0f}s (killed)")
            return None
        finally:
            self.child = None
        res = None
        for line in out.splitlines():
            if line.startswith("BENCH_RESULT "):
                res = json.loads(line[len("BENCH_RESULT "):])
            elif line.startswith("BENCH_LAUNCHES "):
                # the item's kernel launches, a run each, on a line of
                # their own: "BENCH_LAUNCHES <item> <json list>"
                _log(f"BENCH_LAUNCHES {name} {line[15:]}")
            else:
                _log(f"  [{name}] {line}")
        if res is None:
            _log(f"  {name} produced no result (rc={proc.returncode}); "
                 f"stdout tail: {out[-300:]!r}")
        return res


def child_main(name):
    """Run one item in this process; its result is the BENCH_RESULT line,
    its runs' launches (LAUNCHES) the BENCH_LAUNCHES line."""
    fn = {n: f for n, _, f in build_items()}[name]
    res = fn()
    print("BENCH_LAUNCHES " + json.dumps(LAUNCHES), flush=True)
    print("BENCH_RESULT " + json.dumps(res), flush=True)


def run(items, device, budget=None, cmd=None):
    """Run the item table `items` ((name, est_s, fn), the headline first,
    its fallback second), each in a child `cmd` (default `python -m
    pffdtd_tpu_torch.bench`), re-printing the line after each; returns the
    final line as a dict.  device: the line's `device` entry."""
    if budget is None:
        budget = float(os.environ.get("BENCH_BUDGET_S", "3300"))
    r = _Run(budget, device, cmd or CHILD_CMD)
    old = {s: signal.signal(s, r.on_deadline)
           for s in (signal.SIGTERM, signal.SIGALRM)}
    signal.alarm(max(int(budget), 60))
    try:
        only = [s for s in os.environ.get("BENCH_ONLY", "").split(",") if s]
        skip = [s for s in os.environ.get("BENCH_SKIP", "").split(",") if s]
        (first, _, _), (fallback, _, _) = items[:2]
        res = r.run_child(first, r.remaining() - 120)
        if res is None:
            _log("  headline failed; retrying at half size")
            res = r.run_child(fallback, r.remaining() - 60)
            if res:
                # a 1/8-volume grid never passes for the full-size metric
                r.note = "half_scale_fallback_grid"
        res = res or {}
        r.headline = res.pop("__headline__", None)
        r.secondary.update({k: v for k, v in res.items() if v is not None})
        r.emit()
        for name, est, _ in items[2:]:
            if (only and name not in only) or name in skip:
                continue
            if est == 0:
                _log(f"  [bench] SKIP {name}: no estimate (its inputs are "
                     "absent)")
                continue
            if est > r.remaining():
                _log(f"  [bench] SKIP {name}: est {est}s > remaining "
                     f"{r.remaining():.0f}s")
                continue
            t = time.perf_counter()
            res = r.run_child(name, min(r.remaining() - 30,
                                        max(3 * est, est + 600)))
            if res:
                r.secondary.update(
                    {k: v for k, v in res.items() if v is not None})
            _log(f"  [bench] {name} took {time.perf_counter() - t:.0f}s, "
                 f"remaining {r.remaining():.0f}s")
            r.emit()
        r.emit()
        return r.line()
    finally:
        signal.alarm(0)
        for s, h in old.items():
            signal.signal(s, h)


def device_info() -> dict:
    """The card: its name, power limit (nvidia-smi) and the count."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench runs on an NVIDIA card: "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    limit = smi.strip().splitlines()[0].split(",")[-1].strip()
    return {"name": torch.cuda.get_device_name(0),
            "power_limit_w": float(limit.split()[0]), "count": 1}


def main():
    """The bench on the card; raises RuntimeError without one."""
    dev = device_info()
    _log(f"[bench] {dev['name']}, {dev['power_limit_w']:.2f} W")
    if not have_mv():
        _log(f"  [bench] mv_fcc_lossy: the Musikverein model and materials "
             f"are not under {Path(REF).resolve()}; the item skips itself")
    return run(build_items(), dev)


if __name__ == "__main__":
    child = os.environ.get("BENCH_CHILD")
    if child:
        child_main(child)
    else:
        main()
