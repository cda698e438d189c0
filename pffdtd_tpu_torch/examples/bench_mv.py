"""Benchmark on the real Musikverein hall (the counterpart of
examples/bench_mv.py, the reference's benchmark model).

Reference conditions (benchmarks/README.md): 11-branch materials, impulse
+ diff source, single precision, MVPS = Npts * Nsamples / runtime / 1e6.
The setup stays in memory (no HDF5 is written): receivers closer than
0.6 m to a surface's triangle centroid are dropped (the bundled ones
assume the reference's fmax >= 3.2 kHz grids), then the grid is rotated
("auto", as the original's), FCC-folded and sorted.  The engine runs twice and the
second run is timed; one JSON line is printed, with `vs_baseline` against
the reference's 52,512.6 MVPS a GPU (BASELINE.md) and the device it ran
on.

    python -m pffdtd_tpu_torch.examples.bench_mv [FMAX=2000] [NT=100]
        [FCC=1] [--ref REF_DATA] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples import (MV_MATS, MV_MODEL, REF,
                                       add_device_arg, check_device,
                                       model_inputs)
from pffdtd_tpu_torch.geometry.room import RoomGeo
from pffdtd_tpu_torch.scene import fold_fcc_sim, rotate_sim, sort_sim
from pffdtd_tpu_torch.scene_setup import pack_mats, sim_setup_from_room

BASELINE_MVPS = 52512.6


def mv_sim(ref=REF, fmax=2000.0, nt=100, fcc=True, mats=MV_MATS):
    """The hall's sim data in memory, rotated, folded (FCC) and sorted,
    for nt steps.  mats: as ctk_cart_rir.rir's."""
    model, mat_folder = model_inputs(ref, MV_MODEL)
    t0 = time.time()
    rg = RoomGeo(model)
    keep = [r for r in rg.Rxyz
            if np.linalg.norm(rg.tris_pre.cent - r, axis=-1).min() > 0.6]
    rg.Rxyz = np.asarray(keep if keep else rg.Sxyz[:1] + 2.0)
    sim = sim_setup_from_room(
        rg, pack_mats(rg.mat_str, mats, mat_folder), duration=nt * 1e-4,
        insig_type="impulse", diff_source=True, fmax=fmax,
        PPW=5.6 if fcc else 7.75, fcc_flag=fcc, check_adj=False)
    sim = rotate_sim(sim)
    sim = sort_sim(fold_fcc_sim(sim) if fcc else sim)
    v = sim.vox
    print(f"setup {time.time() - t0:.1f}s: grid {v.Nx}x{v.Ny}x{v.Nz} = "
          f"{v.Nx * v.Ny * v.Nz / 1e6:.0f} Mvox, Nb={v.Nb}", file=sys.stderr)
    return sim


def bench(ref=REF, fmax=2000.0, nt=100, fcc=True, device="cuda",
          mats=MV_MATS) -> dict:
    """Set up the hall in memory, run nt fp32 steps twice; returns the
    JSON record of the second run.  mats: as ctk_cart_rir.rir's."""
    dev = check_device(device)
    sim = mv_sim(ref, fmax, nt, fcc, mats)
    eng = TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, dtype=np.float32, device=device)
    nt = min(nt, eng.Nt)
    eng.run(nt=nt, verbose=False)   # warm-up
    eng.run(nt=nt, verbose=False)   # timed
    if not np.isfinite(eng.u_out).all():
        raise FloatingPointError("u_out is not finite")
    return {
        "metric": f"mv_{'fcc' if fcc else 'cart'}_fmax{int(fmax)}",
        "value": round(eng.mvps, 1),
        "unit": "Mvox/s",
        "vs_baseline": round(eng.mvps / BASELINE_MVPS, 4),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fmax", nargs="?", type=float, default=2000.0)
    ap.add_argument("nt", nargs="?", type=int, default=100)
    ap.add_argument("fcc", nargs="?", default="1", choices=["0", "1"])
    ap.add_argument("--ref", default=REF,
                    help="the reference data folder (models/, materials/)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.ref, args.fmax, args.nt, args.fcc == "1",
                           args.device)))


if __name__ == "__main__":
    main()
