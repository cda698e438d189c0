"""Each axis of a scene on z, measured on the card: the data behind
`scene.orientation_scores` (the counterpart of probes/mv_orient.py).

    python -m pffdtd_tpu_torch.probes.orient [--scenes a,b]
        [--nt 128] [--out FILE]

Scenes (`SCENES`), each built once unrotated:
- `headline`: the bench's 36 x 28 x 23 m lossy FCC box at h = 0.046
  (`DEF11`), its receivers 1.6 and 2.1 m from the source;
- `hall`: chip_smoke.py phase 7's 36 x 28 m hall, its ceiling rising from
  17 to 23 m along y, two fitted materials, FCC at h = 0.046, voxelized
  by the native voxelizer;
- `shoebox`: a 49 x 19 x 18 m Cartesian box, lossy with `DEF11`, at h =
  0.046 (1074 x 422 x 400 = 181.3 Mvox): the outer proportions of a
  shoebox concert hall;
- `box_1e9`: setup_1e9's 32 x 25 x 20 m box, Cartesian at h = 0.025
  (1288 x 1008 x 808 = 1.049 Gvox), lossy with `DEF11`: the step route
  only;
- `cart_cell`: the room of the benchmark's Cartesian cell
  (`rirbench/configs/cart_lossy_box.json`), a 30.0 x 23.4 x 19.2 m box at
  h = 343.2 / (1,900 x 7.75) m (1296 x 1012 x 832 = 1.0912e9 points),
  lossy with `DEF11`: the step route only.
For each axis k on z, the grid is permuted as `rotate_sim` permutes it
(`scene.tr_for`: the longer of the other two axes on x), FCC grids are then
folded, and the nodes sorted.  Printed, one `ORIENT {json}` line a
candidate: the permutation, the grid, K1's lane fill along z, the
boundary's cut legs per axis of the rotated grid
(`scene.boundary_face_counts`), its lossy nodes and those on walls normal
to z, the score of `scene.orientation_scores`; K1 and K2 ms (CUDA
events: 3 windows of 20 calls each from a seeded random state, every
window and the best); the step route's MVPS over `--nt` fp32 steps (every
run of 3 after a warm-up, and the best); the tb route's (TB = 3) the same,
with its `plan_tiles` tile; and the receivers against the first
candidate's (the same points, in their order before sorting) and the tb
route's against the step route's, each required within 1e-5 of max
|u_out|.  After a scene's candidates, the first is run again on the step
route (`repeat`), which measures the spread across engine builds.  Then the
rule's scores and choice for the scene (`RULE {json}`).  The first line
printed is the card's name and power limit; with `--out`, the record
also goes to that JSON file.
Raises without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from pffdtd_tpu_torch.bench import rel_err
from pffdtd_tpu_torch.consts import SimConsts
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.kernels.boundary import boundary_update
from pffdtd_tpu_torch.kernels.stencil import stencil_step
from pffdtd_tpu_torch.kernels.stream import time_ms
from pffdtd_tpu_torch.voxelizer.vox import NEIGHBOR_VECTORS
from pffdtd_tpu_torch.scene import (DEF11, LANES, boundary_face_counts,
                                    fold_fcc_sim, headline_rxyz,
                                    make_sloped_room, mats_from_DEF_list,
                                    orientation_scores, rotate_sim,
                                    rotation_of, sort_sim, synthetic_box_sim,
                                    tr_for)

SEED = 0
REPS, WINDOWS, RUNS = 20, 3, 3
# (Lx, Ly, Lz, h) of the analytic boxes
HEADLINE = (36.0, 28.0, 23.0, 0.046)
SHOEBOX = (49.0, 19.0, 18.0, 0.046)
BOX_1E9 = (32.0, 25.0, 20.0, 0.025)
CART_CELL = (30.0, 23.4, 19.2, 343.2 / (1900.0 * 7.75))
# chip_smoke.py phase 7's sloped hall (Lx, Ly, ceiling at y = 0, at y =
# Ly, h), its receivers' offsets from the source, its materials' octave
# absorptions
HALL = (36.0, 28.0, 17.0, 23.0, 0.046)
HALL_RXYZ = np.array([[1.0, -0.8, 0.6], [-0.9, 1.0, -0.6]])
WALLS_SABS = np.linspace(0.05, 0.30, 11)
FLOOR_SABS = np.linspace(0.02, 0.10, 11)
STEP_ONLY = ("box_1e9", "cart_cell")


def box_scene(dims, nt, fcc):
    """A lossy analytic box (`DEF11`), unrotated, its receivers 1.6 and
    2.1 m from its source."""
    Lx, Ly, Lz, h = dims
    return synthetic_box_sim(Lx, Ly, Lz, h=h, Nt=nt, fcc=fcc, lossy=True,
                             insig_type="impulse", DEF=DEF11,
                             Rxyz=headline_rxyz(Lx, Ly, Lz))


def hall_scene(nt, hall=HALL):
    """The sloped hall, unrotated, set up by the port with the native
    voxelizer."""
    from pffdtd_tpu_torch.materials import fit_to_Sabs_oct_11
    from pffdtd_tpu_torch.scene_setup import sim_setup_from_room

    Lx, Ly, Lz1, Lz2, h = hall
    mats = mats_from_DEF_list([fit_to_Sabs_oct_11(FLOOR_SABS),
                               fit_to_Sabs_oct_11(WALLS_SABS)])
    src = np.array([0.45 * Lx, 0.55 * Ly, 0.5 * Lz1])
    return sim_setup_from_room(
        make_sloped_room(Lx, Ly, Lz1, Lz2, src, src + HALL_RXYZ), mats,
        duration=nt * SimConsts(h=h, fcc=True).Ts, insig_type="impulse",
        h=h, fcc_flag=True, diff_source=True, vox_backend="native",
        check_adj=False)


SCENES = {
    "headline": lambda nt: box_scene(HEADLINE, nt, True),
    "hall": hall_scene,
    "shoebox": lambda nt: box_scene(SHOEBOX, nt, False),
    "box_1e9": lambda nt: box_scene(BOX_1E9, nt, False),
    "cart_cell": lambda nt: box_scene(CART_CELL, nt, False),
}


def prepare(sim, tr):
    """The scene permuted by `tr`, folded when FCC, sorted."""
    sim = rotate_sim(sim, tr=tr)
    if sim.consts.fcc_flag == 1:
        sim = fold_fcc_sim(sim)
    return sort_sim(sim)


def lane_fill(Nz: int) -> float:
    """Interior z points over K1's lanes along z (blocks of LANES)."""
    return (Nz - 2) / (-(-(Nz - 2) // LANES) * LANES)


def layout(sim) -> dict:
    """What the cost model reads of a prepared grid: its shape, K1's lane
    fill, cut legs per axis, its lossy nodes and those on a wall normal
    to z (their cut legs span z at least as much as x or y)."""
    v = sim.vox
    lossy = np.asarray(v.mat_bn) >= 0
    per_axis = ~np.asarray(v.adj_bn, bool)[lossy] @ np.abs(
        NEIGHBOR_VECTORS[v.NN])
    z = per_axis[:, 2]
    z_normal = (z > 0) & (z >= per_axis[:, :2].max(1))
    return {"grid": [v.Nx, v.Ny, v.Nz], "lane_fill": lane_fill(v.Nz),
            "faces": boundary_face_counts(v).tolist(),
            "nbl": int(lossy.sum()), "nbl_z": int(z_normal.sum())}


def kernel_ms(eng, gen) -> dict:
    """K1 and K2 on `eng`'s grid and nodes from a seeded random state:
    {name: [ms a call of each window]}."""
    d = eng.data
    r = lambda *s: torch.randn(s, generator=gen, device="cuda",
                               dtype=eng.dtype)
    u0, u1, out = r(*d.grid.shape), r(*d.grid.shape), r(*d.grid.shape)
    vh, gh = r(MMb, d.Nbl), r(MMb, d.Nbl)
    k2 = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    calls = {"K1": lambda: stencil_step(u0, u1, eng.adj, out, d.grid, d.sc),
             "K2": lambda: boundary_update(out, u0, *k2, vh, gh, d.sc,
                                           eng.abcq)}
    return {k: [time_ms(f, REPS) for _ in range(WINDOWS)]
            for k, f in calls.items()}


def route_runs(eng, nt) -> tuple:
    """(MVPS of each of RUNS runs of nt steps after a warm-up, u_out)."""
    g = eng.data.grid
    npts = g.Nx * g.Ny * g.Nz
    eng.run(nt=min(nt, 8), verbose=False)
    mvps = []
    for _ in range(RUNS):
        u = eng.run(nt=nt, verbose=False)
        mvps.append(npts * nt / eng.elapsed / 1e6)
    return mvps, u


def engine(sim, **kw):
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=np.float32, device="cuda", **kw)


def receivers(sim, u_out):
    """u_out's rows in the order of the scene's receiver points before
    `sort_sim`: the same rows whatever the permutation."""
    return u_out[sim.comms.out_reorder]


def probe_scene(name, nt, gen) -> list:
    """Every candidate of scene `name`: a list of records."""
    t0 = time.perf_counter()
    sim = SCENES[name](nt)
    v = sim.vox
    N, fcc = (v.Nx, v.Ny, v.Nz), int(sim.consts.fcc_flag)
    faces = boundary_face_counts(v)
    lossy = bool(np.any(np.asarray(v.mat_bn) >= 0))
    score = orientation_scores(N, faces, fcc, lossy)
    print(f"[{name}] unrotated {N}, fcc {fcc}, Nb {v.Nb}, cut legs "
          f"{faces.tolist()}; setup {time.perf_counter() - t0:.2f} s",
          flush=True)
    recs, first = [], None
    for k in range(3):
        if not np.isfinite(score[k]):
            continue
        tr = tr_for(N, k, fcc)
        ps = prepare(sim, tr)
        rec = {"scene": name, "z_axis": k, "tr": list(tr), **layout(ps),
               "score_ns": score[k]}
        eng = engine(ps)
        rec["ms"] = kernel_ms(eng, gen)
        rec["step_mvps"], u = route_runs(eng, nt)
        del eng
        torch.cuda.empty_cache()
        rx = receivers(ps, u)
        if first is None:
            first = (ps, rx)
        rec["rx_vs_first"] = rel_err(rx, first[1])
        if name not in STEP_ONLY:
            eng = engine(ps, backend="tb", tb=3)
            lists = eng.tb_scene.lists
            rec["tb_tile"] = [list(lists.box), list(lists.ntiles)]
            rec["tb_mvps"], ut = route_runs(eng, nt)
            rec["tb_vs_step"] = rel_err(ut, u)
            del eng
            torch.cuda.empty_cache()
        if max(rec["rx_vs_first"], rec.get("tb_vs_step", 0.0)) > 1e-5:
            raise SystemExit(f"{name}, axis {k} on z: receivers disagree"
                             f" ({rec['rx_vs_first']}, "
                             f"{rec.get('tb_vs_step')})")
        print("ORIENT " + json.dumps(rec), flush=True)
        recs.append(rec)
    eng = engine(first[0])
    rep, _ = route_runs(eng, nt)
    del eng
    torch.cuda.empty_cache()
    recs[0]["repeat_step_mvps"] = rep
    rule = {"scene": name, "N": list(N), "fcc": fcc, "score_ns": score,
            "auto_tr": list(rotation_of(sim)),
            "descending_tr": list(rotation_of(sim, "descending")),
            "seconds": time.perf_counter() - t0}
    print(f"[{name}] repeat of z axis {recs[0]['z_axis']}: step MVPS {rep}",
          flush=True)
    print("RULE " + json.dumps(rule), flush=True)
    return recs + [rule]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--out", type=Path, help="a JSON file for the record")
    a = ap.parse_args(argv)
    names = a.scenes.split(",")
    if not set(names) <= set(SCENES):
        raise SystemExit(f"--scenes: of {sorted(SCENES)}")
    if not torch.cuda.is_available():
        raise SystemExit("the orientation probe measures on an NVIDIA card "
                         "only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = _build.library()
    print(f"built {lib.path.name} in {lib.build_seconds:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"card": card, "nt": a.nt, "records": []}
    for name in names:
        out["records"] += probe_scene(name, a.nt, gen)
        if a.out:
            a.out.parent.mkdir(parents=True, exist_ok=True)
            a.out.write_text(json.dumps(out, indent=1))
    print(card)


if __name__ == "__main__":
    main()
