#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pffdtd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # one card, every phase (1-10)
    python3 chip_smoke.py --cards    # the x-slab path, one slab per card (4)

Phases, each fatal on failure (no CPU fallback; exit code != 0):
1. Device and build: the card's name and power limit (nvidia-smi), then the
   build of the CUDA kernels K1, K5 and K1e (csrc/stencil.cu), K2
   (csrc/boundary.cu), K3 (csrc/tb.cu), K6 (csrc/tb.cu through
   csrc/tb_shard.cu), K4 (csrc/stream.cu), K7 (csrc/energy.cu) and K8
   (csrc/modal.cu) from this checkout's sources, one nvcc per source, all
   started together.
   K4, the streaming probe, is held against PyTorch's sum, fill_ and copy_
   and timed at 64 MB, 512 MB and 2 GB: GB/s per mode beside PyTorch's,
   each the median of 5 windows of 20 calls, the two alternating.  The
   roof of every bound below is the faster of K4's copy and copy_.
2. Per-kernel checks at the main path's shapes, from a seeded random state:
   each kernel vs its plain PyTorch version on the card, one call each.
   K1 and K2: fp32 max relative error <= 1e-6 (one call differs at most by
   summation order: the kernels are built without FMA contraction; K2's
   plain version adds the branches in the kernel's order, so K2 reads 0).  K2's
   time at the headline (no lossy node on an ABC layer: K2 as it was)
   beside its time before the ABC mode (PERF.md's kernel table).  The ABC
   modes on the headline box without its top wall (its side walls' lossy
   nodes reach the top ABC layer), each timed beside the kernel without the
   mode on the same inputs (K3 and K6 in turns: without, ABC mode, ABC
   mode, without, twice): K2 and K3 (TB = 3) bitwise equal to their plain
   versions, K6 (TB = 3, slab 1 of 4) <= 1e-5 of each output's largest
   magnitude.  K3, one
   sweep of every TB = 2..8 (fields, vh/gh, taps): <= 1e-5 of the largest
   magnitude of each output, each timed (ms per sweep and per step: the
   TB scan; TB = 2 and 3 over 20 sweeps, the deeper ones over 3).  K1e,
   K1's energy mode (the step and K7's grid half in one launch), then K7's
   boundary pass (the energy terms), against their plain versions:
   u^{n+1} and L u^n bitwise equal; H, dE_lost and dE_in no further from
   their fp64 value (the fp64 plain versions on the same inputs with the
   fp32 run's constants) than the fp32 plain versions' (K1e and K7 sum in
   fp64 and must not be less accurate than what they replace); K1e timed
   in turns with K1 on the same inputs, K7's boundary pass timed.  Then
   fp64 on the small scenes of phase 3 (K3 at TB = 2, 3 and 8; K1e and K7,
   every output), <= 1e-12.  Kernels and plain versions are timed with
   CUDA events.
   K5 and K6, the shard modes (in phase 5, on the engines it builds): K5 vs
   its plain version on the first, a middle and the last slab of the D = 4
   split, <= 1e-6; K6 with TB = 2 and 3 on the same slabs (fields, owned
   vh/gh, taps), <= 1e-5 of each output's largest magnitude; then fp64 on
   the small scenes at D = 2, <= 1e-12.
3. Small scenes, fp64, kernels vs plain versions.  First two open-top lossy
   boxes, Cartesian and folded FCC, whose lossy nodes reach the top ABC
   layer: K1 and K2 (its ABC mode) vs their plain versions <= 1e-12 and K2
   bitwise, the step route vs the plain path and the x-slab step route at
   D = 2 vs the single device on the same padded grid <= 1e-12 (64 steps),
   launches checked; K3 in its ABC mode at TB = 2, 3 and 8 and K6 at TB =
   2 and 3 (both slabs of D = 2), one sweep each from a random state,
   bitwise equal to their plain versions; the tb (TB = 3 and 8) and pair
   routes' receivers bitwise equal to the step route's, the x-slab tb and
   pair routes' to the single device's step route on the padded grid,
   launches checked; the energy route (K1e + K2's ABC mode + K7) with
   launches checked, its H_tot, E_lost and E_in <= 1e-12 of their largest
   magnitude against its plain path and its receivers bitwise equal to the
   energy-off run, its balance printed and not held under 1e-10 (the
   reference's functional has no term for a lossy node on an ABC layer).
   Then a lossy
   Cartesian box and a lossy FCC box, unfolded and folded.  The single-step route, and the
   TB = 3 and pair (TB = 2) routes over 29 steps (not a multiple of TB, so
   the tail steps run), vs the plain single-step path: receivers <= 1e-12;
   the same three routes of the sharded engine at D = 2 (K5, K6), vs the
   plain path on the same padded grid, <= 1e-12.  Then the same scenes with
   the diagonal shift set by hand (fp32_eps = 1e-3; fp64 takes 0 unless
   told): the step, tb (TB = 3), pair and energy routes and the x-slab step
   route at D = 2, launches checked, vs the plain path with the same shift
   (on the padded grid for the slabs) <= 1e-12, the energies <= 1e-12 of
   their largest magnitude, the balance printed (the functional keeps l2
   unshifted: it does not close); the plain path at 1e-3 more than 1e-9 of
   max |u_out| off its run at 0.
4. The main path at full size: the bench's headline scene, a lossy folded-FCC
   box of 36 x 28 x 23 m at h = 0.046 (11-branch material), rotated
   "descending", folded and sorted: a 792 x 310 x 510 grid, about 125 Mvox,
   128 fp32 steps through TorchEngine(device="cuda"), best of 3 per route:
   backend="tb" (TB = 3: 42 K3 sweeps + 2 single steps), backend="pair"
   (64 K3 sweeps) and backend="step" (128 K1 + K2 steps), each with its
   launch counts checked; then the plain path, whose receivers every route
   must match to <= 1e-5 of max |u_out|.  Two receivers sit 1.6 m from the
   source: the bench's default positions lie beyond the 5.9 m that 128 steps
   can reach, and would read exact zeros.  Then the headline box without
   its top wall (phase 2's) on the tb route (TB = 3: 42 K3 sweeps in the
   ABC mode + 2 single steps) and on the step route, launches checked,
   receivers bitwise equal.  The dashboard's air / boundary split on the
   step route: 128 steps in chunks of 32, quiet and verbose, each with its
   device peak memory over what was allocated before it; the verbose run's
   progress lines carry the split (printed), its launches are K1 128 and
   K2 128 plus the probe's warm launch and 30 timed ones, its receivers and
   final state are bitwise the quiet run's and the one-chunk run's, and
   `bn_ms_per_step` is within a factor of 1.5 of phase 2's K2 time.  Then
   the probe once more on the final state, its own peak memory over what
   was allocated before it printed beside vh's and gh's bytes (and the
   verbose run's peak over the quiet run's).
5. The x-slab path at full size: the headline scene through
   make_sharded_engine with every slab on cuda:0 (the halo exchange is then
   a copy on the card): D = 4 on the step, pair and tb (TB = 3) routes and
   D = 2 on the step route, 128 fp32 steps, best of 3, launch counts
   checked per run (K5 4 x 128 on step; K6 4 x 42 plus 4 x 2 tail steps of
   K5 + K2 on tb).  Receivers vs the single-device engine on the same
   padded grid and route <= 1e-5 of max |u_out| (bitwise equality is
   printed, and expected).  Printed per run: MVPS, frac (the ratio to the
   single-device rate of the same route on the same grid), the exchange
   time per step (CUDA events around the copies, one extra run) and the
   engine's peak device memory.  Each engine is freed before the next.
6. Energy accounting, checkpoint/resume, the per-chunk hook and the modal
   filter: (a) the small fp64 scenes with energy on (K1e + K2 + K7's
   boundary pass a step, launch counts checked: no K1): balance < 1e-10,
   E_lost[-1] > 0, H_tot, E_lost and E_in <= 1e-12 of their largest
   magnitude against the plain path on the card, receivers bitwise equal
   to the energy-off run; (b) the headline scene with energy on, 128 steps
   in fp32 (receivers bitwise equal to phase 4's step route, 128 K1e, 128
   K2 and 128 K7 launches) and in fp64 (balance < 1e-9, the JAX package's
   bar for a real room), each with its peak device memory, then three more
   runs of it: every run bitwise equal to the first (receivers, energies,
   final fields), launches checked per run, MVPS and ms a step, best of 3,
   beside the step route's (fp64: its own run); the whole fp32 energy
   step's bound (each input read and each output written once) beside the
   route's ms a step; then 384 fp64 steps
   (the source sits 11.5 m from the floor and the ceiling, about 250 steps
   of one h): balance < 1e-9, and E_lost grows from step 240 to 384 by
   more than its value at step 240; a checkpoint of the
   fp32 step route at headline size written and resumed (seconds, GB,
   receivers bitwise equal); (c) on the folded FCC scene in fp64, the step,
   tb (TB = 3), pair and energy routes run to step 23 in chunks of 5 with a
   checkpoint every 2 (step 23 on the TB routes: no multiple of TB), then
   resumed in a fresh engine to 29: receivers (and energies) bitwise equal
   to the uninterrupted run; (d) in those resumed runs a hook records the
   steps it sees, which must be the chunk ends; (e) the modal air-absorption
   filter: K8 against its numpy loop (`modal_recurrence_plain`) and
   against its design's plain version on the card (`modal_split_plain`)
   <= 1e-12 relative, its loop modes (q < q0, q >= Nt - q0) bitwise equal
   to the numpy loop, whole-array bitwise equality printed, on the headline
   receivers padded to 4,800 samples; then on 2 x 48,000 samples (1 s at
   48 kHz) `apply_modal_filter` end to end (host clock, one K8 launch
   checked), and K8 alone (CUDA events) beside its plain version on the
   card (<= 1e-12, loop modes bitwise), with q0 and K8's share of two
   bounds: the loop's operations and the split's (operations and fp64
   issue slots); and K8's entry point timed at other splits, q0 = Nt (every
   mode on the loop: the previous design) down to q0 = 1.  The checkpoints
   go to a temporary directory inside the checkout, removed after use.
7. Room to receivers with the port alone: two materials fitted with
   fit_to_Sabs_oct_11 (walls 0.05..0.30, floor 0.02..0.10, no file
   written), a 36 x 28 m hall whose ceiling rises from 17 m to 23 m along y
   (`scene.make_sloped_room`, the sloped room of tests/test_pallas_pair.py
   scaled up) set up by sim_setup_from_room at h = 0.046, FCC, with the
   native voxelizer (built by g++ into pffdtd_tpu_torch/_build/) and
   check_adj_full, then rotated "descending", folded and sorted: 792 x 310
   x 510, the headline's grid.  Host seconds per stage (fit, g++ build,
   voxelize and its parts, check_adj_full, comms, clash check, prep,
   engine build), Nb, Nbl and the process's peak RSS are printed.  K1, K2
   and K3 (TB = 3) at the hall's shapes against their plain versions (as
   in phase 2), timed.  128 fp32 steps on the step route (K1 + K2, launch
   counts checked, MVPS beside phase 4's box) vs the plain path, and on
   the tb route at TB = 3 (K3) vs the step route, each <= 1e-5 of max
   |u_out| (bitwise equality printed).  Then a 4 x 3 m hall with a 1.9 to
   2.5 m ceiling at h = 0.1: the numpy and native voxelizers give equal
   bn_ixyz, adj_bn, mat_bn and saf_bn, cart and FCC; cart and folded FCC
   in fp64 with energy on (K1 + K2) and on the tb route (K3) against the
   port's NumpyEngine on the host <= 1e-12 of each series' largest
   magnitude, balance < 1e-10, E_lost[-1] > 0 (K1e + K2 + K7 a step).
8. A billion voxels: `python -m pffdtd_tpu_torch.examples.setup_1e9
   --check` in a subprocess (host memory of its own; a nonzero exit
   fails the phase), the 32 x 25 x 20 m box at h = 0.025 (1288 x 1008 x
   808 = 1.049 Gvox, Cartesian, one lossy material) set up by the port
   with the native voxelizer and check_adj_full, then 30 ms (715 fp32
   steps, the best of two runs) on the step route (K1 + K2), the tb route
   (K3, TB = 3) and four x-slabs on this card (K5 + K2), each engine
   freed before the next; each kernel against its plain version at these
   shapes where the check fits the card's free memory; then one fp64 run
   of the energy route (K1e + K2 + K7) on the same setup: balance < 1e-9,
   its ms a step, MVPS, peak device memory beside its arrays' reckoned
   size and the seconds it adds (no plain check: the plain passes would
   not fit the card).  Printed: the grid, Nb and Nbl, host seconds per
   setup stage and the peak RSS, each route's MVPS, ms a step, device
   peak memory and launches (checked against the steps), and the
   receivers of tb and x4 against step (<= 1e-5 of max |u_out|, finite,
   nonzero; the fp64 energy route's difference printed).  The launches of its K1, K2, K3 and K5 and their times a
   call in the checks go into the kernels' record as `launches_1e9` and
   `ms_1e9`.
9. The bench: `python -m pffdtd_tpu_torch.bench` in a subprocess of its
   own session (a timeout kills it and its item processes) with
   BENCH_SKIP=fcc_lossy_1e9,cart_rigid_1e9,mv_fcc_lossy (phase 8 covers
   10^9 voxels; the Musikverein hall is not in the repository) and its
   default budget, which skips nothing else.  Required: exit code 0, a last
   line that parses as JSON, the metric voxel_update_rate_fp32_fcc_lossy
   with a value > 0 and no headline_note, the card as its device (name,
   power limit, count 1), every key of the items it ran, both
   *_vs_single_err < 1e-4, kernel_vs_energy_route_err <= 1e-5, both drift
   ratios finite and the lossy one <= 1.  The launches of each engine run
   of each item (the bench sets the counts to 0 just before each run and
   writes them to stderr): every item that ran handed them back, each run
   on the route, TB and slab count its item sets (BENCH_RUNS), and each
   launched exactly what its route must for its steps (K1 and K2 a step,
   K3 a sweep, K5 and K6 on x-slabs, K1e + K2 + K7 on the energy route, K2
   only on lossy scenes; `bench_want`), the open-top items with lossy
   nodes on an ABC layer (K2's ABC mode) and no other item with any, the
   roof K4 alone; over the bench, K1-K7 and K1e each launched.  Its line,
   its seconds and its launches are printed; each kernel's total goes into
   the kernels' record as `launches_bench`.
10. orient="auto" (`scene.rotate_sim`'s default, the port's rule
   `scene.orientation_scores`): on the 49 x 19 x 18 m Cartesian shoebox
   hall (h = 0.046, 1074 x 422 x 400 = 181.3 Mvox, lossy with DEF11) and
   the headline box, both `probes.orient`'s scenes, the rule's
   scores, its choice and the lane fill of each axis on z are printed.
   The shoebox (and the headline, where "auto" is not "descending") runs
   128 fp32 steps on the step route rotated by "auto" and by "descending",
   folded where FCC and sorted, best of 3, launches checked (K1 and K2 a
   step), the MVPS of both printed with the card; the receivers, in the
   points' order before sorting, agree within 1e-5 of max |u_out| (the
   same points, another summation order).  On "auto"'s layout K1 and K2
   are bitwise equal to their plain versions (`kernel_checks`), and the
   tb route (TB = 3, launches checked) within 1e-5 of its step route.
   Each kernel's launches in these runs go into the kernels' record as
   `launches_orient`.
The run's total seconds are printed before the card's line.  The last
two lines are the kernels' JSON record (the rows of K2, K3 and K6
carry their ABC modes' times on the open-top headline box, beside the
kernel without the mode, bound and launches under "abc_mode") and
{"ok": true, "device": {...}}.  The work sits under `__main__`, so importing
this file runs nothing.

`--cards` needs four cards and runs the x-slab path with one slab per card,
`devices=["cuda:0", ..., "cuda:{D-1}"]`, each configuration beside the
same slabs all on cuda:0 (receivers and final state bitwise equal
required) and the single-device engine on the padded grid; every check is
run and printed, and the run fails at its end if any failed:
- the cards' names and power limits, and peer access between the cards of
  neighbouring slabs (`torch.cuda.can_device_access_peer`, both ways);
- the headline box, closed at D = 2 and 4 and open at the top at D = 4,
  on the step, pair and tb (TB = 3) routes, 128 fp32 steps, best of 3,
  launches checked: receivers within 1e-5 of the single device's (bitwise
  equality printed), MVPS and frac (over the single device's on the same
  padded grid), each card's exchange ms a step (`exchange_ms_by_card`: the
  copies it sends and receives and its waits for the neighbours' planes),
  each card's peak memory (the engine's own) and each card's kernel and
  copy time in one run under torch.profiler; at D = 4, K5 (step) or K6
  (TB = 2, 3; in its ABC mode on the open box) on every slab's live state
  after the run, on its card, bitwise equal to its plain version, and on
  the closed box slab 1 timed on cuda:1 and on cuda:0 (the same slab of
  the one-card engine, the same live state), in turns;
- phase 3's fp64 scenes (Cartesian and folded FCC, closed and open at the
  top) at D = 2 and 4 on every route (padded with exterior air where a
  slab would hold fewer than 2 TB rows): within 1e-12 of the single
  device's kernel path, launches checked;
- `TorchEngine` on cuda:1 (step, tb, pair and energy routes of the
  open-top Cartesian box, fp64) bitwise equal to its run on cuda:0;
- `python -m pffdtd_tpu_torch.examples.setup_1e9 --check --routes step,x4
  --devices cuda:0,cuda:1,cuda:2,cuda:3` in a subprocess: the 1.049 Gvox
  box's x4 route with one slab per card within 1e-5 of the step route on
  one card, K5 held to its plain version on shards[1] (cuda:1), setup
  seconds, each card's peak memory, MVPS.
Its last lines: a JSON record of every configuration (`{"cards": ...}`),
the cards' names and power limits, and `{"ok": true, ...}` with the card
count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import re
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from pffdtd_tpu_torch import spans
from pffdtd_tpu_torch.analysis.air_abs import (_modal_setup,
                                               apply_modal_filter,
                                               apply_modal_filter_plain,
                                               modal_recurrence,
                                               modal_recurrence_plain)
from pffdtd_tpu_torch.consts import SimConsts
from pffdtd_tpu_torch.engine.energy import EnergyScene
from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
from pffdtd_tpu_torch.bench import METRIC as BENCH_METRIC, rel_err
from pffdtd_tpu_torch.engine.torch_engine import (BN_ITERS, TorchEngine,
                                                pick_route)
from pffdtd_tpu_torch.examples.setup_1e9 import (CHECK_TOL, peak_rss_gb,
                                                 stage_seconds)
from pffdtd_tpu_torch.io.simdata import MMb
from pffdtd_tpu_torch.kernels import WRAPPERS, _build
from pffdtd_tpu_torch.kernels.boundary import boundary_update, \
    boundary_update_plain
from pffdtd_tpu_torch.kernels.energy import (GRID_THREADS,
                                             energy_boundary_pass,
                                             energy_boundary_pass_plain,
                                             scratch_size, shell_points)
from pffdtd_tpu_torch.kernels.modal import (loop_modes, modal_scan,
                                            modal_scan_plain,
                                            modal_split_plain, serial_modes)
from pffdtd_tpu_torch.kernels.stencil import (CompactAdj, adj_bytes,
                                              stencil_energy_step,
                                              stencil_energy_step_plain,
                                              stencil_step,
                                              stencil_step_plain,
                                              stencil_step_shard,
                                              stencil_step_shard_plain)
from pffdtd_tpu_torch.kernels.stream import (measure, stream, stream_plain,
                                             time_ms)
from pffdtd_tpu_torch.kernels.tb import (TBScene, tb_sweep, tb_sweep_plain,
                                         tb_sweep_shard, tb_sweep_shard_plain,
                                         tile_threads)
from pffdtd_tpu_torch.materials import fit_to_Sabs_oct_11
from pffdtd_tpu_torch.parallel.sharded_engine import make_sharded_engine
from pffdtd_tpu_torch.probes import orient as orient_probe
from pffdtd_tpu_torch.probes.orient import (FLOOR_SABS, HALL, HALL_RXYZ,
                                            WALLS_SABS, lane_fill)
from pffdtd_tpu_torch.scene import (DEF11, boundary_face_counts,
                                    fold_fcc_sim, headline_rxyz,
                                    make_sloped_room, mats_from_DEF_list,
                                    orientation_scores, pad_x_interior,
                                    rotate_sim, rotation_of, sort_sim,
                                    synthetic_box_sim)
from pffdtd_tpu_torch.scene_setup import sim_setup_from_room
from pffdtd_tpu_torch.voxelizer import native

SEED = 0
NT = 128
# phase 3: the diagonal shift set by hand
EPS_SET = 1e-3
# phase 4: the split's probe, K2 timed over BN_ITERS launches after one
# warm launch, within BN_FACTOR of phase 2's K2
BN_FACTOR = 1.5
NT_SMALL = 29
HEADLINE = (36.0, 28.0, 23.0, 0.046)
SMALL = {  # name: (box, h, fcc, fold, Nt), the scenes of test_pallas_stencil
    "cart": ((2.5, 2.0, 1.6), 0.1, False, False, 40),
    "fcc": ((2.2, 1.8, 1.5), 0.12, True, False, 30),
    "fcc_folded": ((2.2, 1.8, 1.5), 0.12, True, True, 30),
}
# phase 3: open-top lossy boxes, whose side walls' lossy nodes reach the
# top ABC layer (K2's ABC mode); as SMALL
OPEN_SMALL = {
    "cart_open": ((1.2, 1.0, 0.9), 0.08, False, False, 64),
    "fcc_folded_open": ((1.2, 1.0, 0.9), 0.1, True, True, 64),
}
# phase 2: K2 at the headline before its ABC mode (PERF.md's kernel table;
# H100 80GB HBM3, 700 W)
K2_PARENT_MS = 0.1320
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
    "K5 stencil_step_shard": (SRC + "stencil.cu",
                              "pffdtd_tpu/engine/pallas_stencil.py:436"),
    "K6 tb_sweep_shard": (SRC + "tb.cu",
                          "pffdtd_tpu/engine/pallas_pair.py:212"),
    "K7 energy_terms": (SRC + "energy.cu",
                        "pffdtd_tpu/engine/jax_engine.py:704"),
    "K8 modal_recurrence": (SRC + "modal.cu",
                            "pffdtd_tpu/analysis/air_abs.py:157"),
    "K1e stencil_energy_step": (SRC + "stencil.cu",
                                "pffdtd_tpu/engine/jax_engine.py:704"),
}
ZERO = (0,) * len(WRAPPERS)
# phase 6b: the headline energy runs, and the long fp64 one that reaches
# the floor and the ceiling (11.5 m from the source: about 250 steps of
# one h) and the step it is read at before them
NT_LONG, N_WALLS = 384, 240
# phase 6e: the modal filter's lengths (samples a channel) and rate
MODAL_CHECK, MODAL_TIMED, FS = 4800, 48000, 48000.0
FP64_ROWS = {"K8 modal_recurrence"}     # bound at the fp64 peak
# phase 7: the sloped hall is probes.orient's `HALL` (its receivers
# 1.4-1.5 m from the source, `HALL_RXYZ`: 128 steps reach about 5.9 m, its
# materials fitted to `WALLS_SABS` and `FLOOR_SABS`); the small hall
# checked against the NumPy oracle
HALL_SMALL = (4.0, 3.0, 1.9, 2.5, 0.1)
HALL_SMALL_SR = (np.array([2.2, 1.6, 1.0]),
                 np.array([[1.5, 1.1, 0.9], [2.9, 2.2, 1.3]]))
# phase 10: orient="auto" against "descending" (probes.orient's scenes)
ORIENT_SCENES = ("shoebox", "headline")
# phase 5: (slabs, route) on cuda:0
SHARDED = ((4, "step", {}), (4, "pair", {}), (4, "tb", {"tb": 3}),
           (2, "step", {}))
# phase 8: the grid setup_1e9 must build, its routes, and its subprocess's
# time limit
GRID_1E9 = [1288, 1008, 808]
ROUTES_1E9 = ("step", "tb", "x4", "energy")
TIMEOUT_1E9 = 900
# phase 9: the bench's items left out (phase 8 covers 10^9 voxels; the hall
# is not in the repository), the keys of the items it runs, its time limit
BENCH_SKIP = "fcc_lossy_1e9,cart_rigid_1e9,mv_fcc_lossy"
BENCH_KEYS = (
    "fcc_lossy_tb", "fcc_lossy_pair", "sharded_pair_mvps",
    "sharded_pair_vs_single_err", "sharded_pair_vs_single_frac",
    "kernel_vs_energy_route_err", "energy_balance_fp32", "energy_route_mvps",
    "fp32_vs_fp64_rir_max_db", "fcc_rigid", "cart_rigid", "cart_lossy",
    "sharded_step_mvps", "sharded_step_vs_single_err",
    "fp32_tail_to_head_rms_50k", "fp32_tail_to_head_rms_50k_lossy",
    "roof_gbps", "k4_copy_gbps", "copy__gbps")
TIMEOUT_BENCH = 800
# phase 9: each item's counted runs, {item: {tag: (route, TB, x-slabs,
# runs)}} (a timed run is a warm-up and 3 runs), and the items on the
# open-top box, whose K2 must run its ABC mode
BENCH_RUNS = {
    "fcc_lossy": {"fcc_lossy": ("step", None, 0, 4),
                  "fcc_lossy_tb": ("tb", 3, 0, 4),
                  "fcc_lossy_pair": ("tb", 2, 0, 4)},
    "sharded_pair": {"sharded_pair_single": ("tb", 2, 0, 4),
                     "sharded_pair": ("tb", 2, 1, 4)},
    "energy_pair": {"energy_pair_step": ("step", None, 0, 1),
                    "energy_pair": ("energy", None, 0, 4)},
    "fp32_spectral": {"fp32_spectral": ("step", None, 0, 1)},
    "fcc_rigid": {"fcc_rigid": ("step", None, 0, 4)},
    "cart_rigid": {"cart_rigid": ("step", None, 0, 4)},
    "cart_lossy": {"cart_lossy": ("step", None, 0, 4)},
    "sharded_pallas": {"sharded_step_single": ("step", None, 0, 4),
                       "sharded_step": ("step", None, 1, 4)},
    "fp32_drift": {"fp32_drift": ("step", None, 0, 1)},
    "fp32_drift_lossy": {"fp32_drift_lossy": ("step", None, 0, 1)},
    "roof": {"roof": ("stream", None, None, 1)},
}
BENCH_OPEN_TOP = ("fp32_spectral", "fp32_drift_lossy")
# --cards: the cards, one slab each, and the x-slab routes they run
CARDS = 4
CARD_ROUTES = (("step", {}), ("pair", {}), ("tb", {"tb": 3}))


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
    open_top = name in OPEN_SMALL
    box, h, fcc, fold, nt = (OPEN_SMALL if open_top else SMALL)[name]
    sim = synthetic_box_sim(*box, h=h, Nt=nt, fcc=fcc, lossy=True,
                            insig_type="hann10", diff_source=False,
                            open_top=open_top)
    return fold_fcc_sim(sim) if fold else sim


def headline_scene(nt, open_top=False):
    """The headline box; open_top: without its top wall (phase 2's scene
    for K2's ABC mode)."""
    Lx, Ly, Lz, h = HEADLINE
    sim = synthetic_box_sim(Lx, Ly, Lz, h=h, Nt=nt, fcc=True, lossy=True,
                            insig_type="impulse", DEF=DEF11,
                            Rxyz=headline_rxyz(Lx, Ly, Lz),
                            open_top=open_top)
    return sort_sim(fold_fcc_sim(rotate_sim(sim, orient="descending")))


def engine(sim, dtype, **kw):
    return TorchEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                       mats=sim.mats, dtype=dtype, device="cuda", **kw)


def sharded(sim, dtype, D, devices=None, **kw):
    return make_sharded_engine(consts=sim.consts, vox=sim.vox,
                               comms=sim.comms, mats=sim.mats,
                               devices=devices or ["cuda:0"] * D,
                               dtype=dtype, **kw)


def random_state(eng, gen):
    d = eng.data
    r = lambda *s: torch.randn(s, generator=gen, device=eng.device,
                               dtype=eng.dtype)
    return r(*d.grid.shape), r(*d.grid.shape), r(MMb, d.Nbl), r(MMb, d.Nbl)


def grid_adj(eng):
    """The packed adjacency grid of `eng`'s scene on its card: `eng.adj`
    where the engine holds the grid, else the grid that its compact form
    stands for (the step route's), from the engine's data."""
    if isinstance(eng.adj, CompactAdj):
        return torch.from_numpy(eng.data.adj_grid).to(eng.device)
    return eng.adj


def kernel_checks(eng, gen, timing_reps=0):
    """One call of K1 (on the engine's adjacency) and K2 vs their plain
    versions (K1's on the packed grid) from a random state.

    Returns {name: (max rel err, max abs err, kernel ms, plain ms)}."""
    d = eng.data
    g, sc = d.grid, d.sc
    u0, u1, vh, gh = random_state(eng, gen)
    adj = grid_adj(eng)
    outk, outp = torch.zeros_like(u0), torch.zeros_like(u0)
    stencil_step(u0, u1, eng.adj, outk, g, sc)
    stencil_step_plain(u0, u1, adj, outp, g, sc)
    torch.cuda.synchronize()
    inner = (slice(1, -1),) * 3
    k1 = rel(outk[inner], outp[inner])

    k2_args = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    unk, unp = outp.clone(), outp.clone()
    vhk, ghk, vhp, ghp = vh.clone(), gh.clone(), vh.clone(), gh.clone()
    boundary_update(unk, u0, *k2_args, vhk, ghk, sc, eng.abcq)
    boundary_update_plain(unp, u0, *k2_args, vhp, ghp, sc, eng.abcq)
    torch.cuda.synchronize()
    errs = [rel(unk, unp), rel(vhk, vhp), rel(ghk, ghp)]
    k2 = (max(e[0] for e in errs), max(e[1] for e in errs))

    t = {}
    if timing_reps:
        t["K1"] = (time_ms(lambda: stencil_step(u0, u1, eng.adj, outk, g, sc),
                           timing_reps),
                   time_ms(lambda: stencil_step_plain(u0, u1, adj, outp,
                                                      g, sc), 3))
        t["K2"] = (time_ms(lambda: boundary_update(unk, u0, *k2_args, vhk,
                                                   ghk, sc, eng.abcq),
                           timing_reps),
                   time_ms(lambda: boundary_update_plain(
                       unp, u0, *k2_args, vhp, ghp, sc, eng.abcq), 3))
    return {"K1": k1 + t.get("K1", (None, None)),
            "K2": k2 + t.get("K2", (None, None))}


def k2_abc_check(eng, gen, timing_reps=0):
    """One call of K2 in its ABC mode (eng.abcq: a scene with lossy nodes
    on an ABC layer) vs its plain version from a random state, required
    bitwise equal; with timing_reps, K2 timed in its ABC mode and without it
    on the same inputs.  Returns (flagged nodes, ms, plain ms, ms without
    the ABC mode), the times None without timing_reps."""
    d = eng.data
    require(eng.abcq is not None, "k2_abc_check: no node on an ABC layer")
    u0, un, vh, gh = random_state(eng, gen)
    k2_args = (eng.bnl, eng.ssaf, eng.mat, eng.coef_table, eng.beta)
    outs = []
    for k2 in (boundary_update, boundary_update_plain):
        x, v, w = un.clone(), vh.clone(), gh.clone()
        k2(x, u0, *k2_args, v, w, d.sc, eng.abcq)
        outs.append((x, v, w))
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(*outs)),
            "K2's ABC mode differs from its plain version")
    nflag = int((eng.abcq > 0).sum())
    if not timing_reps:
        return nflag, None, None, None
    x, v, w = outs[0]
    return (nflag,
            time_ms(lambda: boundary_update(x, u0, *k2_args, v, w, d.sc,
                                            eng.abcq), timing_reps),
            time_ms(lambda: boundary_update_plain(x, u0, *k2_args, v, w,
                                                  d.sc, eng.abcq), 3),
            time_ms(lambda: boundary_update(x, u0, *k2_args, v, w, d.sc),
                    timing_reps))


def sweep_buffers(u0, vh, TB, nr):
    """Zeroed outputs of one sweep: out0, out1; vh_out, gh_out; the taps."""
    o = [torch.zeros_like(u0) for _ in range(2)]
    s = [torch.zeros_like(vh) for _ in range(2)]
    taps = (torch.zeros((TB - 2, nr), dtype=u0.dtype, device=u0.device)
            if TB > 2 else None)
    return o, s, taps


ABC_TURNS = ("without", "ABC mode", "ABC mode", "without") * 2


def abc_turns(sweep, st, reps):
    """K3 or K6 in its ABC mode (`sweep(st)`, st with a Q array) and
    without it on the same inputs (st without its Q array), windows of
    `reps` sweeps taken in turns (ABC_TURNS): {mode: [ms a sweep of each
    window]}."""
    require(st.abcq is not None, "abc_turns: the scene has no Q array")
    scenes = {"ABC mode": st, "without": dataclasses.replace(st, abcq=None)}
    t = {k: [] for k in scenes}
    for k in ABC_TURNS:
        t[k].append(time_ms(lambda: sweep(scenes[k]), reps))
    return t


def tb_check(eng, gen, timing_reps=0, plain_reps=2, abc=False):
    """One K3 sweep vs tb_sweep_plain from a random state (fields, vh/gh,
    source samples).  Returns (max rel err over the outputs, max abs err,
    kernel ms, plain ms or None when plain_reps is 0); each output's error
    is relative to its own largest magnitude.  abc: the scene has a Q array,
    and `abc_turns`' windows (of timing_reps sweeps) follow as a fifth
    item."""
    st, d = eng.tb_scene, eng.data
    TB = st.TB
    u0, u1, vh, gh = random_state(eng, gen)
    sig = torch.randn((TB, d.in_ixyz.size), generator=gen,
                      device=eng.device, dtype=eng.dtype)
    nr = d.out_ixyz.size
    (ok_, sk, tk), (op, sp, tp) = (sweep_buffers(u0, vh, TB, nr)
                                   for _ in range(2))
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
                                            sig, tp), plain_reps)
             if plain_reps else None)
    r = (max(e[0] for e in errs), max(e[1] for e in errs)) + t
    if not abc:
        return r
    return r + (abc_turns(lambda sc: tb_sweep(sc, u0, u1, *ok_, vh, gh, *sk,
                                              sig, tk), st, timing_reps),)


def scene_engine(eng, TB):
    """A stand-in for `eng` (a TorchEngine with a tb scene) whose scene
    sweeps TB steps: the same device tensors, its own tile lists."""
    st = eng.tb_scene
    return SimpleNamespace(
        TB=TB, data=eng.data, device=eng.device, dtype=eng.dtype,
        tb_scene=TBScene.make(eng.data, TB, adj=st.adj, bnl=st.bnl,
                              ssaf=st.ssaf, mat=st.mat,
                              coef_table=st.coef_table, beta=st.beta,
                              in_ixyz=st.in_ixyz, out_ixyz_f=st.out_ixyz_f,
                              abcq=st.abcq))


def randn(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def k5_check(eng, gen, k, timing_reps=0, live=False):
    """One K5 call vs stencil_step_shard_plain on slab k, on the slab's
    device, from a random state or (live) from the slab's fields after the
    engine's last run; (max rel err, max abs err, kernel ms, plain ms) on
    the owned rows."""
    sh, sc = eng.shards[k], eng.data.sc
    sl, dev = sh.slab, sh.dev
    if live:
        u0, u1 = eng.states[k][:2]
    else:
        u0 = randn(gen, eng.dtype, *sl.shape).to(dev)
        u1 = randn(gen, eng.dtype, *sl.shape).to(dev)
    with torch.cuda.device(dev):     # the events and syncs of this card
        outk, outp = torch.zeros_like(u0), torch.zeros_like(u0)
        stencil_step_shard(u0, u1, sh.adj, outk, sl, sc)
        stencil_step_shard_plain(u0, u1, sh.adj, outp, sl, sc)
        torch.cuda.synchronize()
        own = (slice(*sl.owned), slice(1, -1), slice(1, -1))
        t = (None, None)
        if timing_reps:
            t = (time_ms(lambda: stencil_step_shard(u0, u1, sh.adj, outk, sl,
                                                    sc), timing_reps),
                 time_ms(lambda: stencil_step_shard_plain(
                     u0, u1, sh.adj, outp, sl, sc), 3))
        return rel(outk[own], outp[own]) + t


def k6_check(eng, gen, k, timing_reps=0, abc=False, live=False):
    """One K6 sweep vs tb_sweep_shard_plain on slab k, on the slab's
    device, from a random state or (live) from the slab's fields and
    branch states after the engine's last run, with random source samples
    (owned rows of both fields, owned nodes' vh/gh, taps); as tb_check."""
    sh = eng.shards[k]
    st, sl, TB, dev = sh.tb_scene, sh.slab, eng.TB, sh.dev
    nbl, dt = sh.bnl.numel(), eng.dtype
    if live:
        u0, u1, _, (vh, gh) = eng.states[k]
    else:
        u0, u1 = randn(gen, dt, *sl.shape), randn(gen, dt, *sl.shape)
        vh, gh = randn(gen, dt, MMb, nbl), randn(gen, dt, MMb, nbl)
        u0, u1, vh, gh = (a.to(dev) for a in (u0, u1, vh, gh))
    sig = randn(gen, dt, TB, st.in_ixyz.numel()).to(dev)
    with torch.cuda.device(dev):     # the events and syncs of this card
        return _k6_compare(sh, u0, u1, vh, gh, sig, timing_reps, abc)


def _k6_compare(sh, u0, u1, vh, gh, sig, timing_reps, abc):
    st, sl, TB = sh.tb_scene, sh.slab, sh.tb_scene.TB
    nr = st.out_ixyz_f.numel()
    (ok_, sk, tk), (op, sp, tp) = (sweep_buffers(u0, vh, TB, nr)
                                   for _ in range(2))
    tb_sweep_shard(st, u0, u1, *ok_, vh, gh, *sk, sig, tk)
    tb_sweep_shard_plain(st, u0, u1, *op, vh, gh, *sp, sig, tp)
    torch.cuda.synchronize()
    own = (slice(*sl.owned), slice(1, -1), slice(1, -1))
    mine = torch.from_numpy(sh.part.node_own).to(u0.device)
    pairs = [(ok_[0][own], op[0][own]), (ok_[1][own], op[1][own]),
             (sk[0][:, mine], sp[0][:, mine]),
             (sk[1][:, mine], sp[1][:, mine])]
    if TB > 2:
        pairs.append((tk, tp))
    errs = [rel(a, b) for a, b in pairs if b.numel()]
    t = (None, None)
    if timing_reps:
        t = (time_ms(lambda: tb_sweep_shard(st, u0, u1, *ok_, vh, gh, *sk,
                                            sig, tk), timing_reps),
             time_ms(lambda: tb_sweep_shard_plain(st, u0, u1, *op, vh, gh,
                                                  *sp, sig, tp), 2))
    r = (max(e[0] for e in errs), max(e[1] for e in errs)) + t
    if not abc:
        return r
    return r + (abc_turns(lambda sc: tb_sweep_shard(sc, u0, u1, *ok_, vh, gh,
                                                    *sk, sig, tk),
                          st, timing_reps),)


def energy_inputs(es, gen, dt):
    """A random state for K1e and K7 on the scene `es`: u^{n-1}, u^n,
    u^{n+1}, L u^{n-1} (zero halos, as the engine keeps it), vh after the
    step, vh and gh before it, and the source samples."""
    g = es.grid.shape
    nbl = es.ssaf.numel()
    Lu = torch.zeros(g, dtype=dt, device="cuda")
    Lu[1:-1, 1:-1, 1:-1] = randn(gen, dt, *(n - 2 for n in g))
    return (randn(gen, dt, *g), randn(gen, dt, *g), randn(gen, dt, *g), Lu,
            randn(gen, dt, MMb, nbl), randn(gen, dt, MMb, nbl),
            randn(gen, dt, MMb, nbl), randn(gen, dt, es.in_ixyz.numel()))


def energy_step(k1e, boundary_pass, eng, es, ins):
    """`k1e` (K1e or its plain version), then `boundary_pass` (K7's or its
    plain version), from `ins` into fresh outputs: u^{n+1}, L u^n, the
    fp64 scratch, H, E_lost and E_in (0-d, from zero)."""
    u0, u1, unew, Lu, vh, vh_prev, gh_prev, sig = ins
    z = lambda: torch.zeros((), dtype=Lu.dtype, device=Lu.device)
    outs = (torch.zeros_like(u0), Lu.clone(),
            torch.zeros(scratch_size(es.grid, es.ssaf.numel()),
                        dtype=torch.float64, device=Lu.device), z(), z(), z())
    k1e(u0, u1, es.adj, *outs[:3], eng.data.grid, eng.data.sc, es)
    boundary_pass(es, unew, u0, vh, vh_prev, gh_prev, sig, *outs[2:])
    return outs


def energy_check(eng, gen, timing_reps=0):
    """K1e (K1's step with K7's grid half in one launch), then K7's
    boundary pass, vs their plain versions from a random state on the
    scene of `eng`.

    Returns a namespace: same (u^{n+1} and L u^n bitwise equal to the
    plain version's), en {name: (kernels, plain, fp64 reference or None)}
    of H, dE_lost and dE_in (the reference, fp32 states only: the fp64
    plain versions on the same inputs with the fp32 run's constants), err
    (max abs err of u^{n+1}, L u^n and the energies), ms {K1e, K1: kernel
    ms a call, timed in turns on the same inputs; K7: the boundary pass's}
    and pms {K1e, K7: the plain versions' ms} or None, and nbytes {K1e,
    K7}: what a call must move (K1e: u^{n-1}, u^n, adj and L u^{n-1} read,
    u^{n+1} and L u^n written once an interior point, and the blocks'
    sums)."""
    d = eng.data
    g, sc = d.grid, d.sc
    es = EnergyScene.make(d, adj=grid_adj(eng), ssaf=eng.ssaf, mat=eng.mat,
                          in_ixyz=eng.in_ixyz)
    ins = energy_inputs(es, gen, eng.dtype)
    u0, u1, unew, _, vh, vh_prev, gh_prev, sig = ins
    ok = energy_step(stencil_energy_step, energy_boundary_pass, eng, es, ins)
    plain = (stencil_energy_step_plain, energy_boundary_pass_plain)
    op = energy_step(*plain, eng, es, ins)
    torch.cuda.synchronize()
    ref = (None,) * 3
    if eng.dtype == torch.float32:
        es64 = dataclasses.replace(es, ssaf=es.ssaf.double(),
                                   def_table=es.def_table.double())
        o64 = energy_step(*plain, eng, es64, tuple(x.double() for x in ins))
        ref = tuple(float(x) for x in o64[3:])
        del o64
    en = {k: (float(a), float(b), c) for k, a, b, c in zip(
        ("H", "dE_lost", "dE_in"), ok[3:], op[3:], ref)}
    inner = (slice(1, -1),) * 3
    isz, pairs = u0.element_size(), 2 * grid_blocks(g)
    r = SimpleNamespace(
        same=bool(torch.equal(ok[0][inner], op[0][inner])
                  and torch.equal(ok[1], op[1])), en=en,
        err=max([rel(ok[0][inner], op[0][inner])[1], rel(ok[1], op[1])[1]]
                + [abs(a - b) for a, b, _ in en.values()]),
        ms=None, pms=None,
        nbytes={"K1e": (g.n_interior * (5 * isz + es.adj.element_size())
                        + 8 * pairs),
                "K7": (shell_points(g) * 2 * isz
                       + d.Nbl * (3 * MMb * isz + isz + 4)
                       + d.in_ixyz.size * (3 * isz + 8)
                       + 8 * (ok[2].numel() - pairs))})
    if timing_reps:
        b_args = (es, unew, u0, vh, vh_prev, gh_prev, sig)
        calls = {
            "K1e": lambda: stencil_energy_step(u0, u1, es.adj, *ok[:3], g,
                                               sc, es),
            "K1": lambda: stencil_step(u0, u1, eng.adj, ok[0], g, sc)}
        r.ms = {k: float("inf") for k in calls}
        for _ in range(3):      # in turns, the best of three windows each
            for k, fn in calls.items():
                r.ms[k] = min(r.ms[k], time_ms(fn, timing_reps))
        r.ms["K7"] = time_ms(lambda: energy_boundary_pass(*b_args, *ok[2:]),
                             timing_reps)
        r.pms = {"K1e": time_ms(lambda: stencil_energy_step_plain(
                     u0, u1, es.adj, *op[:3], g, sc, es), 2),
                 "K7": time_ms(lambda: energy_boundary_pass_plain(
                     *b_args, *op[2:]), 2)}
    del ins, ok, op
    torch.cuda.empty_cache()
    return r


def energy_print_require(where, r, fp32):
    """Prints an energy_check result and holds it to its bars: u^{n+1} and
    L u^n bitwise equal to the plain version's; the energies as
    `require_energies` holds them."""
    t = ""
    if r.ms is not None:
        m, p, b = r.ms, r.pms, r.nbytes
        t = (f"; K1e {m['K1e']:.4f} ms beside K1 {m['K1']:.4f} ms (in "
             f"turns, best of 3 windows), plain {p['K1e']:.4f} ms; K7's "
             f"boundary pass {m['K7']:.4f} ms, plain {p['K7']:.4f} ms; "
             f"bounds at the published rate "
             f"{b['K1e'] / HBM_BPS * 1e3:.4f} and "
             f"{b['K7'] / HBM_BPS * 1e3:.4f} ms ({b['K1e'] / 1e9:.4f} and "
             f"{b['K7'] / 1e9:.4f} GB)")
    print(f"[2] K1e + K7 {where}: u^(n+1) and L u^n bitwise equal to the "
          f"plain version {r.same}; energies (kernels, plain, fp64 "
          f"reference) {r.en}; max abs err {r.err:.3e}{t}", flush=True)
    require(r.same, f"K1e {where}: u^(n+1) or L u^n differs from the plain "
            f"version")
    require_energies(f"K1e + K7 {where}", r.en, fp32)


def require_energies(where, en, fp32):
    """{name: (kernel, plain, fp64 reference)}: in fp32 the kernel's value
    no further from the fp64 reference than the plain version's (K7 sums
    in fp64 and must not be less accurate than what it replaces), in fp64
    within 1e-12 of the plain version's."""
    for k, (a, b, ref) in en.items():
        if fp32:
            require(abs(a - ref) <= abs(b - ref),
                    f"{where}: {k} {a} is further from the fp64 value "
                    f"{ref} than the fp32 plain path's {b}")
        else:
            require(abs(a - b) <= 1e-12 * abs(b),
                    f"{where}: {k} {a} vs plain {b}")


def grid_blocks(grid):
    """Blocks of K1e's launch: z-runs of GRID_THREADS points of the
    interior's (x, y) rows."""
    return (-(-(grid.Nz - 2) // GRID_THREADS) * (grid.Ny - 2)
            * (grid.Nx - 2))


def once_ms(fn):
    """ms of one call of fn on the card, from CUDA events."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def counts():
    """The launches since reset_counts, a tuple in WRAPPERS' order."""
    return tuple(w.launches for w in WRAPPERS.values())


def launches(**kw):
    """A counts() tuple from {kernel: launches}, the rest zero."""
    require(set(kw) <= set(WRAPPERS), f"no such kernels: {kw}")
    return tuple(kw.get(k, 0) for k in WRAPPERS)


def named(c):
    """The kernels a counts() tuple launched: {kernel: launches}."""
    return {k: n for k, n in zip(WRAPPERS, c) if n}


def run_route(eng, want, reps=3):
    """Best of `reps` runs of NT steps; each run's launch counts are reset
    just before it and must equal `want` just after."""
    runs = []
    for _ in range(reps):
        reset_counts()
        u = eng.run(nt=NT, verbose=False)
        runs.append((eng.elapsed, counts()))
    require(all(c == want for _, c in runs),
            f"{type(eng).__name__} {eng.backend} TB={eng.TB}: launches "
            f"per run {[named(c) for _, c in runs]}, want {named(want)}")
    require(np.isfinite(u).all() and np.abs(u).max() > 0,
            "main path: u_out not finite or all zero")
    return u, min(t for t, _ in runs), want


def eps_check(n, s):
    """Phase 3 with fp32_eps = EPS_SET on the small fp64 scene s: the step,
    tb (TB = 3), pair and energy routes and the x-slab step route at D = 2,
    launches checked, against the plain path with the same shift."""
    eps = {"fp32_eps": EPS_SET}
    up = engine(s, np.float64, use_kernels=False, **eps).run(
        nt=NT_SMALL, verbose=False)
    u0 = engine(s, np.float64, use_kernels=False).run(nt=NT_SMALL,
                                                      verbose=False)
    moved = rel_err(up, u0)
    require(moved > 1e-9, f"{n}: fp32_eps {EPS_SET} moved the plain path by "
            f"{moved} only")
    errs, engs = {}, {}
    for b in ("step", "tb", "pair", "energy"):
        e = engs[b] = engine(s, np.float64, tb=3, energy_on=b == "energy",
                             backend="step" if b == "energy" else b, **eps)
        require(e.data.fp32_eps == EPS_SET, f"{n} {b}: fp32_eps "
                f"{e.data.fp32_eps}")
        reset_counts()
        u = e.run(nt=NT_SMALL, verbose=False)
        c = counts()
        want = (energy_launches(NT_SMALL) if b == "energy"
                else counts_of(e, 1, NT_SMALL))
        require(c == want, f"{n} {b} fp32_eps: launches {named(c)}")
        errs[b] = rel_err(u, up)
    ep = engine(s, np.float64, energy_on=True, use_kernels=False, **eps)
    ep.run(nt=NT_SMALL, verbose=False)
    ek = engs["energy"]
    for a in ("H_tot", "E_lost", "E_in"):
        errs[a] = rel_err(getattr(ek, a), getattr(ep, a))
    ps = pad_x_interior(s, 2)
    up2 = engine(ps, np.float64, use_kernels=False, **eps).run(
        nt=NT_SMALL, verbose=False)
    ex = sharded(s, np.float64, 2, **eps)
    reset_counts()
    u2 = ex.run(nt=NT_SMALL, verbose=False)
    c = counts()
    require(c == counts_of(ex, 2, NT_SMALL), f"{n} x2 fp32_eps: launches "
            f"{named(c)}")
    errs["x2 step"] = rel_err(u2, up2)
    print(f"[3] {n} fp64 fp32_eps={EPS_SET}: vs the plain path {errs}; the "
          f"plain path {moved:.3e} off its run at 0; balance "
          f"{np.abs(ek.energy_balance()).max():.3e} (plain "
          f"{np.abs(ep.energy_balance()).max():.3e}: the functional keeps "
          f"l2 unshifted)", flush=True)
    require(max(errs.values()) <= 1e-12, f"{n} fp32_eps: {errs}")


def split_check(eng, k2_ms, u_one):
    """The air / boundary split on the step engine `eng`, whose
    bn_ms_per_step has not run: NT steps in chunks of NT / 4, quiet, then
    verbose (stdout captured), each with its peak memory over what was
    allocated before it.  The verbose run must launch K1 NT times and K2 NT
    plus the probe's 1 + BN_ITERS times, print the split on every progress
    line, and leave receivers and final state bitwise the quiet run's, and
    the receivers bitwise `u_one` (a one-chunk run's); bn_ms_per_step within
    BN_FACTOR of phase 2's K2 time k2_ms.  Returns bn (ms), bn2 (a second
    probe on the final state), pct (the lines' bn %), run_extra (the
    verbose run's peak bytes over the quiet run's), own (the second
    probe's peak bytes over what was allocated before it), vhgh (vh's and
    gh's bytes), t_q and t_v (the runs' seconds)."""
    require(eng._bn_ms is None, "split_check: the probe already ran")
    chunk = NT // 4

    def run(verbose):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            u = eng.run(nt=NT, chunk=chunk, verbose=verbose)
        return u, torch.cuda.max_memory_allocated() - before, out.getvalue()

    u_q, peak_q, _ = run(False)
    t_q = eng.elapsed
    st_q = [eng.state[k].clone() for k in (0, 1, 3, 4)]
    reset_counts()
    u_v, peak_v, text = run(True)
    c = counts()
    want = launches(K1=NT, K2=NT + 1 + BN_ITERS)
    require(c == want, f"split run: launches {named(c)}, want {named(want)}")
    lines = [ln for ln in text.splitlines() if "MVPS inst" in ln]
    for ln in lines:
        print(f"[4] {ln}")
    found = [re.search(r", air \d+% / bn (\d+)%$", ln) for ln in lines]
    require(len(lines) == NT // chunk - 1 and all(found),
            f"split run: {sum(map(bool, found))} of {len(lines)} progress "
            "lines carry the split")
    pct = [int(m.group(1)) for m in found]
    require(np.array_equal(u_v, u_q) and np.array_equal(u_v, u_one),
            "the split's probe changed the receivers")
    require(all(torch.equal(eng.state[k], a)
                for k, a in zip((0, 1, 3, 4), st_q)),
            "the split's probe changed the final state")
    bn = eng.bn_ms_per_step()
    require(np.isfinite(bn) and 1 / BN_FACTOR <= bn / k2_ms <= BN_FACTOR,
            f"bn_ms_per_step {bn} ms against phase 2's K2 {k2_ms} ms")
    vhgh = 2 * eng.state[3].numel() * eng.state[3].element_size()
    # the probe alone, once more on the final state: its own peak over
    # what the run left allocated
    t_v = eng.elapsed
    eng._bn_ms = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    bn2 = eng.bn_ms_per_step()
    own = torch.cuda.max_memory_allocated() - before
    return SimpleNamespace(bn=bn, bn2=bn2, pct=pct, run_extra=peak_v - peak_q,
                           own=own, vhgh=vhgh, t_q=t_q, t_v=t_v)


def bound_ms(nbytes, nops=0.0, fp64=False):
    """The least time for the work on this card: bytes over the published
    HBM rate vs operations over the published peak; (ms, "bytes"|...)."""
    tb = nbytes / HBM_BPS * 1e3
    to = nops / (FP64_OPS if fp64 else FP32_OPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def slab_bytes_ops(eng, k):
    """Bytes a K5 call (route step) or a K6 sweep (route tb) on slab k must
    move, each input read once and each output written once, and its
    floating-point operations (29 a stencil point, 80 a lossy node); the
    Q array's byte a node where the slab has one."""
    sh = eng.shards[k]
    sl, isz = sh.slab, eng.data.dtype.itemsize
    asz = sh.adj.element_size()
    plane = (sl.shape[1] - 2) * (sl.shape[2] - 2)
    S = sl.S
    if eng.TB is None:
        return plane * S * (3 * isz + asz), 29.0 * plane * S
    TB = eng.TB
    (xa, xb), (xl, xh) = sl.owned, sl.computable
    rows = [min(xb + TB - 1 - s, xh) - max(xa - TB + 1 + s, xl)
            for s in range(TB)]
    st = sh.tb_scene
    n_in, n_own = sh.bnl.numel(), int(sh.part.node_own.sum())
    nbytes = (plane * ((xh - xl) * isz + rows[0] * (isz + asz) + 2 * S * isz)
              + n_in * (2 * MMb * isz + isz + 4) + n_own * 2 * MMb * isz
              + 4 * (st.tl_rptr.numel() + 3 * st.tl_node.numel())
              + (0 if st.abcq is None else n_in))
    node_x = sh.part.bnl // (sl.shape[1] * sl.shape[2])
    nodes = sum(int(((node_x >= max(xa - TB + 1 + s, xl))
                     & (node_x < min(xb + TB - 1 - s, xh))).sum())
                for s in range(TB))
    return nbytes, 29.0 * plane * sum(rows) + 80.0 * nodes


def single_run(sim, backend, kw, single):
    """The single-device run of `backend` on the grid of `sim` on cuda:0,
    from `single` ({(route, Nx): (u_out, seconds, grid)}) or run and added
    there: best of 3, launches checked."""
    key = (backend, sim.vox.Nx)
    if key not in single:
        e1 = engine(sim, np.float32, backend=backend, **kw)
        u1, t1, _ = run_route(e1, counts_of(e1, 1))
        single[key] = (u1, t1, e1.data.grid)
        del e1
        torch.cuda.empty_cache()
    return single[key]


def phase5(sim, gen, single, roof, configs=SHARDED):
    """The x-slab runs of phase 5 and the shard-mode checks of phase 2.
    single: {(route, Nx): (u_out, seconds, grid)} of the single-device
    runs so far (phase 4's step route on the unpadded grid).  Returns
    the K5 and K6 rows of the kernels' record."""
    npts = lambda gr: gr.Nx * gr.Ny * gr.Nz
    chk, rows = {}, {}
    for D, backend, kw in configs:
        u_ref, t_ref, g_ref = single_run(pad_x_interior(sim, D), backend,
                                         kw, single)
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        es = sharded(sim, np.float32, D, backend=backend, **kw)
        torch.cuda.synchronize()
        t_set = time.perf_counter() - t0
        g = es.data.grid
        require(g.shape == g_ref.shape, f"padded grid {g.shape} vs "
                f"{g_ref.shape}")
        name = f"x{D} {backend}" + (f" TB={es.TB}" if es.TB else "")
        print(f"[5] {name}: {D} slabs of {es.S} rows on {g.shape} on "
              f"cuda:0, host setup {t_set:.2f} s", flush=True)
        if D == 4:
            what = "K5" if es.TB is None else f"K6 TB={es.TB}"
            for k in (0, 1, D - 1):
                fn = k5_check if es.TB is None else k6_check
                r = fn(es, gen, k, timing_reps=20 if k == 1 else 0)
                chk[(what, k)] = r
                tms = (f", kernel {r[2]:.4f} ms, plain {r[3]:.4f} ms"
                       if r[2] is not None else "")
                print(f"[2] {what} fp32 main shapes slab {k}/{D}: max rel "
                      f"err {r[0]:.3e} (abs {r[1]:.3e}){tms}", flush=True)
                require(r[0] <= (1e-6 if es.TB is None else 1e-5),
                        f"{what} fp32 slab {k} disagrees: {r[0]}")
        # the run's peak, not the checks' temporaries
        torch.cuda.reset_peak_memory_stats()
        u, t, c = run_route(es, counts_of(es, D))
        es.run(nt=NT, verbose=False, time_exchange=True)
        x_ms = es.exchange_ms / NT
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        scale = np.abs(u_ref).max()
        err = np.abs(u - u_ref).max() / scale
        mv, mv1 = npts(g) * NT / t / 1e6, npts(g) * NT / t_ref / 1e6
        print(f"[5] {name}: {mv:.1f} MVPS (best {t:.4f} s), frac "
              f"{mv / mv1:.4f} of the single device's {mv1:.1f}; exchange "
              f"{x_ms:.4f} ms/step (the copies, on cuda:0's stream); peak "
              f"device memory {peak:.2f} GB "
              f"(a card, the engine's own); "
              f"launches {named(c)}; receivers vs single device "
              f"{err:.3e} of max |u_out| {scale:.3e}, bitwise equal "
              f"{np.array_equal(u, u_ref)}", flush=True)
        require(err <= 1e-5, f"{name} receivers disagree: {err}")
        if D == 4 and backend == "step":
            nb, no = slab_bytes_ops(es, 1)
            r = chk[("K5", 1)]
            rows["K5 stencil_step_shard"] = (
                c[4], max(chk[("K5", k)][1] for k in (0, 1, 3)), r[2], r[3],
                nb, no, None)
        if D == 4 and es.TB == 3:
            nb, no = slab_bytes_ops(es, 1)
            r = chk[("K6 TB=3", 1)]
            rows["K6 tb_sweep_shard"] = (
                c[5], max(chk[(w, k)][1] for w in ("K6 TB=2", "K6 TB=3")
                          for k in (0, 1, 3)), r[2], r[3], nb, no, None)
            print(f"[5] K6 TB=3 {r[2]:.4f} ms/sweep on slab 1 = "
                  f"{r[2] / 3:.4f} ms/step; bound {nb / roof / 1e6:.4f} ms "
                  f"at the roof", flush=True)
        if D == 4 and es.TB == 2:
            nb, _ = slab_bytes_ops(es, 1)
            print(f"[5] K6 TB=2 {chk[('K6 TB=2', 1)][2]:.4f} ms/sweep on "
                  f"slab 1; bound {nb / roof / 1e6:.4f} ms at the roof "
                  f"({nb / HBM_BPS * 1e3:.4f} at the published rate), "
                  f"{nb / 1e9:.4f} GB", flush=True)
        if D == 4 and backend == "step":
            print(f"[5] K5 {chk[('K5', 1)][2]:.4f} ms on slab 1 = "
                  f"{nb / chk[('K5', 1)][2] / 1e6:.1f} GB/s", flush=True)
        del es
        torch.cuda.empty_cache()
    return rows


def counts_of(eng, D, nt=NT):
    """The launches (a counts() tuple) one nt-step run of `eng` must
    make: on x-slabs K2 only on the slabs that hold lossy nodes (a slab of
    padding air holds none)."""
    TB = eng.TB
    if D == 1 and TB is None:
        return launches(K1=nt, K2=nt)
    if D == 1:
        return launches(K1=nt % TB, K2=nt % TB, K3=nt // TB)
    k2 = sum(sh.bnl.numel() > 0 for sh in eng.shards)
    if TB is None:
        return launches(K2=k2 * nt, K5=D * nt)
    return launches(K2=k2 * (nt % TB), K5=D * (nt % TB),
                    K6=D * (nt // TB))


def k3_bytes(e):
    """Bytes a K3 sweep of the tb engine e must move, each input read once
    and each output written once: the fields and adj an interior point, the
    branch states, the tile lists, and the Q array where it has one."""
    d, isz = e.data, e.data.dtype.itemsize
    tl = e.tb_scene.lists
    return (d.grid.n_interior * (4 * isz + e.adj.element_size())
            + d.Nbl * (4 * MMb * isz + isz + 4)
            + 4 * (tl.rptr.size + 3 * tl.node.size)
            + (0 if e.tb_scene.abcq is None else d.Nbl))


def energy_rows_equal(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("u_out", "H_tot", "E_lost", "E_in"))


def energy_runs(name, e, nt, reps):
    """`reps` more runs of the energy engine `e` over nt steps, launches
    checked per run; every run's receivers, energies and final fields must
    be bitwise equal to those `e` holds from its run before the call.
    Returns the best seconds."""
    rows = ("u_out", "H_tot", "E_lost", "E_in")
    first = ([getattr(e, a).copy() for a in rows],
             [f.clone() for f in e.state])
    t = []
    for _ in range(reps):
        reset_counts()
        e.run(nt=nt, verbose=False)
        c = counts()
        require(c == energy_launches(nt), f"{name} energy route launches "
                f"{named(c)}, want {named(energy_launches(nt))}")
        require(all(np.array_equal(getattr(e, a), b)
                    for a, b in zip(rows, first[0])) and all(
            torch.equal(a, b) for a, b in zip(e.state, first[1])),
            f"{name}: a run of the energy route differs from the first "
            f"run's bits")
        t.append(e.elapsed)
    return min(t)


def energy_launches(nt):
    """The launches of an nt-step energy run: K1e, K2 and K7's boundary
    pass once a step."""
    return launches(K1e=nt, K2=nt, K7=nt)


def phase6(sim, eng, u_k, t_k, small):
    """Energy accounting, checkpoint/resume, the per-chunk hook and the
    modal filter on the card.  eng: phase 4's fp32 step engine on the
    headline scene, u_k and t_k its receivers and best time.  Returns the
    launches of the fp32 headline energy run and its ms a step, and K8's
    row of the kernels' record."""
    g = eng.data.grid
    npts = g.Nx * g.Ny * g.Nz

    # (a) energy on the small fp64 scenes: K1e + K2 + K7 against the plain
    # path
    for n, s in small.items():
        ek = engine(s, np.float64, energy_on=True)
        reset_counts()
        uk = ek.run(verbose=False)
        c = counts()
        require(c == energy_launches(ek.Nt),
                f"{n} energy route launches {named(c)}, want {ek.Nt} K1e, "
                f"K2 and K7")
        ep = engine(s, np.float64, energy_on=True, use_kernels=False)
        ep.run(verbose=False)
        bal = np.abs(ek.energy_balance()).max()
        errs = {a: float(np.abs(getattr(ek, a) - getattr(ep, a)).max()
                         / np.abs(getattr(ep, a)).max())
                for a in ("H_tot", "E_lost", "E_in")}
        same = np.array_equal(uk, engine(s, np.float64).run(verbose=False))
        print(f"[6a] {n} fp64 energy: balance {bal:.3e}, E_lost[-1] "
              f"{ek.E_lost[-1]:.6e}, vs plain path {errs}, receivers "
              f"bitwise equal to the energy-off run {same}", flush=True)
        require(bal < 1e-10 and ek.E_lost[-1] > 0,
                f"{n}: energy balance {bal}, E_lost[-1] {ek.E_lost[-1]}")
        require(max(errs.values()) <= 1e-12, f"{n}: energies vs plain {errs}")
        require(same, f"{n}: the energy route changed the receivers")

    # (b) energy on the headline scene, fp32 then fp64, NT steps each
    # against the step route; then fp64 over NT_LONG steps, past the walls
    sim_long = headline_scene(NT_LONG)
    rec = None
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        if dt == np.float32:
            s, u_off, t_off = sim, u_k, t_k
        else:      # the fp64 step route, energy off
            s = sim_long
            e = engine(s, dt)
            u_off = e.run(nt=NT, verbose=False)
            t_off = e.elapsed
            del e
            torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        e = engine(s, dt, energy_on=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        u = e.run(nt=NT, verbose=False)
        c = counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        t1 = energy_runs(f"headline {name}", e, NT, 3)
        bal = np.abs(e.energy_balance()).max()
        same = np.array_equal(u, u_off)
        print(f"[6b] headline {name} energy route (K1e + K2 + K7): "
              f"{npts * NT / t1 / 1e6:.1f} MVPS ({t1:.4f} s, "
              f"{t1 / NT * 1e3:.4f} ms a step, best of 3) against the step "
              f"route's {npts * NT / t_off / 1e6:.1f} "
              f"({t_off / NT * 1e3:.4f} ms); launches {named(c)}; every run "
              f"bitwise equal (receivers, energies, final fields); balance "
              f"{bal:.3e}; E_lost[-1] {e.E_lost[-1]:.6e}; receivers bitwise "
              f"equal to the step route {same}; peak device memory "
              f"{peak:.2f} GB (the engine's own)", flush=True)
        require(c == energy_launches(NT),
                f"{name} energy launches {named(c)}")
        require(np.isfinite(e.H_tot).all() and e.E_in[-1] > 0,
                f"{name}: energies not finite or no input energy")
        require(same, f"headline {name}: energy route receivers differ")
        if dt == np.float32:
            rec = (c, t1 / NT * 1e3)
        else:
            require(bal < 1e-9, f"headline fp64 energy balance {bal}")
            reset_counts()
            e.run(nt=NT_LONG, verbose=False)
            c = counts()
            bal = np.abs(e.energy_balance()).max()
            El = e.E_lost
            grow = El[-1] - El[N_WALLS - 1]
            print(f"[6b] headline float64 energy route, {NT_LONG} steps: "
                  f"{npts * NT_LONG / e.elapsed / 1e6:.1f} MVPS "
                  f"({e.elapsed:.4f} s); launches {named(c)}; balance "
                  f"{bal:.3e}; E_lost at step {N_WALLS} {El[N_WALLS - 1]:.6e}"
                  f", at {NT_LONG} {El[-1]:.6e} (grew {grow:.6e}); E_in[-1] "
                  f"{e.E_in[-1]:.6e}", flush=True)
            require(c == energy_launches(NT_LONG),
                    f"fp64 {NT_LONG}-step energy launches {named(c)}")
            require(bal < 1e-9, f"headline fp64 {NT_LONG}-step energy "
                    f"balance {bal}")
            require(grow > El[N_WALLS - 1],
                    f"E_lost grew by {grow} from step {N_WALLS} to "
                    f"{NT_LONG}, not more than its {El[N_WALLS - 1]}: the "
                    f"walls took no energy")
        del e
        torch.cuda.empty_cache()
    del sim_long

    # checkpoint write and read at headline size (fp32 step route)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) \
            as tmp:
        ck = Path(tmp) / "state.npz"
        since = time.perf_counter_ns()
        u = eng.run(nt=NT, verbose=False, chunk=NT, checkpoint_every=1,
                    checkpoint_path=ck)
        write_s = sum(r.seconds for r in spans.records(since)
                      if r.name == "run.checkpoint")
        size = ck.stat().st_size
        t0 = time.perf_counter()
        ur = eng.run(nt=NT, verbose=False, checkpoint_path=ck, resume=True)
        read_s = time.perf_counter() - t0
    print(f"[6c] headline checkpoint: {size / 1e9:.3f} GB written in "
          f"{write_s:.3f} s, resumed (read) in {read_s:.3f} s; receivers "
          f"bitwise equal {np.array_equal(u, u_k)}, "
          f"{np.array_equal(ur, u_k)}", flush=True)
    require(np.array_equal(u, u_k) and np.array_equal(ur, u_k),
            "headline checkpoint run or resume changed the receivers")

    # (c) resume at a step that is no multiple of TB, small fp64 scene;
    # (d) the hook sees the chunk ends
    s = small["fcc_folded"]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) \
            as tmp:
        for kw in ({"backend": "step"}, {"backend": "tb", "tb": 3},
                   {"backend": "pair"}, {"energy_on": True}):
            ck = Path(tmp) / "state.npz"
            a = engine(s, np.float64, **kw)
            a.run(nt=NT_SMALL, verbose=False)
            engine(s, np.float64, **kw).run(
                nt=23, verbose=False, chunk=5, checkpoint_every=2,
                checkpoint_path=ck)
            with np.load(ck) as z:
                n0 = int(z["n"])
            seen = []

            def hook(n, state):
                seen.append((n, float(state[1].abs().max())))

            b = engine(s, np.float64, **kw)
            b.run(nt=NT_SMALL, verbose=False, chunk=5, checkpoint_path=ck,
                  resume=True, on_chunk=hook)
            same = (energy_rows_equal(a, b) if b.energy_on
                    else np.array_equal(a.u_out, b.u_out))
            TB = b.TB or 1
            c = -(-5 // TB) * TB
            ends = list(range(n0 + c, NT_SMALL, c)) + [NT_SMALL]
            print(f"[6c] fcc_folded fp64 {kw}: checkpoint at step {n0}, "
                  f"resumed to {NT_SMALL}: bitwise equal {same}; [6d] hook "
                  f"steps {[n for n, _ in seen]} (want {ends}), max |u^n| "
                  f"{seen[-1][1]:.6e}", flush=True)
            require(same, f"{kw}: the resumed run differs")
            require([n for n, _ in seen] == ends, f"{kw}: hook steps {seen}")
            require(seen[-1][1] == float(b.state[1].abs().max()) > 0,
                    f"{kw}: the hook saw another state")

    # (e) the modal air-absorption filter: the headline receivers (their 8
    # trilinear taps weighted, as `process` does) padded to MODAL_CHECK
    # samples: K8 vs the numpy loop; then MODAL_TIMED samples a channel
    cm = sim.comms
    taps = u_k[cm.out_reorder].reshape(*cm.out_alpha.shape, -1)
    r = np.sum(taps * cm.out_alpha[..., None], axis=1)
    x = np.zeros((r.shape[0], MODAL_CHECK))
    x[:, :NT] = r
    setup = _modal_setup(x, FS, 20.0, 50.0, 0.0)
    t0 = time.perf_counter()
    P = modal_recurrence(*setup, device="cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    Pn = modal_recurrence_plain(*setup)
    t_np = time.perf_counter() - t0
    err_abs = float(np.abs(P - Pn).max())
    err = err_abs / float(np.abs(Pn).max())
    loop = loop_modes(np.arange(MODAL_CHECK), MODAL_CHECK)
    ts = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in setup]
    Ps = modal_split_plain(*ts, torch.arange(MODAL_CHECK, device="cuda"))
    err_s = float(np.abs(P - Ps.cpu().numpy()).max() / np.abs(Pn).max())
    y = apply_modal_filter(x, FS, 20.0, 50.0, device="cuda")
    yn = apply_modal_filter_plain(x, FS, 20.0, 50.0)
    err_y = float(np.abs(y - yn).max() / np.abs(yn).max())
    same_loop = np.array_equal(P[:, loop], Pn[:, loop])
    print(f"[6e] modal recurrence {r.shape[0]} x {MODAL_CHECK} (q0 "
          f"{serial_modes(MODAL_CHECK)}: {loop.sum()} loop modes): K8 "
          f"{t_card:.3f} s (host clock, copies included) vs the numpy loop "
          f"{t_np:.3f} s, max rel err {err:.3e} (abs {err_abs:.3e}), vs "
          f"modal_split_plain on the card {err_s:.3e}; loop modes bitwise "
          f"equal {same_loop}, every mode bitwise equal "
          f"{np.array_equal(P, Pn)}; filtered RIRs vs "
          f"apply_modal_filter_plain {err_y:.3e}", flush=True)
    require(err <= 1e-12 and err_y <= 1e-12 and err_s <= 1e-12,
            f"K8 vs the numpy loop: {err}, filtered {err_y}, vs the split's "
            f"plain version {err_s}")
    require(same_loop, "K8's loop modes differ from the numpy loop's bits")
    x = np.random.default_rng(SEED).standard_normal((2, MODAL_TIMED))
    reset_counts()
    t0 = time.perf_counter()
    y = apply_modal_filter(x, FS, 20.0, 50.0, device="cuda")
    t_48k = time.perf_counter() - t0
    c = counts()
    require(c == launches(K8=1), f"apply_modal_filter launches {c}, want "
            f"one K8")
    require(np.isfinite(y).all(), "modal filter at 48000: not finite")
    ts = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in
          _modal_setup(x, FS, 20.0, 50.0, 0.0)]
    out, out_p = torch.empty_like(ts[2]), torch.empty_like(ts[2])
    k8_ms = time_ms(lambda: modal_scan(*ts, out), 10)
    plain_ms = once_ms(lambda: modal_scan_plain(*ts, out_p))
    torch.cuda.synchronize()
    same = torch.equal(out, out_p)
    nch, nt = ts[2].shape
    loop = loop_modes(torch.arange(nt, device="cuda"), nt)
    same_loop = torch.equal(out[:, loop], out_p[:, loop])
    err_p = rel(out, out_p)[0]
    q0 = serial_modes(nt)
    ns = int(loop.sum())
    nc = nt - ns
    loop_ops = 7.0 * nch * nt * nt
    nops = float(nt) * (7 * nch * ns + (3 + 4 * nch) * nc)
    slots = float(nt) * (7 * nch * ns + (2 + 2 * nch) * nc)
    b_loop, b_ops = (n / FP64_OPS * 1e3 for n in (loop_ops, nops))
    b_slots = slots / (FP64_OPS / 2) * 1e3
    nbytes = 8 * (2 * nt + 3 * nch * nt + nch * (nt + 1))
    print(f"[6e] modal filter 2 x {MODAL_TIMED} (1 s at 48 kHz): "
          f"apply_modal_filter {t_48k:.3f} s end to end (host clock), "
          f"launches {named(c)}; q0 {q0}: {ns} loop modes, {nc} "
          f"contracted; K8 alone {k8_ms:.4f} ms (CUDA events); bounds at "
          f"{FP64_OPS:.0e} fp64 op/s: the loop's {loop_ops:.4e} operations "
          f"{b_loop:.4f} ms ({b_loop / k8_ms:.1%} of K8), the split's "
          f"{nops:.4e} operations {b_ops:.4f} ms ({b_ops / k8_ms:.1%}), its "
          f"{slots:.4e} fp64 issue slots {b_slots:.4f} ms "
          f"({b_slots / k8_ms:.1%}); the plain version (the loop) on the "
          f"card {plain_ms:.1f} ms, max rel err {err_p:.3e}, loop modes "
          f"bitwise equal {same_loop}, every mode bitwise equal {same}",
          flush=True)
    require(err_p <= 1e-12, f"K8 vs its plain version at {MODAL_TIMED}: "
            f"{err_p}")
    require(same_loop, f"K8's loop modes at {MODAL_TIMED} differ from the "
            f"plain loop's bits")
    # K8's entry point at other splits (measurement only, not counted):
    # q0 = Nt puts every mode on the loop, K8's previous design
    lib = _build.library()
    stream_ = torch.cuda.current_stream().cuda_stream

    def k8_at(q):
        _build.check(lib.pf_modal_recurrence(
            *(t.data_ptr() for t in ts), out_p.data_ptr(), nch, nt, q,
            stream_), "pf_modal_recurrence")

    sweep = {q: time_ms(lambda: k8_at(q), 5)
             for q in (nt, 2 * q0, q0 * 3 // 2, q0, q0 // 2, 1)}
    print(f"[6e] K8 at 2 x {MODAL_TIMED} by q0 (ms, CUDA events): "
          + ", ".join(f"q0 {q} {v:.4f}" for q, v in sweep.items())
          + f" (q0 {nt}: every mode on the loop)", flush=True)
    del ts, out, out_p, Ps
    return rec, (c[7], err_abs, k8_ms, plain_ms, nbytes, nops, None)


def hall_sim(dims, src, rxyz, mats, fcc, backend, nt, insig, diff):
    """sim_setup_from_room on the sloped hall, in memory; with the seconds
    of its stages ("rest": the room, grid, constants and SimData)."""
    Lx, Ly, Lz1, Lz2, h = dims
    Ts = SimConsts(h=h, fcc=fcc).Ts
    since = time.perf_counter_ns()
    t0 = time.perf_counter()
    sim = sim_setup_from_room(
        make_sloped_room(Lx, Ly, Lz1, Lz2, src, rxyz), mats,
        duration=nt * Ts, insig_type=insig, h=h, fcc_flag=fcc,
        diff_source=diff, vox_backend=backend, check_adj=True)
    return sim, stage_seconds(since, time.perf_counter() - t0)


def prepped(sim):
    return sort_sim(fold_fcc_sim(rotate_sim(sim, orient="descending")))


def phase7(gen, ref_mvps, grid_shape, hall=HALL):
    """Room to receivers with the port alone (see the module docstring).
    ref_mvps: phase 4's step-route MVPS on the analytic box, grid_shape its
    grid, which the hall's must equal."""
    t0 = time.perf_counter()
    DEF_walls = fit_to_Sabs_oct_11(WALLS_SABS)
    DEF_floor = fit_to_Sabs_oct_11(FLOOR_SABS)
    t_fit = time.perf_counter() - t0
    mats = mats_from_DEF_list([DEF_floor, DEF_walls])
    require(mats.Nmat == 2 and (mats.Mb == 11).all(),
            f"fitted materials: Mb {mats.Mb}")
    lib = native.lib_path()
    built = not lib.exists()
    t0 = time.perf_counter()
    native.load()
    t_build = time.perf_counter() - t0
    Lx, Ly, Lz1, Lz2, h = hall
    src = np.array([0.45 * Lx, 0.55 * Ly, 0.5 * Lz1])
    rss0 = peak_rss_gb()
    sim, st = hall_sim(hall, src, src + HALL_RXYZ, mats, True, "native",
                       NT, "impulse", True)
    t0 = time.perf_counter()
    sim = prepped(sim)
    t_prep = time.perf_counter() - t0
    v = sim.vox
    npts = v.Nx * v.Ny * v.Nz
    nb, nbl = v.Nb, int((v.mat_bn >= 0).sum())
    require((v.Nx, v.Ny, v.Nz) == tuple(grid_shape),
            f"hall grid {(v.Nx, v.Ny, v.Nz)}, want the box's {grid_shape}")
    t0 = time.perf_counter()
    eng = engine(sim, np.float32)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng_tb = engine(sim, np.float32, backend="tb", tb=3)
    torch.cuda.synchronize()
    t_tb = time.perf_counter() - t0
    print(f"[7] hall {Lx} x {Ly} m, ceiling {Lz1} to {Lz2} m, "
          f"h = {h}: {(v.Nx, v.Ny, v.Nz)} = {npts / 1e6:.1f} Mvox "
          f"folded FCC, Nb {nb}, Nbl {nbl}; voxelizer backend native "
          f"({lib.name}, {'built' if built else 'found'} in {t_build:.3f} s)"
          f"; host seconds: fit {t_fit:.3f}, sim_setup_from_room "
          f"{st['total']:.3f} = "
          + ", ".join(f"{k} {s:.3f}" for k, s in st.items() if k != "total")
          + f"; prep {t_prep:.3f}, "
          f"engine build step {t_step:.3f}, tb {t_tb:.3f}; peak RSS "
          f"{peak_rss_gb():.2f} GB (before the setup {rss0:.2f})",
          flush=True)

    # K1, K2 and K3 at the hall's shapes: vs their plain versions, timed
    for k, (r, a, ms, pms) in kernel_checks(eng, gen, timing_reps=20).items():
        print(f"[7] hall {k} fp32: max rel err {r:.3e} (abs {a:.3e}), "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
        require(r <= 1e-6, f"hall {k} disagrees with its plain version: {r}")
    r, a, ms, _ = tb_check(eng_tb, gen, timing_reps=20, plain_reps=0)
    print(f"[7] hall K3 TB=3 fp32: max rel err {r:.3e} (abs {a:.3e}), "
          f"kernel {ms:.4f} ms/sweep = {ms / 3:.4f} ms/step", flush=True)
    require(r <= 1e-5, f"hall K3 disagrees with its plain version: {r}")
    torch.cuda.empty_cache()

    u_k, t_k, _ = run_route(eng, launches(K1=NT, K2=NT))
    eng.use_kernels = False
    reset_counts()
    u_p = eng.run(nt=NT, verbose=False)
    require(counts() == ZERO, "the plain path launched a kernel")
    scale = np.abs(u_p).max()
    require(np.isfinite(u_p).all() and scale > 0, "hall: plain path empty")
    err = np.abs(u_k - u_p).max() / scale
    mv = npts * NT / t_k / 1e6
    print(f"[7] hall step route (K1 + K2): {mv:.1f} MVPS (best {t_k:.4f} s) "
          f"beside the box's {ref_mvps:.1f} (phase 4); receivers vs plain "
          f"path {err:.3e} of max |u_out| {scale:.3e}, bitwise equal "
          f"{np.array_equal(u_k, u_p)}", flush=True)
    require(err <= 1e-5, f"hall step route vs plain path: {err}")
    del eng
    torch.cuda.empty_cache()
    tb3 = NT // 3, NT % 3
    u_tb, t_t, _ = run_route(eng_tb, launches(K1=tb3[1], K2=tb3[1],
                                              K3=tb3[0]))
    err = np.abs(u_tb - u_k).max() / np.abs(u_k).max()
    tl = eng_tb.tb_scene.lists
    print(f"[7] hall tb route TB=3 (K3): {npts * NT / t_t / 1e6:.1f} MVPS "
          f"(best {t_t:.4f} s), lossy entries {tl.node.size} (max "
          f"{tl.max_per_tile} a tile); receivers vs step route {err:.3e}, "
          f"bitwise equal {np.array_equal(u_tb, u_k)}", flush=True)
    require(err <= 1e-5, f"hall tb route vs step route: {err}")
    del eng_tb, sim
    torch.cuda.empty_cache()

    # the small hall: both voxelizer backends, then the card vs the oracle
    src, rxyz = HALL_SMALL_SR
    for fcc in (False, True):
        sims = {b: hall_sim(HALL_SMALL, src, rxyz, mats, fcc, b, 60,
                            "hann10", False)[0] for b in ("numpy", "native")}
        same = {k: np.array_equal(getattr(sims["numpy"].vox, k),
                                  getattr(sims["native"].vox, k))
                for k in ("bn_ixyz", "adj_bn", "mat_bn", "saf_bn")}
        print(f"[7] small hall {'FCC' if fcc else 'cart'}: numpy vs native "
              f"voxelizer equal {same} (Nb {sims['native'].vox.Nb})",
              flush=True)
        require(all(same.values()), f"voxelizer backends differ: {same}")
        s = prepped(sims["native"]) if fcc else sims["native"]
        o = NumpyEngine(consts=s.consts, vox=s.vox, comms=s.comms,
                        mats=s.mats, energy_on=True)
        o.run_all()
        e = engine(s, np.float64, energy_on=True)
        reset_counts()
        e.run(verbose=False)
        c = counts()
        tb = engine(s, np.float64, backend="tb", tb=3)
        reset_counts()
        u_tb = tb.run(verbose=False)
        c_tb = counts()
        # the oracle's E rows are pre-step (E[0] = 0), the engine's
        # post-step
        pairs = {"u_out": (e.u_out, o.u_out), "u_out tb": (u_tb, o.u_out),
                 "H_tot": (e.H_tot, o.H_tot[:o.n]),
                 "E_lost": (e.E_lost, o.E_lost[1:o.n + 1]),
                 "E_in": (e.E_in, o.E_in[1:o.n + 1])}
        errs = {a: float(np.abs(x - r).max() / np.abs(r).max())
                for a, (x, r) in pairs.items()}
        bal = np.abs(e.energy_balance()).max()
        name = "folded FCC" if fcc else "cart"
        print(f"[7] small hall {name} fp64 ({s.vox.Nx} x {s.vox.Ny} x "
              f"{s.vox.Nz}, {o.Nt} steps, Nbl {o.Nbl}) on the card vs "
              f"NumpyEngine: {errs}; balance {bal:.3e}, E_lost[-1] "
              f"{e.E_lost[-1]:.6e}; launches energy {named(c)}, tb "
              f"{named(c_tb)}", flush=True)
        require(max(errs.values()) <= 1e-12,
                f"small hall {name} vs the oracle: {errs}")
        require(bal < 1e-10 and e.E_lost[-1] > 0,
                f"small hall {name}: balance {bal}, E_lost {e.E_lost[-1]}")
        require(c == energy_launches(o.Nt)
                and c_tb == launches(K1=o.Nt % 3, K2=o.Nt % 3,
                                     K3=o.Nt // 3),
            f"small hall {name}: launches {named(c)}, {named(c_tb)}")


def phase8(roof):
    """setup_1e9 at full size in a subprocess (see the module docstring);
    each kernel's bound at the read+write roof of phase 1 is printed;
    returns {kernel: (its launches over the routes, its ms a call in the
    check, or None)} for K1, K2, K3, K5, K1e and K7."""
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "pffdtd_tpu_torch.examples.setup_1e9",
         "--check", "--routes", ",".join(ROUTES_1E9)],
        cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=TIMEOUT_1E9)
    secs = time.perf_counter() - t0
    for line in p.stdout.splitlines():
        if line.startswith("[setup_1e9]"):
            print("[8]" + line[len("[setup_1e9]"):], flush=True)
    require(p.returncode == 0, f"setup_1e9 exited with {p.returncode}:\n"
            f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
    rec = json.loads(p.stdout.strip().splitlines()[-1])["setup_1e9"]
    require(rec["grid"] == GRID_1E9, f"setup_1e9 grid {rec['grid']}, want "
            f"{GRID_1E9}")
    nt = rec["nt"]
    require(nt == rec["Nt"] > 608, f"setup_1e9 ran {nt} of {rec['Nt']} "
            f"steps: the direct sound needs about 608")
    zero = dict.fromkeys(WRAPPERS, 0)
    want = {"step": dict(zero, K1=nt, K2=nt),
            "tb": dict(zero, K1=nt % 3, K2=nt % 3, K3=nt // 3),
            "x4": dict(zero, K2=4 * nt, K5=4 * nt),
            "energy": dict(zero, K1e=nt, K2=nt, K7=nt)}
    for route, r in rec["routes"].items():
        require(r["launches"] == want[route], f"setup_1e9 {route} launches "
                f"{r['launches']}, want {want[route]}")
        require(r["max_abs_u"] > 0, f"setup_1e9 {route}: u_out all zero")
    require(list(rec["routes"]) == list(ROUTES_1E9),
            f"setup_1e9 routes {list(rec['routes'])}")
    errs = rec["receivers_vs_first"]
    require(max(errs.values()) <= 1e-5, f"setup_1e9 receivers: {errs}")
    en = rec["routes"]["energy"]
    require(en["balance"] < 1e-9, f"setup_1e9 fp64 energy balance "
            f"{en['balance']}")
    print(f"[8] setup_1e9: {secs:.1f} s in all, of which the fp64 energy "
          f"route {en['route_s']:.1f} s ({en['mvps']:.1f} MVPS, "
          f"{en['ms_step']:.4f} ms a step, peak {en['peak_gb']:.2f} GB "
          f"against {en['reckoned_gb']:.2f} reckoned, balance "
          f"{en['balance']:.3e}); receivers vs step {errs}, the fp64 energy "
          f"route's {rec['energy_fp64_vs_first']:.3e}", flush=True)
    # a check that would not fit the card's free memory is skipped and
    # printed as such by the subprocess; one that ran agreed, or it failed
    checks = {k: c for r in rec["routes"].values()
              for k, c in r["checks"].items()}
    for k, c in checks.items():
        if "ms" in c:
            b = c["bytes_gb"] / roof * 1e3
            print(f"[8] {k} {c['ms']:.4f} ms a call, plain {c['plain_ms']:.4f}"
                  f" ms; bound {b:.4f} ms at the roof ({c['bytes_gb']:.4f} "
                  f"GB), {100 * b / c['ms']:.1f}% of it", flush=True)
    names = {"K1": "K1 stencil_step", "K2": "K2 boundary_update",
             "K3": "K3 tb_sweep", "K5": "K5 stencil_step_shard",
             "K1e": "K1e stencil_energy_step", "K7": "K7 energy_terms"}
    return {name: (sum(r["launches"][k] for r in rec["routes"].values()),
                   checks.get(k, {}).get("ms")) for k, name in names.items()}


def bench_want(r):
    """The launches (a counts() tuple) one counted bench run `r` must make:
    K1 (K5 on x-slabs) and K2 a step, K3 (K6) a sweep with the rest of nt
    in single steps, K2 only where the scene has lossy nodes, and on the
    energy route K1e, K2 and K7's boundary pass a step."""
    nt, TB, D, k2 = r["nt"], r["TB"], r["x_slabs"], int(r["lossy"])
    if r["route"] == "energy":
        return launches(K1e=nt, K2=k2 * nt, K7=nt)
    sweeps, rest = divmod(nt, TB) if TB else (0, nt)
    if D == 0:
        return launches(K1=rest, K2=k2 * rest, K3=sweeps)
    return launches(K5=D * rest, K2=k2 * D * rest, K6=D * sweeps)


def bench_launches(err):
    """Phase 9's launch checks on the bench's stderr (its BENCH_LAUNCHES
    lines, see the bench's docstring); returns {kernel: launches over
    every counted run}."""
    recs = {}
    for line in err.splitlines():
        if line.startswith("BENCH_LAUNCHES "):
            _, item, payload = line.split(" ", 2)
            recs[item] = json.loads(payload)
    require(set(recs) == set(BENCH_RUNS), f"the bench's launches came from "
            f"{sorted(recs)}, want {sorted(BENCH_RUNS)}")
    total = dict.fromkeys(WRAPPERS, 0)
    for item, runs in recs.items():
        tags = {}
        for r in runs:
            tags.setdefault(r["tag"], []).append(r)
            c = tuple(r["launches"].get(k, 0) for k in WRAPPERS)
            for k, n in zip(WRAPPERS, c):
                total[k] += n
            if r["route"] == "stream":
                require(set(r["launches"]) == {"K4"},
                        f"the bench's roof launched {r['launches']}")
                continue
            require(r["nt"] > 0 and c == bench_want(r), f"the bench's "
                    f"{item} {r['tag']} ({r['route']} TB={r['TB']}, "
                    f"{r['x_slabs']} x-slabs, {r['nt']} steps): launches "
                    f"{r['launches']}, want {named(bench_want(r))}")
            open_top = item in BENCH_OPEN_TOP
            require((r["abc_nodes"] > 0) == open_top and r["lossy"]
                    >= open_top, f"the bench's {item} {r['tag']}: "
                    f"{r['abc_nodes']} lossy nodes on an ABC layer")
        got = {t: (rs[0]["route"], rs[0].get("TB"), rs[0].get("x_slabs"),
                   len(rs)) for t, rs in tags.items()}
        require(got == BENCH_RUNS[item], f"the bench's {item} ran {got}, "
                f"want {BENCH_RUNS[item]}")
        print(f"[9] launches {item}: " + "; ".join(
            f"{t} {named(tuple(rs[-1]['launches'].get(k, 0) for k in WRAPPERS))}"
            f" x{len(rs)}" for t, rs in tags.items()), flush=True)
    used = {k for k, n in total.items() if n}
    require(used == {"K1", "K2", "K3", "K4", "K5", "K6", "K7", "K1e"},
            f"the bench launched {sorted(used)}")
    return total


def phase9(card):
    """The bench, `python -m pffdtd_tpu_torch.bench`, in a subprocess (its
    own session: a timeout kills it and its item processes), every item but
    BENCH_SKIP's; its line and its runs' launches are checked and printed;
    returns {kernel: launches over the bench's counted runs}."""
    t0 = time.perf_counter()
    env = dict(os.environ, BENCH_SKIP=BENCH_SKIP)
    env.pop("BENCH_ONLY", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pffdtd_tpu_torch.bench"],
        cwd=Path(__file__).resolve().parent, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_BENCH)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"the bench ran past {TIMEOUT_BENCH} s")
    secs = time.perf_counter() - t0
    for line in err.splitlines():
        if "[bench]" in line or line.startswith("["):
            print(f"[9] {line.strip()}", flush=True)
    require(proc.returncode == 0, f"the bench exited with "
            f"{proc.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    lines = out.strip().splitlines()
    require(lines, "the bench printed no line")
    try:
        rec = json.loads(lines[-1])
    except json.JSONDecodeError as e:
        raise SmokeFailure(f"the bench's last line is not JSON: {e}: "
                           f"{lines[-1][:300]}")
    sec = rec.get("secondary", {})
    require(rec.get("metric") == BENCH_METRIC and (rec.get("value") or 0) > 0,
            f"the bench's headline: {rec.get('metric')} = {rec.get('value')}")
    require("headline_note" not in rec,
            f"the bench fell back: {rec.get('headline_note')}")
    dev = rec.get("device", {})
    require(dev.get("name") == torch.cuda.get_device_name(0)
            and dev.get("count") == 1
            and f"{dev.get('power_limit_w'):.2f} W" in card,
            f"the bench's device {dev}, the card {card}")
    missing = [k for k in BENCH_KEYS if k not in sec]
    require(not missing, f"the bench's line lacks {missing}")
    for k in ("sharded_pair_vs_single_err", "sharded_step_vs_single_err"):
        require(sec[k] < 1e-4, f"the bench's {k} = {sec[k]}")
    require(sec["kernel_vs_energy_route_err"] <= 1e-5,
            f"kernel_vs_energy_route_err {sec['kernel_vs_energy_route_err']}")
    drift = (sec["fp32_tail_to_head_rms_50k"],
             sec["fp32_tail_to_head_rms_50k_lossy"])
    require(all(np.isfinite(drift)) and drift[1] <= 1.0,
            f"the bench's drift ratios {drift}: finite, the lossy one <= 1")
    total = bench_launches(err)
    print(f"[9] the bench: {secs:.1f} s, skipped {BENCH_SKIP}; launches "
          f"over its counted runs {named(tuple(total.values()))}; its line:",
          flush=True)
    print(lines[-1], flush=True)
    return total


def oriented(sim, orient):
    """The scene rotated by `orient` (rotate_sim's), folded when FCC,
    sorted."""
    sim = rotate_sim(sim, orient=orient)
    return sort_sim(fold_fcc_sim(sim) if sim.consts.fcc_flag == 1 else sim)


def phase10(gen, card):
    """orient="auto" against "descending" on the shoebox hall and the
    headline (see the module docstring); returns {kernel: launches} of its
    counted runs."""
    t0 = time.perf_counter()
    total = dict.fromkeys(WRAPPERS, 0)
    for name in ORIENT_SCENES:
        sim = orient_probe.SCENES[name](NT)
        v = sim.vox
        N, fcc = (v.Nx, v.Ny, v.Nz), int(sim.consts.fcc_flag)
        faces = boundary_face_counts(v)
        score = orientation_scores(N, faces, fcc)
        tr, desc = rotation_of(sim), rotation_of(sim, "descending")
        print(f"[10] {name} {N} (fcc {fcc}): scores "
              f"{[f'{x:.0f}' for x in score]} ns a step with "
              f"x, y, z on z; lane fill {[lane_fill(n) for n in N]}; auto "
              f"{tr}, descending {desc}", flush=True)
        if name != ORIENT_SCENES[0] and tr == desc:
            continue
        runs = {}
        for orient in ("auto", "descending"):
            ps = oriented(sim, orient)
            want = tr if orient == "auto" else desc
            require((ps.vox.Nx, ps.vox.Nz) == (N[want[0]], N[want[2]]),
                    f"{name} {orient}: grid {ps.vox.Nx, ps.vox.Ny, ps.vox.Nz}"
                    f" is not {want} of {N}")
            eng = engine(ps, np.float32)
            u, t, c = run_route(eng, launches(K1=NT, K2=NT))
            for k, n in named(c).items():
                total[k] += n
            g = eng.data.grid
            runs[orient] = (orient_probe.receivers(ps, u),
                            g.Nx * g.Ny * g.Nz * NT / t / 1e6)
            if orient == "auto":
                chk = kernel_checks(eng, gen)
                require(all(chk[k][1] == 0 for k in ("K1", "K2")),
                        f"{name} auto: K1, K2 vs plain {chk}")
                eng_tb = engine(ps, np.float32, backend="tb", tb=3)
                ut, tt, ct = run_route(eng_tb, counts_of(eng_tb, 1))
                for k, n in named(ct).items():
                    total[k] += n
                err_tb = rel_err(ut, u)
                require(err_tb <= 1e-5, f"{name} auto: tb route vs step "
                        f"{err_tb}")
                tb_mvps = g.Nx * g.Ny * g.Nz * NT / tt / 1e6
                del eng_tb
            del eng
            torch.cuda.empty_cache()
        err = rel_err(runs["auto"][0], runs["descending"][0])
        require(np.isfinite(runs["auto"][0]).all() and err <= 1e-5,
                f"{name}: auto's receivers vs descending's {err}")
        (_, m_auto), (_, m_desc) = runs["auto"], runs["descending"]
        print(f"[10] {name} step route, {NT} fp32 steps, best of 3 ({card})"
              f": auto {m_auto:.1f} MVPS, descending {m_desc:.1f} "
              f"({m_auto / m_desc:.4f}x); "
              f"receivers vs descending's {err:.3e} of max |u_out|; on "
              f"auto's layout K1 and K2 bitwise equal to their plain "
              f"versions, the tb route (TB = 3) {tb_mvps:.1f} MVPS, "
              f"receivers vs its step route {err_tb:.3e}", flush=True)
    print(f"[10] {time.perf_counter() - t0:.1f} s; launches "
          f"{named(tuple(total.values()))}", flush=True)
    return total


def main():
    t_start = time.perf_counter()
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
    probe = measure(STREAM_MB)
    k4_launches = counts()[3]
    require(k4_launches > 0, "the bandwidth probe launched no K4")
    for r in probe:
        print(f"[1] K4 {r['mode']:5s} {r['size_mb']:5d} MB: "
              f"{r['gbps']:.1f} GB/s ({r['ms']:.4f} ms, windows spread "
              f"{100 * r['spread']:.2f}%); torch {r['torch_gbps']:.1f} GB/s "
              f"({r['torch_ms']:.4f} ms, {100 * r['torch_spread']:.2f}%)",
              flush=True)
    copies = [r for r in probe if r["mode"] == "copy"]
    # the roof: the faster of K4's copy and copy_, so no bound rests on a
    # slow probe
    roof = max(max(r["gbps"], r["torch_gbps"]) for r in copies)
    k4 = max(copies, key=lambda r: r["size_mb"])
    print(f"[1] read+write roof {roof:.1f} GB/s (K4 copy "
          f"{max(r['gbps'] for r in copies):.1f}, copy_ "
          f"{max(r['torch_gbps'] for r in copies):.1f})", flush=True)

    # ---- host setup of the main path's scene, one engine per route
    t0 = time.perf_counter()
    sim = headline_scene(NT)
    t_scene = time.perf_counter() - t0
    eng_tb = engine(sim, np.float32, backend="tb", tb=3)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    eng_pair = engine(sim, np.float32, backend="pair")
    eng = engine(sim, np.float32)    # the default route: "auto"
    require((eng.backend, eng.TB) == pick_route("auto"),
            f"auto took {eng.backend} TB={eng.TB}, the rule says "
            f"{pick_route('auto')}")
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
    require(eng.abcq is None, "the headline put a lossy node on an ABC "
            "layer")
    print(f"[2] K2 at the headline, no node on an ABC layer (K2 as it "
          f"was): {main_chk['K2'][2]:.4f} ms, before the ABC mode "
          f"{K2_PARENT_MS:.4f} ({100 * main_chk['K2'][2] / K2_PARENT_MS:.1f}"
          f"%)", flush=True)
    # the ABC modes at the headline's size: the box without its top wall,
    # on the tb route (TB = 3), which phase 4 runs beside its step route
    sim_open = headline_scene(NT, open_top=True)
    eng_open = engine(sim_open, np.float32, backend="tb", tb=3)
    nflag, ms_abc, pms_abc, ms_off = k2_abc_check(eng_open, gen,
                                                  timing_reps=20)
    isz = eng_open.data.dtype.itemsize
    k2_abc = SimpleNamespace(
        nbl=eng_open.data.Nbl, nflag=nflag, ms=ms_abc, off=ms_off,
        plain_ms=pms_abc,
        nbytes=eng_open.data.Nbl * (4 * MMb * isz + 8 + isz + 4 + 3 * isz
                                    + 1))
    print(f"[2] K2 ABC mode, the open-top headline box ({nflag} of "
          f"{k2_abc.nbl} lossy nodes on an ABC layer): bitwise equal to its "
          f"plain version; {ms_abc:.4f} ms (without the mode on the same "
          f"inputs {ms_off:.4f}), plain {pms_abc:.4f} ms, "
          f"{k2_abc.nbytes / 1e6:.1f} MB", flush=True)
    # K3 in its ABC mode (TB = 3) and K6 (TB = 3, slab 1 of 4) on the same
    # box, each beside itself without the mode on the same inputs, in turns
    r, a, _, pms, t = tb_check(eng_open, gen, timing_reps=20, abc=True)
    require(a == 0.0, f"K3's ABC mode differs from its plain version: {a}")
    k3_abc = SimpleNamespace(ms=min(t["ABC mode"]), off=min(t["without"]),
                             plain_ms=pms, nbytes=k3_bytes(eng_open))
    ex_open = sharded(sim_open, np.float32, 4, backend="tb", tb=3)
    r6, a6, _, pms6, t6 = k6_check(ex_open, gen, 1, timing_reps=20,
                                   abc=True)
    require(r6 <= 1e-5, f"K6's ABC mode disagrees with its plain version: "
            f"{r6}")
    nb6, no6 = slab_bytes_ops(ex_open, 1)
    k6_abc = SimpleNamespace(ms=min(t6["ABC mode"]), off=min(t6["without"]),
                             plain_ms=pms6, nbytes=nb6, nops=no6,
                             nflag=int((ex_open.shards[1].abcq > 0).sum()),
                             nbl=ex_open.shards[1].bnl.numel())
    del ex_open
    torch.cuda.empty_cache()
    for name, x, w in (("K3 TB=3", k3_abc, t), ("K6 TB=3 slab 1/4", k6_abc,
                                                  t6)):
        print(f"[2] {name} ABC mode, the open-top headline box: "
              f"{x.ms:.4f} ms a sweep, without the mode on the same inputs "
              f"{x.off:.4f} ({100 * x.ms / x.off:.1f}%; windows "
              f"{', '.join(f'{k} ' + ' '.join(f'{v:.4f}' for v in vs) for k, vs in w.items())}"
              f"), plain {x.plain_ms:.4f} ms, {x.nbytes / 1e9:.4f} GB",
              flush=True)
    print(f"[2] K3 ABC mode bitwise equal to its plain version; K6 max rel "
          f"err {r6:.3e} (abs {a6:.3e})", flush=True)
    en_chk = energy_check(eng, gen, timing_reps=20)
    energy_print_require("fp32 main shapes", en_chk, fp32=True)
    # K3 at every TB on the headline scene: checked against its plain
    # version and timed, TB = 2 and 3 (the routes', on the pair and tb
    # engines' scenes) over 20 sweeps, the deeper ones over 3
    tb_chk = {}
    for TB in range(2, 9):
        e = {2: eng_pair, 3: eng_tb}.get(TB) or scene_engine(eng_tb, TB)
        deep = TB > 3
        r, a, ms, pms = tb_chk[TB] = tb_check(
            e, gen, timing_reps=3 if deep else 20, plain_reps=0 if deep else 2)
        tl = e.tb_scene.lists
        pt = f", plain {pms:.4f} ms/sweep" if pms is not None else ""
        print(f"[2] K3 TB={TB} fp32 main shapes: max rel err {r:.3e} (abs "
              f"{a:.3e}), kernel {ms:.4f} ms/sweep = {ms / TB:.4f} ms/step"
              f"{pt}; tiles {tl.box} x {tl.ntiles}, "
              f"{tile_threads(tl.box, TB)} threads", flush=True)
        require(r <= 1e-5, f"K3 TB={TB} fp32 disagrees: {r}")
        del e
    torch.cuda.empty_cache()
    best = min(tb_chk, key=lambda TB: tb_chk[TB][2] / TB)
    step_ms = main_chk["K1"][2] + main_chk["K2"][2]
    print(f"[2] per step: K3 at its best TB={best} "
          f"{tb_chk[best][2] / best:.4f} ms, the step route's K1 + K2 "
          f"{step_ms:.4f} ms; auto takes {eng.backend}", flush=True)
    small = {n: small_scene(n) for n in SMALL}
    for n, s in small.items():
        for k, (r, a, _, _) in kernel_checks(engine(s, np.float64),
                                             gen).items():
            print(f"[2] {k} fp64 {n}: max rel err {r:.3e}", flush=True)
            require(r <= 1e-12, f"{k} fp64 {n} disagrees: {r}")
        energy_print_require(f"fp64 {n}", energy_check(
            engine(s, np.float64), gen), fp32=False)
        for TB in (2, 3, 8):
            r = tb_check(engine(s, np.float64, backend="tb", tb=TB), gen)[0]
            print(f"[2] K3 TB={TB} fp64 {n}: max rel err {r:.3e}",
                  flush=True)
            require(r <= 1e-12, f"K3 TB={TB} fp64 {n} disagrees: {r}")
        for kw in ({"backend": "step"}, {"backend": "tb", "tb": 2},
                   {"backend": "tb", "tb": 3}):
            e = sharded(s, np.float64, 2, **kw)
            for k in range(2):
                r = (k5_check(e, gen, k) if e.TB is None
                     else k6_check(e, gen, k))[0]
                name = "K5" if e.TB is None else f"K6 TB={e.TB}"
                print(f"[2] {name} fp64 {n} slab {k}/2: max rel err "
                      f"{r:.3e}", flush=True)
                require(r <= 1e-12, f"{name} fp64 {n} slab {k} disagrees: "
                        f"{r}")

    # ---- 3. small scenes, fp64 kernel routes vs the plain path
    abc = {"K2": 0, "K3": 0, "K6": 0}    # launches in the ABC modes

    def add_abc(c):
        for k in abc:
            abc[k] += named(c).get(k, 0)

    for n in OPEN_SMALL:
        s = small_scene(n)
        e = engine(s, np.float64)
        for k, (r, a, _, _) in kernel_checks(e, gen).items():
            print(f"[3] {k} fp64 {n}: max rel err {r:.3e}", flush=True)
            require(r <= 1e-12, f"{k} fp64 {n} disagrees: {r}")
        nflag = k2_abc_check(e, gen)[0]
        up = engine(s, np.float64, use_kernels=False).run(verbose=False)
        reset_counts()
        uk = e.run(verbose=False)
        c = counts()
        require(c == launches(K1=e.Nt, K2=e.Nt), f"{n}: launches "
                f"{named(c)}")
        add_abc(c)
        err = rel_err(uk, up)
        ps = pad_x_interior(s, 2)
        up2 = engine(ps, np.float64).run(verbose=False)
        u2 = sharded(s, np.float64, 2).run(verbose=False)
        err2 = rel_err(u2, up2)
        print(f"[3] {n} fp64 ({nflag} of {e.data.Nbl} lossy nodes on an ABC "
              f"layer): K2's ABC mode bitwise equal to its plain version; "
              f"step route vs plain {err:.3e}, x2 slabs vs the single "
              f"device {err2:.3e} (bitwise: {np.array_equal(u2, up2)})",
              flush=True)
        require(np.isfinite(uk).all() and np.abs(up).max() > 0,
                f"{n}: not finite or empty")
        require(err <= 1e-12, f"{n} fp64 step route disagrees: {err}")
        require(err2 <= 1e-12, f"{n} fp64 x2 slabs disagree: {err2}")
        # K3 and K6 in their ABC modes, one sweep each from a random state
        for TB in (2, 3, 8):
            et = engine(s, np.float64, backend="tb", tb=TB)
            a = tb_check(et, gen)[1]
            require(et.tb_scene.abcq is not None and a == 0.0,
                    f"{n}: K3 TB={TB}'s ABC mode differs from its plain "
                    f"version: {a}")
        for TB in (2, 3):
            ex = sharded(s, np.float64, 2, backend="tb", tb=TB)
            for k in range(2):
                a = k6_check(ex, gen, k)[1]
                require(ex.shards[k].tb_scene.abcq is not None and a == 0.0,
                        f"{n}: K6 TB={TB} slab {k}'s ABC mode differs from "
                        f"its plain version: {a}")
        # the TB routes, one device and two slabs: bitwise the step route's
        # receivers (on the padded grid for the slabs)
        for kw in ({"backend": "tb", "tb": 3}, {"backend": "pair"},
                   {"backend": "tb", "tb": 8}):
            et = engine(s, np.float64, **kw)
            reset_counts()
            u = et.run(verbose=False)
            c = counts()
            require(c == counts_of(et, 1, et.Nt), f"{n} {kw}: launches "
                    f"{named(c)}")
            add_abc(c)
            require(np.array_equal(u, uk), f"{n} {kw}: the receivers differ "
                    f"from the step route's by {rel_err(u, uk):.3e}")
        for b in ("tb", "pair"):
            ex = sharded(s, np.float64, 2, backend=b)
            reset_counts()
            u = ex.run(verbose=False)
            c = counts()
            require(c == counts_of(ex, 2, ex.Nt), f"{n} x2 {b}: launches "
                    f"{named(c)}")
            add_abc(c)
            require(np.array_equal(u, up2), f"{n} x2 {b}: the receivers "
                    f"differ from the single device's step route's by "
                    f"{rel_err(u, up2):.3e}")
        # the energy route (K1e + K2's ABC mode + K7) vs its plain version
        ek = engine(s, np.float64, energy_on=True)
        reset_counts()
        ue = ek.run(verbose=False)
        c = counts()
        require(c == energy_launches(ek.Nt), f"{n} energy route "
                f"launches {named(c)}")
        add_abc(c)
        ep = engine(s, np.float64, energy_on=True, use_kernels=False)
        ep.run(verbose=False)
        errs = {a: float(np.abs(getattr(ek, a) - getattr(ep, a)).max()
                         / np.abs(getattr(ep, a)).max())
                for a in ("H_tot", "E_lost", "E_in")}
        require(max(errs.values()) <= 1e-12, f"{n}: energies vs plain "
                f"{errs}")
        require(np.array_equal(ue, uk), f"{n}: the energy route changed "
                f"the receivers")
        print(f"[3] {n} fp64: K3 (TB = 2, 3, 8) and K6 (TB = 2, 3, both "
              f"slabs) in their ABC modes bitwise equal to their plain "
              f"versions; tb TB=3, pair, tb TB=8 and x2 tb, pair receivers "
              f"bitwise equal to the step route's; energy route vs plain "
              f"{errs}, receivers bitwise equal to the energy-off run, "
              f"balance {np.abs(ek.energy_balance()).max():.3e} (the "
              f"reference's functional, which has no term for a lossy node "
              f"on an ABC layer: not held under 1e-10 here; plain path "
              f"{np.abs(ep.energy_balance()).max():.3e})", flush=True)
    print(f"[3] launches in the ABC modes: {abc}", flush=True)
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
        ps = pad_x_interior(s, 2)          # the grid the D = 2 slabs run
        up2 = engine(ps, np.float64, backend="step",
                     use_kernels=False).run(nt=NT_SMALL, verbose=False)
        for kw in ({"backend": "step"}, {"backend": "tb", "tb": 3},
                   {"backend": "pair"}):
            uk = sharded(s, np.float64, 2, **kw).run(nt=NT_SMALL,
                                                      verbose=False)
            err = np.abs(uk - up2).max() / np.abs(up2).max()
            print(f"[3] {n} fp64 x2 slabs {kw} receivers vs plain: "
                  f"{err:.3e}", flush=True)
            require(np.isfinite(uk).all(), f"{n} x2 {kw}: not finite")
            require(err <= 1e-12, f"{n} x2 {kw}: fp64 route disagrees: "
                    f"{err}")
    for n, s in small.items():
        eps_check(n, s)

    # ---- 4. the main path: 128 fp32 steps per route, best of 3
    tb3 = NT // 3, NT % 3
    u_tb, t_tb, c_tb = run_route(eng_tb, launches(K1=tb3[1], K2=tb3[1],
                                                  K3=tb3[0]))
    u_pr, t_pr, c_pr = run_route(eng_pair, launches(K3=NT // 2))
    u_k, t_k, c_k = run_route(eng, launches(K1=NT, K2=NT))
    # the dashboard's air / boundary split on the step route
    sp = split_check(eng, main_chk["K2"][2], u_k)
    print(f"[4] split: bn_ms_per_step {sp.bn:.4f} ms (again on the final "
          f"state {sp.bn2:.4f}), phase 2's K2 {main_chk['K2'][2]:.4f} ms "
          f"({sp.bn / main_chk['K2'][2]:.3f}x); bn {sp.pct} % of each "
          f"chunk's ms a step; receivers and final state bitwise the quiet "
          f"run's; extra peak memory: the probe's own {sp.own / 1e6:.1f} MB "
          f"beside vh + gh {sp.vhgh / 1e6:.1f} MB, the verbose run's over "
          f"the quiet run's {sp.run_extra / 1e6:.1f} MB; quiet "
          f"{npts * NT / sp.t_q / 1e6:.1f} MVPS, verbose "
          f"{npts * NT / sp.t_v / 1e6:.1f} (chunks of {NT // 4}, the probe "
          f"outside the loop's time)", flush=True)
    eng.use_kernels = False
    reset_counts()
    t_p = []
    for _ in range(3):
        u_p = eng.run(nt=NT, verbose=False)
        t_p.append(eng.elapsed)
    require(counts() == ZERO, "the plain path launched a kernel")
    scale = np.abs(u_p).max()
    isz = eng.state[0].element_size()
    ni = g.n_interior
    k1_ms, k2_ms = main_chk["K1"][2], main_chk["K2"][2]
    k1_bytes = ni * 3 * isz + adj_bytes(eng.adj, ni)
    # the open-top box (phase 2's) on the tb route, K3 in its ABC mode,
    # beside its step route, K2 in its ABC mode
    u_otb, t_otb, c_otb = run_route(eng_open, counts_of(eng_open, 1))
    add_abc(c_otb)
    eng_open_step = engine(sim_open, np.float32)
    u_ost, t_ost, c_ost = run_route(eng_open_step, counts_of(eng_open_step,
                                                             1))
    add_abc(c_ost)
    require(np.array_equal(u_otb, u_ost), "the open-top headline box's tb "
            f"route differs from its step route by {rel_err(u_otb, u_ost)}")
    print(f"[4] the open-top headline box ({k2_abc.nflag} of {k2_abc.nbl} "
          f"lossy nodes on an ABC layer): tb TB=3 {npts * NT / t_otb / 1e6:.1f}"
          f" MVPS (best {t_otb:.4f} s, launches {named(c_otb)}), step "
          f"{npts * NT / t_ost / 1e6:.1f} (best {t_ost:.4f} s, "
          f"{named(c_ost)}); receivers bitwise equal", flush=True)
    del eng_open, eng_open_step
    torch.cuda.empty_cache()
    geo = stencil_step.geometry
    print(f"[4] launches per {NT} steps: tb TB=3 {named(c_tb)}, "
          f"pair {named(c_pr)}, step {named(c_k)}; K1's last launch: "
          f"tiles {geo.By} x {geo.Bz}, chunks of {geo.Cx} rows, "
          f"{geo.blocks} blocks", flush=True)
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
    k3_nbytes = k3_bytes(eng_tb)
    for TB, e in ((3, eng_tb), (2, eng_pair)):
        nb = k3_bytes(e)
        print(f"[4] K3 TB={TB} bound {nb / roof / 1e6:.4f} ms at the roof "
              f"({nb / HBM_BPS * 1e3:.4f} at the published rate), "
              f"{nb / 1e9:.4f} GB", flush=True)
    for TB, (_, _, ms, _) in tb_chk.items():
        print(f"[4] K3 TB={TB} {ms:.4f} ms/sweep, {ms / TB:.4f} ms/step "
              f"(step route K1 + K2 {k1_ms + k2_ms:.4f}), "
              f"{ni * (4 * isz + eng_tb.adj.element_size()) / ms / 1e6:.1f} "
              f"GB/s at 18 B/voxel per sweep", flush=True)
    print(f"[4] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    single = {("step", g.Nx): (u_k, t_k, g)}   # (route, Nx) -> run
    del eng_tb, eng_pair
    torch.cuda.empty_cache()
    p5 = phase5(sim, gen, single, roof)
    (c_e, e_ms), k8_row = phase6(sim, eng, u_k, t_k, small)
    k2_bytes = eng.data.Nbl * (4 * MMb * isz + 8 + isz + 4 + 3 * isz)
    # the whole energy step, each input read and each output written once:
    # u^{n-1}, u^n, adj and L u^{n-1} in, u^{n+1} and L u^n out, an
    # interior point; K2's nodes (branch states in and out); the sums
    e_bytes = en_chk.nbytes["K1e"] + k2_bytes
    print(f"[6b] the fp32 energy step moves at least {e_bytes / 1e9:.4f} GB:"
          f" {e_bytes / roof / 1e6:.4f} ms at the roof "
          f"({e_bytes / HBM_BPS * 1e3:.4f} at the published rate); the "
          f"route {e_ms:.4f} ms a step "
          f"({100 * e_bytes / roof / 1e6 / e_ms:.1f}% of it)",
          flush=True)
    phase7(gen, npts * NT / t_k / 1e6, g.shape)

    k4_bytes = 2 * k4["size_mb"] * (1 << 20)
    rows = {
        "K1 stencil_step": (c_k[0], main_chk["K1"][1], k1_ms,
                            main_chk["K1"][3], k1_bytes, 29.0 * ni, None),
        "K2 boundary_update": (c_k[1], main_chk["K2"][1], k2_ms,
                               main_chk["K2"][3], k2_bytes,
                               80.0 * eng.data.Nbl, None),
        "K3 tb_sweep": (c_tb[2], tb_chk[3][1], tb_chk[3][2], tb_chk[3][3],
                        k3_nbytes, 3 * 29.0 * ni
                        + 3 * 80.0 * eng.data.Nbl, None),
        "K4 stream": (k4_launches, s_err, k4["ms"], k4["torch_ms"], k4_bytes,
                      0.0, k4["torch_ms"]),
        **p5,
        # K7 on the energy route: its boundary pass (K1e does the grid's)
        "K7 energy_terms": (c_e[6], en_chk.err, en_chk.ms["K7"],
                            en_chk.pms["K7"], en_chk.nbytes["K7"],
                            3.0 * shell_points(g)
                            + 10.0 * MMb * eng.data.Nbl, None),
        "K8 modal_recurrence": k8_row,
        # K1's step with K7's grid half: 29 operations a point, 9 more
        "K1e stencil_energy_step": (c_e[8], en_chk.err, en_chk.ms["K1e"],
                                    en_chk.pms["K1e"],
                                    en_chk.nbytes["K1e"], 38.0 * ni, None),
    }
    # phases 8 and 9 run in processes of their own: free this one's fields
    del eng
    torch.cuda.empty_cache()
    p8 = phase8(roof)
    p9 = phase9(card)
    p10 = phase10(gen, card)
    rec = {"kernels": []}
    for name, (n, err, ms, pms, nbytes, nops, lib_ms) in rows.items():
        b, by = bound_ms(nbytes, nops, fp64=name in FP64_ROWS)
        rec["kernels"].append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": n,
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b,
            "bound_by": by, "library_ms": lib_ms,
            "bound_roof_ms": nbytes / roof / 1e6,
            "launches_1e9": p8.get(name, (0, None))[0],
            "ms_1e9": p8.get(name, (0, None))[1],
            "launches_bench": p9[name.split()[0]],
            "launches_orient": p10[name.split()[0]]})
    # the ABC modes: their times on the open-top headline box (phase 2),
    # beside the kernel without the mode on the same inputs (K2: the time
    # measured by k2_abc_check), and their launches on the open-top scenes
    # (phases 3 and 4)
    nl = k2_abc.nbl
    for name, x, nops in (
            ("K2 boundary_update", k2_abc, 80.0 * nl),
            ("K3 tb_sweep", k3_abc, 3 * 29.0 * ni + 3 * 80.0 * nl),
            ("K6 tb_sweep_shard", k6_abc, k6_abc.nops)):
        b, by = bound_ms(x.nbytes, nops)
        row = next(r for r in rec["kernels"] if r["name"] == name)
        row["abc_mode"] = {
            "ms": x.ms, "ms_without": x.off, "plain_ms": x.plain_ms,
            "bound_ms": b, "bound_by": by,
            "bound_roof_ms": x.nbytes / roof / 1e6,
            "launches": abc[name.split()[0]],
            "flagged": getattr(x, "nflag", k2_abc.nflag),
            "nodes": getattr(x, "nbl", nl)}
    k2_row = next(r for r in rec["kernels"] if r["name"].startswith("K2"))
    k2_row["bn_ms_per_step"] = sp.bn
    print(f"[end] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card)   # again, where the end of a long output keeps it
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


class Verdicts:
    """The checks of `--cards`, each printed and kept; a section that
    raises is printed and kept as a failure, and the run goes on, so one
    call on four cards reports every fault at once.  `close` fails the
    run if any check failed."""

    def __init__(self):
        self.failed = []

    def __call__(self, cond, msg):
        if not cond:
            self.failed.append(msg)
            print(f"[cards] FAIL: {msg}", flush=True)

    @contextlib.contextmanager
    def section(self, name):
        try:
            yield
        except Exception as e:        # reported here, fatal at `close`
            traceback.print_exc(file=sys.stdout)
            self(False, f"{name}: {type(e).__name__}: {e}")
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    def close(self):
        require(not self.failed, f"{len(self.failed)} checks failed: "
                f"{self.failed}")


def fit_slabs(sim, D, G):
    """`sim` padded with exterior air so its interior rows split into D
    slabs of at least 2G rows (K6's least, `TBScene.make_slab`)."""
    sim = pad_x_interior(sim, D)
    if (sim.vox.Nx - 2) // D < 2 * G:
        sim = pad_x_interior(sim, 2 * G * D)
    return sim


def busy_by_card(eng, top=6):
    """One NT-step run of `eng` under torch.profiler (host and device):
    {card index: ms of its kernels and copies}, the traced run's seconds,
    and the `top` host operations by their own host time, {name: (calls,
    us of own host time)} a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(nt=NT, verbose=False)
    busy = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            busy[ev.device_index] = (busy.get(ev.device_index, 0.0)
                                     + ev.time_range.elapsed_us() / 1e3)
    host = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda a: -a.self_cpu_time_total)[:top]
    return busy, eng.elapsed, {a.key: (a.count / NT,
                                       a.self_cpu_time_total / NT)
                               for a in host}


def states_equal(a, b):
    """Two x-slab engines' final states (`global_state`) bitwise equal."""
    return all(np.array_equal(x, y)
               for x, y in zip(a.global_state(), b.global_state()))


def cards_headline(sim, scene, D, backend, kw, cards, single, gen, v, recs):
    """One x-slab configuration of the headline box with one slab per card
    (cards[:D]), beside the same slabs on cuda:0 and the single-device
    engine on the padded grid (every run best of 3, launches checked):
    receivers within 1e-5 of the single device's (bitwise printed),
    receivers and final state bitwise the one-card slabs'; MVPS, frac,
    each card's exchange ms a step and peak memory, and each card's
    device time in a traced run.  At D = 4, K5 or K6 on every slab's
    live state on its card, bitwise its plain version, and slab 1 timed
    on its card beside the same slab on cuda:0, in turns."""
    devs = cards[:D]
    used = list(dict.fromkeys(devs))
    u_ref, t_ref, g_ref = single_run(pad_x_interior(sim, D), backend, kw,
                                     single)
    e0 = sharded(sim, np.float32, D, backend=backend, **kw)
    u_one, t_one, _ = run_route(e0, counts_of(e0, D))
    base = {d: torch.cuda.memory_allocated(d) for d in used}
    t0 = time.perf_counter()
    es = sharded(sim, np.float32, D, devices=devs, backend=backend, **kw)
    for d in used:
        torch.cuda.synchronize(d)
    t_set = time.perf_counter() - t0
    name = f"{scene} x{D} {backend}" + (f" TB={es.TB}" if es.TB else "")
    for d in used:
        torch.cuda.reset_peak_memory_stats(d)
    u, t, c = run_route(es, counts_of(es, D))
    peak = {d: (torch.cuda.max_memory_allocated(d) - base[d]) / 1e9
            for d in used}
    same_state = states_equal(es, e0)
    es.run(nt=NT, verbose=False, time_exchange=True)
    xch = {k: ms / NT for k, ms in es.exchange_ms_by_card.items()}
    busy, t_traced, host = busy_by_card(es)
    g = es.data.grid
    npts = g.Nx * g.Ny * g.Nz
    mv, mv1 = npts * NT / t / 1e6, npts * NT / t_ref / 1e6
    err = rel_err(u, u_ref)
    row = dict(scene=scene, D=D, route=backend, TB=es.TB, grid=list(g.shape),
               rows=es.S, mvps=mv, single_mvps=mv1, frac=mv / mv1,
               one_card_mvps=npts * NT / t_one / 1e6, seconds=t,
               setup_s=t_set, exchange_ms_step=xch,
               peak_gb={str(d): x for d, x in peak.items()},
               busy_ms_step={k: x / NT for k, x in busy.items()},
               traced_s=t_traced, host_us_step=host, err=err,
               bitwise_single=bool(np.array_equal(u, u_ref)),
               bitwise_one_card=bool(np.array_equal(u, u_one)),
               state_bitwise_one_card=same_state, launches=named(c))
    print(f"[cards] {name}: {D} slabs of {es.S} rows on {g.shape} on "
          f"{', '.join(map(str, used))}, host setup {t_set:.2f} s; "
          f"{mv:.1f} MVPS (best {t:.4f} s), frac {mv / mv1:.4f} of one "
          f"card's {mv1:.1f} (the same slabs on cuda:0 "
          f"{row['one_card_mvps']:.1f}); exchange ms a step by card "
          f"{ {k: round(x, 4) for k, x in xch.items()} }; peak GB by card "
          f"{ {str(d): round(x, 2) for d, x in peak.items()} }; device ms "
          f"a step by card (traced run, {t_traced:.4f} s) "
          f"{ {k: round(x, 4) for k, x in row['busy_ms_step'].items()} }, "
          f"its top host operations (calls, own us) a step "
          f"{ {k: (round(n, 2), round(x, 1)) for k, (n, x) in host.items()} }"
          f"; launches {named(c)}; receivers vs one card {err:.3e} of max "
          f"|u_out| {np.abs(u_ref).max():.3e}, bitwise equal "
          f"{row['bitwise_single']}; receivers and final state bitwise the "
          f"same slabs on cuda:0's {row['bitwise_one_card']} "
          f"{same_state}", flush=True)
    v(err <= 1e-5, f"{name}: receivers {err} from the single device's")
    v(row["bitwise_one_card"] and same_state, f"{name}: differs from the "
      "same slabs on cuda:0")
    v(c == counts_of(es, D), f"{name}: launches {named(c)}")
    if D == 4:
        fn = k5_check if es.TB is None else k6_check
        what = "K5" if es.TB is None else f"K6 TB={es.TB}"
        abc = [sh.abcq is not None for sh in es.shards]
        errs = [fn(es, gen, k, live=True)[1] for k in range(D)]
        print(f"[cards] {name}: {what} on each slab's live state on its "
              f"card {', '.join(str(sh.dev) for sh in es.shards)}, ABC mode "
              f"{abc}: max abs err vs its plain version {errs}", flush=True)
        v(max(errs) == 0.0, f"{name}: {what} differs from its plain version "
          f"on a card: {errs}")
        v(any(abc) == (scene == "open"), f"{name}: ABC modes {abc}")
        row.update(kernel=what, kernel_abs_err=errs, abc_mode=abc)
        if scene == "closed":          # slab 1 on its card beside cuda:0
            ms = {}
            for e in (e0, es, es, e0):
                r = fn(e, gen, 1, timing_reps=20, live=True)
                ms.setdefault(str(e.shards[1].dev), []).append(r[2:4])
            row["slab1_ms"] = {d: min(m for m, _ in x) for d, x in ms.items()}
            row["slab1_plain_ms"] = {d: min(p for _, p in x)
                                     for d, x in ms.items()}
            print(f"[cards] {what} slab 1 of 4 (live state), ms a call by "
                  f"card, in turns: {ms}", flush=True)
    recs.append(row)
    del e0, es


def cards_small(name, D, backend, kw, cards, v):
    """Phase 3's small fp64 scene `name` in D slabs, one per card, against
    the single device's kernel path on the padded grid (<= 1e-12) and the
    same slabs on cuda:0 (receivers and final state bitwise), launches
    checked; Nt steps on the open-top boxes, NT_SMALL on the others."""
    G = 1 if backend == "step" else kw.get("tb", 2)
    s = fit_slabs(small_scene(name), D, G)
    e0 = sharded(s, np.float64, D, backend=backend, **kw)
    nt = e0.Nt if name in OPEN_SMALL else NT_SMALL
    uk = engine(s, np.float64, backend=backend, **kw).run(nt=nt,
                                                         verbose=False)
    u0 = e0.run(nt=nt, verbose=False)
    es = sharded(s, np.float64, D, devices=cards[:D], backend=backend, **kw)
    reset_counts()
    u = es.run(nt=nt, verbose=False)
    c = counts()
    err = rel_err(u, uk)
    same = bool(np.array_equal(u, u0)) and states_equal(es, e0)
    tag = f"{name} x{D} {backend}" + (f" TB={es.TB}" if es.TB else "")
    print(f"[cards] {tag} fp64 ({es.S} rows a slab, {nt} steps): vs the "
          f"single device {err:.3e} (bitwise {np.array_equal(u, uk)}), "
          f"receivers and final state bitwise the same slabs on cuda:0's "
          f"{same}; launches {named(c)}", flush=True)
    v(np.abs(uk).max() > 0 and err <= 1e-12, f"{tag} fp64: {err}")
    v(same, f"{tag} fp64: differs from the same slabs on cuda:0")
    v(c == counts_of(es, D, nt), f"{tag}: launches {named(c)}")
    return err


def cards_engine(card, v):
    """The single-device engine on `card` (not cuda:0): the step, tb, pair
    and energy routes of the open-top Cartesian box in fp64 (K1, K2, K3 in
    their ABC modes, K1e, K7) bitwise the same engine's on cuda:0."""
    s = small_scene("cart_open")
    for kw in ({"backend": "step"}, {"backend": "tb", "tb": 3},
               {"backend": "pair"}, {"energy_on": True}):
        ek = [TorchEngine(consts=s.consts, vox=s.vox, comms=s.comms,
                          mats=s.mats, dtype=np.float64, device=d, **kw)
              for d in ("cuda:0", card)]
        u = [e.run(verbose=False) for e in ek]
        same = np.array_equal(*u) and all(
            torch.equal(a.cpu(), b.cpu())
            for a, b in zip(ek[0].state, ek[1].state) if torch.is_tensor(a))
        if kw.get("energy_on"):
            same = same and all(np.array_equal(getattr(ek[0], a),
                                               getattr(ek[1], a))
                                for a in ("H_tot", "E_lost", "E_in"))
        print(f"[cards] TorchEngine {kw} cart_open fp64 on {card}: "
              f"receivers and final state (energies) bitwise its run on "
              f"cuda:0: {same}", flush=True)
        v(same, f"TorchEngine {kw} on {card} differs from cuda:0")


def cards_1e9(cards, v):
    """setup_1e9 --check on its step route (one card) and its x4 route
    with one slab per card (`--devices`), in a subprocess: receivers
    within 1e-5, launches checked, K5 held to its plain version on
    shards[1]'s card; returns its record."""
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "pffdtd_tpu_torch.examples.setup_1e9",
         "--check", "--routes", "step,x4", "--devices", ",".join(cards)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=TIMEOUT_1E9)
    secs = time.perf_counter() - t0
    for line in p.stdout.splitlines():
        if line.startswith("[setup_1e9]"):
            print("[cards 1e9]" + line[len("[setup_1e9]"):], flush=True)
    require(p.returncode == 0, f"setup_1e9 exited with {p.returncode}:\n"
            f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
    rec = json.loads(p.stdout.strip().splitlines()[-1])["setup_1e9"]
    nt = rec["nt"]
    st, x4 = rec["routes"]["step"], rec["routes"]["x4"]
    v(rec["grid"] == GRID_1E9, f"setup_1e9 grid {rec['grid']}")
    v(st["launches"]["K1"] == nt and x4["launches"]["K5"] == 4 * nt
      and x4["launches"]["K2"] == 4 * nt, f"setup_1e9 launches "
      f"{st['launches']}, {x4['launches']}")
    v(rec["receivers_vs_first"]["x4"] <= 1e-5 and x4["max_abs_u"] > 0,
      f"setup_1e9 x4 across cards: {rec['receivers_vs_first']}")
    k5 = x4["checks"].get("K5", {})
    v(k5.get("max_rel_err", 1.0) <= CHECK_TOL["K5"], f"setup_1e9 K5 on "
      f"shards[1]: {k5}")
    print(f"[cards 1e9] {secs:.1f} s in all; setup {rec['setup_s']['total']:.2f}"
          f" s, peak RSS {rec['rss_gb']:.2f} GB; step {st['mvps']:.1f} MVPS "
          f"on one card, x4 {x4['mvps']:.1f} on {', '.join(cards)} (frac "
          f"{x4['mvps'] / st['mvps']:.4f}), peak GB by card "
          f"{x4['peak_gb_by_device']}; receivers x4 vs step "
          f"{rec['receivers_vs_first']['x4']:.3e}, bitwise "
          f"{rec['bitwise_equal']['x4']}", flush=True)
    return rec


def main_cards(cards=None):
    """The x-slab path with one slab per card (see the module docstring:
    `--cards`).  cards: the four devices of the slabs, default cuda:0 ..
    cuda:3 (a rehearsal may pass one card four times)."""
    t_start = time.perf_counter()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards is None:
        if n < CARDS:
            raise SmokeFailure(f"--cards needs {CARDS} cards, this machine "
                               f"has {n}")
        cards = [f"cuda:{i}" for i in range(CARDS)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    v = Verdicts()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {n} cards: "
          + ", ".join(torch.cuda.get_device_name(i) for i in range(n)),
          flush=True)
    idx = [torch.device(c).index for c in cards]
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for i, j in zip(idx, idx[1:]) if i != j
            for a, b in ((i, j), (j, i))}
    print(f"[cards] peer access between neighbouring slabs' cards: {peer}",
          flush=True)
    lib = _build.library()
    print(f"[cards] built {lib.path.name} in {lib.build_seconds:.2f} s",
          flush=True)
    recs, single = [], {}
    for scene, open_top, Ds in (("closed", False, (2, 4)),
                                ("open", True, (4,))):
        sim = headline_scene(NT, open_top=open_top)
        for D in Ds:
            for backend, kw in CARD_ROUTES:
                with v.section(f"{scene} x{D} {backend}"):
                    cards_headline(sim, scene, D, backend, kw, cards,
                                   single, gen, v, recs)
        single.clear()
    t_head = time.perf_counter() - t_start
    small = {}
    for name in (*SMALL, *OPEN_SMALL):
        if name == "fcc":          # unfolded FCC: phase 3 has it, as here
            continue
        for D in (2, 4):
            for backend, kw in CARD_ROUTES:
                with v.section(f"{name} x{D} {backend} fp64"):
                    small[f"{name} x{D} {backend}"] = cards_small(
                        name, D, backend, kw, cards, v)
    with v.section("TorchEngine on another card"):
        cards_engine(cards[1], v)
    t_small = time.perf_counter() - t_start - t_head
    rec_1e9 = None
    with v.section("setup_1e9 across cards"):
        rec_1e9 = cards_1e9(cards, v)
    t_all = time.perf_counter() - t_start
    print(f"[cards] {t_all:.1f} s in all: headline {t_head:.1f}, fp64 small "
          f"scenes {t_small:.1f}, setup_1e9 {t_all - t_head - t_small:.1f}",
          flush=True)
    print(json.dumps({"cards": {
        "devices": cards, "peer": peer, "headline": recs,
        "small_fp64_err": small, "seconds": t_all,
        "setup_1e9": None if rec_1e9 is None else {
            k: rec_1e9[k] for k in ("grid", "setup_s", "rss_gb",
                                    "receivers_vs_first", "bitwise_equal")}
        | {"routes": {r: {k: x[k] for k in ("mvps", "ms_step", "peak_gb",
                                             "peak_gb_by_device", "build_s",
                                             "runs_s", "launches", "checks")}
                      for r, x in rec_1e9["routes"].items()}}}}))
    v.close()
    print(smi)   # again, where the end of a long output keeps it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}))


if __name__ == "__main__":
    try:
        main_cards() if sys.argv[1:] == ["--cards"] else main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
