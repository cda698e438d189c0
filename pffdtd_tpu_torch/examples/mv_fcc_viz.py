"""Musikverein hall, FCC scheme, visualization run (the counterpart of
examples/mv_fcc_viz.py; reference: test_script_MV_fcc_viz.py).

A dhann30 pulse from source 3, fmax = 1 kHz at PPW 5.6, 0.1 s: the
voxelization drawn at setup (per-material boundary nodes, cut adjacency
legs and the room's wireframe, saved as `OUT_DIR`/voxelization.png), then
the slice-animation frames of an fp32 run (matplotlib on the Agg
backend).

    python -m pffdtd_tpu_torch.examples.mv_fcc_viz [REF_DATA] [OUT_DIR]
        [FMAX] [--duration T] [--frames N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples import (MV_MATS, MV_MODEL, REF,
                                       add_common_args, check_device,
                                       model_inputs)
from pffdtd_tpu_torch.scene_setup import sim_setup

OUT = "out/mv_fcc_viz"


def viz(ref=REF, out=OUT, fmax=1000.0, duration=0.1, frames=16,
        device="cuda", mats=MV_MATS):
    """Set up into `out` with the voxelization drawn, then write the
    frames of an fp32 run to `out`/frames; returns the frame files.
    mats: as ctk_cart_rir.rir's."""
    check_device(device)
    model, mat_folder = model_inputs(ref, MV_MODEL)
    import matplotlib

    matplotlib.use("Agg")
    from pffdtd_tpu_torch.viz import render_animation

    sim_setup(model_json_file=model, mat_folder=mat_folder,
              mat_files_dict=mats, source_num=3, insig_type="dhann30",
              diff_source=False, duration=duration, Tc=20, rh=50,
              fcc_flag=True, PPW=5.6, fmax=fmax, save_folder=out,
              draw_vox=True, draw_backend="save")   # voxelization.png
    files = render_animation(TorchEngine(out, dtype=np.float32,
                                         device=device),
                             frames=frames, out_dir=Path(out) / "frames")
    print(f"wrote {len(files)} animation frames to {out}/frames")
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, OUT)
    ap.add_argument("fmax", nargs="?", type=float, default=1000.0)
    ap.add_argument("--duration", type=float, default=0.1)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args(argv)
    viz(args.ref, args.out, args.fmax, args.duration, args.frames,
        args.device)


if __name__ == "__main__":
    main()
