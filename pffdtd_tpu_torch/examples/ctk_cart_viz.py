"""CTK church, Cartesian scheme, visualization run (the counterpart of
examples/ctk_cart_viz.py; reference: test_script_CTK_cart_viz.py).

The canonical low-fmax config: a dhann30 pulse (symmetric, for viewing),
fmax = 500 Hz at 7.5 PPW, 0.1 s, run in fp64 with the energy balance on,
then slice-animation frames of an fp32 run (`viz.render_animation`,
matplotlib on the Agg backend).

    python -m pffdtd_tpu_torch.examples.ctk_cart_viz [REF_DATA] [OUT_DIR]
        [--fmax F] [--duration T] [--frames N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples import (CTK_MATS, CTK_MODEL, REF,
                                       add_common_args, check_device,
                                       model_inputs)
from pffdtd_tpu_torch.scene_setup import sim_setup

OUT = "out/ctk_cart_viz"


def viz(ref=REF, out=OUT, fmax=500.0, duration=0.1, frames=16,
        device="cuda", mats=CTK_MATS):
    """Set up into `out`, run fp64 with energy on (balance printed), save
    sim_outs.h5, then write the frames of an fp32 run to `out`/frames;
    returns the frame files.  mats: as ctk_cart_rir.rir's."""
    check_device(device)
    model, mat_folder = model_inputs(ref, CTK_MODEL)
    import matplotlib

    matplotlib.use("Agg")
    from pffdtd_tpu_torch.viz import render_animation

    sim_setup(model_json_file=model, mat_folder=mat_folder,
              mat_files_dict=mats, source_num=1,
              insig_type="dhann30",      # symmetric pulse for viz
              diff_source=False, duration=duration, Tc=20, rh=50,
              fcc_flag=False, PPW=7.5, fmax=fmax, save_folder=out)
    eng = TorchEngine(out, dtype=np.float64, device=device, energy_on=True)
    eng.run(chunk=64)
    eng.save_outputs(out)
    print("energy balance:", np.abs(eng.energy_balance()).max())
    files = render_animation(TorchEngine(out, dtype=np.float32,
                                         device=device),
                             frames=frames, out_dir=Path(out) / "frames")
    print(f"wrote {len(files)} animation frames to {out}/frames")
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, OUT)
    ap.add_argument("--fmax", type=float, default=500.0)
    ap.add_argument("--duration", type=float, default=0.1)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args(argv)
    viz(args.ref, args.out, args.fmax, args.duration, args.frames,
        args.device)


if __name__ == "__main__":
    main()
