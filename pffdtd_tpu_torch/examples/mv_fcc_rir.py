"""Musikverein hall, 13-point FCC scheme, RIR run (the counterpart of
examples/mv_fcc_rir.py; reference: test_script_MV_fcc_gpu.py).

The canonical FCC production config: impulse + diff_source from source 3,
PPW 5.6, 2 s, the sim folder rotated ("auto", as the original's),
FCC-folded and sorted in place, then the post-processing chain with the Stokes (visco)
air-absorption filter.

    python -m pffdtd_tpu_torch.examples.mv_fcc_rir [REF_DATA] [OUT_DIR]
        [FMAX] [--duration T] [--f64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pffdtd_tpu_torch.analysis.process_outputs import ProcessOutputs
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples import (MV_MATS, MV_MODEL, REF,
                                       add_common_args, check_device,
                                       model_inputs)
from pffdtd_tpu_torch.scene_setup import sim_setup

OUT = "out/mv_fcc_rir"


def rir(ref=REF, out=OUT, fmax=1000.0, duration=2.0, device="cuda",
        dtype=np.float32, mats=MV_MATS):
    """Set up the model into `out` (rotated, folded and sorted in place),
    run it, save sim_outs.h5 and process it to RIRs; returns (engine,
    ProcessOutputs).  mats: as ctk_cart_rir.rir's."""
    check_device(device)
    model, mat_folder = model_inputs(ref, MV_MODEL)
    sim_setup(model_json_file=model, mat_folder=mat_folder,
              mat_files_dict=mats, source_num=3, insig_type="impulse",
              diff_source=True, duration=duration, Tc=20, rh=50,
              fcc_flag=True, PPW=5.6, fmax=fmax,   # FCC at CFL 0.999
              save_folder=out, save_folder_gpu=out)
    eng = TorchEngine(out, dtype=dtype, device=device)
    eng.run(chunk=2000)
    eng.save_outputs(out)

    po = ProcessOutputs(out)
    po.initial_process(fcut=10.0, N_order=4)
    po.resample(48e3)
    po.apply_lowpass(fcut=fmax, N_order=8, symmetric=True)
    po.apply_stokes_filter()
    po.save_h5()
    po.save_wav()
    return eng, po


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, OUT)
    ap.add_argument("fmax", nargs="?", type=float, default=1000.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--f64", action="store_true", help="float64 fields")
    args = ap.parse_args(argv)
    rir(args.ref, args.out, args.fmax, args.duration, args.device,
        np.float64 if args.f64 else np.float32)


if __name__ == "__main__":
    main()
