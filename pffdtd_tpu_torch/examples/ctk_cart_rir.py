"""CTK church, Cartesian scheme, RIR run (the counterpart of
examples/ctk_cart_rir.py; reference: test_script_CTK_cart_gpu.py).

The canonical production config: impulse + diff_source (the fp32
safeguard), fmax = 1400 Hz at 10.5 PPW, 3 s, then the full
post-processing chain to 48 kHz wav files with the modal air-absorption
filter, whose recurrence runs on `--device` as the engine does.

    python -m pffdtd_tpu_torch.examples.ctk_cart_rir [REF_DATA] [OUT_DIR]
        [--fmax F] [--duration T] [--f64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pffdtd_tpu_torch.analysis.process_outputs import ProcessOutputs
from pffdtd_tpu_torch.engine.torch_engine import TorchEngine
from pffdtd_tpu_torch.examples import (CTK_MATS, CTK_MODEL, REF,
                                       add_common_args, check_device,
                                       model_inputs)
from pffdtd_tpu_torch.scene_setup import sim_setup

OUT = "out/ctk_cart_rir"


def rir(ref=REF, out=OUT, fmax=1400.0, duration=3.0, device="cuda",
        dtype=np.float32, mats=CTK_MATS):
    """Set up the model into the sim folder `out`, run it, save
    sim_outs.h5 and process it to RIRs; returns (engine, ProcessOutputs).
    mats: the model's material names -> files in REF_DATA/materials."""
    check_device(device)
    model, mat_folder = model_inputs(ref, CTK_MODEL)
    sim_setup(model_json_file=model, mat_folder=mat_folder,
              mat_files_dict=mats, source_num=1, insig_type="impulse",
              diff_source=True, duration=duration, Tc=20, rh=50,
              fcc_flag=False, PPW=10.5, fmax=fmax, save_folder=out)
    eng = TorchEngine(out, dtype=dtype, device=device)
    eng.run(chunk=2000)
    eng.save_outputs(out)
    eng.print_last_samples(5)

    po = ProcessOutputs(out)
    po.initial_process(fcut=10.0, N_order=4)
    po.resample(48e3)
    po.apply_lowpass(fcut=fmax, N_order=8, symmetric=True)
    po.apply_modal_filter(device=device)
    po.save_h5()
    po.save_wav()
    return eng, po


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, OUT)
    ap.add_argument("--fmax", type=float, default=1400.0)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--f64", action="store_true", help="float64 fields")
    args = ap.parse_args(argv)
    rir(args.ref, args.out, args.fmax, args.duration, args.device,
        np.float64 if args.f64 else np.float32)


if __name__ == "__main__":
    main()
