"""Command-line entry points of the port (the subcommands of
pffdtd_tpu/cli.py):

    python -m pffdtd_tpu_torch.cli sim --data_dir DIR [--engine torch|numpy]
        [--f64] [--energy] [--nsteps N]
        [--checkpoint FILE --checkpoint_every K [--resume]]
        [--plot [--show]] [--device cuda|cpu] [--backend auto|step|pair|tb]
        [--tb N] [--fp32_eps EPS]
    python -m pffdtd_tpu_torch.cli process --data_dir DIR ... [--device D]
    python -m pffdtd_tpu_torch.cli prep --data_dir DIR [--rotate] [--fold]
        [--sort]
    python -m pffdtd_tpu_torch.cli fit-material --out mat.h5 --sabs a1,...,a11

`sim` runs the sim folder through `TorchEngine` on the card (or on the CPU
with `--device cpu`, through the kernels' plain versions), or with
`--engine numpy` through the NumPy oracle `NumpyEngine` on the host, and
writes `sim_outs.h5` with the port's writer (byte-compatible with the
reference).  `process` turns it into RIRs (`analysis.process_outputs`); its
modal air-absorption filter runs on `--device`.  `prep` rotates (by
"auto", as the JAX package's), folds (FCC) and sorts a sim folder in
place; `fit-material` fits 11 DEF branches to 11 octave-band absorptions
and writes them to a material file.  Each reads and writes HDF5 with
h5py, imported inside its function.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _cmd_sim(args):
    if args.engine == "numpy":
        from pffdtd_tpu_torch.engine.numpy_ref import NumpyEngine
        from pffdtd_tpu_torch.io.h5 import write_outputs

        eng = NumpyEngine(args.data_dir, energy_on=args.energy)
        eng.run_all()
        write_outputs(args.data_dir, eng.u_out, eng.comms.out_reorder)
        if args.energy:
            print(f"--ENGINE(numpy): max |energy balance| = "
                  f"{np.nanmax(np.abs(eng.energy_balance())):.3e}")
        print(f"--ENGINE(numpy): wrote "
              f"{Path(args.data_dir) / 'sim_outs.h5'}")
        return
    from pffdtd_tpu_torch.engine.torch_engine import TorchEngine

    dtype = np.float64 if args.f64 else np.float32
    eng = TorchEngine(args.data_dir, dtype=dtype, device=args.device,
                      backend=args.backend, tb=args.tb,
                      energy_on=args.energy, fp32_eps=args.fp32_eps)
    on_chunk = None
    chunk = args.nsteps
    if args.plot:
        from pffdtd_tpu_torch.viz import LiveSliceView

        on_chunk = LiveSliceView(eng, show=args.show,
                                 out_dir=Path(args.data_dir) / "live_frames")
        chunk = chunk or max(1, eng.Nt // 60)
    eng.run(chunk=chunk, checkpoint_every=args.checkpoint_every or None,
            checkpoint_path=args.checkpoint, resume=args.resume,
            on_chunk=on_chunk)
    eng.save_outputs(args.data_dir)
    eng.print_last_samples(5)
    if args.energy:
        print(f"--ENGINE(torch): max |energy balance| = "
              f"{np.abs(eng.energy_balance()).max():.3e}")
    print(f"--ENGINE(torch): wrote {Path(args.data_dir) / 'sim_outs.h5'}")


def _cmd_process(args):
    from pffdtd_tpu_torch.analysis.process_outputs import main as process_main

    argv = ["--data_dir", args.data_dir,
            "--resample_Fs", str(args.resample_Fs),
            "--fcut_lowcut", str(args.fcut_lowcut),
            "--N_order_lowcut", str(args.N_order_lowcut),
            "--fcut_lowpass", str(args.fcut_lowpass),
            "--N_order_lowpass", str(args.N_order_lowpass),
            "--air_abs_filter", args.air_abs_filter,
            "--device", args.device]
    for flag in ("symmetric_lowpass", "save_wav", "plot", "show"):
        if getattr(args, flag):
            argv.append("--" + flag)
    process_main(argv)


def _cmd_prep(args):
    from pffdtd_tpu_torch.prep import (fold_fcc_sim_data, rotate_sim_data,
                                       sort_sim_data)

    if args.rotate:
        rotate_sim_data(args.data_dir)
    if args.fold:
        fold_fcc_sim_data(args.data_dir)
    if args.sort:
        sort_sim_data(args.data_dir)


def _cmd_fit_material(args):
    from pffdtd_tpu_torch.materials import fit_to_Sabs_oct_11

    sabs = np.array([float(x) for x in args.sabs.split(",")])
    DEF = fit_to_Sabs_oct_11(sabs, filename=args.out)
    print(f"wrote {args.out}\nDEF=\n{DEF}")


def main(argv=None):
    from pffdtd_tpu_torch.engine.torch_engine import BACKENDS

    p = argparse.ArgumentParser(prog="pffdtd_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sim", help="run the FDTD engine on a sim folder")
    ps.add_argument("--data_dir", required=True)
    ps.add_argument("--engine", default="torch", choices=["torch", "numpy"],
                    help="torch: TorchEngine on --device; numpy: the NumPy "
                         "oracle on the host (fp64; of the other flags only "
                         "--energy applies)")
    ps.add_argument("--f64", action="store_true", help="double precision")
    ps.add_argument("--energy", action="store_true",
                    help="machine-precision energy accounting (step route)")
    ps.add_argument("--nsteps", type=int, default=None,
                    help="progress/checkpoint block size")
    ps.add_argument("--checkpoint", default=None,
                    help="wavefield checkpoint file (.npz)")
    ps.add_argument("--checkpoint_every", type=int, default=0,
                    help="checkpoint every N blocks")
    ps.add_argument("--resume", action="store_true",
                    help="restart from --checkpoint if it exists")
    ps.add_argument("--plot", action="store_true",
                    help="live 3-slice wavefield view during the run "
                         "(saves PNG frames into DIR/live_frames when "
                         "headless)")
    ps.add_argument("--show", action="store_true",
                    help="with --plot, open an interactive window")
    ps.add_argument("--device", default="cuda",
                    help="torch device: cuda (hand-written kernels, the "
                         "default) or cpu (their plain versions)")
    ps.add_argument("--backend", default="auto", choices=BACKENDS,
                    help="route: step (K1+K2 per step), tb (K3, --tb steps "
                         "per sweep), pair (tb with 2 steps), auto (step: "
                         "the faster route on the H100)")
    ps.add_argument("--tb", type=int, default=3,
                    help="steps per sweep of --backend tb (2..8)")
    ps.add_argument("--fp32_eps", type=float, default=None,
                    help="the stencil's diagonal shift, sl2 = (1 + EPS) "
                         "lfac l2 (default: FP32_EPS in fp32, 0 with "
                         "--f64); 0 runs fp32 without it, to study the "
                         "drift it prevents")
    ps.set_defaults(fn=_cmd_sim)

    pp = sub.add_parser("process", help="post-process sim_outs.h5 into RIRs")
    pp.add_argument("--data_dir", required=True)
    pp.add_argument("--resample_Fs", type=float, default=48e3)
    pp.add_argument("--fcut_lowcut", type=float, default=10.0)
    pp.add_argument("--N_order_lowcut", type=int, default=8)
    pp.add_argument("--fcut_lowpass", type=float, default=0.0)
    pp.add_argument("--N_order_lowpass", type=int, default=8)
    pp.add_argument("--symmetric_lowpass", action="store_true")
    pp.add_argument("--air_abs_filter", default="none",
                    choices=["none", "stokes", "modal", "ola"])
    pp.add_argument("--save_wav", action="store_true")
    pp.add_argument("--plot", action="store_true",
                    help="save time/spectra plots per receiver (rirs.png)")
    pp.add_argument("--show", action="store_true",
                    help="with --plot, open a window instead of saving")
    pp.add_argument("--device", default="cuda",
                    help="torch device of the modal filter: cuda (the "
                         "default) or cpu")
    pp.set_defaults(fn=_cmd_process)

    pr = sub.add_parser("prep", help="rotate/fold/sort a sim folder")
    pr.add_argument("--data_dir", required=True)
    pr.add_argument("--rotate", action="store_true",
                    help="permute the grid's dims by \"auto\", as the "
                         "JAX package's prep: the axis on z that the port's "
                         "step-route cost model on the H100 scores lowest, "
                         "kept as the descending order's unless another "
                         "scores lower by more than a margin")
    pr.add_argument("--fold", action="store_true",
                    help="fold an FCC grid across mid-y (fcc_flag 2)")
    pr.add_argument("--sort", action="store_true",
                    help="sort the boundary and source/receiver indices")
    pr.set_defaults(fn=_cmd_prep)

    pf = sub.add_parser("fit-material",
                        help="fit DEF branches to 11 octave-band absorptions")
    pf.add_argument("--out", required=True)
    pf.add_argument("--sabs", required=True,
                    help="11 comma-separated absorption coefficients")
    pf.set_defaults(fn=_cmd_fit_material)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
