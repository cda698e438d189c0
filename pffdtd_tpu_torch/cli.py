"""Command-line entry points of the port (the `sim` and `process`
subcommands of pffdtd_tpu/cli.py):

    python -m pffdtd_tpu_torch.cli sim --data_dir DIR [--f64] [--energy]
        [--nsteps N] [--checkpoint FILE --checkpoint_every K [--resume]]
        [--plot [--show]] [--device cuda|cpu] [--backend auto|step|pair|tb]
        [--tb N]
    python -m pffdtd_tpu_torch.cli process --data_dir DIR ... [--device D]

`sim` runs the sim folder through `TorchEngine` on the card (or on the CPU
with `--device cpu`, through the kernels' plain versions) and writes
`sim_outs.h5` with the port's writer (byte-compatible with the reference).
`process` turns it into RIRs (`analysis.process_outputs`); its modal
air-absorption filter runs on `--device`.  Both read and write the sim
folder with h5py, which they import inside their functions.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _cmd_sim(args):
    from pffdtd_tpu_torch.engine.torch_engine import TorchEngine

    dtype = np.float64 if args.f64 else np.float32
    eng = TorchEngine(args.data_dir, dtype=dtype, device=args.device,
                      backend=args.backend, tb=args.tb,
                      energy_on=args.energy)
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


def main(argv=None):
    from pffdtd_tpu_torch.engine.torch_engine import BACKENDS

    p = argparse.ArgumentParser(prog="pffdtd_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sim", help="run the FDTD engine on a sim folder")
    ps.add_argument("--data_dir", required=True)
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
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
