"""Command-line entry point of the port (the `sim` subcommand of
pffdtd_tpu/cli.py):

    python -m pffdtd_tpu_torch.cli sim --data_dir DIR [--f64] [--nsteps N]
        [--device cuda|cpu] [--backend auto|step|pair|tb] [--tb N]

Runs the sim folder through `TorchEngine` on the card (or on the CPU with
`--device cpu`, through the kernels' plain versions) and writes
`sim_outs.h5` with the port's writer (byte-compatible with the reference).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _cmd_sim(args):
    from pffdtd_tpu_torch.engine.torch_engine import TorchEngine

    dtype = np.float64 if args.f64 else np.float32
    eng = TorchEngine(args.data_dir, dtype=dtype, device=args.device,
                      backend=args.backend, tb=args.tb)
    eng.run(chunk=args.nsteps)
    eng.save_outputs(args.data_dir)
    eng.print_last_samples(5)
    print(f"--ENGINE(torch): wrote {Path(args.data_dir) / 'sim_outs.h5'}")


def main(argv=None):
    from pffdtd_tpu_torch.engine.torch_engine import BACKENDS

    p = argparse.ArgumentParser(prog="pffdtd_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sim", help="run the FDTD engine on a sim folder")
    ps.add_argument("--data_dir", required=True)
    ps.add_argument("--f64", action="store_true", help="double precision")
    ps.add_argument("--nsteps", type=int, default=None,
                    help="progress block size")
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
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
