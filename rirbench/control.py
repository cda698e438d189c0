"""The control of `correct`: the plain reference put in the program's
place, computed one precision below the configuration's (fp32 with every
stored value rounded to TF32, for a float32 configuration), and judged as
the program is judged, against the reference in the configuration's
precision.
Its numbers must fail the limits (`rirbench/limits/<cell>.json`).

    python -m rirbench.control --workload <cell> --seeds 1,2,3

Runs on the card at the cell's own size (on the CPU with --device cpu);
the benchmark's runs never run it.  Prints one JSON line a seed."""

from __future__ import annotations

import argparse
import json
import time

import torch

from rirbench import compare, program, spec
from rirbench.reference.box_fdtd import tf32


def control(cell: dict, seed: int, device: str) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    if cfg["precision"] != "float32":
        raise ValueError("the TF32 control is for a float32 configuration")
    src, rx = program.request(cfg, traffic, seed)
    ref = spec.reference(cfg)
    args = (cfg, src, rx, float(traffic["sim_seconds"]), traffic["signal"],
            bool(traffic["diff_source"]))
    t = time.perf_counter()
    ctl = ref.BoxFDTD(*args, device=device, dtype=torch.float32,
                      round_fn=tf32)
    rx_c, field_c = ctl.run()
    t_c = time.perf_counter() - t
    field_c = field_c.cpu() if device != "cpu" else field_c
    vh_c = ctl.vh.cpu()
    t = time.perf_counter()
    judge = ref.BoxFDTD(*args, device=device, dtype=torch.float32)
    rx_r, field_r = judge.run()
    t_r = time.perf_counter() - t
    return {"cell": cell["cell"], "seed": seed,
            "rx_err": compare.rx_err(rx_c, rx_r),
            "field_err": compare.rel_gap(field_c.to(device), field_r),
            "branch_err": compare.rel_gap(vh_c.to(device), judge.vh),
            "control_s": t_c, "reference_s": t_r}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)
    if a.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("the control runs on the card (or --device cpu)")
    for s in a.seeds.split(","):
        print(json.dumps(control(cell, int(s), a.device)), flush=True)


if __name__ == "__main__":
    main()
