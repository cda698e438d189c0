"""One run of one cell of the port's benchmark on the card.

    python -m rirbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell's room and engine (the port, `pffdtd_tpu_torch`), warms
it up, then for `--seconds` runs whole simulations back to back through
`TorchEngine.run` (one chunk, no checkpoint, no progress lines), each from
the zero state to Nt steps with its receivers on the host.  Once the
window has closed it reads the device's peak memory, frees the program's
state and computes the same request with the plain reference
(`rirbench/reference/`) in the configuration's precision, which decides
`correct`.  The last line of
standard output is the result, as JSON.

--trace 0 reports the end-to-end metrics: `mvps` (the scheme's points, as
the reference counts them from the room, times steps of every simulation
of the window, over the window's wall time, which ends in a
synchronize), `device_mem_gib` (the process's peak of
`torch.cuda.max_memory_allocated`) and `setup_s` (from the process's
start to the window's).  --trace 1 profiles the window's second simulation and
reports the per-layer metrics, each read by its reader
(`rirbench/metrics/<name>.py`), with the trace's breakdown.

Exits 2 without a result where there is no card, or fewer than the cell
asks for; 3 where the process holds a module of JAX or of the JAX package
once the window has closed."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rirbench import compare, program, spec  # noqa: E402
from rirbench.trace import Trace  # noqa: E402

T_IMPORTS = time.perf_counter()

FOREIGN = {"jax", "jaxlib", "flax", "pffdtd_tpu"}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def foreign_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package (compared whole: `pffdtd_tpu_torch` is not `pffdtd_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FOREIGN)


def warm_steps(traffic: dict, nt: int) -> int:
    """Steps of a warm-up run that launches what the window launches: on
    the tb route two sweeps and the Nt % TB steps of K1 + K2 after them."""
    if traffic["route"] == "tb":
        tb = int(traffic.get("tb", 3))
        return 2 * tb + nt % tb
    return 2


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
        "unknown"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0) -> dict:
    """One run of `cell` (`spec.load_cell`); returns the result line.
    `device="cpu"` runs the port's plain versions (the tests' path)."""
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    spans = {}
    src, rx = program.request(cfg, traffic, seed)
    ref_mod = spec.reference(cfg)
    # the work of a step: the points of the scheme, counted from the room
    points = ref_mod.Scheme(cfg, float(traffic["sim_seconds"])).points

    # the process's start to here: imports, the look for the card, the
    # card's context
    stamps = {"imports": T_IMPORTS - t0}
    if cuda:
        t = time.perf_counter()
        torch.zeros(1, device=device)
        stamps["context"] = time.perf_counter() - t
    stamps["start"] = time.perf_counter() - t0
    t = time.perf_counter()
    sim = program.scene(cfg, traffic, src, rx)
    spans["scene_s"] = time.perf_counter() - t
    t = time.perf_counter()
    eng = program.engine(cfg, traffic, sim, device)
    spans["engine_build_s"] = time.perf_counter() - t
    for i in range(2):   # the second drops the first's state, then allocates
        t = time.perf_counter()
        eng.run(nt=warm_steps(traffic, eng.Nt), verbose=False)
        stamps[f"warm{i}"] = time.perf_counter() - t
    program.reset_launches()
    setup_s = time.perf_counter() - t0
    log(f"[rirbench] {cell['cell']} seed {seed}: set-up {setup_s:.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in {**stamps, **spans}.items())}"
        f"), grid {eng.data.grid.shape}, {points} points, Nbl {eng.data.Nbl}, "
        f"Nt {eng.Nt}")

    tr = Trace(cuda) if trace else None
    outs, ends = [], []
    w0 = time.perf_counter()
    while True:
        if tr is not None and len(outs) == 1:
            with tr.capture():
                outs.append(eng.run(verbose=False))
        else:
            outs.append(eng.run(verbose=False))
        ends.append(time.perf_counter())
        if ends[-1] - w0 >= seconds and (tr is None or len(outs) >= 2):
            break
    window_s = ends[-1] - w0
    each = np.diff([w0] + ends)

    g = eng.data.grid
    mem = torch.cuda.max_memory_allocated(eng.device) if cuda else 0
    launches = program.launches()
    log(f"[rirbench] window {window_s:.3f} s, {len(outs)} simulations of "
        f"{eng.Nt} steps (s each: min {each.min():.4f}, median "
        f"{np.median(each):.4f}, max {each.max():.4f}); launches "
        f"{json.dumps(launches)}")
    run = {"cell": cell["cell"], "config": cfg, "traffic": traffic,
           "grid": g.shape, "fcc": bool(g.fcc_flag), "folded": g.folded,
           "itemsize": eng.data.dtype.itemsize, "Nbl": eng.data.Nbl,
           "branches": int(cfg["branches_per_material"]),
           "route": eng.backend, "TB": eng.TB, "Nt": eng.Nt,
           "k1_adj_bytes": program.k1_adj_bytes(eng), "spans": spans,
           "trace": tr.summary() if tr is not None else None}
    if run["trace"] is not None:
        log(f"[rirbench] traced: idle gaps at ms {run['trace']['gaps_at_ms']}")

    # the program's outputs, judged once its state is freed
    # u^Nt and the branch states, in the units the program keeps them in
    # (fp32: over `infac`), and its lossy nodes in its layout
    final, vh, infac, nt = eng.state[1], eng.state[3], eng.data.infac, \
        eng.Nt
    nodes = torch.from_numpy(eng.data.bnl_ixyz).to(final.device)
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = ref_mod.BoxFDTD(
        cfg, src, rx, float(traffic["sim_seconds"]), traffic["signal"],
        bool(traffic["diff_source"]), device=device,
        dtype=getattr(torch, cfg["precision"]))
    rx_ref, field_ref = ref.run()
    if ref.Nt != nt:
        log(f"[rirbench] the reference has {ref.Nt} steps, the program {nt}")
    errs = [compare.rx_err(program.receivers(sim, u), rx_ref) for u in outs]
    ferr = compare.field_err(final, field_ref, ref.sc.N, ref.stored,
                             run["folded"], infac)
    berr = compare.branch_err(vh, nodes, ref.vh, ref.lossy, ref.sc.N,
                              final.shape, run["folded"], infac)
    log(f"[rirbench] reference {time.perf_counter() - t:.3f} s")
    lim = cell["limits"]
    compared = {"rx_err": {"value": max(errs),
                           "limit": lim["rx_err"]["limit"]},
                "field_err": {"value": ferr,
                              "limit": lim["field_err"]["limit"]},
                "branch_err": {"value": berr,
                               "limit": lim["branch_err"]["limit"]}}
    bad = [e > compared["rx_err"]["limit"] for e in errs]
    bad[-1] = bad[-1] or not (ferr <= compared["field_err"]["limit"]
                              and berr <= compared["branch_err"]["limit"])

    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"mvps": points * nt * len(outs) / window_s / 1e6,
               "device_mem_gib": mem / 2**30, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": mem}
    if cuda:
        dev["power_limit"] = power_limit()
    finite = bool(np.isfinite(errs + [ferr, berr]).all())
    out = {"correct": not any(bad) and finite,
           "attempted": len(outs), "failed": int(sum(bad)),
           "metrics": metrics, "device": dev}
    if run["trace"] is not None:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = run["trace"]["breakdown"]
    for v in compared.values():     # inf or nan: no JSON number
        if not np.isfinite(v["value"]):
            v["value"] = str(v["value"])
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"[rirbench] {a.workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}: no result")
        return 2
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    foreign = foreign_modules()
    if foreign:
        log(f"[rirbench] modules of JAX or the JAX package are loaded: "
            f"{foreign}: no result")
        return 3
    for k, v in out["compared"].items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
