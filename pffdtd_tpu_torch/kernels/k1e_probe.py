"""Two measurements behind K1e's design, on the card:

    python -m pffdtd_tpu_torch.kernels.k1e_probe [--base DIR]

1. Where K1e loads L u^{n-1}: this tree's `csrc/stencil.cu` (with the
   adjacency, ahead of the legs) against a copy that loads it after the
   store of u^{n+1} (where K7's grid pass has it), and that copy without
   the block sum (its barrier): K1e's ms a call beside K1's and K7's grid
   pass's.
2. With `--base DIR`, a directory holding another checkout's
   `stencil.cu` (and `energy.cu`, if its K1 calls K7's middle stage): the
   SASS of each K1/K5 instance (the energy mode off) compared instruction
   for instruction with this tree's, and K1 timed from both in turns
   (base, tree, tree, base, twice), fp32 and fp64.

Each variant is built by nvcc into a library of its own under
`_build/probe/`; times are the best of CUDA-event windows of 20 calls,
taken in turns, at the headline cell's shapes (792 x 310 x 510, fp32 FCC,
every leg set).  The first line printed is the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.kernels.stream import time_ms

SHAPE = (792, 310, 510)
REPS, ROUNDS = 20, 3
PROBE = _build.BUILD / "probe"
# the late load: the line that loads L u^{n-1} moves after u^{n+1}'s store
EARLY = "    const T L_prev = ENERGY ? e.Lu[c] : T(0);\n"
GRID_PASS_PLACE = ("    if (ENERGY) {  // K7's grid pass on the same "
                   "registers, in its order\n")
BLOCK_SUM = "    block_sums<2, kThreads>(sums, e.part + 2 * b);\n"
# keeps the sums live (the compiler would drop the energy work) without the
# block sum and its barrier
NO_BLOCK_SUM = "    if (sums[0] == 12345.0) e.part[2 * b] = sums[1];\n"


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"stencil.cu no longer holds {old!r} once: "
                               "update the probe's edits")
        src = src.replace(old, new)
    return src


def _late(src: str) -> str:
    return _edit(src, [(EARLY, ""), (GRID_PASS_PLACE, GRID_PASS_PLACE
                                     + "      const T L_prev = e.Lu[c];\n")])


def _build_lib(name: str, stencil: str, energy: Path | None,
               include: Path) -> ctypes.CDLL:
    """nvcc of `stencil` (source text) and `energy` (a file) into
    _build/probe/<name>/lib.so, with the kernels' flags."""
    d = PROBE / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "stencil.cu").write_text(stencil)
    nvcc = _build._nvcc()
    srcs = [d / "stencil.cu"] + ([energy] if energy else [])
    objs = [d / f"{p.stem}.o" for p in srcs]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(include),
                               "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(d / "lib.so"),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn in ("pf_stencil_step", "pf_stencil_energy_step", "pf_energy_grid"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _sass(obj: Path) -> dict:
    """{(dtype, adj, legs, shard): instruction lines} of the step kernel's
    instances with the energy mode off (or without one)."""
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                         text=True, check=True).stdout
    out = {}
    for block in txt.split("Function : ")[1:]:
        m = re.search(r"stencil_step_kernelI([fd])([ht])Li(\d+)ELb([01])E"
                      r"(Lb([01])E)?", block.splitlines()[0])
        if not m or m.group(6) == "1":
            continue
        out[m.group(1, 2, 3, 4)] = [
            re.sub(r"/\*[0-9a-f]{4}\*/", "", ln).split(";")[0].strip()
            for ln in block.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/",
                                                      ln)]
    return out


class _Fields:
    """Random fields at SHAPE on the card, every leg of the adjacency set."""

    def __init__(self, dtype):
        g = torch.Generator(device="cuda").manual_seed(0)
        r = lambda: torch.randn(SHAPE, generator=g, device="cuda",
                                dtype=dtype)
        self.code = 0 if dtype == torch.float32 else 1
        self.u0, self.u1, self.out, self.Lu = r(), r(), r(), r()
        self.adj = torch.full(SHAPE, 4095, dtype=torch.uint16, device="cuda")
        Nx, Ny, Nz = SHAPE
        blocks = -(-(Nz - 2) // 128) * (Ny - 2) * (Nx - 2)
        self.part = torch.zeros(2 * blocks + 2048, dtype=torch.float64,
                                device="cuda")
        self.stream = torch.cuda.current_stream().cuda_stream

    def k1(self, lib):
        p = lambda t: t.data_ptr()
        return lambda: _build.check(lib.pf_stencil_step(
            self.code, 12, p(self.u0), p(self.u1), p(self.adj), p(self.out),
            *SHAPE, 1, 0.25, 3.0, 0.57, 1.14, 1.71, self.stream), "K1")

    def k1e(self, lib):
        p = lambda t: t.data_ptr()
        return lambda: _build.check(lib.pf_stencil_energy_step(
            self.code, 12, p(self.u0), p(self.u1), p(self.adj), p(self.out),
            p(self.Lu), p(self.part), self.part.numel(), *SHAPE, 1, 0.25,
            3.0, 0.57, 1.14, 1.71, 0.1, 1.3, self.stream), "K1e")

    def grid_pass(self, lib):
        p = lambda t: t.data_ptr()
        return lambda: _build.check(lib.pf_energy_grid(
            self.code, 12, p(self.u0), p(self.u1), p(self.adj), p(self.Lu),
            p(self.part), self.part.numel(), *SHAPE, 1, 0.1, 1.3,
            self.stream), "K7 grid pass")


def _in_turns(calls, rounds=ROUNDS):
    """{name: best ms a call} of `calls`, each timed once a round."""
    best = {k: float("inf") for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            best[k] = min(best[k], time_ms(fn, REPS))
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=None,
                    help="a directory holding another checkout's stencil.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1e_probe measures on an NVIDIA card only")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    csrc = _build.CSRC
    tree = (csrc / "stencil.cu").read_text()
    energy = csrc / "energy.cu"
    libs = {"tree": _build_lib("tree", tree, energy, csrc),
            "late L u": _build_lib("late", _late(tree), energy, csrc),
            "late L u, no block sum": _build_lib(
                "late_nosum", _edit(_late(tree), [(BLOCK_SUM, NO_BLOCK_SUM)]),
                energy, csrc)}
    f = _Fields(torch.float32)
    calls = {f"K1e ({k})": f.k1e(lib) for k, lib in libs.items()}
    calls["K1"] = f.k1(libs["tree"])
    calls["K7 grid pass"] = f.grid_pass(libs["tree"])
    for k, ms in _in_turns(calls).items():
        print(f"[order] fp32 FCC {SHAPE}: {k} {ms:.4f} ms", flush=True)
    del f
    if args.base is None:
        return
    base_energy = args.base / "energy.cu"
    libs["base"] = _build_lib(
        "base", (args.base / "stencil.cu").read_text(),
        base_energy if base_energy.exists() else None, args.base)
    sb, st = (_sass(PROBE / d / "stencil.o") for d in ("base", "tree"))
    for key in sorted(sb):
        print(f"[base] SASS of K1/K5 {key} (dtype, adj, legs, shard): "
              f"{len(sb[key])} instructions in base, {len(st[key])} in tree,"
              f" identical {sb[key] == st[key]}", flush=True)
    for dt in (torch.float32, torch.float64):
        f = _Fields(dt)
        t = {"base": [], "tree": []}
        for k in ("base", "tree", "tree", "base") * 2:
            t[k].append(time_ms(f.k1(libs[k]), REPS))
        print(f"[base] K1 {dt} FCC {SHAPE}: " + ", ".join(
            f"{k} {min(v):.4f} ms (windows {', '.join(f'{x:.4f}' for x in v)})"
            for k, v in t.items()), flush=True)
        del f


if __name__ == "__main__":
    sys.exit(main())
