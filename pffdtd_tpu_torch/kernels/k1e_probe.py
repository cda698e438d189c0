"""Where K1e loads L u^{n-1}, measured on the card:

    python -m pffdtd_tpu_torch.kernels.k1e_probe

This tree's `csrc/stencil.cu` (the load with the adjacency, ahead of the
legs) against a copy that loads it after the store of u^{n+1} (where K7's
grid pass has it), and that copy without the block sum (its barrier):
K1e's ms a call beside K1's and K7's grid pass's.  Each variant is built by
nvcc into a library of its own under `_build/probe/` (`kernels.probe`'s
helpers); times are the best of CUDA-event windows of 20 calls, taken in
turns, at the headline cell's shapes (792 x 310 x 510, fp32 FCC, every leg
set).  The first line printed is the card's name and power limit.  K1
against another checkout's, SASS and time, is `python -m
pffdtd_tpu_torch.kernels.probe --base DIR --kernels K1`.
"""

from __future__ import annotations

import argparse
import sys

import torch

from pffdtd_tpu_torch.kernels import _build
from pffdtd_tpu_torch.kernels.probe import (SHAPE, Fields, build_lib,
                                            card_line, turns)

ROUNDS = 3

# the late load: the line that loads L u^{n-1} moves after u^{n+1}'s store
U1C = "    const T* __restrict__ u1c = u1 + c;\n"
EARLY = "    const T L_prev = e.Lu[c];\n" + U1C
GRID_PASS_PLACE = ("    {  // K7's grid pass on the same registers, in its "
                   "order\n")
BLOCK_SUM = "  block_sums<2, kThreads>(sums, e.part + 2 * b);\n"
# keeps the sums live (the compiler would drop the energy work) without the
# block sum and its barrier
NO_BLOCK_SUM = "  if (sums[0] == 12345.0) e.part[2 * b] = sums[1];\n"


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"stencil.cu no longer holds {old!r} once: "
                               "update the probe's edits")
        src = src.replace(old, new)
    return src


def _late(src: str) -> str:
    return _edit(src, [(EARLY, U1C), (GRID_PASS_PLACE, GRID_PASS_PLACE
                                      + "      const T L_prev = e.Lu[c];\n")])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1e_probe measures on an NVIDIA card only")
    card_line()
    csrc = _build.CSRC
    tree = (csrc / "stencil.cu").read_text()
    energy = (csrc / "energy.cu").read_text()
    variants = {"tree": tree, "late L u": _late(tree),
                "late L u, no block sum": _edit(_late(tree),
                                                [(BLOCK_SUM, NO_BLOCK_SUM)])}
    libs = {k: build_lib(f"k1e_{i}", {"stencil.cu": v, "energy.cu": energy},
                         csrc)
            for i, (k, v) in enumerate(variants.items())}
    for lib in libs.values():
        lib.march = True   # this tree's K1
    f = Fields(torch.float32)
    calls = {f"K1e ({k})": f.k1e(lib) for k, lib in libs.items()}
    calls["K1"] = f.k1(libs["tree"])
    calls["K7 grid pass"] = f.grid_pass(libs["tree"])
    for k, ms in turns(calls, list(calls) * ROUNDS).items():
        print(f"[order] fp32 FCC {SHAPE}: {k} {min(ms):.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
