"""Rooflines: the least time a call could take on the card, and the share
of it a measured time reaches.

Each kernel's module (`k1.py`, ...) gives `cost(run) -> (bytes, flops)`
for one call, from the shapes of the run (`run` as `rirbench.run` builds
it): each input read once and each output written once, and the
operations the arithmetic needs.  The least time is the larger of bytes
over the HBM rate and operations over the arithmetic rate of the run's
precision (`peaks.json`, NVIDIA's published peaks)."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def least_seconds(bytes_: float, flops: float, itemsize: int) -> float:
    rate = PEAKS["fp32_flops_per_s"] if itemsize == 4 else \
        PEAKS["fp64_flops_per_s"]
    return max(bytes_ / PEAKS["hbm_bytes_per_s"], flops / rate)


def interior(grid) -> int:
    nx, ny, nz = grid
    return (nx - 2) * (ny - 2) * (nz - 2)


def kernel_share(run: dict, kernel: str, cost) -> float | None:
    """100 x the least time of one call (`cost(run)`) over the mean device
    time of the traced calls of `kernel`; None where the trace holds
    none."""
    tr = run.get("trace")
    times = [s for name, s in tr["ops"] if name == kernel] if tr else []
    if not times:
        return None
    return 100.0 * least_seconds(*cost(run), run["itemsize"]) / (
        sum(times) / len(times))
