"""K4, the streaming bandwidth probe, and its plain PyTorch versions.

`stream(mode, ...)` launches the CUDA kernels of `csrc/stream.cu` for
tensors on the card and runs `stream_plain` for tensors on the CPU:
- "read":  the float64 sum of x (plain: x.sum(dtype=torch.float64));
- "write": y filled with `value` (plain: y.fill_(value));
- "copy":  x copied into y (plain: y.copy_(x)).
x and y are contiguous float32 tensors.  It is the H100 counterpart of the
TPU DMA probes (probes/dma_issue*.py, probes/dma_plateau*.py): the
bandwidth roof every bound of the port is measured against, not part of the
engine.  On the card,

    python -m pffdtd_tpu_torch.kernels.stream [--sizes-mb 64 512 2048]

prints GB/s per mode beside PyTorch's sum, fill_ and copy_.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pffdtd_tpu_torch.kernels import _build

MODES = ("read", "write", "copy")
_MODE_ID = {"read": 0, "write": 1, "copy": 2}
WINDOWS = 5    # timing windows per mode and size, whose median is taken


def _check(mode, x, y):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    ts = {"x": x} if mode == "read" else {"y": y}
    if mode == "copy":
        ts["x"] = x
    for name, t in ts.items():
        if t is None:
            raise ValueError(f"{name}: required by mode {mode!r}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous float32 tensor")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: want 16-byte alignment")
    if mode == "copy":
        if x.numel() != y.numel() or x.device != y.device:
            raise ValueError("x, y: want one size on one device")
        if x.data_ptr() == y.data_ptr():
            raise ValueError("x and y must be distinct buffers")
    return next(iter(ts.values()))


def stream(mode: str, x=None, y=None, value: float = 0.0):
    """One K4 pass; returns the 0-d float64 sum (read) or y."""
    t = _check(mode, x, y)
    if t.device.type == "cpu":
        return stream_plain(mode, x, y, value)
    if t.device.type != "cuda":
        raise ValueError(f"device {t.device}: cpu or cuda only")
    lib = _build.library()
    partial = out = None
    with _build.on_device(t.device):
        if mode == "read":
            blocks = lib.pf_stream_blocks(t.numel())
            if blocks <= 0:
                raise RuntimeError("stream: no CUDA device to size the grid")
            partial = torch.empty(blocks, dtype=torch.float64,
                                  device=t.device)
            out = torch.empty((), dtype=torch.float64, device=t.device)
        rc = lib.pf_stream(
            _MODE_ID[mode], x.data_ptr() if x is not None else None,
            y.data_ptr() if y is not None else None, t.numel(), float(value),
            partial.data_ptr() if partial is not None else None,
            out.data_ptr() if out is not None else None,
            torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(rc, "stream")
    stream.launches += 1
    return out if mode == "read" else y


stream.launches = 0


def stream_plain(mode: str, x=None, y=None, value: float = 0.0):
    """PyTorch's own sum, fill_ and copy_ (same signature and result)."""
    _check(mode, x, y)
    if mode == "read":
        return x.sum(dtype=torch.float64)
    if mode == "write":
        return y.fill_(value)
    return y.copy_(x)


def time_ms(fn, reps):
    """Mean ms per call of fn on the card, from CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def measure(sizes_mb=(64, 512, 2048), reps=20):
    """Rows {size_mb, mode, ms, gbps, torch_ms, torch_gbps, spread,
    torch_spread} on the card: bytes moved (read: n*4, write: n*4, copy:
    2*n*4) over the median, across WINDOWS windows, of the mean time of
    `reps` calls, from CUDA events after a warm-up.  K4's windows and
    PyTorch's (sum, fill_, copy_) alternate, so a drift of the card's clock
    reaches both; spread is (slowest - fastest) / median of the windows."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bandwidth probe runs on an NVIDIA card only")
    rows = []
    for mb in sizes_mb:
        n = mb * (1 << 20) // 4
        x = torch.randn(n, device="cuda")
        y = torch.empty_like(x)
        calls = {
            "read": (lambda: stream("read", x), lambda: x.sum(), 4 * n),
            "write": (lambda: stream("write", y=y, value=1.0),
                      lambda: y.fill_(1.0), 4 * n),
            "copy": (lambda: stream("copy", x, y), lambda: y.copy_(x),
                     8 * n),
        }
        for mode, (k, lib_call, nbytes) in calls.items():
            ks, ts = [], []
            for _ in range(WINDOWS):
                ks.append(time_ms(k, reps))
                ts.append(time_ms(lib_call, reps))
            ms, tms = float(np.median(ks)), float(np.median(ts))
            rows.append({"size_mb": mb, "mode": mode, "ms": ms,
                         "gbps": nbytes / ms / 1e6, "torch_ms": tms,
                         "torch_gbps": nbytes / tms / 1e6,
                         "spread": (max(ks) - min(ks)) / ms,
                         "torch_spread": (max(ts) - min(ts)) / tms})
        del x, y
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="pffdtd_tpu_torch.kernels.stream")
    p.add_argument("--sizes-mb", type=int, nargs="+", default=[64, 512, 2048])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    print(f"device {torch.cuda.get_device_name(0)}")
    for r in measure(args.sizes_mb, args.reps):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
