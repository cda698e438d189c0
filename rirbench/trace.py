"""The device trace of one simulation of the window: `torch.profiler` with
CUDA activity, read from its Chrome trace.

`Trace.summary(window)` gives what the per-layer readers take: the
window's length (the host span around the traced simulation), the seconds
in which a kernel, copy or set ran on the card (the union of their
intervals inside the window), and each device operation's duration; and
the breakdown: the device operations that took the most time and the
longest idle gaps, named by the host operation that overlapped each
most."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "rirbench.traced_simulation"


def short(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace, template and arguments:
    `void (anonymous namespace)::k<float, 12>(float*, ...)` -> `k`."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    if not name.startswith(("Memcpy", "Memset")):
        name = name.split("<")[0].split("(")[0]
    return name.strip()


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Profiles what runs inside `capture()`; `summary()` reads it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events = None

    @contextlib.contextmanager
    def capture(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield
                if self.cuda:
                    torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = [e for e in json.load(f)["traceEvents"]
                               if e.get("ph") == "X"]

    def summary(self, top: int = 10) -> dict | None:
        """None where nothing ran on the device; else window_s, busy_s,
        ops [(name, seconds)] of every device operation in the window,
        and the breakdown."""
        win = [e for e in self.events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        dev = [e for e in self.events if e.get("cat") in DEVICE_CATS]
        if not win or not dev:
            return None
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        spans = [(max(float(e["ts"]), w0),
                  min(float(e["ts"]) + float(e["dur"]), w1), e) for e in dev]
        spans = [s for s in spans if s[1] > s[0]]
        busy = _union([(a, b) for a, b, _ in spans])
        by_name = {}
        for a, b, e in spans:
            k = short(e["name"])
            by_name[k] = by_name.get(k, 0.0) + (b - a) * 1e-6
        # idle gaps inside the window, before, between and after the ops
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        host = [e for e in self.events if e.get("cat") in HOST_CATS
                and e.get("name") != WINDOW]
        return {
            "window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "ops": [(short(e["name"]), (b - a) * 1e-6) for a, b, e in spans],
            "gaps_at_ms": [round((a - w0) * 1e-3, 3) for a, _ in gaps],
            "breakdown": {
                "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": [[self._host_at(host, a, b), (b - a) * 1e-6]
                              for a, b in gaps]}}

    @staticmethod
    def _host_at(host, a, b) -> str:
        """The host operation that overlaps [a, b] the most."""
        best, name = 0.0, "host: no traced operation"
        for e in host:
            t0 = float(e["ts"])
            ov = min(b, t0 + float(e.get("dur", 0.0))) - max(a, t0)
            if ov > best:
                best, name = ov, e["name"]
        return name
