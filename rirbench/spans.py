"""The program's spans (`pffdtd_tpu_torch.spans`) as the per-layer readers
take them: set-up stages, the engine's device memory, and each run's host
work around its step loop.

`records` imports the program inside the function, as `program.py` does,
so that the harness's other modules import without it.  It gives None
where the program records no spans (before it had them) and where the run
has no device trace: the readers of a traced run on the card, like the
trace's own readers, then read nothing."""

from __future__ import annotations

import statistics

GIB = 2**30


def records(run: dict) -> list | None:
    """The process's span records, or None (see the module docstring)."""
    if not run.get("trace"):
        return None
    try:
        from pffdtd_tpu_torch import spans
    except ImportError:
        return None
    return spans.records()


def setup_seconds(run: dict, name: str) -> float | None:
    """Seconds of the set-up spans `name` (outside every run), summed;
    None where none ran."""
    recs = records(run) or []
    got = [r.seconds for r in recs if r.name == name and r.run is None]
    return sum(got) if got else None


def engine_static_bytes(recs: list) -> int | None:
    """Device bytes the last engine's constructor left allocated: its
    `engine.upload`'s exit less entry allocation, plus its
    `engine.tb_scene`'s (tb route); None off the card."""
    up = [r for r in recs if r.name == "engine.upload"
          and r.mem_in is not None]
    if not up:
        return None
    u = up[-1]
    tb = [r.mem_out - r.mem_in for r in recs if r.name == "engine.tb_scene"
          and r.mem_in is not None and r.t0_ns > u.t0_ns]
    return u.mem_out - u.mem_in + sum(tb[-1:])


def peak_state(recs: list):
    """The `run.state` span of the run that set the process's peak: the
    highest allocator peak at its exit, the first of equals (later runs
    read the peak it set); None off the card.  Its peak less its entry
    allocation is what the run allocated beside what it held, and
    engine + held + that is the peak."""
    st = [r for r in recs if r.name == "run.state" and r.mem_peak is not None]
    return max(st, key=lambda r: r.mem_peak) if st else None


def run_host_seconds(recs: list) -> float | None:
    """The median, over the full-length runs, of a run's host work around
    its step loop: `run.signals` + `run.state` + `run.receivers`.  A run
    is full-length where its step loop (`run.state`'s end to
    `run.receivers`' start) lasted at least half the longest loop's time:
    the warm-up runs of a few steps are not."""
    by_run = {}
    for r in recs:
        if r.run is not None and r.name in ("run.signals", "run.state",
                                            "run.receivers"):
            by_run.setdefault(r.run, {})[r.name] = r
    whole = [s for s in by_run.values() if len(s) == 3]
    if not whole:
        return None
    loop = [s["run.receivers"].t0_ns - s["run.state"].t1_ns for s in whole]
    full = [s for s, t in zip(whole, loop) if 2 * t >= max(loop)]
    return statistics.median(sum(r.seconds for r in s.values())
                             for s in full)
