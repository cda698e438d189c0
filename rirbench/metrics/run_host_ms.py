"""run_host_ms (ms): a simulation's host work around its step loop, the
median over the process's full-length runs of the spans run.signals (the
signals' upload), run.state (the device allocations) and run.receivers
(the rows' download and scaling)."""

from rirbench.spans import records, run_host_seconds


def read(run):
    s = run_host_seconds(records(run) or [])
    return None if s is None else 1e3 * s
