"""run_state_gib (GiB): device memory the run that set the peak allocated
beside what it held (span `run.state`: the receiver rows, the state, the
TB route's spare buffers): the allocator's peak at the span's exit less
the allocation at its entry.  The last run's state is dropped before the
run's first span, so no second state lies under this peak."""

from rirbench.spans import GIB, peak_state, records


def read(run):
    s = peak_state(records(run) or [])
    return None if s is None else (s.mem_peak - s.mem_in) / GIB
