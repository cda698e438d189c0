"""run_held_gib (GiB): device memory still held when the run that set the
peak starts to allocate its own (`run.state`'s entry allocation), beyond
the engine's (`engine_static_gib`): the run's signals.  The last run's
state is dropped before the run's first span, so it is not held here."""

from rirbench.spans import GIB, engine_static_bytes, peak_state, records


def read(run):
    recs = records(run) or []
    s, static = peak_state(recs), engine_static_bytes(recs)
    if s is None or static is None:
        return None
    return (s.mem_in - static) / GIB
