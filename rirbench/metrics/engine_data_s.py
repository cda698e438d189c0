"""engine_data_s (s): host seconds of the engine's host-side static arrays
(span `engine.data`, `EngineData`: the adjacency grid, the lossy nodes'
tables, the signals)."""

from rirbench.spans import setup_seconds


def read(run):
    return setup_seconds(run, "engine.data")
