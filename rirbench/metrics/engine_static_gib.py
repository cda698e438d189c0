"""engine_static_gib (GiB): device memory the engine holds from its
constructor on: the allocation that its uploads (span `engine.upload`)
and, on the tb route, its tile lists (`engine.tb_scene`) added."""

from rirbench.spans import GIB, engine_static_bytes, records


def read(run):
    recs = records(run)
    b = engine_static_bytes(recs) if recs else None
    return None if b is None else b / GIB
