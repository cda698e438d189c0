"""engine_build_s (s): host seconds of the engine's constructor: its
static arrays, their uploads and, on the tb route, the tile lists."""


def read(run):
    return run["spans"]["engine_build_s"]
