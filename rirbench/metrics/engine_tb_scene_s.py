"""engine_tb_scene_s (s): host seconds of K3's tile lists, built in the
engine's constructor on the tb route (span `engine.tb_scene`,
`TBScene.make`)."""

from rirbench.spans import setup_seconds


def read(run):
    return setup_seconds(run, "engine.tb_scene")
