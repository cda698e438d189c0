"""scene_rotate_s (s): host seconds of the rotation (span `scene.rotate`,
`scene.rotate_sim` with "auto"'s scoring)."""

from rirbench.spans import setup_seconds


def read(run):
    return setup_seconds(run, "scene.rotate")
