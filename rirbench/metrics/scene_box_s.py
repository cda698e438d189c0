"""scene_box_s (s): host seconds of the analytic box (span `scene.box`,
`scene.synthetic_box_sim`): its boundary nodes and its own source and
receivers; the request's are timed apart (`comms.prepare`)."""

from rirbench.spans import setup_seconds


def read(run):
    return setup_seconds(run, "scene.box")
