"""scene_s (s): host seconds of the room set-up: the box's boundary nodes,
the request's source and receivers, rotation, fold and sort."""


def read(run):
    return run["spans"]["scene_s"]
