"""engine_upload_s (s): host seconds of the engine's uploads of its static
arrays to the card (span `engine.upload`)."""

from rirbench.spans import setup_seconds


def read(run):
    return setup_seconds(run, "engine.upload")
