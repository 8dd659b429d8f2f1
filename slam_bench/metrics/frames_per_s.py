"""End to end: frames completed inside the window over the window's
seconds, every kind of frame included."""


def read(run):
    return len(run["frames"]) / run["seconds"] if run["frames"] else None
