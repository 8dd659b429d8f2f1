"""End to end: seconds from the harness's start to the window's start (the
kernel library's load or build, the render, the vocabulary load, the
warm-up frames and the set-up pass)."""


def read(run):
    return run["setup_s"]
