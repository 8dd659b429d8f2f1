"""System: median host-clock ms of `SlamSystem.process` on tracked frames
without an insertion, in the window before the profiler starts."""

import statistics


def read(run):
    ms = [f["ms"] for f in run["frames"] if f["kind"] == "tracked" and f["phase"] == "plain"]
    return statistics.median(ms) if ms else None
