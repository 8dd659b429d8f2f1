"""System: median host-clock ms of `SlamSystem.process` on frames that
insert a keyframe, in the window before the profiler starts."""

import statistics


def read(run):
    ms = [f["ms"] for f in run["frames"] if f["kind"] == "insert" and f["phase"] == "plain"]
    return statistics.median(ms) if ms else None
