"""Step: median count of device kernels per traced tracked frame (the
tracking step `track_frame_fused` and the frame's one read)."""

import statistics

from slam_bench import trace


def read(run):
    counts = trace.frame_kernel_counts(run["session"], ("tracked",))
    return statistics.median(counts) if counts else None
