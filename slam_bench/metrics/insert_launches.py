"""Mapping: kernels an insertion frame runs beyond a tracked frame's
(`insert_keyframe_fused` with the BoW registration), the difference of the
two medians over the traced frames."""

import statistics

from slam_bench import trace


def read(run):
    ins = trace.frame_kernel_counts(run["session"], ("insert",))
    trk = trace.frame_kernel_counts(run["session"], ("tracked",))
    return statistics.median(ins) - statistics.median(trk) if ins and trk else None
