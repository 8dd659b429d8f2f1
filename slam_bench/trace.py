"""Reductions of the session's device trace: the union of its kernel and
copy intervals, their busy share and longest idle gaps over the traced
window (first kernel start to last kernel end), kernel time by name, and
kernels per frame. A trace is (starts ns, ends ns, name ids, names)."""

from __future__ import annotations

import numpy as np

NAME_CHARS = 120  # a kernel's name in the breakdown: its first characters


def union(intervals: np.ndarray) -> np.ndarray:
    """(M, 2) disjoint sorted intervals covering the (N, 2) ones."""
    if len(intervals) == 0:
        return np.zeros((0, 2), np.int64)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(np.r_[new[1:], True])
    return np.stack([starts, ends[last]], 1)


def clipped(kernels, window: tuple[int, int]) -> np.ndarray:
    """The trace's intervals clipped to `window`, (N, 2) ns."""
    s, e, _, _ = kernels
    a, b = window
    iv = np.stack([np.clip(s, a, b), np.clip(e, a, b)], 1)
    return iv[iv[:, 1] > iv[:, 0]]


def busy_ns(kernels, window: tuple[int, int]) -> int:
    """Nanoseconds of `window` in which some kernel or copy ran."""
    u = union(clipped(kernels, window))
    return int((u[:, 1] - u[:, 0]).sum())


def idle_gaps(kernels, window: tuple[int, int], host_state, top: int = 10) -> list:
    """The `top` longest stretches of `window` with no kernel, each named by
    `host_state(ns)`; [[name, seconds], ...]."""
    u = union(clipped(kernels, window))
    edges = np.r_[window[0], u.ravel(), window[1]].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:top]
    return [[host_state(int(gaps[j, 0])), (gaps[j, 1] - gaps[j, 0]) / 1e9] for j in order]


def device_ops(kernels, window: tuple[int, int], top: int = 10) -> list:
    """[[kernel name, seconds], ...]: device time by name inside `window`,
    the `top` largest."""
    s, e, nid, names = kernels
    a, b = window
    d = np.maximum(np.clip(e, a, b) - np.clip(s, a, b), 0)
    sums = np.bincount(nid, weights=d, minlength=len(names))
    order = np.argsort(-sums, kind="stable")[:top]
    return [[names[j][:NAME_CHARS], float(sums[j] / 1e9)] for j in order if sums[j] > 0]


def frame_kernel_counts(session: dict, kinds: tuple[str, ...]) -> list[int] | None:
    """Kernels that ran during each traced in-window frame of `kinds`: the
    device's kernel starts (the trace's clock, Unix ns) inside
    the frame's host-clock interval. Each frame ends in a device read, so
    its kernels end inside it. None where the trace is missing or where
    fewer than 99% of the kernels inside the traced frames' span fall in a
    frame (the two clocks disagree)."""
    tr = session.get("trace")
    frames = [f for f in session["records"] if f["phase"] == "traced" and f["in_window"]]
    if not tr or tr["kernels"] is None or not frames:
        return None
    s, _, nid, names = tr["kernels"]
    kern = np.sort(s[[not names[j].startswith(("Memcpy", "Memset")) for j in nid]])
    lo = np.searchsorted(kern, [f["wall_start_ns"] for f in frames])
    hi = np.searchsorted(kern, [f["wall_end_ns"] for f in frames])
    span = np.searchsorted(kern, [frames[0]["wall_start_ns"], frames[-1]["wall_end_ns"]])
    if (hi - lo).sum() < 0.99 * max(span[1] - span[0], 1):
        return None
    return [int(h - l) for f, l, h in zip(frames, lo, hi) if f["kind"] in kinds]
