"""Loop-closure recall on the synthetic room circuit (port of the measurement
in tools/loop_recall.py and tools/loop_gate_study.py).

The circuit's camera looks along θ(frame) = 2π·revs·frame/n_frames, so two
frames' frusta overlap when their angles differ by little (mod 2π). Set
`SlamSystem.loop_gt_overlap = circuit_gt_overlap(n_frames, revs)` and the
system records one event per loop-detection round (`loop_events`): whether a
revisit opportunity existed (an old keyframe with no covisibility to the
query whose frustum overlaps it) and whether a loop closed. Consecutive
opportunity events form an episode, one revisit that needs one closure:

  recall          = closed episodes / episodes
  false closures  = closures whose matched keyframe's frustum does not
                    overlap the query's within 45°
"""

from __future__ import annotations

from typing import Callable

import numpy as np

OVERLAP_DEG = 25.0        # frusta of a revisit opportunity
FALSE_CLOSURE_DEG = 45.0  # a closure further apart than this is geometrically wrong


def circuit_gt_overlap(n_frames: int, revs: float, max_deg: float = OVERLAP_DEG) -> Callable[..., bool]:
    """(frame_q, frame_k[, max_deg]) → whether the two frames' viewing
    directions on the circuit differ by less than max_deg."""

    def theta(fid: int) -> float:
        return 2.0 * np.pi * revs * fid / n_frames

    def gt_overlap(fid_q: int, fid_k: int, max_deg: float = max_deg) -> bool:
        d = abs(theta(fid_q) - theta(fid_k)) % (2.0 * np.pi)
        d = min(d, 2.0 * np.pi - d)
        return bool(d < np.deg2rad(max_deg))

    return gt_overlap


def episodes(events: list[dict]) -> list[dict]:
    """Runs of consecutive opportunity events: {"events", "kfs", "frames",
    "closed"} each."""
    out, cur = [], None
    for ev in events:
        if ev["opportunity"]:
            if cur is None:
                cur = {"events": [], "kfs": [], "frames": [], "closed": False}
                out.append(cur)
            cur["events"].append(ev)
            cur["kfs"].append(ev["kf"])
            cur["frames"].append(ev["frame"])
            cur["closed"] = cur["closed"] or ev["closed"]
        else:
            cur = None
    return out


def false_closures(events: list[dict], kf_frame_id, gt_overlap: Callable[..., bool]) -> int:
    """Closures whose matched keyframe (its frame from `kf_frame_id`, the
    final map's) is more than FALSE_CLOSURE_DEG from the query's frame."""
    fid = np.asarray(kf_frame_id)
    return sum(1 for ev in events
               if ev["closed"] and ev["matched_kf"] is not None
               and not gt_overlap(ev["frame"], int(fid[ev["matched_kf"]]), max_deg=FALSE_CLOSURE_DEG))


def recall_summary(events: list[dict], kf_frame_id, gt_overlap: Callable[..., bool]) -> dict:
    """The recall tool's counts of one run: events, opportunity events,
    episodes, closed episodes, closures (events that closed) and false
    closures."""
    eps = episodes(events)
    return {
        "events": len(events),
        "opportunity_events": sum(1 for e in events if e["opportunity"]),
        "episodes": len(eps),
        "closed_episodes": sum(1 for e in eps if e["closed"]),
        "closures": sum(1 for e in events if e["closed"]),
        "false_closures": false_closures(events, kf_frame_id, gt_overlap),
    }


def closed_episodes_missed(ref_events: list[dict], events: list[dict], slack: int) -> list[tuple[int, int]]:
    """Frame spans of the reference's closed episodes that no closed
    episode of `events` meets within `slack` frames (two runs of one
    sequence insert keyframes at slightly different frames)."""
    spans = [(min(e["frames"]), max(e["frames"])) for e in episodes(events) if e["closed"]]
    missed = []
    for e in episodes(ref_events):
        if not e["closed"]:
            continue
        lo, hi = min(e["frames"]) - slack, max(e["frames"]) + slack
        if not any(a <= hi and b >= lo for a, b in spans):
            missed.append((min(e["frames"]), max(e["frames"])))
    return missed


def events_to_array(events: list[dict]) -> np.ndarray:
    """(E, 5) int32 rows (kf, frame, opportunity, closed, matched_kf or −1)."""
    return np.asarray([[e["kf"], e["frame"], int(e["opportunity"]), int(e["closed"]),
                        -1 if e["matched_kf"] is None else e["matched_kf"]] for e in events],
                      np.int32).reshape(-1, 5)


def events_from_array(a) -> list[dict]:
    """The inverse of events_to_array."""
    return [{"kf": int(r[0]), "frame": int(r[1]), "opportunity": bool(r[2]), "closed": bool(r[3]),
             "matched_kf": None if r[4] < 0 else int(r[4])} for r in np.asarray(a).reshape(-1, 5)]
