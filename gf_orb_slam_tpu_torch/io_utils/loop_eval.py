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


# Operating points the gate study sweeps offline (tools/loop_gate_study.py --analyze).
SWEEP_CONSISTENCY = (2, 3)
SWEEP_RANSAC = (8, 10, 13, 15, 20)
SWEEP_REFINE = (10, 15, 20, 25)


def gate_sweep(runs: list[dict]) -> dict:
    """The loop-gate study's offline sweep over recorded funnels (runs with
    `episodes` and `gate_events`, probe mode): per (consistency, RANSAC
    floor, refine floor) the episodes whose keyframes (±1) had a
    ground-truth-true candidate event passing all three, and the false
    events passing them. An episode is a dict with its keyframes `kfs`."""
    cand_events = [dict(ev, run=i) for i, r in enumerate(runs) for ev in r["gate_events"] if "cand" in ev]
    n_episodes = sum(len(r["episodes"]) for r in runs)

    def passes(ev, cons, t_ransac, t_refine):
        return ev["streak"] >= cons and ev["n_ransac"] >= t_ransac and ev["n_opt"] >= t_refine

    table = []
    for cons in SWEEP_CONSISTENCY:
        for t_r in SWEEP_RANSAC:
            for t_o in SWEEP_REFINE:
                closed = sum(
                    any(ev["run"] == i and any(abs(ev["kf"] - k) <= 1 for k in ep["kfs"]) and ev["gt_true"]
                        and passes(ev, cons, t_r, t_o) for ev in cand_events)
                    for i, r in enumerate(runs) for ep in r["episodes"])
                false = sum(1 for ev in cand_events if ev["gt_true"] is False and passes(ev, cons, t_r, t_o))
                table.append({"consistency": cons, "ransac_th": t_r, "refine_th": t_o, "episodes_closed": closed,
                              "episodes": n_episodes, "recall": closed / n_episodes if n_episodes else None,
                              "false_accepts": false})
    return {
        "n_runs": len(runs),
        "n_episodes": n_episodes,
        "live_closed_episodes": sum(1 for r in runs for ep in r["episodes"] if ep["closed"]),
        "n_candidate_events": len(cand_events),
        "n_gt_true_events": sum(1 for e in cand_events if e["gt_true"]),
        "n_gt_false_events": sum(1 for e in cand_events if e["gt_true"] is False),
        "note": ("offline projection over shadow-verified funnels recorded at ransac_floor=8 under the shipped "
                 "live decision (>=20/>=20 @ streak>=3); episode<->event association by keyframe id +/-1"),
        "operating_points": table,
    }


def _rot(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _center(pose_cw) -> np.ndarray:
    return -_rot(pose_cw[:4]).T @ np.asarray(pose_cw[4:7], np.float64)


def map_scale_ratio(query_kf: int, cand_kf: int, kf_pose, kf_frame_id, kf_valid, poses_gt) -> float:
    """The map's scale at the query keyframe over that at the candidate:
    each keyframe's distance to the valid keyframe nearest it in frames,
    over the ground truth's distance between the two frames. A loop Sim3
    (candidate camera → query camera) of the right scale has this scale."""
    fid, valid = np.asarray(kf_frame_id), np.flatnonzero(np.asarray(kf_valid))

    def scale(k) -> float:
        j = min((j for j in valid if j != k), key=lambda j: abs(int(fid[j]) - int(fid[k])))
        gt = np.linalg.norm(_center(poses_gt[fid[k]]) - _center(poses_gt[fid[j]]))
        return float(np.linalg.norm(_center(kf_pose[k]) - _center(kf_pose[j])) / gt)

    return scale(query_kf) / scale(cand_kf)


def sim3_against_ground_truth(S12, query_kf: int, cand_kf: int, kf_pose, kf_frame_id, kf_valid, poses_gt) -> dict:
    """A loop Sim3 (candidate camera → query camera) against the ground
    truth: its rotation error to the ground truth's relative rotation of the
    two keyframes' frames (degrees), its scale, `map_scale_ratio` and the
    scale over that ratio."""
    fid = np.asarray(kf_frame_id)
    R_gt = _rot(poses_gt[fid[query_kf]][:4]) @ _rot(poses_gt[fid[cand_kf]][:4]).T
    cos = (np.trace(_rot(S12[:4]).T @ R_gt) - 1) / 2
    ratio = map_scale_ratio(query_kf, cand_kf, kf_pose, kf_frame_id, kf_valid, poses_gt)
    return {"rotation_error_deg": float(np.rad2deg(np.arccos(np.clip(cos, -1, 1)))), "scale": float(S12[7]),
            "map_scale_ratio": ratio, "scale_error": float(S12[7]) / ratio}
