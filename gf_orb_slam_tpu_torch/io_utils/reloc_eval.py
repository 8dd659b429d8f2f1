"""Relocalization recall on the synthetic room circuit (port of the
measurement in tools/reloc_recall.py).

One disturbance episode per run, from 60% of the sequence:

  blackout  BLACKOUT_LEN black frames; the camera then goes on from where
            it was.
  kidnap    the same black frames, after which frame i shows the
            ground-truth frame i + jump, jump = −int(0.25·n_frames / revs):
            the camera is back a quarter revolution, in a part of the room
            mapped long ago, and relocalization has to match old keyframes.

`frame_src` gives the ground-truth index each frame shows (−1 for a black
frame). `recovery` reads a run: recovered (the first WORKING frame with a
pose after the black frames), frames to recover (counted from the first
frame after them), and a false relocalization: the mean error of the first
POST_FRAMES posed frames from the recovery on, mapped through the Sim(3)
alignment fitted on the frames before the black ones, above ERR_TH_M (a
relocalization in the wrong place lands metres off in this room).
"""

from __future__ import annotations

import numpy as np

from gf_orb_slam_tpu_torch.io_utils.evaluation import umeyama_alignment

BLACKOUT_LEN = 8
BLACKOUT_AT = 0.60      # the episode starts at this share of the sequence
ERR_TH_M = 0.5          # post-recovery error of a false relocalization
POST_FRAMES = 10        # frames from the recovery on that the error averages


def blackout_start(n_frames: int) -> int:
    return int(BLACKOUT_AT * n_frames)


def kidnap_jump(n_frames: int, revs: float) -> int:
    """Frames the kidnapped camera jumps by (negative: back along the circuit)."""
    return -int(0.25 * n_frames / revs)


def frame_src(n_frames: int, kind: str, revs: float, blackout_len: int = BLACKOUT_LEN) -> list[int]:
    """The ground-truth index shown at each frame (−1 = black)."""
    if kind not in ("blackout", "kidnap"):
        raise ValueError(f"unknown disturbance {kind!r}; blackout or kidnap")
    b0, jump = blackout_start(n_frames), kidnap_jump(n_frames, revs)
    out = []
    for i in range(n_frames):
        if b0 <= i < b0 + blackout_len:
            out.append(-1)
        elif kind == "kidnap" and i >= b0 + blackout_len:
            out.append(i + jump)
        else:
            out.append(i)
    return out


def recovery(states: list[str], centers: list, src: list[int], gt_centers: np.ndarray,
             blackout_len: int = BLACKOUT_LEN, err_th: float = ERR_TH_M) -> dict:
    """The recall tool's reading of one run.

    states: each frame's state name after it; centers: each frame's
    estimated camera centre (3,), or None where the frame has no pose;
    src: frame_src; gt_centers: the ground-truth camera centres by index."""
    n = len(src)
    b0 = src.index(-1)
    rec_frame = next((i for i in range(b0 + blackout_len, n) if states[i] == "WORKING" and centers[i] is not None),
                     None)
    post_err, false_reloc = None, False
    if rec_frame is not None:
        pre = [i for i in range(b0) if centers[i] is not None]
        s, R, t = umeyama_alignment(np.stack([centers[i] for i in pre]), gt_centers[pre])
        post = [j for j in range(rec_frame, min(rec_frame + POST_FRAMES, n))
                if centers[j] is not None and src[j] >= 0]
        if post:
            est = np.stack([centers[j] for j in post])
            aligned = (s * (R @ est.T)).T + t
            post_err = float(np.linalg.norm(aligned - gt_centers[[src[j] for j in post]], axis=1).mean())
            false_reloc = post_err > err_th
    return {"blackout_at": b0, "blackout_len": blackout_len, "recovered": rec_frame is not None,
            "recovery_frame": rec_frame,
            "frames_to_recover": rec_frame - (b0 + blackout_len) if rec_frame is not None else None,
            "post_recovery_err_m": post_err, "false_reloc": bool(false_reloc)}


def recall_summary(rows: list[dict]) -> dict:
    """The recall tool's summary over runs: episodes, true recoveries,
    recall, false relocalizations, frames to recover (mean, max, all)."""
    good = [r for r in rows if r["recovered"] and not r["false_reloc"]]
    ftr = [r["frames_to_recover"] for r in good]
    return {"episodes": len(rows), "recovered_true": len(good), "recall": len(good) / len(rows) if rows else None,
            "false_relocs": sum(1 for r in rows if r["false_reloc"]),
            "frames_to_recover": {"mean": sum(ftr) / len(ftr) if ftr else None, "max": max(ftr) if ftr else None,
                                  "all": ftr}}
