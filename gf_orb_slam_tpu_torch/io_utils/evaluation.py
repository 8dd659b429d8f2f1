"""Trajectory evaluation: ATE-RMSE with Umeyama Sim(3) alignment (a copy of
gf_orb_slam_tpu/io_utils/evaluation.py, host numpy; tests hold the two equal).

Monocular trajectories are aligned with a similarity transform (scale is
unobservable) before computing RMSE, the standard EuRoC/TUM protocol.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning src → dst, both (N, 3).

    Returns (s, R, t) with dst ≈ s·R·src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True
) -> float:
    """Absolute trajectory error RMSE after Sim(3) (or SE(3)) alignment."""
    s, R, t = umeyama_alignment(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=1)
    return float(np.sqrt((err**2).mean()))


def write_tum_trajectory(path: str, timestamps, poses_cw) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` of T_wc (ref main.cc:186-215)."""
    import torch

    from gf_orb_slam_tpu_torch.geometry import se3

    with open(path, "w") as f:
        for t, p in zip(timestamps, poses_cw):
            wc = se3.inverse(torch.as_tensor(np.asarray(p, np.float32)))
            q = se3.pose_q(wc).numpy()
            tr = se3.pose_t(wc).numpy()
            f.write(
                f"{t:.6f} {tr[0]:.6f} {tr[1]:.6f} {tr[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )
