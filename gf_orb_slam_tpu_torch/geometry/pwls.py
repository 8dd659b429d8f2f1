"""PWLS 13-state constant-velocity camera state (port of the part of
gf_orb_slam_tpu/geometry/pwls.py on the tracking path).

Xv (13,) = [r(3) position in world, q(4) camera→world wxyz, v(3), w(3)].
"""

from __future__ import annotations

import torch

from gf_orb_slam_tpu_torch.geometry import quat, se3

_EPS = 1e-6


def state_from_pose_pair(
    t0: torch.Tensor, Tcw0: torch.Tensor, t1: torch.Tensor, Tcw1: torch.Tensor
) -> torch.Tensor:
    """Xv from two timed world→camera poses: position/orientation from Twc1,
    velocities from the relative motion over the time gap."""
    dt = torch.as_tensor(t1 - t0, dtype=Tcw1.dtype, device=Tcw1.device)
    inv_dt = 1.0 / torch.where(torch.abs(dt) < _EPS, _EPS, dt)
    Twc1 = se3.inverse(Tcw1)
    r = se3.pose_t(Twc1)
    q = se3.pose_q(Twc1)
    T_rel = se3.inverse(se3.compose(Tcw0, Twc1))
    v = se3.pose_t(T_rel) * inv_dt
    w = quat.q2v(se3.pose_q(T_rel)) * inv_dt
    return torch.cat([r, q, v, w], dim=-1)
