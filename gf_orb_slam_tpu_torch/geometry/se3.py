"""SE(3) operations on 7-vector poses [qw qx qy qz tx ty tz] encoding T_cw
(port of gf_orb_slam_tpu/geometry/se3.py). All ops are batch-friendly."""

from __future__ import annotations

import torch

from gf_orb_slam_tpu_torch.geometry import quat

_EPS = 1e-7


def make_pose(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def identity_pose(dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 0, 0, 0, 0, 0, 0], built by a fill (no host→device copy)."""
    return torch.zeros(7, dtype=dtype, device=device).index_fill_(
        0, torch.zeros(1, dtype=torch.int64, device=device), 1.0
    )


def pose_matrix(p: torch.Tensor) -> torch.Tensor:
    """7-vec → 4×4 homogeneous matrix."""
    R = quat.q2r(quat.qnormalize(pose_q(p)))
    top = torch.cat([R, pose_t(p)[..., None]], dim=-1)
    zeros = torch.zeros(p.shape[:-1] + (1, 3), dtype=p.dtype, device=p.device)
    bottom = torch.cat([zeros, torch.ones_like(zeros[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def from_matrix(T: torch.Tensor) -> torch.Tensor:
    """4×4 (or 3×4) homogeneous matrix → 7-vec."""
    return make_pose(quat.r2q(T[..., :3, :3]), T[..., :3, 3])


def pose_q(p: torch.Tensor) -> torch.Tensor:
    return p[..., :4]


def pose_t(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:7]


def compose(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """T(p1) @ T(p2) as 7-vecs."""
    q = quat.qnormalize(quat.qprod(pose_q(p1), pose_q(p2)))
    t = quat.rotate(pose_q(p1), pose_t(p2)) + pose_t(p1)
    return make_pose(q, t)


def inverse(p: torch.Tensor) -> torch.Tensor:
    qi = quat.qconj(pose_q(p))
    ti = -quat.rotate(qi, pose_t(p))
    return make_pose(qi, ti)


def transform_point(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply T(p) to 3D point(s) x."""
    return quat.rotate(pose_q(p), x) + pose_t(p)


def relative(p_a: torch.Tensor, p_b: torch.Tensor) -> torch.Tensor:
    """T_a ∘ T_b⁻¹: the transform taking frame b's camera to frame a's."""
    return compose(p_a, inverse(p_b))


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator, (..., 3) → (..., 3, 3)."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with the series branch near 0, (..., 3) → (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < _EPS * _EPS
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A * W + B * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → rotation vector."""
    return quat.q2v(quat.r2q(R))


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: xi = [rho(3), phi(3)] → 7-vec pose, series branch near 0."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta2 < _EPS * _EPS
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta)
    )
    W = hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + B * W + C * (W @ W)
    t = (V @ rho[..., None])[..., 0]
    return make_pose(quat.v2q(phi), t)


def apply_left_update(xi: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """exp(xi) ∘ T(p): the left-multiplicative update of the LM solvers."""
    return compose(exp_se3(xi), p)
