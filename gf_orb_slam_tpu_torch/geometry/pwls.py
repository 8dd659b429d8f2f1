"""PWLS 13-state constant-velocity camera state (port of
gf_orb_slam_tpu/geometry/pwls.py).

Xv (13,) = [r(3) position in world, q(4) camera→world wxyz, v(3), w(3)].
Propagation over dt: r += v·dt; q ← q ⊗ v2q(w·dt); v, w constant. Its
Jacobian F is the identity except F[0:3, 7:10] = dt·I, F[3:7, 3:7] =
Rm(v2q(w·dt)) and F[3:7, 10:13] = L(q)·d(v2q(w·dt))/dw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import quat, se3

_EPS = 1e-6


class KineState(NamedTuple):
    """PWLS segment: state vector and segment duration (ref KineStruct)."""

    Xv: torch.Tensor  # (13,) or batched (..., 13)
    dt: torch.Tensor  # scalar or (...,)


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


def _as(dt, like: torch.Tensor) -> torch.Tensor:
    """dt as a tensor on like's device; a Python number is filled in place
    there (no host→device copy)."""
    if isinstance(dt, torch.Tensor):
        return dt.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(dt), dtype=like.dtype, device=like.device)


def propagate(Xv: torch.Tensor, dt) -> torch.Tensor:
    """One PWLS step, the quaternion renormalized."""
    Xn = propagate_unnormalized(Xv, dt)
    return torch.cat([Xn[..., 0:3], quat.qnormalize(Xn[..., 3:7]), Xn[..., 7:13]], dim=-1)


def propagate_unnormalized(Xv: torch.Tensor, dt) -> torch.Tensor:
    """One PWLS step without renormalizing the quaternion: the map whose
    exact Jacobian is f_matrix."""
    dt = _as(dt, Xv)
    r = Xv[..., 0:3] + Xv[..., 7:10] * dt[..., None]
    q = quat.qprod(Xv[..., 3:7], quat.v2q(Xv[..., 10:13] * dt[..., None]))
    return torch.cat([r, q, Xv[..., 7:10], Xv[..., 10:13]], dim=-1)


def dq_dt_by_domega(w: torch.Tensor, dt) -> torch.Tensor:
    """d(v2q(w·dt))/dw, (..., 4, 3), branch-free with the ω→0 limits
    (dq0/dw → 0, dqA/dwA → dt/2, dqA/dwB → 0)."""
    dt = _as(dt, w)
    omega = torch.linalg.vector_norm(w, dim=-1)
    small = omega < _EPS
    om = torch.where(small, 1.0, omega)
    half = om * dt / 2.0
    s, c = torch.sin(half), torch.cos(half)

    # Row 0: dq0/dwA = (−dt/2)(wA/ω)·sin(ω·dt/2); its coefficient's limit −dt²/4.
    coef0 = torch.where(small, -dt * dt / 4.0, (-dt / 2.0) * s / om)[..., None]
    row0 = coef0 * w
    # Diagonal: (dt/2)(wA²/ω²)cos + (1/ω)(1 − wA²/ω²)sin; limit dt/2.
    wa2 = (w * w) / (om * om)[..., None]
    diag = torch.where(
        small[..., None],
        dt[..., None] / 2.0 * torch.ones_like(w),
        (dt[..., None] / 2.0) * wa2 * c[..., None] + (1.0 / om[..., None]) * (1.0 - wa2) * s[..., None],
    )
    # Off-diagonal: (wA·wB/ω²)((dt/2)cos − (1/ω)sin); limit 0.
    off_coef = torch.where(small, 0.0, ((dt / 2.0) * c - s / om) / (om * om))
    outer = w[..., :, None] * w[..., None, :]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    J_xyz = off_coef[..., None, None] * outer * (1.0 - eye) + diag[..., :, None] * eye
    return torch.cat([row0[..., None, :], J_xyz], dim=-2)


def f_matrix(Xv: torch.Tensor, dt) -> torch.Tensor:
    """State-transition Jacobian F (..., 13, 13). `dt` may be a device
    tensor; nothing here reads it on the host."""
    dt = _as(dt, Xv)
    q_old = Xv[..., 3:7]
    w_old = Xv[..., 10:13]
    q_move = quat.v2q(w_old * dt[..., None])
    batch = Xv.shape[:-1]
    eye13 = torch.eye(13, dtype=Xv.dtype, device=Xv.device).expand(batch + (13, 13))
    dt_block = dt[..., None, None] * torch.eye(3, dtype=Xv.dtype, device=Xv.device)
    zeros = Xv.new_zeros(batch + (3, 3))
    rows_r = torch.cat([eye13[..., 0:3, 0:7], dt_block, zeros], dim=-1)              # (…, 3, 13)
    F_Q = quat.right_prod_matrix(q_move)                                             # d(q⊗q_move)/dq
    F_Omg = quat.left_prod_matrix(q_old) @ dq_dt_by_domega(w_old, dt)                # d(q⊗q_move)/dw
    rows_q = torch.cat([Xv.new_zeros(batch + (4, 3)), F_Q, Xv.new_zeros(batch + (4, 3)), F_Omg], dim=-1)
    return torch.cat([rows_r, rows_q, eye13[..., 7:13, :]], dim=-2)


def pose_cw_from_state(Xv: torch.Tensor) -> torch.Tensor:
    """Xv → 7-vector T_cw."""
    q_cw = quat.qconj(quat.qnormalize(Xv[..., 3:7]))
    t_cw = -quat.rotate(q_cw, Xv[..., 0:3])
    return se3.make_pose(q_cw, t_cw)
