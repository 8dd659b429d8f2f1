"""Hamilton quaternion operations, wxyz convention (port of
gf_orb_slam_tpu/geometry/quat.py). Every function accepts leading batch
dimensions; q2r(q) is R with R @ v_c = v_w for an orientation q_wc."""

from __future__ import annotations

from functools import lru_cache

import torch

_EPS = 1e-7


@lru_cache(maxsize=None)
def _conj_sign(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # Cached per device: a host→device copy of a pageable tensor synchronises
    # the stream, so constants cross once, not on every call.
    return torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype, device=device)


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate [w, -x, -y, -z]."""
    return q * _conj_sign(q.dtype, q.device)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qprod(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    a, b, c, d = q1.unbind(-1)
    w, x, y, z = q2.unbind(-1)
    return torch.stack(
        [
            a * w - b * x - c * y - d * z,
            a * x + b * w + c * z - d * y,
            a * y - b * z + c * w + d * x,
            a * z + b * y - c * x + d * w,
        ],
        dim=-1,
    )


def q2r(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → DCM, (..., 4) → (..., 3, 3). Not normalized internally
    (the GF Jacobians differentiate the homogeneous form)."""
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack(
        [r * r + x * x - y * y - z * z, 2.0 * (x * y - r * z), 2.0 * (z * x + r * y)], dim=-1
    )
    row1 = torch.stack(
        [2.0 * (x * y + r * z), r * r - x * x + y * y - z * z, 2.0 * (y * z - r * x)], dim=-1
    )
    row2 = torch.stack(
        [2.0 * (z * x - r * y), 2.0 * (y * z + r * x), r * r - x * x - y * y + z * z], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def r2q(R: torch.Tensor) -> torch.Tensor:
    """DCM → quaternion, wxyz with w ≥ 0, branch-free: the largest-pivot
    candidate of the four standard constructions."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS * _EPS))

    s_w = safe_sqrt(1.0 + tr)
    q_w = torch.stack(
        [0.5 * s_w, (m21 - m12) / (2.0 * s_w), (m02 - m20) / (2.0 * s_w), (m10 - m01) / (2.0 * s_w)], dim=-1
    )
    s_x = safe_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack(
        [(m21 - m12) / (2.0 * s_x), 0.5 * s_x, (m01 + m10) / (2.0 * s_x), (m02 + m20) / (2.0 * s_x)], dim=-1
    )
    s_y = safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack(
        [(m02 - m20) / (2.0 * s_y), (m01 + m10) / (2.0 * s_y), 0.5 * s_y, (m12 + m21) / (2.0 * s_y)], dim=-1
    )
    s_z = safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack(
        [(m10 - m01) / (2.0 * s_z), (m02 + m20) / (2.0 * s_z), (m12 + m21) / (2.0 * s_z), 0.5 * s_z], dim=-1
    )
    cond_tr = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_tr, q_w, torch.where(cond_x, q_x, torch.where(cond_y, q_y, q_z)))
    q = q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    return qnormalize(q)


def v2q(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector → quaternion, with the small-angle series below _EPS."""
    a2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = a2 < _EPS * _EPS
    a = torch.sqrt(torch.where(small, 1.0, a2))
    half = 0.5 * a
    sinc_half = torch.where(small, 0.5 - a2 / 48.0, torch.sin(half) / a)
    w = torch.where(small, 1.0 - a2 / 8.0, torch.cos(half))
    return torch.cat([w, v * sinc_half], dim=-1)


def q2v(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → rotation vector (log map)."""
    q = qnormalize(q)
    q = q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    small = vn2 < _EPS * _EPS
    vn = torch.sqrt(torch.where(small, 1.0, vn2))
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=_EPS) * (1.0 - vn2 / (3.0 * torch.clamp(w * w, min=_EPS))),
        angle / vn,
    )
    return q[..., 1:] * scale


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q without forming the DCM."""
    qv, v = torch.broadcast_tensors(q[..., 1:], v)  # linalg.cross needs equal ranks
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + q[..., :1] * t + torch.linalg.cross(qv, t, dim=-1)


def dRq_a_dq(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """d(R(q) @ a)/dq, shape (..., 3, 4), R the homogeneous DCM of q2r."""
    q0, qx, qy, qz = q.unbind(-1)

    def m3(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    dR_dq0 = m3([[2 * q0, -2 * qz, 2 * qy], [2 * qz, 2 * q0, -2 * qx], [-2 * qy, 2 * qx, 2 * q0]])
    dR_dqx = m3([[2 * qx, 2 * qy, 2 * qz], [2 * qy, -2 * qx, -2 * q0], [2 * qz, 2 * q0, -2 * qx]])
    dR_dqy = m3([[-2 * qy, 2 * qx, 2 * q0], [2 * qx, 2 * qy, 2 * qz], [-2 * q0, 2 * qz, -2 * qy]])
    dR_dqz = m3([[-2 * qz, -2 * q0, 2 * qx], [2 * q0, -2 * qz, 2 * qy], [2 * qx, 2 * qy, 2 * qz]])
    a_col = a[..., None]
    cols = [(dR @ a_col)[..., 0] for dR in (dR_dq0, dR_dqx, dR_dqy, dR_dqz)]
    return torch.stack(cols, dim=-1)


@lru_cache(maxsize=None)
def dqbar_by_dq(dtype=torch.float32, device=None) -> torch.Tensor:
    """d(conj(q))/dq — constant diagonal (cached per device; do not modify)."""
    return torch.diag(torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype, device=device))


def left_prod_matrix(q: torch.Tensor) -> torch.Tensor:
    """L(q) with qprod(q, p) = L(q) @ p: the Jacobian d(q⊗p)/dp, (..., 4, 4)."""
    r, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([r, -x, -y, -z], dim=-1),
            torch.stack([x, r, -z, y], dim=-1),
            torch.stack([y, z, r, -x], dim=-1),
            torch.stack([z, -y, x, r], dim=-1),
        ],
        dim=-2,
    )


def right_prod_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rm(q) with qprod(p, q) = Rm(q) @ p: the Jacobian d(p⊗q)/dp, (..., 4, 4)."""
    r, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([r, -x, -y, -z], dim=-1),
            torch.stack([x, r, z, -y], dim=-1),
            torch.stack([y, -z, r, x], dim=-1),
            torch.stack([z, y, -x, r], dim=-1),
        ],
        dim=-2,
    )


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation, shortest arc; linear where the two are
    nearly parallel."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < _EPS
    safe = torch.where(near, 1.0, sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    return qnormalize(w0 * q0 + w1 * q1)
