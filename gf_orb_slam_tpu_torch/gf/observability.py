"""Measurement Jacobians and information matrices wrt the PWLS camera state
(port of gf_orb_slam_tpu/gf/observability.py).

Camera state Xv = [r(3), q_wr(4), v(3), w(3)]; landmark y in world;
hrl = R_rw (y − r); pixel u = fx·x/z + cx, v = fy·y/z + cy.
  H13 = ∂(u,v)/∂r = −dhu_dhrl · R_rw                     (2×3)
  H47 = ∂(u,v)/∂q = dhu_dhrl · dRq_a_dq(q̄, y−r) · dq̄/dq (2×4)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import quat
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel, projection_jacobian


class ObsJacobians(NamedTuple):
    H13: torch.Tensor      # (N, 2, 3)
    H47: torch.Tensor      # (N, 2, 4)
    H: torch.Tensor        # (N, 2, 7) = [H13 | H47]
    uv: torch.Tensor       # (N, 2) predicted pixels
    visible: torch.Tensor  # (N,) bool


def measurement_jacobians(
    cam: CameraModel,
    Xv: torch.Tensor,
    points_w: torch.Tensor,
    bound_depth: float = 0.0,
    bound_frame: float = 0.0,
) -> ObsJacobians:
    """H-subblocks for all N landmarks at once for one state Xv (13,)."""
    q_wr = quat.qnormalize(Xv[3:7])
    R_rw = quat.q2r(q_wr).T
    t_rw = points_w - Xv[None, 0:3]                    # (N, 3) world offsets
    hrl = torch.einsum("ij,nj->ni", R_rw, t_rw)        # camera-frame coords

    z = hrl[:, 2]
    z_ok = z > bound_depth
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * hrl[:, 0] / z_safe + cam.cx
    v = cam.fy * hrl[:, 1] / z_safe + cam.cy
    uv = torch.stack([u, v], dim=-1)
    visible = (
        z_ok
        & (u >= -bound_frame) & (u < cam.width + bound_frame)
        & (v >= -bound_frame) & (v < cam.height + bound_frame)
    )

    dhu = projection_jacobian(cam, hrl)                # (N, 2, 3)
    H13 = -torch.einsum("nij,jk->nik", dhu, R_rw)
    dR = quat.dRq_a_dq(quat.qconj(q_wr)[None, :], t_rw)  # (N, 3, 4)
    dqbar = quat.dqbar_by_dq(Xv.dtype, Xv.device)
    H47 = torch.einsum("nij,njk,kl->nil", dhu, dR, dqbar)
    H = torch.cat([H13, H47], dim=-1)
    return ObsJacobians(H13=H13, H47=H47, H=H, uv=uv, visible=visible)


def whiten(H: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """Octave-leveled noise whitening: Σ = σ²·I per observation → H/σ."""
    return H / torch.sqrt(sigma2)[..., None, None]


def info_matrices(H_w: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """(N, 2, 7) whitened Jacobians → (N, 7, 7) information blocks HᵀH;
    invisible landmarks give zeros."""
    blocks = torch.einsum("nri,nrj->nij", H_w, H_w)
    return torch.where(visible[:, None, None], blocks, 0.0)


def hybrid_factors(H: torch.Tensor, F: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """Two-segment PWLS stacking [H·Sel ; H·Sel·F] over the 13-dim state,
    (N, 4, 13), Sel embedding the 7 pose columns into 13: block_i =
    factorᵀ·factor. Invisible landmarks give zeros."""
    H13d = torch.cat([H, H.new_zeros(H.shape[:-1] + (6,))], dim=-1)  # (N, 2, 13)
    HF = torch.einsum("nri,ij->nrj", H13d, F)
    stacked = torch.cat([H13d, HF], dim=1)
    return torch.where(visible[:, None, None], stacked, 0.0)


def hybrid_matrices(H: torch.Tensor, F: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """13×13 information block per landmark from the hybrid stacking."""
    stacked = hybrid_factors(H, F, visible)
    return torch.einsum("nri,nrj->nij", stacked, stacked)
