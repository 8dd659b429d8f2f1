"""Pinhole camera with radial-tangential distortion (port of
gf_orb_slam_tpu/geometry/camera.py). CameraModel is a hashable NamedTuple of
Python scalars, so it can key caches like the reference's static jit args."""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraModel(NamedTuple):
    """Intrinsics + distortion, the settings-yaml Camera.* fields."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 752
    height: int = 480
    fps: float = 20.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


# EuRoC cam0 intrinsics with its radtan distortion: the room-circuit camera.
EUROC_CAM = CameraModel(
    fx=458.654, fy=457.296, cx=367.215, cy=248.375,
    k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
    width=752, height=480, fps=20.0,
)


def distort_normalized(cam: CameraModel, xn: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: CameraModel, xd: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert radtan by fixed-point iteration (static iteration count)."""
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xx * yy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xx * yy
        x = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return x


def pixel_to_normalized(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def normalized_to_pixel(cam: CameraModel, xn: torch.Tensor) -> torch.Tensor:
    return torch.stack([xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_pixels(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords → undistorted pixel coords."""
    if not cam.has_distortion:
        return uv
    return normalized_to_pixel(cam, undistort_normalized(cam, pixel_to_normalized(cam, uv)))


def project(cam: CameraModel, xc: torch.Tensor, eps: float = 1e-6):
    """Camera-frame points (..., 3) → (uv (..., 2), depth (...,), valid (...,)).
    uv stays finite behind the camera (clamped z); valid is False there."""
    z = xc[..., 2]
    z_safe = torch.where(torch.abs(z) < eps, eps, z)
    xn = xc[..., :2] / z_safe[..., None]
    uv = normalized_to_pixel(cam, xn)
    return uv, z, z > eps


def in_image(cam: CameraModel, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= -margin) & (uv[..., 0] < cam.width + margin)
        & (uv[..., 1] >= -margin) & (uv[..., 1] < cam.height + margin)
    )


def backproject(cam: CameraModel, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels + depth → camera-frame 3D points."""
    xn = pixel_to_normalized(cam, uv)
    return torch.cat([xn * depth[..., None], depth[..., None]], dim=-1)


def projection_jacobian(cam: CameraModel, xc: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """d(uv)/d(xc): the 2×3 pinhole Jacobian (..., 2, 3)."""
    x, y, z = xc.unbind(-1)
    z_safe = torch.where(torch.abs(z) < eps, eps, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row0 = torch.stack([cam.fx * iz, zero, -x * cam.fx * iz2], dim=-1)
    row1 = torch.stack([zero, cam.fy * iz, -y * cam.fy * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)
