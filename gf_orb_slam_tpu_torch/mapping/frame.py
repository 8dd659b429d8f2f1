"""Per-image Frame container as SoA tensors (port of
gf_orb_slam_tpu/mapping/frame.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry.camera import CameraModel, undistort_pixels
from gf_orb_slam_tpu_torch.ops import orb


class FrameData(NamedTuple):
    uv: torch.Tensor        # (N, 2) undistorted pixel coords
    uv_raw: torch.Tensor    # (N, 2) raw (distorted) pixel coords
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) float32
    desc: torch.Tensor      # (N, 8) int32 (bit view of uint32)
    response: torch.Tensor  # (N,) float32
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def make_frame(img: torch.Tensor, cam: CameraModel, cfg: orb.OrbConfig) -> FrameData:
    """Extract ORB features and undistort the keypoints."""
    kps = orb.extract_orb(img, cfg)
    return FrameData(
        uv=undistort_pixels(cam, kps.uv),
        uv_raw=kps.uv,
        octave=kps.octave,
        angle=kps.angle,
        desc=kps.desc,
        response=kps.response,
        valid=kps.valid,
    )
