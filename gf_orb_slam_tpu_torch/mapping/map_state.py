"""The SLAM map as struct-of-arrays tensors: the read side of
gf_orb_slam_tpu/mapping/map_state.py (container, incidence, covisibility).
The write side (adding points and keyframes, culling) is not ported yet.

`kf_obs_point[k, i]` is the map-point id observed by keypoint slot i of
keyframe k (NO_POINT = none). Descriptor fields hold int32 bit views of the
reference's uint32 words.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NO_POINT = -1
DESC_FIELDS = ("kf_kp_desc", "pt_desc")


class MapState(NamedTuple):
    # --- keyframes (capacity K, keypoints-per-frame capacity N) ---
    kf_pose: torch.Tensor       # (K, 7) T_cw pose vectors
    kf_valid: torch.Tensor      # (K,) bool
    kf_frame_id: torch.Tensor   # (K,) int32
    kf_timestamp: torch.Tensor  # (K,) float32
    kf_kp_uv: torch.Tensor      # (K, N, 2) float32 undistorted pixels
    kf_kp_octave: torch.Tensor  # (K, N) int32
    kf_kp_angle: torch.Tensor   # (K, N) float32
    kf_kp_desc: torch.Tensor    # (K, N, 8) int32
    kf_kp_valid: torch.Tensor   # (K, N) bool
    kf_obs_point: torch.Tensor  # (K, N) int32 — map-point id or NO_POINT

    # --- map points (capacity P) ---
    pt_pos: torch.Tensor        # (P, 3) float32 world positions
    pt_valid: torch.Tensor      # (P,) bool
    pt_desc: torch.Tensor       # (P, 8) int32
    pt_normal: torch.Tensor     # (P, 3) float32 mean viewing direction
    pt_min_dist: torch.Tensor   # (P,) float32
    pt_max_dist: torch.Tensor   # (P,) float32
    pt_visible: torch.Tensor    # (P,) int32
    pt_found: torch.Tensor      # (P,) int32
    pt_first_kf: torch.Tensor   # (P,) int32
    pt_first_frame: torch.Tensor  # (P,) int32

    # --- counters ---
    n_kf: torch.Tensor          # () int32
    n_pt: torch.Tensor          # () int32

    @property
    def kf_capacity(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_pos.shape[0]


def incidence(m: MapState) -> torch.Tensor:
    """(K, P) bool — keyframe k observes point p."""
    K, P = m.kf_capacity, m.pt_capacity
    obs = m.kf_obs_point
    ok = (obs >= 0) & m.kf_valid[:, None]
    k_idx = torch.arange(K, device=obs.device)[:, None]
    flat = torch.where(ok, k_idx * P + obs, K * P)  # K·P = dropped
    A = torch.zeros(K * P + 1, dtype=torch.bool, device=obs.device)
    A[flat.reshape(-1)] = True
    return A[: K * P].reshape(K, P) & m.pt_valid[None, :]


def covisibility(m: MapState, A: torch.Tensor | None = None) -> torch.Tensor:
    """(K, K) int32 shared-point counts (one incidence matmul; float32 counts
    are exact below 2^24)."""
    if A is None:
        A = incidence(m)
    Af = A.to(torch.float32)
    W = (Af @ Af.T).to(torch.int32)
    W = W * (1 - torch.eye(m.kf_capacity, dtype=torch.int32, device=W.device))
    return torch.where(m.kf_valid[:, None] & m.kf_valid[None, :], W, 0)


def to_numpy(m: MapState) -> dict[str, np.ndarray]:
    """Field name → numpy array in the reference's dtypes (descriptors back
    to uint32), the inverse of io_utils.snapshot.map_state_from_numpy."""
    out = {}
    for k, v in m._asdict().items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in DESC_FIELDS else a
    return out
