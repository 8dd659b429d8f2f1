"""Compact per-keyframe tracking view of the map (port of
gf_orb_slam_tpu/pipeline/track_view.py): candidate point ids plus their
slowly-changing attributes, snapshotted at keyframe rate so the per-frame
tracker works on ~4k candidates instead of the whole point table."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable


class TrackView(NamedTuple):
    ids: torch.Tensor       # (V,) int32 global point ids (P = invalid padding)
    valid: torch.Tensor     # (V,) bool
    desc: torch.Tensor      # (V, 8) int32
    normal: torch.Tensor    # (V, 3)
    min_dist: torch.Tensor  # (V,)
    max_dist: torch.Tensor  # (V,)

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]


def compute_track_view(
    m: ms.MapState,
    center_kf,
    view_size: int = 4096,
    n_neighbor_kfs: int = 12,
) -> TrackView:
    """Candidates = points observed by the center keyframe's top covisible
    neighbors (plus itself), capped at view_size (lowest ids first)."""
    P = m.pt_capacity
    dev = m.pt_pos.device
    center = torch.as_tensor(center_kf, device=dev).long()
    W_row = ms.covisibility(m)[center]
    w_row = W_row.clone()
    w_row[center] = 1 << 30
    _, kf_ids = top_k_stable(w_row, n_neighbor_kfs)  # ties → lowest keyframe id
    obs = m.kf_obs_point[kf_ids]                      # (n_neighbor_kfs, N)
    kf_ok = m.kf_valid[kf_ids] & ((W_row[kf_ids] > 0) | (kf_ids == center))
    ok = (obs >= 0) & kf_ok[:, None]
    member = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    member[torch.where(ok, obs, P).reshape(-1)] = True
    member = member[:P] & m.pt_valid

    order = torch.where(member, torch.arange(P, dtype=torch.int32, device=dev), P)
    ids = torch.sort(order).values[:view_size]  # the view_size smallest member ids
    valid = ids < P
    safe = torch.clamp(ids, max=P - 1).long()
    return TrackView(
        ids=ids.to(torch.int32),
        valid=valid,
        desc=m.pt_desc[safe],
        normal=m.pt_normal[safe],
        min_dist=m.pt_min_dist[safe],
        max_dist=m.pt_max_dist[safe],
    )
