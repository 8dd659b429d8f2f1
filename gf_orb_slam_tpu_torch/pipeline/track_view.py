"""Compact per-keyframe tracking view of the map (port of
gf_orb_slam_tpu/pipeline/track_view.py): candidate point ids plus their
slowly-changing attributes, snapshotted at keyframe rate so the per-frame
tracker works on ~4k candidates instead of the whole point table."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable

# Keyframes whose points make a view: the centre's top covisible neighbours.
# The reference's `top_k` over a keyframe row needs at least this many
# keyframe slots, so it is also the smallest keyframe capacity (see
# check_keyframe_capacity).
N_NEIGHBOR_KFS = 12


def check_keyframe_capacity(max_keyframes: int) -> None:
    """A keyframe capacity below N_NEIGHBOR_KFS raises: the reference fails
    on it at its first track view (`top_k` larger than the row), and the
    port's stable top-k would quietly take fewer neighbours."""
    if max_keyframes < N_NEIGHBOR_KFS:
        raise ValueError(f"max_keyframes {max_keyframes} < {N_NEIGHBOR_KFS}: a track view takes the "
                         f"{N_NEIGHBOR_KFS} top covisible keyframes")


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
    n_neighbor_kfs: int = N_NEIGHBOR_KFS,
) -> TrackView:
    """Candidates = points observed by the center keyframe's top covisible
    neighbors (plus itself), capped at view_size (lowest ids first)."""
    P = m.pt_capacity
    dev = m.pt_pos.device
    c1 = ms.kf_index(center_kf, dev)
    W_row = ms.covisibility(m).index_select(0, c1)[0]
    w_row = W_row.index_fill(0, c1, 1 << 30)
    _, kf_ids = top_k_stable(w_row, n_neighbor_kfs)  # ties → lowest keyframe id
    obs = m.kf_obs_point[kf_ids]                      # (n_neighbor_kfs, N)
    kf_ok = m.kf_valid[kf_ids] & ((W_row[kf_ids] > 0) | (kf_ids == c1))
    ok = (obs >= 0) & kf_ok[:, None]
    member = ms.mark(P, torch.where(ok, obs, P), dev) & m.pt_valid
    return view_from_members(m, member, view_size)


def view_from_members(m: ms.MapState, member: torch.Tensor, view_size: int) -> TrackView:
    """The view of the `view_size` smallest member point ids."""
    P = m.pt_capacity
    order = torch.where(member, torch.arange(P, dtype=torch.int32, device=member.device), P)
    ids = torch.sort(order).values[:view_size]
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


def empty_view(view_size: int, pt_capacity: int, device=None) -> TrackView:
    return TrackView(
        ids=torch.full((view_size,), pt_capacity, dtype=torch.int32, device=device),
        valid=torch.zeros(view_size, dtype=torch.bool, device=device),
        desc=torch.zeros((view_size, 8), dtype=torch.int32, device=device),
        normal=torch.zeros((view_size, 3), dtype=torch.float32, device=device),
        min_dist=torch.zeros(view_size, dtype=torch.float32, device=device),
        max_dist=torch.full((view_size,), float("inf"), dtype=torch.float32, device=device),
    )
