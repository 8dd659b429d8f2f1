"""The SLAM map as struct-of-arrays tensors (port of
gf_orb_slam_tpu/mapping/map_state.py): the container, its derived structure
(incidence, covisibility, observation counts) and the functional write side
(adding keyframes and points, erasing, compaction, the point-statistics
refresh). Every update returns a new MapState and leaves its input intact.

`kf_obs_point[k, i]` is the map-point id observed by keypoint slot i of
keyframe k (NO_POINT = none). Descriptor fields hold int32 bit views of the
reference's uint32 words.

Keyframe ids that index on the device are (1,) int64 tensors (`kf_index`):
indexing with a 0-d tensor reads its value on the host, a synchronisation.
The reference's `mode="drop"` scatters (index = capacity) write into one
extra row that is cut off afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gf_orb_slam_tpu_torch.geometry import se3
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable

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
    n_kf: torch.Tensor          # () int32 — next keyframe slot
    n_pt: torch.Tensor          # () int32 — high-water mark of point slots

    @property
    def kf_capacity(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def kp_capacity(self) -> int:
        return self.kf_kp_uv.shape[1]


def empty_map(
    max_keyframes: int = 256, max_points: int = 16384, max_kps: int = 1024,
    device=None, dtype=torch.float32,
) -> MapState:
    K, P, N = max_keyframes, max_points, max_kps
    f = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    pose = torch.zeros((K, 7), **f)
    pose[:, 0] = 1.0
    return MapState(
        kf_pose=pose,
        kf_valid=torch.zeros(K, **b),
        kf_frame_id=torch.full((K,), -1, **i32),
        kf_timestamp=torch.zeros(K, **f),
        kf_kp_uv=torch.zeros((K, N, 2), **f),
        kf_kp_octave=torch.zeros((K, N), **i32),
        kf_kp_angle=torch.zeros((K, N), **f),
        kf_kp_desc=torch.zeros((K, N, 8), **i32),
        kf_kp_valid=torch.zeros((K, N), **b),
        kf_obs_point=torch.full((K, N), NO_POINT, **i32),
        pt_pos=torch.zeros((P, 3), **f),
        pt_valid=torch.zeros(P, **b),
        pt_desc=torch.zeros((P, 8), **i32),
        pt_normal=torch.zeros((P, 3), **f),
        pt_min_dist=torch.zeros(P, **f),
        pt_max_dist=torch.full((P,), float("inf"), **f),
        pt_visible=torch.ones(P, **i32),
        pt_found=torch.ones(P, **i32),
        pt_first_kf=torch.full((P,), -1, **i32),
        pt_first_frame=torch.full((P,), -1, **i32),
        n_kf=torch.zeros((), **i32),
        n_pt=torch.zeros((), **i32),
    )


# ---------------------------------------------------------------------------
# Index and scatter helpers
# ---------------------------------------------------------------------------


def kf_index(k, device) -> torch.Tensor:
    """A keyframe id (Python int, 0-d or (1,) tensor) as a (1,) int64 tensor
    on `device`, built without a host→device copy."""
    if isinstance(k, torch.Tensor):
        return k.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(k), dtype=torch.int64, device=device)


def filled(v, n: int, dtype, device) -> torch.Tensor:
    """(n,) tensor of `v` (Python scalar or 0-d/(1,) tensor), no host copy."""
    if isinstance(v, torch.Tensor):
        return v.reshape(-1).to(device=device, dtype=dtype).expand(n)
    return torch.full((n,), v, dtype=dtype, device=device)


def set_drop(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """`arr.at[idx].set(vals, mode="drop")` for idx in [0, len(arr)], where
    len(arr) is the dropped index. Returns a new tensor. Indices other than
    the dropped one must be unique, or hold equal values."""
    n = arr.shape[0]
    buf = torch.cat([arr, arr[:1]]) if n else arr.new_empty((1,) + arr.shape[1:])
    buf[idx.reshape(-1).long()] = vals.reshape((-1,) + arr.shape[1:]).to(arr.dtype)
    return buf[:n]


def mark(n: int, idx: torch.Tensor, device) -> torch.Tensor:
    """(n,) bool, True at every idx < n (index n = dropped)."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=device)
    # index_fill_ takes the scalar as a kernel argument; `out[idx] = True`
    # copies it to the device first, which synchronises the stream.
    return out.index_fill_(0, idx.reshape(-1).long(), True)[:n]


def last_wins(idx: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the writes that win a scatter of flat `idx` (< n) under
    `valid` when later writes overwrite earlier ones, as XLA applies a
    scatter's updates in order on the CPU. CUDA gives duplicate indices no
    order, so callers write only the winners. Same shape as idx."""
    shape = idx.shape
    idx = idx.reshape(-1).long()
    valid = valid.reshape(-1)
    pos = torch.arange(idx.shape[0], device=idx.device)
    safe = torch.where(valid, idx, n)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, safe, torch.where(valid, pos, -1), "amax")
    return (valid & (last[safe] == pos)).reshape(shape)


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------


def incidence(m: MapState) -> torch.Tensor:
    """(K, P) bool — keyframe k observes point p."""
    K, P = m.kf_capacity, m.pt_capacity
    obs = m.kf_obs_point
    ok = (obs >= 0) & m.kf_valid[:, None]
    k_idx = torch.arange(K, device=obs.device)[:, None]
    flat = torch.where(ok, k_idx * P + obs, K * P)  # K·P = dropped
    return mark(K * P, flat, obs.device).reshape(K, P) & m.pt_valid[None, :]


def covisibility(m: MapState, A: torch.Tensor | None = None) -> torch.Tensor:
    """(K, K) int32 shared-point counts (one incidence matmul; float32 counts
    are exact below 2^24)."""
    if A is None:
        A = incidence(m)
    Af = A.to(torch.float32)
    W = (Af @ Af.T).to(torch.int32)
    W = W * (1 - torch.eye(m.kf_capacity, dtype=torch.int32, device=W.device))
    return torch.where(m.kf_valid[:, None] & m.kf_valid[None, :], W, 0)


def covisibility_row(m: MapState, kf_id) -> torch.Tensor:
    """(K,) int32 — shared-point counts between kf_id and every keyframe,
    without the full incidence: mark kf_id's points, then count marked hits
    along each keyframe's observation row."""
    P = m.pt_capacity
    dev = m.kf_obs_point.device
    k1 = kf_index(kf_id, dev)
    obs_new = m.kf_obs_point.index_select(0, k1)[0]
    marked = mark(P, torch.where(obs_new >= 0, obs_new, P), dev) & m.pt_valid
    marked = torch.cat([marked, marked.new_zeros(1)])  # index P reads False
    obs = m.kf_obs_point
    hit = marked[torch.where(obs >= 0, obs, P).long()]  # (K, N)
    w = hit.sum(dim=1, dtype=torch.int32)
    w = torch.where(m.kf_valid & m.kf_valid.index_select(0, k1), w, 0)
    return w.index_fill(0, k1, 0)


def spanning_tree_parent(m: MapState, W: torch.Tensor | None = None) -> torch.Tensor:
    """(K,) int32 parent = the earlier keyframe of highest covisibility (the
    first of equal ones); −1 for roots and invalid keyframes."""
    if W is None:
        W = covisibility(m)
    K = m.kf_capacity
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool, device=W.device), diagonal=-1)
    W_earlier = torch.where(earlier, W, -1)
    parent = torch.argmax(W_earlier, dim=1).to(torch.int32)
    has = W_earlier.amax(dim=1) > 0
    return torch.where(m.kf_valid & has, parent, -1)


def point_observation_count_raw(m: MapState) -> torch.Tensor:
    """(P,) int32 observation counts without the pt_valid mask (fused
    programs run the scatter once and re-mask it per stage)."""
    P = m.pt_capacity
    obs = m.kf_obs_point
    ok = (obs >= 0) & m.kf_valid[:, None]
    idx = torch.where(ok, obs, P).reshape(-1).long()
    cnt = torch.zeros(P + 1, dtype=torch.int32, device=obs.device)
    return cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))[:P]


def point_observation_count(m: MapState) -> torch.Tensor:
    """(P,) int32 — number of keyframes observing each valid point."""
    return point_observation_count_raw(m) * m.pt_valid.to(torch.int32)


# ---------------------------------------------------------------------------
# Allocation and functional updates
# ---------------------------------------------------------------------------


def free_point_slots(m: MapState, n: int) -> torch.Tensor:
    """(n,) int32 indices of invalid point slots, lowest index first; valid
    slots follow once the free ones run out (callers size capacity so they
    do not)."""
    P = m.pt_capacity
    dev = m.pt_pos.device
    free = ~m.pt_valid
    score = torch.where(free, 1.0, 0.0) - torch.arange(P, device=dev, dtype=torch.float32) * 1e-9
    return top_k_stable(score, n)[1].to(torch.int32)


def add_keyframe(
    m: MapState,
    pose: torch.Tensor,
    frame_id,
    timestamp,
    kp_uv: torch.Tensor,
    kp_octave: torch.Tensor,
    kp_angle: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_valid: torch.Tensor,
    obs_point: torch.Tensor,
) -> tuple[MapState, torch.Tensor]:
    """Insert a keyframe at the next slot; returns (new state, kf_id as a
    0-d int32 tensor)."""
    dev = m.kf_pose.device
    k = m.n_kf
    k1 = kf_index(k, dev)

    def put(arr, val):
        return arr.index_copy(0, k1, val.to(arr.dtype)[None])

    return (
        m._replace(
            kf_pose=put(m.kf_pose, pose),
            kf_valid=m.kf_valid.index_fill(0, k1, True),
            kf_frame_id=m.kf_frame_id.index_copy(0, k1, filled(frame_id, 1, torch.int32, dev)),
            kf_timestamp=m.kf_timestamp.index_copy(0, k1, filled(timestamp, 1, m.kf_timestamp.dtype, dev)),
            kf_kp_uv=put(m.kf_kp_uv, kp_uv),
            kf_kp_octave=put(m.kf_kp_octave, kp_octave),
            kf_kp_angle=put(m.kf_kp_angle, kp_angle),
            kf_kp_desc=put(m.kf_kp_desc, kp_desc),
            kf_kp_valid=put(m.kf_kp_valid, kp_valid),
            kf_obs_point=put(m.kf_obs_point, obs_point),
            n_kf=m.n_kf + 1,
        ),
        k,
    )


def add_points(
    m: MapState,
    slots: torch.Tensor,      # (M,) int32 target slots (from free_point_slots)
    pos: torch.Tensor,        # (M, 3)
    desc: torch.Tensor,       # (M, 8) int32
    normal: torch.Tensor,     # (M, 3)
    min_dist: torch.Tensor,   # (M,)
    max_dist: torch.Tensor,   # (M,)
    first_kf,                 # scalar, () or (M,)
    first_frame,
    use: torch.Tensor,        # (M,) bool — only these slots are written
) -> MapState:
    """Batch-insert map points at explicit slots under a mask."""
    P = m.pt_capacity
    dev = m.pt_pos.device
    M = use.shape[0]
    safe = torch.where(use, slots, P)

    def wr(arr, vals):
        return set_drop(arr, safe, vals)

    def per_point(v):
        if isinstance(v, torch.Tensor) and v.numel() == M and M != 1:
            return v.to(torch.int32)
        return filled(v, M, torch.int32, dev)

    ones = torch.ones(M, dtype=torch.int32, device=dev)
    return m._replace(
        pt_pos=wr(m.pt_pos, pos),
        pt_valid=wr(m.pt_valid, torch.ones_like(use)),
        pt_desc=wr(m.pt_desc, desc),
        pt_normal=wr(m.pt_normal, normal),
        pt_min_dist=wr(m.pt_min_dist, min_dist),
        pt_max_dist=wr(m.pt_max_dist, max_dist),
        pt_visible=wr(m.pt_visible, ones),
        pt_found=wr(m.pt_found, ones),
        pt_first_kf=wr(m.pt_first_kf, per_point(first_kf)),
        pt_first_frame=wr(m.pt_first_frame, per_point(first_frame)),
        n_pt=torch.maximum(m.n_pt, torch.where(use, slots + 1, 0).amax().to(torch.int32)),
    )


def erase_points(m: MapState, kill: torch.Tensor) -> MapState:
    """Tombstone points (kill: (P,) bool) and clear their observations."""
    obs = m.kf_obs_point
    obs_kill = (obs >= 0) & kill[torch.clamp(obs, min=0).long()]
    return m._replace(
        pt_valid=m.pt_valid & ~kill,
        kf_obs_point=torch.where(obs_kill, NO_POINT, obs),
    )


def erase_keyframe(m: MapState, k) -> MapState:
    """Tombstone keyframe k: its observations vanish from the incidence;
    points keep living through other keyframes."""
    k1 = kf_index(k, m.kf_valid.device)
    return m._replace(
        kf_valid=m.kf_valid.index_fill(0, k1, False),
        kf_obs_point=m.kf_obs_point.index_fill(0, k1, NO_POINT),
    )


def compact_keyframes(m: MapState):
    """Renumber live keyframes to the front (temporal order kept), freeing
    tombstoned slots. Returns (m', perm, n_valid): perm (K,) gathers old rows
    into the new order."""
    K = m.kf_capacity
    dev = m.kf_pose.device
    ar = torch.arange(K, dtype=torch.int32, device=dev)
    order = torch.where(m.kf_valid, ar, K + ar)
    perm = torch.argsort(order, stable=True)              # old ids, new order
    inv = torch.zeros(K, dtype=torch.int32, device=dev).scatter(0, perm, ar)  # old id → new id
    n_valid = m.kf_valid.sum(dtype=torch.int32)

    first_old = torch.clamp(m.pt_first_kf, 0, K - 1).long()
    # Points whose creator was culled keep a mature (early) reference.
    first_new = torch.where(m.pt_valid & m.kf_valid[first_old], inv[first_old], 0)
    m2 = m._replace(
        kf_pose=m.kf_pose[perm],
        kf_valid=m.kf_valid[perm],
        kf_frame_id=m.kf_frame_id[perm],
        kf_timestamp=m.kf_timestamp[perm],
        kf_kp_uv=m.kf_kp_uv[perm],
        kf_kp_octave=m.kf_kp_octave[perm],
        kf_kp_angle=m.kf_kp_angle[perm],
        kf_kp_desc=m.kf_kp_desc[perm],
        kf_kp_valid=m.kf_kp_valid[perm],
        kf_obs_point=m.kf_obs_point[perm],
        pt_first_kf=torch.where(m.pt_valid, first_new, m.pt_first_kf),
        n_kf=n_valid,
    )
    return m2, perm.to(torch.int32), n_valid


def replace_point(m: MapState, old_id, new_id) -> MapState:
    """MapPoint::Replace: every observation of old_id is rewired to new_id,
    which takes over its counters; old_id dies."""
    dev = m.pt_pos.device
    o1, n1 = kf_index(old_id, dev), kf_index(new_id, dev)
    obs = m.kf_obs_point
    return m._replace(
        kf_obs_point=torch.where(obs == o1.to(obs.dtype), n1.to(obs.dtype), obs),
        pt_valid=m.pt_valid.index_fill(0, o1, False),
        pt_found=m.pt_found.index_add(0, n1, m.pt_found.index_select(0, o1)),
        pt_visible=m.pt_visible.index_add(0, n1, m.pt_visible.index_select(0, o1)),
    )


def refresh_point_stats(
    m: MapState, scale: float = 1.2, n_levels: int = 8, update_desc: bool = True,
) -> MapState:
    """Recompute normals and scale-invariance ranges (and, with update_desc,
    descriptors from the first observing keyframe) of every observed point
    from the observation table, in one batched pass."""
    A = incidence(m)  # (K, P)
    Af = A.to(torch.float32)
    n_obs = Af.sum(dim=0)  # (P,)
    has_obs = n_obs > 0
    P = m.pt_capacity
    dev = m.pt_pos.device

    centers = se3.pose_t(se3.inverse(m.kf_pose))          # (K, 3) camera centers
    diff = m.pt_pos[None, :, :] - centers[:, None, :]     # (K, P, 3)
    dist = torch.linalg.vector_norm(diff, dim=-1)          # (K, P)
    unit = diff / torch.clamp(dist[..., None], min=1e-9)
    normals = torch.einsum("kp,kpd->pd", Af, unit) / torch.clamp(n_obs[:, None], min=1.0)

    # Each point's first (keyframe, slot) observation: one scatter-min of the
    # packed code k·N + i (exact on int32 on every device).
    K, N = m.kf_obs_point.shape
    BIG = K * N
    code = torch.arange(K * N, dtype=torch.int32, device=dev).reshape(K, N)
    obs_ok = (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    min_code = torch.full((P + 1,), BIG, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.where(obs_ok, m.kf_obs_point, P).reshape(-1).long(),
        torch.where(obs_ok, code, BIG).reshape(-1), "amin",
    )[:P]
    min_code = torch.clamp(min_code, max=BIG - 1)
    first_kf = torch.div(min_code, N, rounding_mode="floor").long()
    obs_slot = torch.remainder(min_code, N).long()
    ref_dist = dist[first_kf, torch.arange(P, device=dev)]
    ref_oct = m.kf_kp_octave[first_kf, obs_slot]
    level_factor = torch.pow(torch.full_like(ref_dist, scale), ref_oct.to(torch.float32))
    max_dist = ref_dist * level_factor
    min_dist = max_dist / (scale ** (n_levels - 1))

    m = m._replace(
        pt_normal=torch.where(has_obs[:, None], normals, m.pt_normal),
        pt_min_dist=torch.where(has_obs, min_dist, m.pt_min_dist),
        pt_max_dist=torch.where(has_obs, max_dist, m.pt_max_dist),
    )
    if update_desc:
        desc_ref = m.kf_kp_desc[first_kf, obs_slot]
        m = m._replace(pt_desc=torch.where(has_obs[:, None], desc_ref, m.pt_desc))
    return m


def to_numpy(m: MapState) -> dict[str, np.ndarray]:
    """Field name → numpy array in the reference's dtypes (descriptors back
    to uint32), the inverse of io_utils.snapshot.map_state_from_numpy."""
    out = {}
    for k, v in m._asdict().items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in DESC_FIELDS else a
    return out
