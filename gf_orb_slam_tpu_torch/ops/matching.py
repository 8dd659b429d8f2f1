"""Batched Hamming-distance data association (port of
gf_orb_slam_tpu/ops/matching.py): one dense masked (Nq, Nt) distance matrix
per search, candidate gates as boolean masks.

Descriptors are (·, 8) int32 bit views. `hamming_matrix` launches the CUDA
kernel (kernels/hamming.py) for CUDA tensors and uses the plain version,
`hamming_matrix_torch`, for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.kernels import hamming as hamming_kernel

TH_LOW = 50
TH_HIGH = 100
BIG = 10_000


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words by SWAR. The sign bit is counted
    apart so every intermediate stays non-negative; int32 `>>` is arithmetic,
    so each shift is masked."""
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = (v + (v >> 16)) & 0x3F
    return v + (x < 0).to(torch.int32)


def hamming_matrix_torch(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """Plain version: (Nq, 8) × (Nt, 8) int32 → (Nq, Nt) int32 distances,
    XOR + SWAR popcount one word at a time, summed over the 8 words."""
    out = torch.zeros((desc_q.shape[0], desc_t.shape[0]), dtype=torch.int32, device=desc_q.device)
    for w in range(desc_q.shape[1]):
        out += _popcount32(torch.bitwise_xor(desc_q[:, w, None], desc_t[None, :, w]))
    return out


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """(Nq, 8) × (Nt, 8) int32 → (Nq, Nt) int32 Hamming distances: the
    hand-written kernel on CUDA tensors, the plain version on CPU tensors."""
    if desc_q.is_cuda:
        return hamming_kernel.hamming_matrix_cuda(desc_q, desc_t)
    return hamming_matrix_torch(desc_q, desc_t)


class MatchResult(NamedTuple):
    idx: torch.Tensor      # (Nq,) int32 — best target index (valid only where matched)
    dist: torch.Tensor     # (Nq,) int32 — best distance
    matched: torch.Tensor  # (Nq,) bool


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best index, best and second-best distance over a masked matrix
    (masked-out entries = BIG; ties go to the lowest index)."""
    d = torch.where(mask, dist, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols[None, :] == best_idx[:, None], BIG, d).amin(dim=1)
    return best_idx.to(torch.int32), best, second


def mutual_filter(dist: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, matched: torch.Tensor):
    """Cross-check: query q's best target t must have q as its best query."""
    d = torch.where(mask, dist, BIG)
    best_q_for_t = torch.argmin(d, dim=0)  # (Nt,)
    rows = torch.arange(dist.shape[0], device=dist.device)
    return matched & (best_q_for_t[idx.long()] == rows)


def match(
    desc_q: torch.Tensor,
    desc_t: torch.Tensor,
    mask: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    mutual: bool = False,
) -> MatchResult:
    """The one matching kernel: `mask[q, t]` gates candidate pairs. The
    reference's orientation-consistency option is not on the tracking path
    and is not ported."""
    dist = hamming_matrix(desc_q, desc_t)
    idx, best, second = masked_best2(dist, mask)
    matched = best <= max_dist
    if ratio < 1.0:
        matched = matched & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    if mutual:
        matched = mutual_filter(dist, mask, idx, matched)
    return MatchResult(idx=idx, dist=best, matched=matched)


def window_mask(
    uv_q: torch.Tensor,
    uv_t: torch.Tensor,
    radius,
    valid_q: torch.Tensor,
    valid_t: torch.Tensor,
) -> torch.Tensor:
    """|Δu|, |Δv| ≤ radius box gate; radius per query (Nq,) or scalar."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=uv_q.device)
    r = r[:, None] if r.ndim == 1 else r
    du = torch.abs(uv_q[:, None, 0] - uv_t[None, :, 0])
    dv = torch.abs(uv_q[:, None, 1] - uv_t[None, :, 1])
    return (du <= r) & (dv <= r) & valid_q[:, None] & valid_t[None, :]


def octave_mask(octave_q_lo: torch.Tensor, octave_q_hi: torch.Tensor, octave_t: torch.Tensor) -> torch.Tensor:
    """Target keypoint octave within [lo, hi] of the query's predicted octave."""
    return (octave_t[None, :] >= octave_q_lo[:, None]) & (octave_t[None, :] <= octave_q_hi[:, None])


def projection_mask(
    uv_proj: torch.Tensor,
    valid_proj: torch.Tensor,
    kp_uv: torch.Tensor,
    kp_octave: torch.Tensor,
    kp_valid: torch.Tensor,
    radius_per_q: torch.Tensor,
    pred_octave: torch.Tensor,
    octave_window: tuple[int, int] = (-1, 1),
) -> torch.Tensor:
    """Map-point → frame projection gate: octave-scaled radius, target octave
    within the window around the predicted one."""
    base = window_mask(uv_proj, kp_uv, radius_per_q, valid_proj, kp_valid)
    lo = pred_octave + octave_window[0]
    hi = pred_octave + octave_window[1]
    return base & octave_mask(lo, hi, kp_octave)
