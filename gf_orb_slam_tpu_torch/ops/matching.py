"""Batched Hamming-distance data association (port of
gf_orb_slam_tpu/ops/matching.py): one dense masked (Nq, Nt) distance matrix
per search, candidate gates as boolean masks.

Descriptors are (·, 8) int32 bit views. `hamming_matrix` launches the CUDA
kernel (kernels/hamming.py) for CUDA tensors and uses the plain version,
`hamming_matrix_torch`, for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from gf_orb_slam_tpu_torch.kernels import hamming as hamming_kernel
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
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


def orientation_consistency(
    angle_q: torch.Tensor, angle_t: torch.Tensor, matched: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Keep only matches whose rotation Δθ falls in the 3 dominant histogram
    bins, each at least 10% of the largest (ORBmatcher's rotHist rule). Bin
    ties rank lowest bin first, as JAX's top_k does."""
    # jnp.mod's float formula (fmod, then shift negatives up), not
    # torch.remainder's floor division, which can differ by an ulp.
    dtheta = torch.fmod(angle_q - angle_t[idx.long()], 2.0 * math.pi)
    dtheta = torch.where(dtheta < 0, dtheta + 2.0 * math.pi, dtheta)
    bins = torch.clamp(
        torch.remainder(torch.round(dtheta * (HISTO_BINS / (2.0 * math.pi))).to(torch.int32), HISTO_BINS),
        0, HISTO_BINS - 1,
    ).long()
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=bins.device)
    hist = hist.scatter_add(0, bins, matched.to(torch.int32))
    top3, top3_idx = top_k_stable(hist, 3)
    floor = torch.clamp((0.1 * top3[0]).to(torch.int32), min=1)
    keep = top3 >= floor
    bin_ok = torch.zeros(HISTO_BINS, dtype=torch.bool, device=bins.device).scatter(0, top3_idx, keep)
    return matched & bin_ok[bins]


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
    angle_q: torch.Tensor | None = None,
    angle_t: torch.Tensor | None = None,
    mutual: bool = False,
) -> MatchResult:
    """The one matching kernel: `mask[q, t]` gates candidate pairs; with
    both angle arrays given, the rotation-histogram consistency check runs
    after the ratio and mutual tests."""
    dist = hamming_matrix(desc_q, desc_t)
    idx, best, second = masked_best2(dist, mask)
    matched = best <= max_dist
    if ratio < 1.0:
        matched = matched & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    if mutual:
        matched = mutual_filter(dist, mask, idx, matched)
    if angle_q is not None and angle_t is not None:
        matched = orientation_consistency(angle_q, angle_t, matched, idx)
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


def epipolar_mask(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    F12: torch.Tensor,
    sigma2_t: torch.Tensor,
    valid_q: torch.Tensor,
    valid_t: torch.Tensor,
    thresh_chi2: float = 3.84,
) -> torch.Tensor:
    """Epipolar-line distance gate of the triangulation search: target t
    within chi² · σ²_t of query q's epipolar line x1ᵀ F12ᵀ."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)  # (Nq, 3)
    lines = x1 @ F12.T  # (Nq, 3): epipolar lines in image 2
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    d = a * uv2[None, :, 0] + b * uv2[None, :, 1] + c  # (Nq, Nt)
    dsq = (d * d) / torch.clamp(a * a + b * b, min=1e-12)
    return (dsq < thresh_chi2 * sigma2_t[None, :]) & valid_q[:, None] & valid_t[None, :]
