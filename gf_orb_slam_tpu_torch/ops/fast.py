"""FAST-9/16 corner scores, 3×3 NMS and stratified keypoint selection (port
of gf_orb_slam_tpu/ops/fast.py).

Selection mirrors the reference's top_k calls with a stable descending
sort: JAX's top_k returns the lowest index among equal values, torch.topk
does not, and with the reference's float32 tier bonuses (+1e6 / +1e3) equal
ranks are common.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, OpenCV ordering (dy, dx), index 0 at 12 o'clock.
CIRCLE_OFFSETS = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, lowest index
    first among equal values (JAX top_k order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 score: max over the 32 bright/dark 9-long arcs of the
    minimum margin within the arc; 0 on the 3-pixel border."""
    x = img.to(torch.float32)
    diffs = torch.stack(
        [torch.roll(x, (-int(dy), -int(dx)), dims=(0, 1)) - x for dy, dx in CIRCLE_OFFSETS],
        dim=0,
    )  # (16, H, W)

    def arc_min(m):
        # min over all 9-long cyclic windows, log-depth: 9 = 4 + 4 + 1.
        m2 = torch.minimum(m, torch.roll(m, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        m9 = torch.minimum(m8, torch.roll(m, -8, dims=0))
        return torch.amax(m9, dim=0)

    score = torch.maximum(arc_min(diffs), arc_min(-diffs))
    h, w = x.shape
    yy = torch.arange(h, device=x.device)[:, None]
    xx = torch.arange(w, device=x.device)[None, :]
    border = (yy < 3) | (yy >= h - 3) | (xx < 3) | (xx >= w - 3)
    return torch.where(border, 0.0, score)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3×3 non-max suppression (max_pool2d pads with -inf)."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh, score, 0.0)


def detect_keypoints(
    img: torch.Tensor,
    n_keep: int,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    grid: int = 8,
    cell_cap: int = 0,
):
    """Up to n_keep FAST corners with spatial stratification: per-cell top
    `cell_cap` with a two-tier preference (≥ threshold beats ≥ min_threshold),
    then the global top n_keep. Returns (xy (n_keep, 2) [x, y], resp, valid)."""
    if cell_cap <= 0:
        cell_cap = max(4 * n_keep // (grid * grid), 8)

    score = nms3(fast_score(img))
    h, w = score.shape
    ch, cw = -(-h // grid), -(-w // grid)
    sp = F.pad(score, (0, cw * grid - w, 0, ch * grid - h))
    cells = sp.reshape(grid, ch, grid, cw).permute(0, 2, 1, 3).reshape(grid * grid, ch * cw)

    strong = cells >= threshold
    weak = cells >= min_threshold
    rank = torch.where(strong, cells + 1e6, torch.where(weak, cells + 1e3, -1.0))
    top_vals, top_idx = top_k_stable(rank, cell_cap)

    cell_ids = torch.arange(grid * grid, device=img.device)[:, None]
    gy, gx = cell_ids // grid, cell_ids % grid
    ly, lx = top_idx // cw, top_idx % cw
    ys, xs = gy * ch + ly, gx * cw + lx

    best, pick = top_k_stable(top_vals.reshape(-1), n_keep)
    valid = best > 0.0
    resp = torch.where(best >= 1e6, best - 1e6, torch.where(best >= 1e3, best - 1e3, 0.0))
    xy = torch.stack(
        [xs.reshape(-1)[pick].to(torch.float32), ys.reshape(-1)[pick].to(torch.float32)], dim=-1
    )
    return xy, resp, valid
