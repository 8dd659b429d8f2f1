"""Box-filtered Laplacian-of-Gaussian (BoxLOG) blob detector (port of
gf_orb_slam_tpu/ops/boxlog.py; ref include/BoxLOG.hpp, an experimental
alternative to FAST).

Each scale's LoG is approximated by a box mean of radius 2r less one of
radius r, all scales as one convolution; non-maximum suppression runs over
space and scale with one max pool. The output has fast.detect_keypoints'
contract, (xy, response, valid). A standalone op: nothing in the extractor
selects it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from gf_orb_slam_tpu_torch.ops.fast import top_k_stable

RADII = (2, 3, 4, 6, 8)


def _box_kernel(r: int, size: int) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    c = size // 2
    k[c - r : c + r + 1, c - r : c + r + 1] = 1.0 / ((2 * r + 1) ** 2)
    return k


@lru_cache(maxsize=None)
def _kernels(radii: tuple, device: torch.device) -> torch.Tensor:
    # Cached per device: a host→device copy synchronises the stream.
    size = 4 * max(radii) + 1
    K = np.stack([_box_kernel(2 * r, size) - _box_kernel(r, size) for r in radii])
    return torch.from_numpy(K)[:, None].to(device)  # (S, 1, k, k)


def boxlog_response(img: torch.Tensor, radii: tuple = RADII) -> torch.Tensor:
    """(H, W) → (S, H, W) |surround box mean − centre box mean| per scale
    (zero padding outside the image)."""
    x = img.to(torch.float32)[None, None]
    return torch.abs(F.conv2d(x, _kernels(tuple(radii), img.device), padding="same")[0])


def detect_blobs(img: torch.Tensor, n_keep: int, threshold: float = 4.0, radii: tuple = RADII):
    """Multi-scale blob detection with space + scale NMS: (xy (n, 2),
    response (n,), valid (n,)), the n_keep strongest interior peaks."""
    resp = boxlog_response(img, radii)  # (S, H, W)
    S = len(radii)
    lo = (S - 1) // 2
    # reduce_window's SAME padding with −inf, then a max over (S, 3, 3).
    padded = F.pad(resp[None, None], (1, 1, 1, 1, lo, S - 1 - lo), value=-torch.inf)
    neigh = F.max_pool3d(padded, (S, 3, 3), stride=1)[0, 0]
    peaks = torch.where((resp >= neigh) & (resp > threshold), resp, 0.0)
    best_scale = peaks.amax(dim=0)  # (H, W)

    # Mask the border, where the zero padding corrupts the surround box.
    h, w = img.shape
    b = 2 * max(radii)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    best_scale = torch.where(interior, best_scale, 0.0)

    vals, idx = top_k_stable(best_scale.reshape(-1), n_keep)
    xy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
    return xy, vals, vals > 0.0
