"""Image pyramid + Gaussian smoothing (port of gf_orb_slam_tpu/ops/pyramid.py).

The resize matrices are numpy constants built on the host exactly as the
reference builds them (copied here, since the port cannot import the JAX
package; tests/test_torch_extract.py holds each copy equal to the
reference's). The pyramid is two batched einsums against the composed
per-level matrices, as in the reference's build_pyramid_stack.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Per-level (H, W) list."""
    shapes = []
    for lv in range(n_levels):
        inv = 1.0 / (scale**lv)
        shapes.append((max(int(round(height * inv)), 16), max(int(round(width * inv)), 16)))
    return shapes


def _resize_matrix(n_out: int, n_in: int, antialias: bool = True) -> np.ndarray:
    """(n_out, n_in) linear-interpolation matrix with triangle antialiasing."""
    scale = n_in / n_out
    support = max(scale, 1.0) if antialias else 1.0
    A = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        center = (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        idx = np.clip(np.arange(lo, hi + 1), 0, n_in - 1)
        w = np.maximum(0.0, 1.0 - np.abs(np.arange(lo, hi + 1) - center) / support)
        if w.sum() > 0:
            np.add.at(A[o], idx, w / w.sum())
    return A


@lru_cache(maxsize=None)
def _resize_mats(h_out: int, w_out: int, h_in: int, w_in: int):
    return _resize_matrix(h_out, h_in), _resize_matrix(w_out, w_in)


def resize_matmul(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear + antialias resize as two matmuls: A_h @ img @ A_wᵀ."""
    Ah, Aw = _resize_mats(shape[0], shape[1], img.shape[0], img.shape[1])
    Ah, Aw = (torch.from_numpy(a).to(img.device) for a in (Ah, Aw))
    return (Ah @ img) @ Aw.T


@lru_cache(maxsize=None)
def _chain_resize_mats(h0: int, w0: int, n_levels: int, scale: float):
    """(L, h0, h0) and (L, w0, w0) composed-chain resize matrices (float64
    composition on the host, float32 result); rows/cols beyond a level's
    extent are zero."""
    shapes = pyramid_shapes(h0, w0, n_levels, scale)
    Rrow = np.zeros((n_levels, h0, h0), np.float64)
    Rcol = np.zeros((n_levels, w0, w0), np.float64)
    cur_r = np.eye(h0)
    cur_c = np.eye(w0)
    for lv, (hl, wl) in enumerate(shapes):
        if lv > 0:
            Ah, Aw = _resize_mats(hl, wl, shapes[lv - 1][0], shapes[lv - 1][1])
            cur_r = Ah.astype(np.float64) @ cur_r
            cur_c = Aw.astype(np.float64) @ cur_c
        Rrow[lv, :hl, :] = cur_r
        Rcol[lv, :wl, :] = cur_c
    return Rrow.astype(np.float32), Rcol.astype(np.float32)


@lru_cache(maxsize=None)
def _chain_resize_tensors(h0: int, w0: int, n_levels: int, scale: float, device: torch.device):
    # Device copies cached per device: 25 MB of matrices at 752×480 must not
    # cross the host link every frame.
    Rr, Rc = _chain_resize_mats(h0, w0, n_levels, scale)
    return torch.from_numpy(Rr).to(device), torch.from_numpy(Rc).to(device)


def build_pyramid_stack(img: torch.Tensor, n_levels: int, scale: float) -> torch.Tensor:
    """All levels as one (L, H0, W0) tensor (level l in the top-left (h_l, w_l)
    corner, zeros elsewhere) via two batched matmuls. Level 0's matrices are
    identities, so level 0 is the input bit for bit."""
    Rr, Rc = _chain_resize_tensors(img.shape[0], img.shape[1], n_levels, scale, img.device)
    t = torch.einsum("lij,jw->liw", Rr, img.to(torch.float32))
    return torch.einsum("liw,lmw->lim", t, Rc)


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """Grayscale f32 [H, W] → n_levels images, level l scaled by scale^-l."""
    shapes = pyramid_shapes(img.shape[0], img.shape[1], n_levels, scale)
    stack = build_pyramid_stack(img, n_levels, scale)
    return [stack[lv, :h, :w] for lv, (h, w) in enumerate(shapes)]


def _gaussian_kernel_1d(sigma: float, ksize: int) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def _gaussian_taps(sigma: float, ksize: int, device: torch.device) -> torch.Tensor:
    # Cached per device: a host→device copy synchronises the stream.
    return torch.from_numpy(_gaussian_kernel_1d(sigma, ksize)).to(device)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, ksize: int = 7) -> torch.Tensor:
    """Separable Gaussian with reflect padding, summed tap by tap in the
    reference's order."""
    k = _gaussian_taps(sigma, ksize, img.device)
    r = ksize // 2
    x = img.to(torch.float32)
    h_out, w_out = x.shape
    xp = F.pad(x[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    h = sum(xp[:, i : i + w_out] * k[i] for i in range(ksize))
    hp = F.pad(h[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    return sum(hp[i : i + h_out, :] * k[i] for i in range(ksize))


def scale_factors(n_levels: int, scale: float) -> np.ndarray:
    """Per-level scale factors [scale^l]."""
    return np.asarray([scale**lv for lv in range(n_levels)], dtype=np.float32)


def level_sigma2(n_levels: int, scale: float) -> np.ndarray:
    """Per-level measurement noise variance scale^(2l) (ref mvLevelSigma2)."""
    return scale_factors(n_levels, scale) ** 2


def features_per_level(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Geometric per-level feature quota."""
    factor = 1.0 / scale
    n_first = n_features * (1.0 - factor) / (1.0 - factor**n_levels)
    quotas = []
    acc = 0
    for lv in range(n_levels - 1):
        q = int(round(n_first * factor**lv))
        quotas.append(q)
        acc += q
    quotas.append(max(n_features - acc, 0))
    return quotas


class LevelConsts(NamedTuple):
    """Per-level tables of the scale pyramid, on one device."""

    sigma2: torch.Tensor  # (L,) scale^(2l)
    sf: torch.Tensor      # (L,) scale^l
    log_s: torch.Tensor   # () log(scale) in float32


@lru_cache(maxsize=None)
def level_consts(scale: float, n_levels: int, device: torch.device) -> LevelConsts:
    # Cached per device: a host→device copy synchronises the stream, so the
    # step must not make one per frame.
    f32 = dict(dtype=torch.float32, device=device)
    return LevelConsts(
        sigma2=torch.tensor([scale ** (2 * i) for i in range(n_levels)], **f32),
        sf=torch.tensor([scale**i for i in range(n_levels)], **f32),
        log_s=torch.log(torch.tensor(scale, **f32)),
    )


def predict_octave(dist, max_dist, scale: float, n_levels: int):
    """Pyramid level predicted from the distance ratio (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    log_s = level_consts(scale, n_levels, dist.device).log_s
    return torch.clamp(torch.ceil(torch.log(ratio) / log_s).to(torch.int32), 0, n_levels - 1)
