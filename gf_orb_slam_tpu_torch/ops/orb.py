"""ORB orientation + rBRIEF-256 descriptors and the full extractor (port of
gf_orb_slam_tpu/ops/orb.py): the production path (row-integral IC angles and
the flat (N, 512) descriptor gather), the single-level helpers, and the
patch-matmul path of `OrbConfig.patch_desc`.

The sampling pattern is built on the host with the reference's own recipe,
copied here (tests hold the copy equal). Descriptors are packed in int64 and
wrapped explicitly to the int32 bit view of the reference's uint32 words.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from gf_orb_slam_tpu_torch.ops import fast as fast_ops
from gf_orb_slam_tpu_torch.ops import pyramid as pyr

HALF_PATCH = 15
EDGE_MARGIN = 19  # ref EDGE_THRESHOLD
N_ROT_BINS = 30
N_BITS = 256
N_WORDS = 8  # 256 bits as 8 words
_INT_SCALE = 8  # fixed-point scale for integral-image moments


def make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) int32 — 256 point pairs (p, q) in patch coords, both points
    ~ N(0, (31/5)²) rounded and clipped to ±13, deduplicated."""
    rng = np.random.default_rng(seed)
    sigma = (2 * HALF_PATCH + 1) / 5.0
    pairs = []
    seen = set()
    while len(pairs) < N_BITS:
        p = np.clip(np.round(rng.normal(0, sigma, 2)), -13, 13).astype(np.int32)
        q = np.clip(np.round(rng.normal(0, sigma, 2)), -13, 13).astype(np.int32)
        key = (p[0], p[1], q[0], q[1])
        if (p == q).all() or key in seen:
            continue
        seen.add(key)
        pairs.append((p, q))
    return np.asarray(pairs, dtype=np.int32)


def rotated_patterns(pattern: np.ndarray) -> np.ndarray:
    """(30, 256, 2, 2) int32 — the pattern pre-rotated at 12° steps."""
    out = np.zeros((N_ROT_BINS, N_BITS, 2, 2), dtype=np.int32)
    for b in range(N_ROT_BINS):
        th = 2.0 * np.pi * b / N_ROT_BINS
        c, s = np.cos(th), np.sin(th)
        x, y = pattern[..., 0], pattern[..., 1]
        out[b, ..., 0] = np.round(c * x - s * y)
        out[b, ..., 1] = np.round(s * x + c * y)
    return out


def _disc_halfwidths() -> np.ndarray:
    """(31,) per-row half-width of the radius-15 disc."""
    dy = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return np.floor(np.sqrt(float(HALF_PATCH * HALF_PATCH) - dy * dy + 1e-6)).astype(np.int32)


_ROT_PATTERNS = rotated_patterns(make_brief_pattern())

# The patch-matmul path gathers one (2R+1)² patch per keypoint, covering both
# the rotated BRIEF reach (≤ 13·√2) and the radius-15 moment disc.
_PATCH_R = max(int(np.abs(_ROT_PATTERNS).max()), HALF_PATCH)
_PATCH_W = 2 * _PATCH_R + 1
_PATCH_AREA = _PATCH_W * _PATCH_W


@lru_cache(maxsize=None)
def _device_constants(device: torch.device):
    return (
        torch.from_numpy(_ROT_PATTERNS).to(device),
        torch.from_numpy(_disc_halfwidths()).to(device),
    )


def _moment_masks() -> np.ndarray:
    """(2, 31, 31) x- and y-weighted circular-disc masks."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    disc = (xs * xs + ys * ys) <= r * r
    return np.stack([xs * disc, ys * disc]).astype(np.float32)


def _moment_conv(x: torch.Tensor) -> torch.Tensor:
    k = torch.from_numpy(_moment_masks()).to(x.device)[:, None]  # (2, 1, 31, 31)
    return torch.nn.functional.conv2d(x[None, None], k, padding="same")[0]


def moment_maps_circular(img: torch.Tensor) -> torch.Tensor:
    """(2, H, W) circular-disc (m10, m01) maps by one dense float32 31×31
    convolution (cross-correlation, zero padding)."""
    return _moment_conv(img.to(torch.float32))


def moment_maps(img: torch.Tensor) -> torch.Tensor:
    """The reference's bf16-input moment maps: the image rounded to bfloat16,
    then the float32 convolution (the masks' weights are exact in bfloat16;
    on 8-bit images every product and sum is an exact integer)."""
    return _moment_conv(img.to(torch.bfloat16).to(torch.float32))


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Keypoint orientations in [0, 2π) on one level: each keypoint's 31×31
    patch (one flat gather) against the two disc masks, (N, 961) @ (961, 2)."""
    h, w = img.shape
    r = HALF_PATCH
    xi = torch.clamp(xy[..., 0].to(torch.int32), r, w - 1 - r)
    yi = torch.clamp(xy[..., 1].to(torch.int32), r, h - 1 - r)
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    offs = torch.from_numpy((dy * w + dx).reshape(-1).astype(np.int64)).to(img.device)
    idx = (yi * w + xi).long()[:, None] + offs[None, :]                  # (N, 961)
    patches = torch.take(img.to(torch.float32), idx)
    flat = torch.from_numpy(_moment_masks().reshape(2, -1).T.copy()).to(img.device)  # (961, 2)
    m = patches @ flat
    ang = torch.atan2(m[:, 1], m[:, 0])
    return torch.where(ang < 0, ang + 2.0 * np.pi, ang)


def level_moment_integrals(lvl_img: torch.Tensor):
    """Row prefix sums padded with a leading zero column, exact in int32:
    S[y, x+1] = Σ_{x'≤x} round(8·I), Sx[y, x+1] = Σ (x'−c)·round(8·I)."""
    h, w = lvl_img.shape
    q = torch.round(lvl_img * _INT_SCALE).to(torch.int32)
    c = (w - 1) // 2
    xw = (torch.arange(w, dtype=torch.int32, device=q.device) - c)[None, :]
    S = torch.nn.functional.pad(torch.cumsum(q, dim=1, dtype=torch.int32), (1, 0))
    Sx = torch.nn.functional.pad(torch.cumsum(q * xw, dim=1, dtype=torch.int32), (1, 0))
    return S, Sx, c


def _clip(x: torch.Tensor, lo: int, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip with a scalar floor and a per-keypoint ceiling."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def ic_angles_rows(
    flat_S: torch.Tensor, flat_Sx: torch.Tensor, xy: torch.Tensor,
    base: torch.Tensor, wl: torch.Tensor, hl: torch.Tensor, xc: torch.Tensor,
) -> torch.Tensor:
    """IC angles in [0, 2π) from row integrals: each of the 31 disc rows reads
    (S, Sx) at its two ends. flat_S/flat_Sx concatenate the levels' padded
    prefix sums (row stride wl+1); base is each keypoint's level offset."""
    r = HALF_PATCH
    _, u = _device_constants(xy.device)
    dyv = torch.arange(-r, r + 1, dtype=torch.int32, device=xy.device)
    xi = _clip(xy[:, 0].to(torch.int32), r, wl - 1 - r)
    yi = _clip(xy[:, 1].to(torch.int32), r, hl - 1 - r)
    stride = wl + 1
    row = base[:, None] + (yi[:, None] + dyv[None, :]) * stride[:, None]  # (N, 31)
    hi = row + xi[:, None] + u[None, :] + 1
    lo = row + xi[:, None] - u[None, :]
    idx = torch.cat([hi, lo], dim=1).long()  # (N, 62)
    S2 = torch.take(flat_S, idx).long()
    Sx2 = torch.take(flat_Sx, idx).long()
    m00r = S2[:, :31] - S2[:, 31:]
    mxr = Sx2[:, :31] - Sx2[:, 31:]
    # The reference sums in int32; the sums fit, and the wrap keeps int32 semantics.
    m10 = (mxr.sum(1) - (xi - xc).long() * m00r.sum(1)).to(torch.int32)
    m01 = (dyv[None, :].long() * m00r).sum(1).to(torch.int32)
    ang = torch.atan2(m01.to(torch.float32), m10.to(torch.float32))
    return torch.where(ang < 0, ang + 2.0 * np.pi, ang)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool → (N, 8) int32 words, bit j of word w = bits[32·w + j].
    Packed in int64, then bit 31 is wrapped to the int32 sign explicitly."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(bits.shape[0], N_WORDS, 32).long() << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def angle_bins(angles: torch.Tensor) -> torch.Tensor:
    """Steering bin in [0, 30) of each angle."""
    b = torch.remainder(torch.round(angles * (N_ROT_BINS / (2.0 * np.pi))).to(torch.int32), N_ROT_BINS)
    return torch.clamp(b, 0, N_ROT_BINS - 1)


def brief_descriptors(blurred: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 rBRIEF descriptors on one blurred level: nearest-pixel
    samples at the steered pattern offsets, one (N, 512) gather."""
    h, w = blurred.shape
    rot, _ = _device_constants(xy.device)
    offs = rot[angle_bins(angles)]  # (N, 256, 2, 2)
    xi = torch.clamp(xy[:, None, None, 0].to(torch.int32) + offs[..., 0], 0, w - 1)
    yi = torch.clamp(xy[:, None, None, 1].to(torch.int32) + offs[..., 1], 0, h - 1)
    samples = torch.take(blurred, (yi * w + xi).long())  # (N, 256, 2)
    return _pack_bits(samples[..., 0] < samples[..., 1])


def brief_descriptors_flat(
    flat_blur: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor,
    base: torch.Tensor, wl: torch.Tensor, hl: torch.Tensor,
) -> torch.Tensor:
    """(N, 8) int32 rBRIEF descriptors from one (N, 512) gather over the
    flattened blurred pyramid (same layout as ic_angles_rows)."""
    rot, _ = _device_constants(xy.device)
    offs = rot[angle_bins(angles)]  # (N, 256, 2, 2)
    xi = _clip(xy[:, None, None, 0].to(torch.int32) + offs[..., 0], 0, (wl - 1)[:, None, None])
    yi = _clip(xy[:, None, None, 1].to(torch.int32) + offs[..., 1], 0, (hl - 1)[:, None, None])
    idx = base[:, None, None] + yi * wl[:, None, None] + xi
    samples = torch.take(flat_blur, idx.long())  # (N, 256, 2)
    return _pack_bits(samples[..., 0] < samples[..., 1])


def _pair_diff_matrix() -> np.ndarray:
    """(PATCH_AREA, 30·256) int8: column (bin, bit) holds +1 at the pair's
    point p and −1 at q, so `patch @ D` is I(p) − I(q) for every bit of
    every steering bin."""
    D = np.zeros((_PATCH_AREA, N_ROT_BINS * N_BITS), np.int8)
    for b in range(N_ROT_BINS):
        for j in range(N_BITS):
            (px, py), (qx, qy) = _ROT_PATTERNS[b, j]
            col = b * N_BITS + j
            D[(py + _PATCH_R) * _PATCH_W + (px + _PATCH_R), col] += 1
            D[(qy + _PATCH_R) * _PATCH_W + (qx + _PATCH_R), col] -= 1
    return D


def _patch_moment_masks_i8() -> np.ndarray:
    """(PATCH_AREA, 2) int8 x- and y-weighted radius-15 disc masks in patch
    coordinates."""
    ys, xs = np.mgrid[-_PATCH_R : _PATCH_R + 1, -_PATCH_R : _PATCH_R + 1]
    disc = (xs * xs + ys * ys) <= HALF_PATCH * HALF_PATCH
    return np.stack([xs * disc, ys * disc], axis=-1).reshape(_PATCH_AREA, 2).astype(np.int8)


@lru_cache(maxsize=None)
def _patch_constants(device: torch.device):
    # Float32 copies, cached per device (D is 33 MB): the products below run
    # as float32 matmuls.
    return (torch.from_numpy(_patch_moment_masks_i8()).to(device, torch.float32),
            torch.from_numpy(_pair_diff_matrix()).to(device, torch.float32))


def center_i8(img: torch.Tensor) -> torch.Tensor:
    """Float intensities → int8 I − 128 of the rounded 8-bit value."""
    return (torch.clamp(torch.round(img), 0.0, 255.0) - 128.0).to(torch.int8)


def patch_orientation_brief(
    flat_blur_i8: torch.Tensor, xy: torch.Tensor,
    base: torch.Tensor, wl: torch.Tensor, hl: torch.Tensor,
):
    """(angles (N,), desc (N, 8) int32) from one (2R+1)² patch gather per
    keypoint of the flattened int8 blurred pyramid (I − 128; the same layout
    as brief_descriptors_flat) and two products:

      * IC moments = patch @ disc masks (the disc is symmetric, so the −128
        centering cancels);
      * all 30 steering bins' pair differences = patch @ D, the keypoint's
        bin picked after; bit = I(p) < I(q), ties 0.

    The reference's int8 × int8 → int32 products run here as float32
    matmuls with TF32 off, and are exact: every operand is a small integer,
    D's columns hold at most two ±1 entries (|I(p) − I(q)| ≤ 255), and the
    moments stay under 1089 · 128 · 15 < 2^24, so no partial sum rounds in
    any order. Orientation comes from the blurred patch (the gather path
    uses the raw level)."""
    n = xy.shape[0]
    dev = xy.device
    xi = _clip(xy[:, 0].to(torch.int32), _PATCH_R, wl - 1 - _PATCH_R)
    yi = _clip(xy[:, 1].to(torch.int32), _PATCH_R, hl - 1 - _PATCH_R)
    dyv = torch.arange(-_PATCH_R, _PATCH_R + 1, dtype=torch.int64, device=dev)
    starts = (base.long()[:, None] + (yi.long()[:, None] + dyv[None, :]) * wl.long()[:, None]
              + (xi.long() - _PATCH_R)[:, None])  # (N, W): each patch row's first element
    # lax.gather's CLIP mode: a slice that would run past the buffer starts earlier.
    starts = torch.clamp(starts, 0, flat_blur_i8.shape[0] - _PATCH_W)
    cols = torch.arange(_PATCH_W, dtype=torch.int64, device=dev)
    patch = torch.take(flat_blur_i8, starts[:, :, None] + cols).reshape(n, _PATCH_AREA).to(torch.float32)

    masks, D = _patch_constants(dev)
    m = patch @ masks  # (N, 2) = [m10, m01], exact
    ang = torch.atan2(m[:, 1], m[:, 0])
    ang = torch.where(ang < 0, ang + 2.0 * np.pi, ang)
    diffs = (patch @ D).reshape(n, N_ROT_BINS, N_BITS)  # exact
    sel = torch.gather(diffs, 1, angle_bins(ang).long()[:, None, None].expand(n, 1, N_BITS))[:, 0]
    return ang, _pack_bits(sel < 0)


class OrbConfig(NamedTuple):
    """The settings-yaml ORBextractor.* block."""

    n_features: int = 800
    n_levels: int = 8
    scale: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    grid: int = 8
    # Descriptor path: False (the shipped one) = row-integral IC angles and
    # the (N, 512) element gather; True = one patch gather and two products
    # (patch_orientation_brief), the reference's A/B path.
    patch_desc: bool = False


class Keypoints(NamedTuple):
    """SoA keypoint set, capacity cfg.n_features, mask `valid`; uv in level-0
    pixel coordinates."""

    uv: torch.Tensor        # (N, 2) float32
    response: torch.Tensor  # (N,) float32
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) float32 radians
    desc: torch.Tensor      # (N, 8) int32 (bit view of uint32)
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


@lru_cache(maxsize=None)
def _level_layout(h0: int, w0: int, cfg: OrbConfig, device: torch.device):
    """Static per-keypoint level metadata of the flattened pyramid, as
    device tensors: (used levels, octave, scale factor, base, wl, hl, ibase, xc)."""
    shapes = pyr.pyramid_shapes(h0, w0, cfg.n_levels, cfg.scale)
    quotas = pyr.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale)
    sf = pyr.scale_factors(cfg.n_levels, cfg.scale)
    cols = {k: [] for k in ("oct", "sf", "base", "wl", "hl", "ibase", "xc")}
    used = []
    offset = ioffset = 0
    for lv, ((h, w), quota) in enumerate(zip(shapes, quotas)):
        if quota <= 0:
            continue
        for k, v, dt in (
            ("oct", lv, np.int32), ("sf", sf[lv], np.float32), ("base", offset, np.int32),
            ("wl", w, np.int32), ("hl", h, np.int32), ("ibase", ioffset, np.int32),
            ("xc", (w - 1) // 2, np.int32),
        ):
            cols[k].append(np.full((quota,), v, dt))
        used.append((lv, quota))
        offset += h * w
        ioffset += h * (w + 1)
    t = {k: torch.from_numpy(np.concatenate(v)).to(device) for k, v in cols.items()}
    return tuple(used), t["oct"], t["sf"], t["base"], t["wl"], t["hl"], t["ibase"], t["xc"]


def extract_orb(img: torch.Tensor, cfg: OrbConfig) -> Keypoints:
    """Grayscale f32 [H, W] → Keypoints with capacity cfg.n_features: per level
    FAST quota detection, then IC orientation and rBRIEF for all levels at
    once; coordinates rescaled to level 0."""
    levels = pyr.build_pyramid(img, cfg.n_levels, cfg.scale)
    used, octave, sfs, base, wl, hl, ibase, xc = _level_layout(
        img.shape[0], img.shape[1], cfg, img.device
    )
    xs, resps, valids = [], [], []
    for lv, quota in used:
        lvl_img = levels[lv]
        h, w = lvl_img.shape
        xy, resp, valid = fast_ops.detect_keypoints(
            lvl_img, n_keep=quota, threshold=cfg.fast_threshold,
            min_threshold=cfg.fast_min_threshold, grid=cfg.grid,
        )
        inside = (
            (xy[:, 0] >= EDGE_MARGIN) & (xy[:, 0] < w - EDGE_MARGIN)
            & (xy[:, 1] >= EDGE_MARGIN) & (xy[:, 1] < h - EDGE_MARGIN)
        )
        xs.append(xy)
        resps.append(resp)
        valids.append(valid & inside)
    xy_all = torch.cat(xs)

    if cfg.patch_desc:
        flat_blur_i8 = torch.cat([center_i8(pyr.gaussian_blur(levels[lv])).reshape(-1) for lv, _ in used])
        ang, desc = patch_orientation_brief(flat_blur_i8, xy_all, base, wl, hl)
    else:
        S_parts, Sx_parts = [], []
        for lv, _ in used:
            S, Sx, _ = level_moment_integrals(levels[lv])
            S_parts.append(S.reshape(-1))
            Sx_parts.append(Sx.reshape(-1))
        flat_blur = torch.cat([pyr.gaussian_blur(levels[lv]).reshape(-1) for lv, _ in used])
        ang = ic_angles_rows(torch.cat(S_parts), torch.cat(Sx_parts), xy_all, ibase, wl, hl, xc)
        desc = brief_descriptors_flat(flat_blur, xy_all, ang, base, wl, hl)
    return Keypoints(
        uv=xy_all * sfs[:, None],
        response=torch.cat(resps),
        octave=octave,
        angle=ang,
        desc=desc,
        valid=torch.cat(valids),
    )
