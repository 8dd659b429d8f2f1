"""Synthetic scenes with exact ground-truth poses (port of
gf_orb_slam_tpu/io_utils/synthetic.py): the planes scene (a camera flies
past textured fronto-parallel planes at different depths) and the room
scene (four textured walls, circled by a camera looking outward: the
loop-closing sequence), each frame rendered by ray–plane intersection and
bilinear texture sampling on the device of the scene's textures; the room
is rendered through the camera's radtan distortion.

The texture generators are the reference's numpy code, copied (tests hold
the textures equal); the trajectories are numpy plus the port's quaternion
ops on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gf_orb_slam_tpu_torch.geometry import quat, se3
from gf_orb_slam_tpu_torch.geometry import camera as cam_mod
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel


class PlaneScene(NamedTuple):
    textures: torch.Tensor  # (n_planes, T, T) float32
    depths: torch.Tensor    # (n_planes,) plane z in world
    centers: torch.Tensor   # (n_planes, 2) world (x, y) of texture center
    extents: torch.Tensor   # (n_planes,) half-size in world units
    tex_size: int


def blob_textures(seed: int, n_planes: int, tex_size: int) -> np.ndarray:
    """(n_planes, T, T) float32 blobby high-contrast textures with fine
    noise, drawn exactly as the reference's make_scene draws them."""
    rng = np.random.default_rng(seed)
    return np.stack([_blob_texture(rng, tex_size) for _ in range(n_planes)])


def _blob_texture(rng, tex_size):
    t = np.full((tex_size, tex_size), 128.0, np.float32)
    for _ in range(tex_size // 2):
        y, x = rng.integers(0, tex_size - 24, 2)
        sy, sx = rng.integers(6, 24, 2)
        t[y : y + sy, x : x + sx] = rng.uniform(10, 245)
    t += rng.uniform(-12, 12, t.shape).astype(np.float32)
    return np.clip(t, 0, 255)


TEXTURE_STYLES = ("blobs", "stripes", "checker", "smooth", "mixed")


def varied_texture(rng, tex_size: int = 1024, style: str | None = None):
    """A texture from one of several families with a random gain and bias
    (the vocabulary-training corpus's widening beyond the blob family; no
    benchmark scene uses it)."""
    if style is None:
        style = TEXTURE_STYLES[rng.integers(len(TEXTURE_STYLES))]
    if style == "blobs":
        t = _blob_texture(rng, tex_size)
    elif style == "stripes":
        ang = rng.uniform(0, np.pi)
        period = rng.uniform(12, 80)
        yy, xx = np.mgrid[0:tex_size, 0:tex_size]
        ph = (np.cos(ang) * xx + np.sin(ang) * yy) / period
        t = 128.0 + 100.0 * np.sign(np.sin(2 * np.pi * ph))
        t += rng.uniform(-15, 15, t.shape)
    elif style == "checker":
        cell = int(rng.integers(8, 48))
        yy, xx = np.mgrid[0:tex_size, 0:tex_size]
        t = np.where(((yy // cell) + (xx // cell)) % 2 == 0, 40.0, 215.0)
        t += rng.uniform(-20, 20, t.shape)
    elif style == "smooth":
        # Band-limited noise: a coarse grid upsampled, plus dots.
        coarse = rng.uniform(30, 225, (tex_size // 32, tex_size // 32))
        t = np.kron(coarse, np.ones((32, 32)))
        for _ in range(tex_size // 4):
            y, x = rng.integers(4, tex_size - 4, 2)
            t[y - 2 : y + 3, x - 2 : x + 3] = rng.uniform(0, 255)
    else:  # mixed: blobs over stripes
        t = 0.5 * _blob_texture(rng, tex_size) + 0.5 * varied_texture(rng, tex_size, "stripes")
    gain = rng.uniform(0.55, 1.25)
    bias = rng.uniform(-30, 30)
    return np.clip(gain * (t - 128.0) + 128.0 + bias, 0, 255).astype(np.float32)


def make_scene(
    seed: int = 0, n_planes: int = 3, tex_size: int = 1024,
    depths=(6.0, 9.0, 14.0), extents=(5.0, 8.0, 14.0), device=None,
) -> PlaneScene:
    f32 = dict(dtype=torch.float32, device=device)
    return PlaneScene(
        textures=torch.from_numpy(blob_textures(seed, n_planes, tex_size)).to(device),
        depths=torch.tensor(depths[:n_planes], **f32),
        centers=torch.zeros((n_planes, 2), **f32),
        extents=torch.tensor(extents[:n_planes], **f32),
        tex_size=tex_size,
    )


def render(scene: PlaneScene, cam: CameraModel, pose_cw: torch.Tensor) -> torch.Tensor:
    """One frame: per-pixel ray ↦ nearest plane intersection ↦ bilinear
    texture sample. (H, W) float32 in [0, 255] on the scene's device."""
    dev = scene.textures.device
    H, W, T = cam.height, cam.width, scene.tex_size
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    rx = (xx - cam.cx) / cam.fx
    ry = (yy - cam.cy) / cam.fy
    rays_c = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)  # (H, W, 3)

    pose_wc = se3.inverse(pose_cw.to(device=dev, dtype=torch.float32))
    C = se3.pose_t(pose_wc)
    rays_w = quat.rotate(se3.pose_q(pose_wc)[None, None, :], rays_c)

    tex_px_per_unit = T / (2.0 * scene.extents)
    best_depth = torch.full((H, W), float("inf"), device=dev)
    out = torch.full((H, W), 96.0, device=dev)  # background
    rz = rays_w[..., 2]
    rz = torch.where(torch.abs(rz) < 1e-9, 1e-9, rz)
    for p in range(scene.textures.shape[0]):
        lam = (scene.depths[p] - C[2]) / rz
        Xw = C[None, None, :] + lam[..., None] * rays_w
        u = (Xw[..., 0] - scene.centers[p, 0] + scene.extents[p]) * tex_px_per_unit[p]
        v = (Xw[..., 1] - scene.centers[p, 1] + scene.extents[p]) * tex_px_per_unit[p]
        inside = (lam > 0.1) & (u >= 0) & (u < T - 1) & (v >= 0) & (v < T - 1)
        u0 = torch.clamp(torch.floor(u).to(torch.int32), 0, T - 2)
        v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, T - 2)
        fu, fv = u - u0, v - v0
        t = scene.textures[p]
        u0l, v0l = u0.long(), v0.long()
        val = (
            t[v0l, u0l] * (1 - fu) * (1 - fv)
            + t[v0l, u0l + 1] * fu * (1 - fv)
            + t[v0l + 1, u0l] * (1 - fu) * fv
            + t[v0l + 1, u0l + 1] * fu * fv
        )
        closer = inside & (lam < best_depth)
        best_depth = torch.where(closer, lam, best_depth)
        out = torch.where(closer, val, out)
    return out


def trajectory(
    n_frames: int, fps: float = 20.0, radius: float = 1.2, forward: float = 0.4,
    yaw_amp: float = 0.06,
) -> tuple[np.ndarray, np.ndarray]:
    """Smooth figure trajectory: lateral sweep plus slight forward and yaw
    motion. Returns (timestamps (F,), poses_cw (F, 7)) as numpy arrays."""
    ts = np.arange(n_frames, dtype=np.float64) / fps
    poses = []
    for t in ts:
        phase = 2.0 * np.pi * t / (n_frames / fps)
        tx = radius * np.sin(phase)
        ty = 0.25 * radius * np.sin(2.0 * phase)
        tz = forward * np.sin(phase * 0.5)
        yaw = yaw_amp * np.sin(phase + 0.5)
        pitch = 0.4 * yaw_amp * np.cos(phase)
        q_wc = quat.v2q(torch.tensor([pitch, yaw, 0.0], dtype=torch.float32))
        t_wc = torch.tensor([tx, ty, tz], dtype=torch.float32)
        poses.append(se3.inverse(se3.make_pose(q_wc, t_wc)).numpy())
    return ts.astype(np.float64), np.stack(poses)


# ---------------------------------------------------------------------------
# The room scene
# ---------------------------------------------------------------------------


class GeneralScene(NamedTuple):
    """Textured planes in arbitrary poses (the room's walls)."""

    textures: torch.Tensor  # (n, T, T) float32
    plane_q: torch.Tensor   # (n, 4) world←plane rotation; plane-local +z = normal
    plane_c: torch.Tensor   # (n, 3) plane centre in world
    extents: torch.Tensor   # (n, 2) half-sizes (x, y) in world units
    tex_size: int


def make_room_scene(seed: int = 0, half_size: float = 8.0, height: float = 5.0, tex_size: int = 1024,
                    device=None) -> GeneralScene:
    """A square room of 4 distinctly textured walls facing inward."""
    rng = np.random.default_rng(seed)
    texs, qs, cs, es = [], [], [], []
    for j in range(4):
        phi = j * np.pi / 2.0
        texs.append(_blob_texture(rng, tex_size))
        # The wall's normal points inward: Ry(phi + pi) maps +z to -(sin, 0, cos).
        qs.append(quat.v2q(torch.tensor([0.0, phi + np.pi, 0.0], dtype=torch.float32)))
        cs.append(half_size * np.asarray([np.sin(phi), 0.0, np.cos(phi)], np.float32))
        es.append([half_size, height])
    f32 = dict(dtype=torch.float32, device=device)
    return GeneralScene(
        textures=torch.from_numpy(np.stack(texs)).to(device),
        plane_q=torch.stack(qs).to(device),
        plane_c=torch.tensor(np.stack(cs), **f32),
        extents=torch.tensor(es, **f32),
        tex_size=tex_size,
    )


def render_general(scene: GeneralScene, cam: CameraModel, pose_cw: torch.Tensor) -> torch.Tensor:
    """Arbitrary-pose planes through the full camera model, radtan
    distortion included: each distorted pixel's ray comes from the
    tracker's own fixed-point undistortion. (H, W) float32 in [0, 255]."""
    dev = scene.textures.device
    H, W, T = cam.height, cam.width, scene.tex_size
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    xn = cam_mod.pixel_to_normalized(cam, torch.stack([xx, yy], dim=-1))
    if cam.has_distortion:
        xn = cam_mod.undistort_normalized(cam, xn)
    rays_c = torch.cat([xn, torch.ones((H, W, 1), device=dev)], dim=-1)

    pose_wc = se3.inverse(pose_cw.to(device=dev, dtype=torch.float32))
    C = se3.pose_t(pose_wc)
    rays_w = quat.rotate(se3.pose_q(pose_wc)[None, None, :], rays_c)

    best_depth = torch.full((H, W), float("inf"), device=dev)
    out = torch.full((H, W), 96.0, device=dev)
    for p in range(scene.textures.shape[0]):
        R_wp = quat.q2r(scene.plane_q[p])
        n_w = R_wp[:, 2]
        denom = torch.sum(rays_w * n_w, dim=-1)
        denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        lam = torch.dot(scene.plane_c[p] - C, n_w) / denom
        Xw = C[None, None, :] + lam[..., None] * rays_w
        local = (Xw - scene.plane_c[p]) @ R_wp                 # plane-local coordinates
        ex, ey = scene.extents[p, 0], scene.extents[p, 1]
        u = (local[..., 0] + ex) / (2.0 * ex) * T
        v = (local[..., 1] + ey) / (2.0 * ey) * T
        inside = (lam > 0.1) & (u >= 0) & (u < T - 1) & (v >= 0) & (v < T - 1)
        u0 = torch.clamp(torch.floor(u).to(torch.int32), 0, T - 2)
        v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, T - 2)
        fu, fv = u - u0, v - v0
        t = scene.textures[p]
        u0l, v0l = u0.long(), v0.long()
        val = (
            t[v0l, u0l] * (1 - fu) * (1 - fv)
            + t[v0l, u0l + 1] * fu * (1 - fv)
            + t[v0l + 1, u0l] * (1 - fu) * fv
            + t[v0l + 1, u0l + 1] * fu * fv
        )
        closer = inside & (lam < best_depth)
        best_depth = torch.where(closer, lam, best_depth)
        out = torch.where(closer, val, out)
    return out


def circuit_trajectory(
    n_frames: int, fps: float = 20.0, radius: float = 4.0, bob: float = 0.08,
    revs: float = 1.0, phase: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """The camera orbits the room's centre looking radially outward for
    `revs` revolutions; after a full one the starting view recurs with
    whatever drift has accumulated. Returns (timestamps, poses_cw)."""
    ts = np.arange(n_frames, dtype=np.float64) / fps
    poses = []
    for i in range(n_frames):
        th = phase + 2.0 * np.pi * revs * i / n_frames
        pos = np.asarray([radius * np.sin(th), bob * np.sin(3.0 * th), radius * np.cos(th)], np.float32)
        q_wc = quat.v2q(torch.tensor([0.0, th, 0.0], dtype=torch.float32))
        poses.append(se3.inverse(se3.make_pose(q_wc, torch.from_numpy(pos))).numpy())
    return ts.astype(np.float64), np.stack(poses)


def revisit_trajectory(
    n_frames: int, fps: float = 20.0, sweep: float = 4.0, yaw_amp: float = 0.35,
) -> tuple[np.ndarray, np.ndarray]:
    """Out-and-back sweep: the camera pans right (translation with a
    synchronized yaw) until its starting view leaves the frustum, then
    returns over the mapped area. Returns (timestamps, poses_cw)."""
    ts = np.arange(n_frames, dtype=np.float64) / fps
    poses = []
    for i in range(n_frames):
        phase = 2.0 * np.pi * i / n_frames
        q_wc = quat.v2q(torch.tensor([0.0, yaw_amp * np.sin(phase), 0.0], dtype=torch.float32))
        t_wc = torch.tensor([sweep * np.sin(phase), 0.15 * np.sin(2.0 * phase), 0.0], dtype=torch.float32)
        poses.append(se3.inverse(se3.make_pose(q_wc, t_wc)).numpy())
    return ts.astype(np.float64), np.stack(poses)
