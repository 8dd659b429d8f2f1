"""The benchmark's own synthetic sequences: the planes sweep and the room
circuit, with exact ground-truth poses.

A copy of the program's generator (gf_orb_slam_tpu_torch/io_utils/synthetic.py
and run_slam.render_frames), written with its own quaternion helpers so that
the inputs and the ground truth the reference reads come from nothing of the
program. Textures are drawn with numpy from the traffic's fixed scene seed;
frames are rendered on the device in float32 by ray-plane intersection and
bilinear texture sampling, take per-pixel Gaussian sensor noise drawn on the
device from the run's seed, and are rounded to uint8 values as a camera
delivers them. The room is seen through the camera's radtan distortion.
Every product is written elementwise, so that no matmul precision setting
changes a frame.

Poses are 7-vectors [qw qx qy qz tx ty tz] of T_cw, as the program takes them.
"""

from __future__ import annotations

import numpy as np
import torch


# --- quaternions (wxyz), float64 numpy for the trajectories --------------
def v2q(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    a = float(np.linalg.norm(v))
    if a < 1e-12:
        return np.array([1.0, *(0.5 * v)])
    return np.concatenate([[np.cos(0.5 * a)], np.sin(0.5 * a) / a * v])


def q2r(q) -> np.ndarray:
    r, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [r * r + x * x - y * y - z * z, 2.0 * (x * y - r * z), 2.0 * (z * x + r * y)],
        [2.0 * (x * y + r * z), r * r - x * x + y * y - z * z, 2.0 * (y * z - r * x)],
        [2.0 * (z * x - r * y), 2.0 * (y * z + r * x), r * r - x * x - y * y + z * z],
    ])


def pose_cw(q_wc, t_wc) -> np.ndarray:
    """T_cw of the camera whose world pose is (q_wc, t_wc)."""
    q_cw = np.asarray(q_wc, np.float64) * np.array([1.0, -1.0, -1.0, -1.0])
    t_cw = -q2r(q_cw) @ np.asarray(t_wc, np.float64)
    return np.concatenate([q_cw, t_cw])


# --- trajectories ---------------------------------------------------------
def planes_trajectory(n_frames: int, fps: float, radius: float, forward: float, yaw_amp: float) -> np.ndarray:
    """(F, 7) T_cw: a lateral sweep with slight forward and yaw motion over
    the whole sequence (the program's synthetic.trajectory)."""
    poses = []
    for i in range(n_frames):
        phase = 2.0 * np.pi * (i / fps) / (n_frames / fps)
        t_wc = [radius * np.sin(phase), 0.25 * radius * np.sin(2.0 * phase), forward * np.sin(phase * 0.5)]
        yaw = yaw_amp * np.sin(phase + 0.5)
        poses.append(pose_cw(v2q([0.4 * yaw_amp * np.cos(phase), yaw, 0.0]), t_wc))
    return np.stack(poses)


def circuit_trajectory(n_frames: int, radius: float, bob: float, revs: float) -> np.ndarray:
    """(F, 7) T_cw: the camera orbits the room's centre looking outward,
    `revs` revolutions over the sequence (synthetic.circuit_trajectory)."""
    poses = []
    for i in range(n_frames):
        th = 2.0 * np.pi * revs * i / n_frames
        t_wc = [radius * np.sin(th), bob * np.sin(3.0 * th), radius * np.cos(th)]
        poses.append(pose_cw(v2q([0.0, th, 0.0]), t_wc))
    return np.stack(poses)


# --- textures ---------------------------------------------------------------
def _blob_texture(rng, tex_size: int) -> np.ndarray:
    t = np.full((tex_size, tex_size), 128.0, np.float32)
    for _ in range(tex_size // 2):
        y, x = rng.integers(0, tex_size - 24, 2)
        sy, sx = rng.integers(6, 24, 2)
        t[y : y + sy, x : x + sx] = rng.uniform(10, 245)
    t += rng.uniform(-12, 12, t.shape).astype(np.float32)
    return np.clip(t, 0, 255)


def textures(seed: int, n: int, tex_size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_blob_texture(rng, tex_size) for _ in range(n)])


# --- rendering (torch, elementwise) ------------------------------------------
def _rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + q[..., :1] * t + torch.linalg.cross(qv, t, dim=-1)


def _camera_rays(cam: dict, dev) -> torch.Tensor:
    """(H, W, 3) camera-frame rays of the pixel centres, through the radtan
    model's fixed-point undistortion where the camera has distortion."""
    H, W = cam["height"], cam["width"]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    xd = torch.stack([(xx - cam["cx"]) / cam["fx"], (yy - cam["cy"]) / cam["fy"]], dim=-1)
    k1, k2, p1, p2, k3 = (cam.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3"))
    if any(abs(v) > 0 for v in (k1, k2, p1, p2, k3)):
        x = xd
        for _ in range(8):
            u, v = x[..., 0], x[..., 1]
            r2 = u * u + v * v
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
            dy = p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
            x = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
        xd = x
    return torch.cat([xd, torch.ones((H, W, 1), device=dev)], dim=-1)


def _sample(tex: torch.Tensor, u, v, lam, best, out):
    T = tex.shape[-1]
    inside = (lam > 0.1) & (u >= 0) & (u < T - 1) & (v >= 0) & (v < T - 1)
    u0 = torch.clamp(torch.floor(u).to(torch.int32), 0, T - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, T - 2)
    fu, fv = u - u0, v - v0
    u0l, v0l = u0.long(), v0.long()
    val = (tex[v0l, u0l] * (1 - fu) * (1 - fv) + tex[v0l, u0l + 1] * fu * (1 - fv)
           + tex[v0l + 1, u0l] * (1 - fu) * fv + tex[v0l + 1, u0l + 1] * fu * fv)
    closer = inside & (lam < best)
    return torch.where(closer, lam, best), torch.where(closer, val, out)


def _world_rays(rays_c, pose):
    q_wc = pose[:4] * torch.tensor([1.0, -1.0, -1.0, -1.0], device=pose.device)
    C = -_rotate(q_wc, pose[4:7])
    return C, _rotate(q_wc[None, None, :], rays_c)


def render_planes(tex, depths, extents, rays_c, pose) -> torch.Tensor:
    """Fronto-parallel planes at z = depths, centred on the z axis."""
    C, rays = _world_rays(rays_c, pose)
    T = tex.shape[-1]
    rz = rays[..., 2]
    rz = torch.where(torch.abs(rz) < 1e-9, 1e-9, rz)
    best = torch.full(rz.shape, float("inf"), device=rz.device)
    out = torch.full(rz.shape, 96.0, device=rz.device)
    for p in range(tex.shape[0]):
        lam = (depths[p] - C[2]) / rz
        per_unit = T / (2.0 * extents[p])
        u = (C[0] + lam * rays[..., 0] + extents[p]) * per_unit
        v = (C[1] + lam * rays[..., 1] + extents[p]) * per_unit
        best, out = _sample(tex[p], u, v, lam, best, out)
    return out


def render_room(tex, walls, rays_c, pose) -> torch.Tensor:
    """Four walls of a square room facing inward; `walls` holds per wall
    its rotation columns (x axis, y axis, normal), centre and half-sizes."""
    C, rays = _world_rays(rays_c, pose)
    T = tex.shape[-1]
    best = torch.full(rays.shape[:2], float("inf"), device=rays.device)
    out = torch.full(rays.shape[:2], 96.0, device=rays.device)
    for p, (ax, ay, n, c, ex, ey) in enumerate(walls):
        denom = (rays * n).sum(-1)
        denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        lam = ((c - C) * n).sum() / denom
        d = C + lam[..., None] * rays - c
        u = ((d * ax).sum(-1) + ex) / (2.0 * ex) * T
        v = ((d * ay).sum(-1) + ey) / (2.0 * ey) * T
        best, out = _sample(tex[p], u, v, lam, best, out)
    return out


def ground_truth(traffic: dict, cam: dict) -> tuple[np.ndarray, np.ndarray]:
    """(timestamps (F,), ground-truth T_cw (F, 7) float64) of the traffic's
    first F = `frames` frames."""
    n_seq, n = traffic["sequence_frames"], traffic["frames"]
    kind = traffic["scene"]["kind"]
    if kind == "planes":
        gt = planes_trajectory(n_seq, cam["fps"], **traffic["trajectory"])
    elif kind == "room":
        gt = circuit_trajectory(n_seq, **traffic["trajectory"])
    else:
        raise ValueError(f"unknown scene kind {kind!r}")
    return np.arange(n_seq, dtype=np.float64)[:n] / cam["fps"], gt[:n]


def make_sequence(traffic: dict, cam: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """(timestamps (F,), ground-truth T_cw (F, 7) float64, frames (F, H, W)
    float32 with uint8 values on `device`) of the traffic's first F =
    `frames` frames: the scene of the traffic's scene seed, seen with the
    sensor noise (`noise_sigma` grey levels) that `seed` draws."""
    sc = traffic["scene"]
    ts, gt = ground_truth(traffic, cam)
    dev = torch.device(device)
    tex = torch.from_numpy(textures(sc["seed"], sc["n_planes"], sc["tex_size"])).to(dev)
    rays_c = _camera_rays(cam, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if sc["kind"] == "planes":
        depths, extents = torch.tensor(sc["depths"], **f32), torch.tensor(sc["extents"], **f32)

        def render(pose):
            return render_planes(tex, depths, extents, rays_c, pose)
    else:
        walls = []
        for j in range(sc["n_planes"]):
            R = q2r(v2q([0.0, j * np.pi / 2.0 + np.pi, 0.0]))
            c = sc["half_size"] * np.array([np.sin(j * np.pi / 2.0), 0.0, np.cos(j * np.pi / 2.0)])
            walls.append(tuple(torch.tensor(a, **f32) for a in (R[:, 0], R[:, 1], R[:, 2], c))
                         + (sc["half_size"], sc["height"]))

        def render(pose):
            return render_room(tex, walls, rays_c, pose)
    poses = torch.tensor(gt, **f32)
    frames = torch.stack([render(poses[i]) for i in range(len(ts))])
    gen = torch.Generator(device=dev).manual_seed(seed % 2**63)
    frames += traffic["noise_sigma"] * torch.randn(frames.shape, generator=gen, **f32)
    frames = torch.clamp(torch.round(frames), 0, 255)
    for i in traffic.get("black_frames", []):
        frames[i] = 0.0
    return ts, gt, frames
