"""Visualization export (port of gf_orb_slam_tpu/io_utils/viz.py), the
equivalents of the reference's FramePublisher and MapPublisher without ROS:

* annotate_frame(...)  → an RGB numpy image with the tracked and GF-selected
                         keypoints drawn;
* export_map_ply(...)  → an ASCII PLY of the map points, the keyframes'
                         camera centres and the covisibility edges (≥ 15
                         shared points), for MeshLab, CloudCompare or rerun.

Both are host numpy; export_map_ply reads the port's MapState from its device.
"""

from __future__ import annotations

import numpy as np

from gf_orb_slam_tpu_torch.geometry import se3
from gf_orb_slam_tpu_torch.mapping import map_state as ms

COVISIBILITY_EDGE = 15  # shared points for a drawn edge


def annotate_frame(
    img: np.ndarray,
    kp_uv: np.ndarray,
    tracked: np.ndarray,
    gf_selected: np.ndarray | None = None,
    radius: int = 3,
) -> np.ndarray:
    """Grayscale (H, W) + keypoints → RGB uint8 with hollow square markers:
    magenta = GF-selected, green = tracked."""
    h, w = img.shape
    rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)

    def draw(u, v, color):
        x, y = int(round(u)), int(round(v))
        if not (radius <= x < w - radius and radius <= y < h - radius):
            return
        rgb[y - radius : y + radius + 1, x - radius : x + radius + 1] = color
        rgb[y - radius + 1 : y + radius, x - radius + 1 : x + radius] = (
            img[y - radius + 1 : y + radius, x - radius + 1 : x + radius, None]
        )

    for i, (u, v) in enumerate(kp_uv):
        if gf_selected is not None and i < len(gf_selected) and gf_selected[i]:
            draw(u, v, (255, 0, 255))
        elif tracked[i]:
            draw(u, v, (0, 255, 0))
    return rgb


def _edges(m: ms.MapState, kf_valid: np.ndarray) -> list[tuple[int, int]]:
    """Covisibility pairs (a < b) of valid keyframes, as indices into the
    valid keyframes."""
    W = ms.covisibility(m).cpu().numpy()
    ids = np.flatnonzero(kf_valid)
    sub = W[np.ix_(ids, ids)] >= COVISIBILITY_EDGE
    a, b = np.nonzero(np.triu(sub, k=1))
    return list(zip(a.tolist(), b.tolist()))


def export_map_ply(path: str, m: ms.MapState, with_covisibility: bool = True) -> None:
    """Write the map as an ASCII PLY: map points (grey), camera centres
    (red), covisibility edges."""
    pts = m.pt_pos.cpu().numpy()[m.pt_valid.cpu().numpy()]
    kf_valid = m.kf_valid.cpu().numpy()
    centers = se3.pose_t(se3.inverse(m.kf_pose)).cpu().numpy()[kf_valid]
    edges = _edges(m, kf_valid) if with_covisibility else []

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts) + len(centers)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 200 200 200\n")
        for c in centers:
            f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} 255 40 40\n")
        off = len(pts)
        for a, b in edges:
            f.write(f"{off + a} {off + b}\n")
