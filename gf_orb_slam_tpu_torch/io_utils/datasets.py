"""Dataset sequences on disk: the EuRoC MAV, TUM-RGBD and NUIM/ICL layouts
(a copy of gf_orb_slam_tpu/io_utils/datasets.py, host Python; tests hold the
two equal), nearest-timestamp ground-truth association, and a writer of the
EuRoC layout.

Each loader lists a sequence's timestamps and image paths in time order and
its ground-truth trajectory where the layout has one. Frames are read by
io_utils/images.py (8-bit grayscale PNG or PGM), or ahead of the tracker by
io_utils/prefetch.py.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from gf_orb_slam_tpu_torch.io_utils.images import read_gray, write_gray


def _imread_gray(path: str) -> np.ndarray:
    """(H, W) float32 grey levels of one frame."""
    return read_gray(path).astype(np.float32)


@dataclass
class Sequence:
    name: str
    timestamps: list[float]
    image_paths: list[str]
    gt_timestamps: np.ndarray | None = None
    gt_positions: np.ndarray | None = None    # (G, 3)
    gt_quaternions: np.ndarray | None = None  # (G, 4) wxyz, T_wc

    def __len__(self) -> int:
        return len(self.image_paths)

    def frames(self) -> Iterator[tuple[float, np.ndarray]]:
        for t, p in zip(self.timestamps, self.image_paths):
            yield t, _imread_gray(p)


def load_euroc(seq_dir: str, cam: str = "cam0") -> Sequence:
    """EuRoC ASL layout: <seq>/mav0/cam0/data.csv + data/*.png, ground truth
    in mav0/state_groundtruth_estimate0/data.csv (ns timestamps)."""
    base = os.path.join(seq_dir, "mav0", cam)
    stamps, paths = [], []
    with open(os.path.join(base, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            stamps.append(int(row[0]) * 1e-9)
            paths.append(os.path.join(base, "data", row[1].strip()))
    seq = Sequence(name=os.path.basename(seq_dir.rstrip("/")), timestamps=stamps, image_paths=paths)

    gt_csv = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        ts, pos, quat = [], [], []
        with open(gt_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                pos.append([float(x) for x in row[1:4]])
                quat.append([float(x) for x in row[4:8]])  # w x y z
        seq.gt_timestamps = np.asarray(ts)
        seq.gt_positions = np.asarray(pos)
        seq.gt_quaternions = np.asarray(quat)
    return seq


def load_tum_rgbd(seq_dir: str) -> Sequence:
    """TUM-RGBD layout: rgb.txt (timestamp path) + groundtruth.txt
    (timestamp tx ty tz qx qy qz qw)."""
    stamps, paths = [], []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            t, p = line.split()[:2]
            stamps.append(float(t))
            paths.append(os.path.join(seq_dir, p))
    seq = Sequence(name=os.path.basename(seq_dir.rstrip("/")), timestamps=stamps, image_paths=paths)

    gt_txt = os.path.join(seq_dir, "groundtruth.txt")
    if os.path.exists(gt_txt):
        ts, pos, quat = [], [], []
        with open(gt_txt) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                vals = [float(x) for x in line.split()]
                ts.append(vals[0])
                pos.append(vals[1:4])
                qx, qy, qz, qw = vals[4:8]
                quat.append([qw, qx, qy, qz])
        seq.gt_timestamps = np.asarray(ts)
        seq.gt_positions = np.asarray(pos)
        seq.gt_quaternions = np.asarray(quat)
    return seq


def load_nuim(seq_dir: str) -> Sequence:
    """NUIM/ICL living-room layout: rgb/*.png numbered frames at 30 Hz +
    optional livingRoom<N>.gt.freiburg TUM-format ground truth."""
    rgb_dir = os.path.join(seq_dir, "rgb")
    names = sorted(
        (f for f in os.listdir(rgb_dir) if f.endswith(".png")),
        key=lambda s: int(os.path.splitext(s)[0]),
    )
    stamps = [i / 30.0 for i in range(len(names))]
    paths = [os.path.join(rgb_dir, n) for n in names]
    seq = Sequence(name=os.path.basename(seq_dir.rstrip("/")), timestamps=stamps, image_paths=paths)

    for f in os.listdir(seq_dir):
        if f.endswith(".gt.freiburg"):
            ts, pos, quat = [], [], []
            with open(os.path.join(seq_dir, f)) as fh:
                for line in fh:
                    vals = [float(x) for x in line.split()]
                    ts.append(vals[0] / 30.0)
                    pos.append(vals[1:4])
                    qx, qy, qz, qw = vals[4:8]
                    quat.append([qw, qx, qy, qz])
            seq.gt_timestamps = np.asarray(ts)
            seq.gt_positions = np.asarray(pos)
            seq.gt_quaternions = np.asarray(quat)
            break
    return seq


def detect_and_load(seq_dir: str) -> Sequence:
    """The sequence at seq_dir, whichever of the three layouts it has."""
    if os.path.isdir(os.path.join(seq_dir, "mav0")):
        return load_euroc(seq_dir)
    if os.path.exists(os.path.join(seq_dir, "rgb.txt")):
        return load_tum_rgbd(seq_dir)
    if os.path.isdir(os.path.join(seq_dir, "rgb")):
        return load_nuim(seq_dir)
    raise ValueError(f"unrecognized dataset layout at {seq_dir}")


def associate_ground_truth(seq: Sequence, est_timestamps: np.ndarray, max_dt: float = 0.03):
    """Nearest-timestamp association of estimated poses to ground truth.
    Returns (gt_positions (M, 3), valid_mask (M,)), or (None, None) for a
    sequence without ground truth."""
    if seq.gt_timestamps is None:
        return None, None
    idx = np.searchsorted(seq.gt_timestamps, est_timestamps)
    idx = np.clip(idx, 1, len(seq.gt_timestamps) - 1)
    left = seq.gt_timestamps[idx - 1]
    right = seq.gt_timestamps[idx]
    use_left = np.abs(est_timestamps - left) < np.abs(est_timestamps - right)
    pick = np.where(use_left, idx - 1, idx)
    dt = np.abs(seq.gt_timestamps[pick] - est_timestamps)
    return seq.gt_positions[pick], dt < max_dt


def write_euroc(out: str, timestamps, frames_u8, poses_cw) -> Sequence:
    """A sequence in the EuRoC ASL layout: mav0/cam0/data.csv and
    data/<ns>.png, and the ground truth (positions and wxyz quaternions of
    T_wc at the same ns stamps) in mav0/state_groundtruth_estimate0/data.csv.
    frames_u8 (F, H, W) uint8; poses_cw (F, 7) T_cw. Returns it as loaded."""
    import torch

    from gf_orb_slam_tpu_torch.geometry import se3

    cam_dir = os.path.join(out, "mav0", "cam0", "data")
    gt_dir = os.path.join(out, "mav0", "state_groundtruth_estimate0")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    wc = se3.inverse(torch.as_tensor(np.asarray(poses_cw, np.float32)))
    pos, quat = se3.pose_t(wc).numpy(), se3.pose_q(wc).numpy()
    with open(os.path.join(out, "mav0", "cam0", "data.csv"), "w") as cam_csv, \
            open(os.path.join(gt_dir, "data.csv"), "w") as gt_csv:
        cam_csv.write("#timestamp [ns],filename\n")
        gt_csv.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                     "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for t, img, p, q in zip(timestamps, frames_u8, pos, quat):
            ns = int(round(float(t) * 1e9))
            write_gray(os.path.join(cam_dir, f"{ns}.png"), np.asarray(img))
            cam_csv.write(f"{ns},{ns}.png\n")
            gt_csv.write(f"{ns},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    return load_euroc(out)
