"""The reference's OpenCV-YAML settings files (a copy of
gf_orb_slam_tpu/io_utils/settings.py, host Python; tests hold the two
equal): the Camera.*, Camera2.*, ORBextractor.* and UseMotionModel keys of
Tracking's constructor become a CameraModel and a SlamConfig whose other
fields keep the shipped defaults.
"""

from __future__ import annotations

import re

from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.pipeline.system import SlamConfig


def _parse_opencv_yaml(path: str) -> dict:
    """The flat `key: number` lines of an OpenCV YAML file (%YAML:1.0
    header, which PyYAML rejects); anything else is skipped."""
    values: dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(-?[0-9.eE+-]+)\s*$", line)
            if m:
                values[m.group(1)] = float(m.group(2))
    return values


def load_settings(path: str) -> tuple[CameraModel, SlamConfig]:
    v = _parse_opencv_yaml(path)
    cam = CameraModel(
        fx=v.get("Camera.fx", 458.654),
        fy=v.get("Camera.fy", 457.296),
        cx=v.get("Camera.cx", 367.215),
        cy=v.get("Camera.cy", 248.375),
        k1=v.get("Camera.k1", 0.0),
        k2=v.get("Camera.k2", 0.0),
        p1=v.get("Camera.p1", 0.0),
        p2=v.get("Camera.p2", 0.0),
        k3=v.get("Camera.k3", 0.0),
        width=int(v.get("Camera2.nCols", 752)),
        height=int(v.get("Camera2.nRows", 480)),
        fps=v.get("Camera.fps", 20.0),
    )
    fps = cam.fps if cam.fps > 0 else 30.0
    cfg = SlamConfig(
        n_features=int(v.get("ORBextractor.nFeatures", 800)),
        n_levels=int(v.get("ORBextractor.nLevels", 8)),
        scale=v.get("ORBextractor.scaleFactor", 1.2),
        fast_threshold=v.get("ORBextractor.fastTh", 20.0),
        use_motion_model=bool(int(v.get("UseMotionModel", 1))),
        # mMaxFrames = 18 * fps / 30 (Tracking.cc:153)
        max_frames_between_kf=max(int(18 * fps / 30), 4),
    )
    return cam, cfg


def write_settings(path: str, cam: CameraModel, cfg: SlamConfig) -> None:
    """A settings file that load_settings reads back as (cam, cfg)'s
    camera, ORB extractor and motion-model fields."""
    keys = {
        "Camera.fx": cam.fx, "Camera.fy": cam.fy, "Camera.cx": cam.cx, "Camera.cy": cam.cy,
        "Camera.k1": cam.k1, "Camera.k2": cam.k2, "Camera.p1": cam.p1, "Camera.p2": cam.p2,
        "Camera.k3": cam.k3, "Camera.fps": cam.fps, "Camera2.nCols": cam.width, "Camera2.nRows": cam.height,
        "ORBextractor.nFeatures": cfg.n_features, "ORBextractor.scaleFactor": cfg.scale,
        "ORBextractor.nLevels": cfg.n_levels, "ORBextractor.fastTh": cfg.fast_threshold,
        "UseMotionModel": int(cfg.use_motion_model),
    }
    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        f.writelines(f"{k}: {v!r}\n" for k, v in keys.items())
