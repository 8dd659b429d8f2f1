"""Entry points of the port (port of the repository's __graft_entry__.py):

* entry(device=None) → (fn, example_args): the Good-Feature tracking step on
  synthetic data — measurement Jacobians → information blocks → lazier-greedy
  Max-logDet selection → masked Hamming matching of the selected landmarks
  (512 × 512 descriptors: the CUDA kernel on the card) → staged robust pose
  LM. `fn(*example_args)` returns (pose (7,), n_inliers, logdet).
* dryrun_multichip(n) — one keyframe-sharded global BA step on n ranks
  (parallel/launch.py).

The step runs eagerly; the reference's `key` argument becomes the lazier
selection's Gumbel noise, drawn apart (`selection.sample_gumbel`) so that
tests can inject the reference's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
from gf_orb_slam_tpu_torch.gf import observability, selection
from gf_orb_slam_tpu_torch.io_utils.snapshot import to_tensor
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops import matching
from gf_orb_slam_tpu_torch.parallel.launch import dryrun_multichip  # noqa: F401  (an entry point)
from gf_orb_slam_tpu_torch.pipeline.system import resolve_device
from gf_orb_slam_tpu_torch.solvers import pose_opt

GF_BUDGET = 100
N_POINTS = 512
N_KEYPOINTS = 512


def example_arrays(n_pts: int = N_POINTS, n_kps: int = N_KEYPOINTS, seed: int = 0) -> dict:
    """The step's inputs as numpy arrays, made as the reference's
    `_example_inputs` makes them: points in front of the EuRoC camera, the
    frame's keypoints at their noisy projections, half the descriptors
    shuffled away from their points."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform([40, 40], [712, 440], (n_pts, 2)).astype(np.float32)
    z = rng.uniform(3, 15, n_pts).astype(np.float32)
    Xv = np.zeros(13, np.float32)
    Xv[3] = 1.0
    pts = np.concatenate([(uv[:, 0:1] - 367.215) / 458.654 * z[:, None],
                          (uv[:, 1:2] - 248.375) / 457.296 * z[:, None], z[:, None]], axis=1)
    frame_uv = np.clip(uv + rng.normal(0, 0.5, uv.shape), 0, [751, 479]).astype(np.float32)[:n_kps]
    frame_desc = rng.integers(0, 2**32, (n_kps, 8), dtype=np.uint32)
    pt_desc = frame_desc.copy()
    rng.shuffle(pt_desc[n_pts // 2 :])  # half the descriptors mismatched
    frame_oct = rng.integers(0, 8, n_kps).astype(np.int32)
    pose0 = np.asarray([1.0, 0, 0, 0, 0.02, -0.01, 0.03], np.float32)
    return {"Xv": Xv, "pts": pts.astype(np.float32), "pt_desc": pt_desc[:n_pts], "frame_uv": frame_uv,
            "frame_desc": frame_desc, "frame_oct": frame_oct, "pose0": pose0}


def gf_track_step(Xv, pts, pt_desc, frame_uv, frame_desc, frame_oct, pose0, gumbel):
    """One GF tracking step: (pose, n_inliers, logdet of the selection)."""
    cam = EUROC_CAM
    dev = pts.device
    n_pts, n_kps = pts.shape[0], frame_uv.shape[0]
    # 1) observability: batched Jacobians and 7×7 information blocks
    jac = observability.measurement_jacobians(cam, Xv, pts)
    blocks = observability.info_matrices(
        observability.whiten(jac.H, torch.ones(n_pts, device=dev)), jac.visible)
    # 2) lazier-greedy Max-logDet subset selection
    sel = selection.lazier_greedy_maxlogdet(blocks, jac.visible, k=GF_BUDGET, gumbel=gumbel)
    # 3) masked projection matching of the selected landmarks
    pmask = matching.projection_mask(
        jac.uv, sel.selected, frame_uv, frame_oct, torch.ones(n_kps, dtype=torch.bool, device=dev),
        torch.full((n_pts,), 15.0, device=dev), torch.zeros(n_pts, dtype=torch.int32, device=dev),
        octave_window=(0, 7))
    res = matching.match(pt_desc, frame_desc, pmask, max_dist=matching.TH_HIGH)
    hit = res.matched & sel.selected
    # The reference's in-order scatter: a keypoint two points matched keeps the later one.
    win = ms.last_wins(res.idx, hit, n_kps)
    obs = ms.set_drop(torch.full((n_kps,), -1, dtype=torch.int32, device=dev),
                      torch.where(win, res.idx, n_kps), torch.arange(n_pts, dtype=torch.int32, device=dev))
    # 4) staged robust pose LM on the selected matches
    op = torch.clamp(obs, min=0).long()
    result = pose_opt.optimize_pose(cam, pose0, pts[op], frame_uv, torch.ones(n_kps, device=dev), obs >= 0)
    return result.pose, result.n_inliers, sel.logdet


def entry(device=None, seed: int = 0):
    """(fn, example_args) of the GF tracking step on `device` (the first
    CUDA card unless given); the selection's noise from a generator seeded
    with `seed`."""
    dev = resolve_device(device)
    a = example_arrays()
    args = [to_tensor(a[k], dev) for k in ("Xv", "pts", "pt_desc", "frame_uv", "frame_desc", "frame_oct", "pose0")]
    _, rounds, _ = selection.lazier_sizes(N_POINTS, GF_BUDGET)
    gumbel = selection.sample_gumbel(rounds, N_POINTS, torch.Generator(device=dev).manual_seed(seed))
    return gf_track_step, (*args, gumbel)
