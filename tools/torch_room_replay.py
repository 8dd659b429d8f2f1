#!/usr/bin/env python
"""Every keyframe insertion and tracked frame of the reference's room run,
replayed through the PyTorch port on the reference's own inputs.

    python tools/torch_room_replay.py [--out results/room_replay.json]

Runs the JAX reference's synchronous `SlamSystem` on the CPU over the
reference CLI's room circuit (as tools/make_torch_room_fixture.py does:
radtan EuRoC camera, keyframe cadence 6, GF subset at budget 100, scene
seed 0, the 1M-word vocabulary) and, at each call, feeds the port (CPU, two
intra-op threads) the same inputs:

* each `insert_keyframe_fused`: the map before it and its arguments; the
  port's map after it against the reference's (pt_valid agreement,
  kf_obs_point agreement over slots either side fills, keyframe validity,
  the culled keyframe, the largest keyframe-pose gap);
* each tracked frame: the map, view and state the reference's
  `track_frame_fused` received, and the keypoints it extracted, through
  `tracking.track_frame`; pose gap, n_inliers, ok and obs_point agreement,
  and each side's GF pick count (the reference's read by a debug callback
  in its selection, which adds an output and changes none).

Prints per stage how many calls fall outside the planes tolerances (the
insertion: pt_valid ≥ 99%, kf_obs_point ≥ 98%, poses within 1e-3, culled
keyframe equal; the step: pose 1e-3, n_inliers within max(3, 2%), ok equal,
obs_point ≥ 95%), split by whether the two sides' GF pick counts agree.
About 20 minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_torch_room_fixture import FPS, N_FRAMES, host  # noqa: E402

from gf_orb_slam_tpu.geometry.camera import EUROC_CAM as JCAM  # noqa: E402
from gf_orb_slam_tpu.gf import selection as jsel  # noqa: E402
from gf_orb_slam_tpu.io_utils import synthetic  # noqa: E402
from gf_orb_slam_tpu.pipeline import local_mapping as jlm  # noqa: E402
from gf_orb_slam_tpu.pipeline import system as system_mod  # noqa: E402
from gf_orb_slam_tpu.pipeline import tracking as jtrk  # noqa: E402
from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod  # noqa: E402
from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM  # noqa: E402
from gf_orb_slam_tpu_torch.gf import selection as psel  # noqa: E402
from gf_orb_slam_tpu_torch.io_utils import map_delta, snapshot  # noqa: E402
from gf_orb_slam_tpu_torch.mapping.frame import FrameData  # noqa: E402
from gf_orb_slam_tpu_torch.pipeline import local_mapping, tracking  # noqa: E402


def t(a) -> torch.Tensor:
    return snapshot.to_tensor(np.asarray(a), "cpu")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results", "room_replay.json"))
    args = ap.parse_args()
    torch.set_num_threads(2)
    n = N_FRAMES
    picks = {"reference": [], "port": []}
    insertions, frames = [], []

    select = jsel.greedy_maxlogdet_lowrank

    def counted_select(factors, valid, k, batch=1, info_prior=None):
        res = select(factors, valid, k, batch=batch, info_prior=info_prior)
        jax.debug.callback(lambda c: picks["reference"].append(int(c)), res.n_selected)
        return res

    port_select = psel.greedy_maxlogdet_lowrank

    def counted_port_select(*a, **kw):
        res = port_select(*a, **kw)
        picks["port"].append(int(res.n_selected))
        return res

    insert = jlm.insert_keyframe_fused

    def replayed_insert(cam, m, *a, **kw):
        m_in, a_np = host(m), [np.array(x, copy=True) for x in a]
        res = insert(cam, jax.tree.map(jnp.asarray, m), *a, **kw)
        got = local_mapping.insert_keyframe_fused(
            EUROC_CAM, snapshot.map_state_from_numpy(m_in, "cpu"), t(a_np[0]), int(a_np[1]), float(a_np[2]),
            *[t(x) for x in a_np[3:]], **kw)
        insertions.append({"frame": int(a_np[1]), "kf_id": int(res.kf_id), "culled_kf": int(res.culled_kf),
                           "port_culled_kf": int(got.culled_kf),
                           **map_delta.agreement({k: v.numpy() for k, v in got.m._asdict().items()}, host(res.m))})
        return res

    track = jtrk.track_frame_fused

    def replayed_track(cam, orb_cfg, m, view, img, *a, **kw):
        n_ref = len(picks["reference"])
        res = track(cam, orb_cfg, m, view, img, *a, **kw)
        jax.effects_barrier()
        uv = t(res.frame_uv)
        frame = FrameData(uv=uv, uv_raw=uv, octave=t(res.frame_octave), angle=t(res.frame_angle),
                          desc=t(res.frame_desc), response=torch.zeros_like(uv[:, 0]), valid=t(res.frame_valid))
        view_p = snapshot.track_view_from_numpy(host(view), "cpu")
        n_port = len(picks["port"])
        r = tracking.track_frame(EUROC_CAM, snapshot.map_state_from_numpy(host(m), "cpu"), view_p, frame,
                                 *[t(x) for x in a[:4]], float(np.asarray(a[4])), t(np.asarray(a[5]).astype(np.int64)),
                                 **kw)
        o, wo = r.obs_point.numpy(), np.asarray(res.obs_point)
        either = (o >= 0) | (wo >= 0)
        frames.append({"frame": system.frame_id, "pose": float(np.abs(r.pose.numpy() - np.asarray(res.pose)).max()),
                       "n_inliers": int(r.n_inliers), "ref_n_inliers": int(res.n_inliers),
                       "ok_equal": bool(r.ok) == bool(res.ok),
                       "obs_point": float((o == wo)[either].mean()) if either.any() else 1.0,
                       "ref_picks": picks["reference"][-1] if len(picks["reference"]) > n_ref else None,
                       "port_picks": picks["port"][-1] if len(picks["port"]) > n_port else None})
        return res

    jsel.greedy_maxlogdet_lowrank = counted_select
    psel.greedy_maxlogdet_lowrank = counted_port_select
    jlm.insert_keyframe_fused = replayed_insert
    jtrk.track_frame_fused = replayed_track
    cfg = system_mod.SlamConfig(max_frames_between_kf=6, use_gf=True, gf_budget=100, gf_mode="subset",
                                pipelined=False)
    scene = synthetic.make_room_scene(seed=0)
    ts, poses_gt = synthetic.circuit_trajectory(n, fps=FPS, radius=4.0, revs=min(1.1, n / 270.0))
    system = system_mod.SlamSystem(JCAM, cfg)
    system.set_vocabulary(voc_mod.load_default_vocabulary())
    t0 = time.perf_counter()
    for i in range(n):
        img = np.clip(np.round(np.asarray(synthetic.render_general(scene, JCAM, jnp.asarray(poses_gt[i])))), 0, 255)
        system.process(jnp.asarray(img.astype(np.uint8), jnp.float32), float(ts[i]))
        if i % 50 == 0:
            print(f"frame {i}: {time.perf_counter() - t0:.0f}s", flush=True)
    system.flush()

    def outside_insertion(r):
        return (r["pt_valid"] < 0.99 or r["kf_obs_point"] < 0.98 or r["kf_pose"] > 1e-3 or not r["kf_valid_equal"]
                or r["culled_kf"] != r["port_culled_kf"])

    def outside_step(r):
        w = r["ref_n_inliers"]
        return (r["pose"] > 1e-3 or not r["ok_equal"] or r["obs_point"] < 0.95
                or abs(r["n_inliers"] - w) > max(3, 0.02 * w))

    summary = {"frames": n, "seconds": time.perf_counter() - t0,
               "insertions": {"calls": len(insertions), "culls": sum(r["culled_kf"] >= 0 for r in insertions),
                              "outside": sum(map(outside_insertion, insertions)),
                              "min_pt_valid": min(r["pt_valid"] for r in insertions),
                              "min_kf_obs_point": min(r["kf_obs_point"] for r in insertions),
                              "max_kf_pose": max(r["kf_pose"] for r in insertions)}}
    for name, rows in (("picks_equal", [r for r in frames if r["ref_picks"] == r["port_picks"]]),
                       ("picks_differ", [r for r in frames if r["ref_picks"] != r["port_picks"]])):
        summary[f"tracked_{name}"] = {
            "calls": len(rows), "outside": sum(map(outside_step, rows)),
            "max_pose": max((r["pose"] for r in rows), default=0.0),
            "min_obs_point": min((r["obs_point"] for r in rows), default=1.0),
            "max_n_inliers_gap": max((abs(r["n_inliers"] - r["ref_n_inliers"]) for r in rows), default=0)}
    for side, key in (("reference", "ref_picks"), ("port", "port_picks")):
        p = np.asarray([r[key] for r in frames if r[key] is not None])
        summary[f"{side}_gf_picks"] = {"none": int((p == 0).sum()), "partial": int(((p > 0) & (p < 100)).sum()),
                                       "full": int((p >= 100).sum())}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**summary, "insertion_rows": insertions, "tracked_rows": frames}, f)


if __name__ == "__main__":
    main()
