#!/usr/bin/env python
"""How far the port's GF selections in the lazier, auto and active modes
stray from the reference's on identical inputs, frame by frame over the
track fixture (gf_orb_slam_tpu_torch/data/track_fixture.npz), on the CPU.

For each of the fixture's 12 frames and each mode, the port's frame and
motion-model result go to both `track_local_map`s (the reference's with its
own jax.random draws, the port's with the same draws injected). Printed per
frame: the selected sets' sizes, the share of the reference's picks the port
also made, the float64 objective of each set (logdet of the prior, plus the
matches' information in active mode, plus the selected blocks, in the
selection's normalized scale), the pose difference, and the gap between the
float32 and float64 marginal gains of the first round's candidates.
These bound `tests/test_torch_tracking.py`'s near-tie checks.

    python tools/torch_gf_near_ties.py [--modes lazier,auto,active]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gf_orb_slam_tpu.geometry.camera import CameraModel as JCam  # noqa: E402
from gf_orb_slam_tpu.io_utils import snapshot as jsnap  # noqa: E402
from gf_orb_slam_tpu.mapping.frame import FrameData as JFrame  # noqa: E402
from gf_orb_slam_tpu.pipeline import track_view as jtv  # noqa: E402
from gf_orb_slam_tpu.pipeline import tracking as jtrk  # noqa: E402
from gf_orb_slam_tpu_torch.geometry import linalg, pwls, se3  # noqa: E402
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel  # noqa: E402
from gf_orb_slam_tpu_torch.gf import active_matching, selection  # noqa: E402
from gf_orb_slam_tpu_torch.io_utils import snapshot  # noqa: E402
from gf_orb_slam_tpu_torch.mapping.frame import make_frame  # noqa: E402
from gf_orb_slam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from gf_orb_slam_tpu_torch.pipeline import track_view as tv  # noqa: E402
from gf_orb_slam_tpu_torch.pipeline import tracking  # noqa: E402

FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
CPU = torch.device("cpu")
SELECTION = {"lazier": (selection, "lazier_greedy_maxlogdet"), "auto": (selection, "auto_maxlogdet"),
             "active": (active_matching, "active_match")}


def reference_noise(mode, key, V, budget, batch):
    rounds = {"lazier": -(-budget // batch), "auto": budget}.get(mode)
    if rounds is None:
        return None
    return np.stack([np.asarray(jax.random.gumbel(k, (V,))) for k in jax.random.split(key, rounds)])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="lazier,auto,active")
    args = ap.parse_args()

    with np.load(FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    gf = dict(gf_budget=meta["gf"]["gf_budget"], gf_batch=meta["gf"]["gf_batch"], use_gf=True)
    cam, jcam, orb = CameraModel(**meta["camera"]), JCam(**meta["camera"]), OrbConfig(**meta["orb_config"])
    m = snapshot.load_map(FIXTURE, CPU)[0]
    view = tv.compute_track_view(m, int(z["center_kf"]), view_size=meta["view_size"])
    m_j, _, _ = jsnap.load_map(FIXTURE)
    view_j = jtv.TrackView(*(jnp.asarray(z["track_view_" + k]) for k in jtv.TrackView._fields))
    ids = torch.clamp(view.ids, max=m.pt_capacity - 1).long()
    V = view.capacity

    for i in range(meta["F"]):
        if i == 0:
            state = [z[k] for k in ("last_pose", "last_obs", "last_uv", "velocity")]
        else:
            state = [z[f"ref_{k}"][i - 1] for k in ("pose", "obs_point", "frame_uv", "velocity")]
        last_pose, last_obs, last_uv, vel = (snapshot.to_tensor(a, CPU) for a in state)
        frame = make_frame(snapshot.to_tensor(z["frames"][i], CPU).float(), cam, orb)
        r1 = tracking.track_with_motion_model(cam, m, frame, se3.compose(vel, last_pose), last_obs, last_uv)
        t0 = torch.zeros(())
        Xv = pwls.state_from_pose_pair(t0, last_pose, t0 + meta["dt"], r1.pose)
        frame_j = JFrame(*(jnp.asarray(getattr(frame, k).numpy()) for k in JFrame._fields))
        frame_j = frame_j._replace(desc=jnp.asarray(frame.desc.numpy().view(np.uint32)))
        key = jnp.asarray([0, i], jnp.uint32)
        for mode in args.modes.split(","):
            noise = reference_noise(mode, key, V, gf["gf_budget"], gf["gf_batch"])
            mod, name = SELECTION[mode]
            fn, seen = getattr(mod, name), {}

            def recorded(*a, _fn=fn, **kw):
                seen["args"] = a
                return _fn(*a, **kw)

            setattr(mod, name, recorded)
            try:
                r = tracking.track_local_map(cam, m, view, frame, r1.pose, r1.obs_point, Xv,
                                             None if noise is None else torch.from_numpy(noise),
                                             gf_mode=mode, dt=meta["dt"], **gf)
            finally:
                setattr(mod, name, fn)
            rj = jtrk.track_local_map(jcam, m_j, view_j, frame_j, jnp.asarray(r1.pose.numpy()),
                                      jnp.asarray(r1.obs_point.numpy()), jnp.asarray(Xv.numpy()), key,
                                      gf_mode=mode, dt=jnp.asarray(meta["dt"], jnp.float32), **gf)
            blocks, cand = seen["args"][0], seen["args"][1]
            b, s = selection.normalize_blocks(blocks, cand)
            M = selection.PRIOR_EPS * torch.eye(b.shape[-1])
            if mode == "active":
                M = M + seen["args"][4] / s
            sel_t = r.gf_selected[ids] & view.valid
            sel_j = torch.from_numpy(np.array(rj.gf_selected))[ids] & view.valid
            obj = [float(torch.logdet(M.double() + b.double()[x].sum(0))) for x in (sel_t, sel_j)]
            g32 = torch.where(cand, linalg.logdet_psd(M[None] + b) - linalg.logdet_psd(M), -torch.inf)
            g64 = torch.where(cand, torch.logdet(M.double()[None] + b.double()) - torch.logdet(M.double()), -torch.inf)
            fin = torch.isfinite(g64)
            print(json.dumps({
                "frame": i, "mode": mode, "n_port": int(sel_t.sum()), "n_ref": int(sel_j.sum()),
                "ref_picks_kept": int((sel_t & sel_j).sum()) / max(1, int(sel_j.sum())),
                "objective_port": obj[0], "objective_ref": obj[1],
                "objective_rel_diff": (obj[0] - obj[1]) / abs(obj[1]),
                "pose_max_abs_diff": float(np.abs(r.pose.numpy() - np.asarray(rj.pose)).max()),
                "first_round_gain_f32_f64_max_abs": float((g32.double() - g64)[fin].abs().max()),
            }), flush=True)


if __name__ == "__main__":
    main()
