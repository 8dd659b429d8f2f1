"""The port's local mapping against the JAX reference: the matching gates
it adds (orientation consistency, epipolar mask), the keyframe operations
on the tracking fixture's map, and the whole fused insertion fed the
fixture's frame 0 as tracked by the port (the same numpy frame, pose and
observations go into both sides).

Tolerances for the insertion: kf_id, culled_kf and n_ref equal; pt_valid
agreement ≥ 99%; kf_obs_point agreement ≥ 98% over slots either side
fills; keyframe poses within 1e-3; view ids agreement ≥ 98%."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry.camera import CameraModel as JCam
from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.mapping import keyframe_ops as jko
from gf_orb_slam_tpu.mapping import map_state as jms
from gf_orb_slam_tpu.ops import matching as jm_match
from gf_orb_slam_tpu.pipeline import local_mapping as jlm
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.io_utils import snapshot
from gf_orb_slam_tpu_torch.mapping import keyframe_ops
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops import matching
from gf_orb_slam_tpu_torch.ops.orb import OrbConfig
from gf_orb_slam_tpu_torch.pipeline import local_mapping, track_view, tracking

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
CPU = torch.device("cpu")
CAM = dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0)


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(str(arrays["meta"]))


def load_maps():
    jm, _, _ = jsnap.load_map(FIXTURE)
    return snapshot.load_map(FIXTURE, CPU)[0], jm


def t(a):
    return snapshot.to_tensor(np.asarray(a), CPU)


def agreement(m, jm):
    """(pt_valid agreement, kf_obs_point agreement over slots either side
    fills, max |Δpos| over points valid on both sides)."""
    got = ms.to_numpy(m)
    pv, jpv = got["pt_valid"], np.asarray(jm.pt_valid)
    o, jo = got["kf_obs_point"], np.asarray(jm.kf_obs_point)
    either = (o >= 0) | (jo >= 0)
    both = pv & jpv
    dpos = np.abs(got["pt_pos"][both] - np.asarray(jm.pt_pos)[both]).max() if both.any() else 0.0
    return (pv == jpv).mean(), (o == jo)[either].mean() if either.any() else 1.0, dpos


def assert_map_equalish(m, jm, atol=1e-4):
    pv_agree, obs_agree, dpos = agreement(m, jm)
    assert pv_agree == 1.0 and obs_agree == 1.0 and dpos <= atol, (pv_agree, obs_agree, dpos)
    got = ms.to_numpy(m)
    for k in ("kf_valid", "pt_first_kf", "pt_first_frame", "pt_visible", "pt_found", "n_pt", "n_kf"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jm, k)), err_msg=k)


# ---------------------------------------------------------------------------
# Matching gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ties", "random"])
def test_orientation_consistency(rng, case):
    n = 400
    if case == "ties":
        # Planted equal bins: rotations in 5 bins with 20 matches each, so
        # the three dominant bins tie and JAX's lowest-index order decides.
        bins = np.repeat([3, 7, 11, 18, 25], 20)
        dtheta = bins * (2 * np.pi / 30)
        angle_t = rng.random(n).astype(np.float32) * 6.0
        idx = rng.permutation(n)[:100].astype(np.int32)
        angle_q = (angle_t[idx] + dtheta).astype(np.float32)
        matched = np.ones(100, bool)
    else:
        angle_q = (rng.random(n) * 2 * np.pi).astype(np.float32)
        angle_t = (rng.random(n) * 2 * np.pi).astype(np.float32)
        idx = rng.integers(0, n, n).astype(np.int32)
        matched = rng.random(n) < 0.7
    got = matching.orientation_consistency(t(angle_q), t(angle_t), t(matched), t(idx)).numpy()
    want = np.asarray(jm_match.orientation_consistency(jnp.asarray(angle_q), jnp.asarray(angle_t),
                                                        jnp.asarray(matched), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    if case == "ties":
        assert got.sum() == 60  # bins 3, 7 and 11 kept


def test_epipolar_mask(rng):
    uv1 = (rng.random((300, 2)) * [752, 480]).astype(np.float32)
    uv2 = (rng.random((280, 2)) * [752, 480]).astype(np.float32)
    F = rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
    F[2, 2] = 1.0
    s2 = (1.2 ** (2 * rng.integers(0, 8, 280))).astype(np.float32)
    vq, vt = rng.random(300) < 0.9, rng.random(280) < 0.9
    got = matching.epipolar_mask(t(uv1), t(uv2), t(F), t(s2), t(vq), t(vt), thresh_chi2=400.0).numpy()
    want = np.asarray(jm_match.epipolar_mask(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(F), jnp.asarray(s2),
                                              jnp.asarray(vq), jnp.asarray(vt), thresh_chi2=400.0))
    assert want.sum() > 100
    np.testing.assert_array_equal(got, want)


def test_match_with_orientation_check(rng):
    q = rng.integers(0, 2**32, (200, 8), dtype=np.uint32)
    tt = q[rng.permutation(200)] ^ (rng.random((200, 8)) < 0.02).astype(np.uint32)
    mask = rng.random((200, 200)) < 0.5
    aq, at = (rng.random(200) * 6).astype(np.float32), (rng.random(200) * 6).astype(np.float32)
    r = matching.match(t(q), t(tt), t(mask), max_dist=80, ratio=0.9, angle_q=t(aq), angle_t=t(at), mutual=True)
    jr = jm_match.match(jnp.asarray(q), jnp.asarray(tt), jnp.asarray(mask), max_dist=80, ratio=0.9,
                        angle_q=jnp.asarray(aq), angle_t=jnp.asarray(at), mutual=True)
    np.testing.assert_array_equal(r.matched.numpy(), np.asarray(jr.matched))
    np.testing.assert_array_equal(r.idx.numpy()[r.matched.numpy()], np.asarray(jr.idx)[np.asarray(jr.matched)])


# ---------------------------------------------------------------------------
# Keyframe operations on the fixture's map
# ---------------------------------------------------------------------------


def neighbours(m, center, n):
    w = ms.covisibility_row(m, center).numpy()
    ids = np.argsort(-w, kind="stable")[:n]
    return ids, w[ids]


def test_fundamental_from_poses(fx):
    m, jm = load_maps()
    p1, p2 = m.kf_pose[int(fx[0]["center_kf"])], m.kf_pose[0]
    got = keyframe_ops.fundamental_from_poses(CameraModel(**CAM), p1, p2).numpy()
    want = np.asarray(jko.fundamental_from_poses(JCam(**CAM), jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_triangulate_between(fx):
    m, jm = load_maps()
    center = int(fx[0]["center_kf"])
    ids, _ = neighbours(m, center, 2)
    for nb in ids:
        got = keyframe_ops.triangulate_between(CameraModel(**CAM), m, center, int(nb), 500)
        want = jko.triangulate_between(JCam(**CAM), jm, jnp.asarray(center), jnp.asarray(int(nb)), jnp.asarray(500))
        assert int(got.pt_valid.sum()) > int(m.pt_valid.sum())  # new points
        # New points come from float32 3×3 normal equations: measured 1.4e-4
        # apart at ~10 map units.
        assert_map_equalish(got, want, atol=1e-3)


def test_cull_points(fx):
    m, jm = load_maps()
    center = int(fx[0]["center_kf"])
    # Lower the found counters so the ratio rule fires too.
    found = np.maximum(np.asarray(jm.pt_found) - np.random.default_rng(6).integers(0, 40, m.pt_capacity), 0)
    m, jm = m._replace(pt_found=t(found.astype(np.int32))), jm._replace(pt_found=jnp.asarray(found, jnp.int32))
    got = keyframe_ops.cull_points(m, center + 2)
    want = jko.cull_points(jm, jnp.asarray(center + 2))
    assert int(got.pt_valid.sum()) < int(m.pt_valid.sum())
    assert_map_equalish(got, want, atol=0)


def fuse_inputs(m, center, Mf=2048, F=4):
    P = m.pt_capacity
    obs = m.kf_obs_point.numpy()
    ids, w = neighbours(m, center, F)
    ok = w >= 10
    nb = obs[ids]
    union = np.unique(nb[(nb >= 0) & ok[:, None]])[:Mf]
    cand1 = np.full(Mf, P, np.int64)
    cand1[: union.size] = union
    c2 = np.full(Mf, -1, np.int64)
    c2[: obs.shape[1]] = obs[center]
    targets = np.concatenate([[center], ids]).astype(np.int32)
    t_ok = np.concatenate([[True], ok])
    cands = np.concatenate([np.minimum(cand1, P - 1)[None], np.repeat(np.maximum(c2, 0)[None], F, 0)]).astype(np.int32)
    uses = np.concatenate([(cand1 < P)[None], np.repeat((c2 >= 0)[None], F, 0)])
    return targets, t_ok, cands, uses


def test_fuse_points_into_keyframes(fx):
    m, jm = load_maps()
    center = int(fx[0]["center_kf"])
    # Duplicate a quarter of the centre keyframe's points under fresh ids
    # so the fuse has merges (case B) as well as claims (case A) to make.
    obs = m.kf_obs_point.numpy().copy()
    slots = np.flatnonzero(obs[center] >= 0)[::4]
    new_ids = np.flatnonzero(~m.pt_valid.numpy())[: slots.size]
    arrays = ms.to_numpy(m)
    for k in ("pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_visible", "pt_found",
              "pt_first_kf", "pt_first_frame"):
        arrays[k][new_ids] = arrays[k][obs[center, slots]]
    arrays["pt_valid"][new_ids] = True
    obs[center, slots] = new_ids
    arrays["kf_obs_point"] = obs
    m = snapshot.map_state_from_numpy(arrays, CPU)
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    targets, t_ok, cands, uses = fuse_inputs(m, center)
    got = keyframe_ops.fuse_points_into_keyframes(CameraModel(**CAM), m, t(targets), t(t_ok), t(cands), t(uses))
    want = jko.fuse_points_into_keyframes(JCam(**CAM), jm, jnp.asarray(targets), jnp.asarray(t_ok),
                                          jnp.asarray(cands), jnp.asarray(uses))
    assert int(got.pt_valid.sum()) < int(m.pt_valid.sum())  # merges happened
    assert_map_equalish(got, want, atol=0)


@pytest.mark.parametrize("rows", [False, True])
def test_keyframe_redundancy(fx, rows):
    m, jm = load_maps()
    r = np.argsort(-ms.covisibility_row(m, int(fx[0]["center_kf"])).numpy(), kind="stable")[:32] if rows else None
    got = keyframe_ops.keyframe_redundancy(m, rows=None if r is None else t(r)).numpy()
    want = np.asarray(jko.keyframe_redundancy(jm, rows=None if r is None else jnp.asarray(r)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got > 0).sum() >= 3


def tiny_map(lib, pose, uv, desc, pts, pdesc):
    """A 2-keyframe, 4-keypoint, 8-point map built with `lib`'s own calls."""
    if lib is ms:
        m = ms.empty_map(2, 8, 4, device=CPU)
        arr = t
    else:
        m = jms.empty_map(2, 8, 4)
        arr = jnp.asarray
    m, _ = lib.add_keyframe(m, arr(pose), arr(np.int32(1)), arr(np.float32(0.05)), arr(uv),
                            arr(np.zeros(4, np.int32)), arr(np.zeros(4, np.float32)), arr(desc),
                            arr(np.ones(4, bool)), arr(np.full(4, -1, np.int32)))
    d = np.linalg.norm(pts, axis=1).astype(np.float32)
    n = len(pts)
    return lib.add_points(m, arr(np.arange(n, dtype=np.int32)), arr(pts), arr(pdesc), arr(pts / d[:, None]),
                          arr(np.zeros(n, np.float32)), arr(d), arr(np.int32(0)), arr(np.int32(1)),
                          arr(np.ones(n, bool)))


@pytest.mark.parametrize("order", [[0, 1], [1, 0]])
def test_fuse_duplicate_claim_last_wins(rng, order):
    """Two candidates claim one free keypoint slot (the fuse match is not
    mutual): the later candidate row wins, as the reference's in-order
    scatter resolves it."""
    pose = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    uv = np.asarray([[100, 100], [600, 400], [650, 60], [300, 420]], np.float32)
    desc = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
    ray = np.asarray([(100 - 376) / 458, (100 - 240) / 458, 1.0], np.float32)
    pts = np.stack([5.0 * ray, 5.2 * ray]).astype(np.float32)
    pdesc = np.stack([desc[0], desc[0]])
    targets, t_ok = np.asarray([0], np.int32), np.asarray([True])
    cands, uses = np.asarray([order], np.int32), np.ones((1, 2), bool)
    got = keyframe_ops.fuse_points_into_keyframes(
        CameraModel(**CAM), tiny_map(ms, pose, uv, desc, pts, pdesc), t(targets), t(t_ok), t(cands), t(uses))
    want = jko.fuse_points_into_keyframes(
        JCam(**CAM), tiny_map(jms, pose, uv, desc, pts, pdesc), jnp.asarray(targets), jnp.asarray(t_ok),
        jnp.asarray(cands), jnp.asarray(uses))
    assert int(got.kf_obs_point[0, 0]) == order[-1] == int(want.kf_obs_point[0, 0])
    np.testing.assert_array_equal(got.kf_obs_point.numpy(), np.asarray(want.kf_obs_point))


# ---------------------------------------------------------------------------
# The fused insertion
# ---------------------------------------------------------------------------


def test_insert_keyframe_fused(fx):
    arrays, meta = fx
    m, jm = load_maps()
    cam = CameraModel(**meta["camera"])
    gf = meta["gf"]
    view = track_view.compute_track_view(m, int(arrays["center_kf"]), view_size=meta["view_size"])
    state = [t(arrays[k]) for k in ("last_pose", "last_obs", "last_uv", "velocity")]
    r = tracking.track_frame_fused(
        cam, OrbConfig(**meta["orb_config"]), m, view, t(arrays["frames"][0]).float(), *state, meta["dt"],
        torch.tensor([0, 1]), gf_budget=gf["gf_budget"], use_gf=True, gf_mode=gf["gf_mode"], gf_batch=gf["gf_batch"],
    )
    assert bool(r.ok)
    N = m.kp_capacity
    pad = N - r.frame_uv.shape[0]

    def pz(a, fill=0):
        a = a.numpy()
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    vis, fnd = r.pt_visible.numpy(), r.pt_found.numpy()
    kp = [pz(r.frame_uv), pz(r.frame_octave), pz(r.frame_angle), pz(r.frame_desc).view(np.uint32),
          pz(r.frame_valid, False), pz(r.obs_point, -1)]
    pose = r.pose.numpy()
    frame_id, ts = 132, 6.6
    kw = dict(scale=1.2, n_levels=8, ba_window=8, ba_fixed=2, n_tri_neighbors=3, ba_points=2048,
              ba_iters=(5, 10), view_size=meta["view_size"])
    got = local_mapping.insert_keyframe_fused(
        cam, m._replace(pt_visible=t(vis), pt_found=t(fnd)), t(pose), frame_id, ts, *[t(a) for a in kp], **kw)
    want = jlm.insert_keyframe_fused(
        JCam(**meta["camera"]), jm._replace(pt_visible=jnp.asarray(vis), pt_found=jnp.asarray(fnd)),
        jnp.asarray(pose), jnp.asarray(frame_id), jnp.asarray(ts, jnp.float32), *[jnp.asarray(a) for a in kp], **kw)

    assert int(got.kf_id) == int(want.kf_id) == 14
    assert int(got.culled_kf) == int(want.culled_kf)
    assert int(got.n_ref) == int(want.n_ref)
    pv_agree, obs_agree, _ = agreement(got.m, want.m)
    assert pv_agree >= 0.99 and obs_agree >= 0.98, (pv_agree, obs_agree)
    kv = np.asarray(want.m.kf_valid)
    np.testing.assert_array_equal(got.m.kf_valid.numpy(), kv)
    np.testing.assert_allclose(got.m.kf_pose.numpy()[kv], np.asarray(want.m.kf_pose)[kv], atol=1e-3, rtol=0)
    ids, jids = got.view.ids.numpy(), np.asarray(want.view.ids)
    P = m.pt_capacity
    either = (ids < P) | (jids < P)
    assert (np.isin(ids[ids < P], jids[jids < P]).sum() / either.sum()) >= 0.98
    # The input map is left intact (functional update).
    assert int(m.n_kf) == 14 and int(m.kf_valid.sum()) == 5
