"""The port's loop closing and relocalization against the JAX reference:
the map's spanning tree and point replacement, the single-keyframe fuse,
`verify_candidate` and `correct_loop` on the reference's own drifted-map
scenario (tests/test_loop_closing.py), the host-side `LoopDetector`, and
`relocalize_fused` on the track fixture's map with a fixture frame as the
lost frame. Random draws are the reference's own, injected.

Tolerances: spanning tree, point replacement, the fuse's observation table
and point flags, the loop detector's streaks, BoW match counts, ok flags and
the winning keyframe exact; verify_candidate's Sim3 1e-4 (rotation 1e-4
rad) and its inlier counts within max(3, 2%); correct_loop's poses and
points 1e-4 given the same optimized graph (the graph's own parity is
tests/test_torch_loop_solvers.py); the relocalized pose 1e-3 (rad and map
units) and its inliers within max(3, 2%)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_closing as ref_scenario
from gf_orb_slam_tpu.geometry import camera as jcam
from gf_orb_slam_tpu.geometry import sim3 as js3
from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.loop import loop_closing as jlc
from gf_orb_slam_tpu.mapping import frame as jframe
from gf_orb_slam_tpu.mapping import keyframe_ops as jkops
from gf_orb_slam_tpu.mapping import map_state as jms
from gf_orb_slam_tpu.ops import orb as jorb
from gf_orb_slam_tpu.pipeline import tracking as jtrk
from gf_orb_slam_tpu.retrieval import keyframe_db as jkdb
from gf_orb_slam_tpu.retrieval import vocabulary as jvoc
from gf_orb_slam_tpu.solvers import pose_graph as jpg
from gf_orb_slam_tpu_torch.geometry import camera
from gf_orb_slam_tpu_torch.io_utils import snapshot
from gf_orb_slam_tpu_torch.loop import loop_closing
from gf_orb_slam_tpu_torch.mapping import keyframe_ops
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.pipeline import tracking
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu_torch.solvers import pnp, pose_graph, sim3_solver

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")


def to_port_map(jm) -> ms.MapState:
    return snapshot.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()}, CPU)


def to_port_db(jdb) -> kdb.BowDatabase:
    return kdb.BowDatabase(*(snapshot.to_tensor(np.asarray(f), CPU) for f in jdb))


def assert_map_equal(got: ms.MapState, want, fields=None, atol=0.0):
    for f in fields or ms.MapState._fields:
        g, w = ms.to_numpy(got)[f], np.asarray(getattr(want, f))
        if atol and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, rtol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def rot_angle(q1, q2):
    d = abs(float(np.dot(q1, q2))) / (np.linalg.norm(q1) * np.linalg.norm(q2))
    return 2 * np.arccos(min(1.0, d))


def gumbel_top_k(key, valid, n_hyp, size):
    """The reference's in-solver draw (pnp.py:110-116, sim3_solver.py:120-126)."""
    keys = jax.random.split(key, n_hyp)

    def sample(k):
        g = jax.random.gumbel(k, (valid.shape[0],)) + jnp.where(valid, 0.0, -1e9)
        return jax.lax.top_k(g, size)[1]

    return torch.from_numpy(np.asarray(jax.vmap(sample)(keys)).astype(np.int64))


@pytest.fixture(scope="module")
def fixture_map():
    jm, _, _ = jsnap.load_map(FIXTURE)
    return jm, snapshot.load_map(FIXTURE, CPU)[0]


# ---------------------------------------------------------------------------
# The map's loop-closing helpers
# ---------------------------------------------------------------------------


def test_spanning_tree_parent(fixture_map):
    jm, m = fixture_map
    want = np.asarray(jms.spanning_tree_parent(jm))
    np.testing.assert_array_equal(ms.spanning_tree_parent(m).numpy(), want)
    assert (want >= 0).sum() == int(np.asarray(jm.kf_valid).sum()) - 1  # one root
    W = np.asarray(jms.covisibility(jm))
    np.testing.assert_array_equal(ms.spanning_tree_parent(m, torch.from_numpy(W.copy())).numpy(),
                                  np.asarray(jms.spanning_tree_parent(jm, jnp.asarray(W))))


def test_replace_point(fixture_map):
    jm, m = fixture_map
    obs = np.asarray(jm.kf_obs_point)
    used = np.unique(obs[obs >= 0])
    old, new = int(used[3]), int(used[40])
    assert_map_equal(ms.replace_point(m, old, new), jms.replace_point(jm, jnp.asarray(old), jnp.asarray(new)))
    assert not bool(ms.replace_point(m, torch.tensor(old), torch.tensor(new)).pt_valid[old])


@pytest.mark.parametrize("target,sources", [(1, (0, 2)), (3, (1, 2, 4))])
def test_fuse_into_keyframe(fixture_map, target, sources):
    jm, m = fixture_map
    kfs = np.flatnonzero(np.asarray(jm.kf_valid))
    tgt = int(kfs[target])
    cand = np.concatenate([np.asarray(jm.kf_obs_point)[int(kfs[s])] for s in sources])
    use = cand >= 0
    cand = np.maximum(cand, 0).astype(np.int32)
    want = jkops.fuse_into_keyframe(jcam.CameraModel(**camera_bench()._asdict()), jm, jnp.asarray(tgt),
                                    jnp.asarray(cand), jnp.asarray(use))
    got = keyframe_ops.fuse_into_keyframe(camera_bench(), m, torch.tensor(tgt), torch.from_numpy(cand),
                                          torch.from_numpy(use))
    assert_map_equal(got, want, ("kf_obs_point", "pt_valid", "pt_visible", "pt_found"))
    changed = (np.asarray(want.kf_obs_point) != np.asarray(jm.kf_obs_point)).sum()
    assert changed > 0  # the fuse claimed or merged something


def camera_bench():
    with np.load(FIXTURE) as z:
        import json

        return camera.CameraModel(**json.loads(str(z["meta"]))["camera"])


# ---------------------------------------------------------------------------
# verify_candidate and correct_loop on the reference's drifted map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drifted():
    rng = np.random.default_rng(42)
    jm, S_drift, poses_gt, n_pts = ref_scenario.build_drifted_map(rng)
    voc = jvoc.train_vocabulary(rng.integers(0, 2**32, (2000, 8), dtype=np.uint32), k=8, L=2)
    jdb = jkdb.empty_db(8, jm.kp_capacity, voc.n_words)
    for k in range(8):
        jdb = jkdb.add_keyframe(jdb, voc, jnp.asarray(k), jm.kf_kp_desc[k], jm.kf_kp_valid[k])
    return jm, jdb, to_port_map(jm), to_port_db(jdb), poses_gt


@pytest.fixture(scope="module")
def verified(drifted):
    jm, jdb, m, db, _ = drifted
    key = jax.random.PRNGKey(0)
    want = jlc.verify_candidate(ref_scenario.CAM, jm, jdb, jnp.asarray(7), jnp.asarray(0), key)
    draws = []

    def reference_draw(valid, n_hypotheses, generator):
        draws.append(n_hypotheses)
        return gumbel_top_k(key, jnp.asarray(valid.numpy()), n_hypotheses, 3)

    mp = pytest.MonkeyPatch()
    mp.setattr(sim3_solver, "sample_sim3", reference_draw)
    try:
        got = loop_closing.verify_candidate(camera.EUROC_CAM, m, db, 7, 0, torch.Generator())
    finally:
        mp.undo()
    assert draws == [128]
    return want, got


def test_verify_candidate_recovers_drift(verified):
    want, got = verified
    assert bool(got.ok) and bool(want.ok)
    assert int(got.n_bow) == int(want.n_bow)
    for f in ("n_ransac", "n_guided", "n_inliers"):
        w = int(getattr(want, f))
        assert abs(int(getattr(got, f)) - w) <= max(3, 0.02 * w), f
    S_t, S_j = got.S12.numpy(), np.asarray(want.S12)
    assert rot_angle(S_t[:4], S_j[:4]) < 1e-4
    np.testing.assert_allclose(S_t[4:], S_j[4:], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_cam", [False, True])
def test_correct_loop(drifted, verified, with_cam):
    """Given the reference's optimized graph, the port corrects the map as
    the reference does: the same essential-graph problem, the same point
    re-anchoring and write-back, and (with a camera) the same SearchAndFuse."""
    jm, _, m, _, poses_gt = drifted
    want_lm, _ = verified
    covis = jms.covisibility(jm)
    # The reference's essential-graph problem, built as correct_loop builds
    # it, and its optimized poses.
    S_cw = js3.from_se3(jm.kf_pose)
    ei, ej, meas, ev, w = jpg.build_essential_edges(covis, jms.spanning_tree_parent(jm, covis), jm.kf_valid,
                                                    jnp.asarray([0]), jnp.asarray([7]), jnp.ones(1, bool), S_cw)
    jp = jpg.PoseGraphProblem(S_cw.at[7].set(js3.compose(want_lm.S12, S_cw[0])), jnp.zeros(8, bool).at[0].set(True),
                              jm.kf_valid, ei, ej, meas.at[-1].set(want_lm.S12), ev, w)
    s_opt = np.asarray(jpg.optimize_pose_graph(jp, n_iters=20))
    problems = []

    def replay_opt(prob, n_iters=20):
        problems.append(prob)
        return torch.from_numpy(s_opt)

    cam_kw = {"cam": ref_scenario.CAM} if with_cam else {}
    want = jlc.correct_loop(jm, jnp.asarray(7), jnp.asarray(0), want_lm.S12, covis, **cam_kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(pose_graph, "optimize_pose_graph", replay_opt)
    try:
        got = loop_closing.correct_loop(m, 7, 0, torch.from_numpy(np.asarray(want_lm.S12)),
                                        torch.from_numpy(np.asarray(covis)),
                                        cam=camera.EUROC_CAM if with_cam else None)
    finally:
        mp.undo()
    (tp,) = problems
    for f in ("fixed", "vertex_valid", "edge_i", "edge_j", "edge_valid", "edge_weight"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    for f in ("poses", "edge_meas"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), atol=1e-5, err_msg=f)
    assert_map_equal(got, want, ("kf_pose", "pt_pos"), atol=1e-4)
    assert_map_equal(got, want, ("kf_obs_point", "pt_valid", "pt_visible", "pt_found"))
    if with_cam:
        np.testing.assert_allclose(got.pt_normal.numpy(), np.asarray(want.pt_normal), atol=1e-4)
    err = lambda mm: np.linalg.norm(ms.to_numpy(mm)["kf_pose"][7, 4:] - np.asarray(poses_gt[7])[4:])  # noqa: E731
    assert err(got) < 0.6 * err(m)


def test_loop_detector_streaks():
    rng = np.random.default_rng(5)
    groups = {c: set(rng.choice(20, 3, replace=False).tolist()) for c in range(20)}
    a, b = loop_closing.LoopDetector(), jlc.LoopDetector()
    for _ in range(12):
        cand = rng.choice(20, 6, replace=False)
        ok = rng.random(6) < 0.7
        row = lambda c: sorted(groups[c])  # noqa: E731
        assert a.update_streaks(cand, ok, row) == b.update_streaks(cand, ok, row)
        assert a.update(cand, ok, row) == b.update(cand, ok, row)
    a.reset()
    assert a.prev_groups == []


# ---------------------------------------------------------------------------
# Relocalization on the fixture's map
# ---------------------------------------------------------------------------


def test_relocalize_fused_on_the_fixture():
    import json

    with np.load(FIXTURE) as z:
        meta = json.loads(str(z["meta"]))
        img = z["frames"][0].astype(np.float32)
    jm, _, _ = jsnap.load_map(FIXTURE)
    m = snapshot.load_map(FIXTURE, CPU)[0]
    jcam_ = jcam.CameraModel(**meta["camera"])
    cam = camera.CameraModel(**meta["camera"])
    jv = jvoc.load_binary(jvoc.default_vocabulary_path())
    tv_ = voc_mod.load_binary(voc_mod.default_vocabulary_path(), CPU)
    jdb = jkdb.empty_db(jm.kf_capacity, jm.kp_capacity, jv.n_words)
    for k in np.flatnonzero(np.asarray(jm.kf_valid)):
        jdb = jkdb.add_keyframe(jdb, jv, jnp.asarray(int(k)), jm.kf_kp_desc[int(k)], jm.kf_kp_valid[int(k)])
    db = to_port_db(jdb)

    jf = jframe.make_frame(jnp.asarray(img), jcam_, jorb.OrbConfig(**meta["orb_config"]))
    frame = snapshot.frame_from_numpy({k: np.asarray(v) for k, v in jf._asdict().items()}, CPU)
    wj, _ = jvoc.quantize(jv, jf.desc, jf.valid)
    wt, _ = voc_mod.quantize(tv_, frame.desc, frame.valid)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    covis = np.asarray(jms.covisibility(jm))
    vj = jvoc.bow_vector(jv, wj)
    cj, oj = jkdb.detect_reloc_candidates(jdb, jnp.asarray(covis), vj, max_candidates=4)
    ct, ot = kdb.detect_reloc_candidates(db, ms.covisibility(m), voc_mod.bow_vector(tv_, wt), max_candidates=4)
    # The fixture's keyframes are all covisible, so every group score is the
    # same sum in another order: a documented tie, ranked by float32
    # round-off. The candidates agree up to it: same ok flags, and group
    # scores (recomputed in float64) equal to 1e-6 rank by rank.
    scores = np.asarray(jkdb.query_scores(jdb, vj)).astype(np.float64)
    grp = scores + ((covis > 15) * np.where(scores > 0, scores, 0.0)[None, :]).sum(1)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(grp[ct.numpy()], grp[np.asarray(cj)], atol=1e-6)
    assert bool(ot[0])
    # From here on both run on the reference's candidates.
    ct, ot = torch.from_numpy(np.asarray(cj)), torch.from_numpy(np.asarray(oj))

    key = jax.random.PRNGKey(3)
    want, want_view = jtrk.relocalize_fused(jcam_, jm, jdb.words, jf, wj, cj, oj, key)
    cand_keys = jax.random.split(key, 4)
    calls = []

    def reference_draw(valid, n_hypotheses, generator):
        calls.append(n_hypotheses)
        return gumbel_top_k(cand_keys[len(calls) - 1], jnp.asarray(valid.numpy()), n_hypotheses, pnp.MIN_SET)

    mp = pytest.MonkeyPatch()
    mp.setattr(pnp, "sample_pnp", reference_draw)
    try:
        got, view = tracking.relocalize_fused(cam, m, db.words, frame, wt, ct, ot, torch.Generator())
    finally:
        mp.undo()
    assert calls == [128] * 4
    assert bool(got.ok) == bool(want.ok) is True
    assert int(got.best_kf[0]) == int(want.best_kf)
    np.testing.assert_array_equal(view.ids.numpy(), np.asarray(want_view.ids))
    n_w = int(want.n_inliers)
    assert abs(int(got.n_inliers) - n_w) <= max(3, 0.02 * n_w)
    p, pw = got.pose.numpy(), np.asarray(want.pose)
    assert rot_angle(p[:4], pw[:4]) < 1e-3 and np.abs(p[4:] - pw[4:]).max() < 1e-3
    # The fixture's own tracked pose of this frame.
    with np.load(FIXTURE) as z:
        ref_pose = z["ref_pose"][0]
    assert rot_angle(p[:4], ref_pose[:4]) < 5e-3 and np.abs(p[4:] - ref_pose[4:]).max() < 5e-3
