"""The port's room path held stage by stage against the JAX reference's own
room run (the radtan-distorted EuRoC camera, keyframe cadence 6, a loop
correction on a ~22-keyframe map): every stage is fed the reference's
inputs from gf_orb_slam_tpu_torch/data/room_fixture.npz
(tools/make_torch_room_fixture.py) and compared with the reference's
recorded output. Each test prints its agreement and its count of points
that differ.

Tolerances are the planes path's (tests/test_torch_local_mapping.py,
test_torch_local_ba.py, test_torch_tracking.py, test_torch_loop_closing.py):
* the insertion as a whole: kf_id and culled_kf equal, pt_valid agreement
  ≥ 99%, kf_obs_point agreement ≥ 98% over slots either side fills,
  keyframe poses within 1e-3, view ids ≥ 98%;
* each piece of it fed the reference's intermediate map: triangulation
  (points within 1e-3), point culling and the two-way fuse exact; the
  window BA poses 1e-4, points 1e-3, obs_active ≥ 99.5%, cost 1e-3
  relative; keyframe redundancy 1e-6;
* the tracking step: pose ≤ 1e-3 rad / 1e-3 map units, n_inliers within
  max(3, 2%), ok equal, obs_point agreement ≥ 95%, the GF selection's
  pick count equal;
* the GF selection on the room prior of frame 236, where the reference's
  selection picks no point: see test_room_gf_selection_at_a_null_prior;
* correct_loop, its essential graph the port's own: poses and points
  1e-4, observations and point flags exact; the predicate that mirrors the
  reference's rejected graph steps exact on every edge of the loop's graph;
* the Schur global BA (5 + 40 LM) of the reference's final map: keyframe
  ATE within 5% of the reference's solve.
"""

import json
import os

import numpy as np
import pytest
import torch

from gf_orb_slam_tpu_torch import run_slam
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.gf import selection
from gf_orb_slam_tpu_torch.io_utils import evaluation, map_delta, snapshot
from gf_orb_slam_tpu_torch.loop import loop_closing
from gf_orb_slam_tpu_torch.mapping import keyframe_ops
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.mapping.frame import FrameData
from gf_orb_slam_tpu_torch.pipeline import local_mapping, tracking
from gf_orb_slam_tpu_torch.solvers import local_ba, pose_graph

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "room_fixture.npz")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(str(arrays["meta"]))


def t(a) -> torch.Tensor:
    return snapshot.to_tensor(np.asarray(a), CPU)


def port_map(arrays, name) -> ms.MapState:
    return snapshot.map_state_from_numpy(map_delta.decode(arrays, name), CPU)


def diff_report(got: ms.MapState, want: dict) -> dict:
    return map_delta.agreement(ms.to_numpy(got), want)


def assert_piece_equal(got: ms.MapState, want: dict, atol: float, stage: str):
    """The planes pieces' tolerance: discrete state exact, positions atol."""
    rep = diff_report(got, want)
    print(stage, rep)
    assert rep["pt_valid"] == 1.0 and rep["kf_obs_point"] == 1.0 and rep["pt_pos"] <= atol, (
        f"{stage} on the reference's room inputs falls below the tolerance the planes path meets: {rep}")
    g = ms.to_numpy(got)
    for k in ("kf_valid", "pt_first_kf", "pt_first_frame", "pt_visible", "pt_found", "n_pt", "n_kf"):
        np.testing.assert_array_equal(g[k], want[k], err_msg=f"{stage}: {k}")


def camera(meta) -> CameraModel:
    return CameraModel(**meta["camera"])


# ---------------------------------------------------------------------------
# (a) the insertion, whole and piece by piece
# ---------------------------------------------------------------------------


def insertion_args(arrays):
    names = ("pose", "frame_id", "timestamp", "kp_uv", "kp_octave", "kp_angle", "kp_desc", "kp_valid", "obs_point")
    a = [arrays[f"ins_arg_{k}"] for k in names]
    return [t(a[0]), int(a[1]), float(a[2])] + [t(x) for x in a[3:]]


def test_room_insert_keyframe_fused(fx):
    arrays, meta = fx
    kw = dict(meta["insert_kw"], ba_iters=tuple(meta["insert_kw"]["ba_iters"]))
    got = local_mapping.insert_keyframe_fused(camera(meta), port_map(arrays, "ins_in"), *insertion_args(arrays),
                                              **kw)
    want = map_delta.decode(arrays, "ins_out")
    rep = diff_report(got.m, want)
    ids, wids = got.view.ids.numpy(), arrays["ins_view_ids"]
    P = want["pt_valid"].shape[0]
    either = (ids < P) | (wids < P)
    rep["view_ids"] = float(np.isin(ids[ids < P], wids[wids < P]).sum() / either.sum())
    print("insert_keyframe_fused", rep)
    assert int(got.kf_id) == int(arrays["ins_kf_id"]) and int(got.culled_kf) == int(arrays["ins_culled_kf"])
    assert rep["kf_valid_equal"]
    assert rep["pt_valid"] >= 0.99 and rep["kf_obs_point"] >= 0.98 and rep["kf_pose"] <= 1e-3, (
        f"the insertion on the reference's room inputs falls below the planes tolerance: {rep}")
    assert rep["view_ids"] >= 0.98, rep


def tri_input(arrays, i) -> str:
    """The map triangulation i was fed: the last earlier neighbour that
    triangulated (covisibility ≥ 10), else the keyframe just added."""
    name = "ins_add"
    for j in range(i):
        if arrays["ins_tri_w"][j] >= 10:
            name = f"ins_tri{j}_out"
    return name


@pytest.mark.parametrize("i", [0, 1, 2])
def test_room_triangulate_between(fx, i):
    arrays, meta = fx
    m = port_map(arrays, tri_input(arrays, i))
    got = keyframe_ops.triangulate_between(camera(meta), m, int(arrays["ins_kf_id"]), int(arrays["ins_tri_ids"][i]),
                                           int(arrays["ins_arg_frame_id"]))
    want = map_delta.decode(arrays, f"ins_tri{i}_out")
    print(f"triangulate_between {i}: neighbour {int(arrays['ins_tri_ids'][i])}, covisibility "
          f"{int(arrays['ins_tri_w'][i])}, new points {int(want['pt_valid'].sum() - m.pt_valid.sum())}")
    # New points come from float32 3×3 normal equations (the planes test's 1e-3).
    assert_piece_equal(got, want, 1e-3, f"triangulate_between {i}")


def test_room_cull_points(fx):
    arrays, _ = fx
    m = port_map(arrays, str(arrays["ins_cull_in"]))
    got = keyframe_ops.cull_points(m, int(arrays["ins_kf_id"]), n_obs=t(arrays["ins_n_obs"]))
    want = map_delta.decode(arrays, "ins_cull_out")
    print(f"cull_points: culled {int(m.pt_valid.sum() - want['pt_valid'].sum())}")
    assert_piece_equal(got, want, 0.0, "cull_points")


def test_room_fuse_points_into_keyframes(fx):
    arrays, meta = fx
    m = port_map(arrays, "ins_cull_out")
    got = keyframe_ops.fuse_points_into_keyframes(
        camera(meta), m, t(arrays["ins_fuse_targets"]), t(arrays["ins_fuse_t_ok"]), t(arrays["ins_fuse_cands"]),
        t(arrays["ins_fuse_uses"]), n_obs=t(arrays["ins_fuse_n_obs"]))
    want = map_delta.decode(arrays, "ins_fuse_out")
    print(f"fuse_points_into_keyframes: merged {int(m.pt_valid.sum() - want['pt_valid'].sum())}")
    assert_piece_equal(got, want, 0.0, "fuse_points_into_keyframes")


def test_room_window_bundle_adjust(fx):
    arrays, meta = fx
    prob = local_ba.BAProblem(**{f: t(arrays[f"ins_ba_{f}"]) for f in local_ba.BAProblem._fields})
    kw = meta["insert_kw"]["ba_iters"]
    got = local_ba.bundle_adjust(camera(meta), prob, iters_stage1=kw[0], iters_stage2=kw[1])
    pv = arrays["ins_ba_point_valid"]
    rep = {"poses": float(np.abs(got.poses.numpy() - arrays["ins_ba_out_poses"]).max()),
           "points": float(np.abs(got.points.numpy()[pv] - arrays["ins_ba_out_points"][pv]).max()),
           "obs_active": float((got.obs_active.numpy() == arrays["ins_ba_out_obs_active"]).mean()),
           "points_over_1e-3": int((np.abs(got.points.numpy()[pv] - arrays["ins_ba_out_points"][pv]).max(1) > 1e-3)
                                   .sum()),
           "cost": float(got.cost), "ref_cost": float(arrays["ins_ba_out_cost"])}
    print("window bundle_adjust", rep)
    assert rep["poses"] <= 1e-4 and rep["points"] <= 1e-3 and rep["obs_active"] >= 0.995, (
        f"the window BA on the reference's room problem falls below the planes tolerance: {rep}")
    assert abs(rep["cost"] - rep["ref_cost"]) <= 1e-3 * abs(rep["ref_cost"]), rep


def test_room_keyframe_redundancy(fx):
    arrays, _ = fx
    got = keyframe_ops.keyframe_redundancy(port_map(arrays, "ins_pre_cull"), rows=t(arrays["ins_red_rows"])).numpy()
    print("keyframe_redundancy", float(np.abs(got - arrays["ins_red"]).max()), "over 0.9:", int((got > 0.9).sum()))
    np.testing.assert_allclose(got, arrays["ins_red"], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# (b) the tracking step on the frames after it
# ---------------------------------------------------------------------------


def selection_inputs(arrays, meta, j, monkeypatch):
    """Step j of the fixture through the port: its result and the (factors,
    valid, info prior) of each GF selection call in it."""
    calls = []
    select = selection.greedy_maxlogdet_lowrank

    def recorded(factors, valid, k, batch=1, info_prior=None):
        res = select(factors, valid, k, batch=batch, info_prior=info_prior)
        calls.append((factors.numpy().copy(), valid.numpy().copy(), info_prior.numpy().copy(), int(res.n_selected)))
        return res

    monkeypatch.setattr(selection, "greedy_maxlogdet_lowrank", recorded)
    p = f"trk{j}_"
    m = port_map(arrays, f"trk{j}_map")
    view = snapshot.track_view_from_numpy(arrays, CPU, prefix=p + "view_")
    uv = t(arrays[p + "out_frame_uv"])
    frame = FrameData(uv=uv, uv_raw=uv, octave=t(arrays[p + "out_frame_octave"]),
                      angle=t(arrays[p + "out_frame_angle"]), desc=t(arrays[p + "out_frame_desc"]),
                      response=torch.zeros_like(uv[:, 0]), valid=t(arrays[p + "out_frame_valid"]))
    state = [t(arrays[p + k]) for k in ("last_pose", "last_obs", "last_uv", "velocity")]
    kw = meta["track_kw"]
    r = tracking.track_frame(camera(meta), m, view, frame, *state, float(arrays[p + "dt"]),
                             t(arrays[p + "key"].astype(np.int64)), scale=kw["scale"], n_levels=kw["n_levels"],
                             gf_budget=kw["gf_budget"], use_gf=kw["use_gf"], gf_mode=kw["gf_mode"],
                             gf_batch=kw["gf_batch"])
    return r, calls


@pytest.mark.parametrize("j", [0, 1, 2])
def test_room_track_frame(fx, j, monkeypatch):
    arrays, meta = fx
    p = f"trk{j}_"
    r, calls = selection_inputs(arrays, meta, j, monkeypatch)
    pose, wpose = r.pose.numpy(), arrays[p + "out_pose"]
    o, wo = r.obs_point.numpy(), arrays[p + "out_obs_point"]
    either = (o >= 0) | (wo >= 0)
    d = abs(float(np.dot(pose[:4], wpose[:4]))) / (np.linalg.norm(pose[:4]) * np.linalg.norm(wpose[:4]))
    rep = {"frame": int(arrays[p + "frame"]), "rot_err_rad": float(2 * np.arccos(min(1.0, d))),
           "trans_err": float(np.linalg.norm(pose[4:] - wpose[4:])),
           "n_inliers": int(r.n_inliers), "ref_n_inliers": int(arrays[p + "out_n_inliers"]),
           "ok": bool(r.ok), "ref_ok": bool(arrays[p + "out_ok"]),
           "obs_point": float((o == wo)[either].mean()), "points_differ": int((o != wo).sum()),
           "gf_picks": [c[-1] for c in calls], "ref_gf_picks": int(arrays[p + "gf_picks"])}
    print("track_frame", rep)
    assert rep["gf_picks"] == [rep["ref_gf_picks"]], (
        f"the GF selection's pick count on the reference's room inputs differs from the reference's: {rep}")
    w = rep["ref_n_inliers"]
    assert rep["ok"] == rep["ref_ok"] and rep["rot_err_rad"] <= 1e-3 and rep["trans_err"] <= 1e-3, rep
    assert abs(rep["n_inliers"] - w) <= max(3, 0.02 * w) and rep["obs_point"] >= 0.95, (
        f"the step on the reference's room inputs falls below the planes tolerance: {rep}")


@pytest.mark.parametrize("batch", [1, 10])
@pytest.mark.parametrize("shift", [-1e-2, 1e-2])
def test_room_gf_selection_at_a_null_prior(fx, monkeypatch, batch, shift):
    """Frame 236 (fixture step 3), where the reference's GF selection picks
    no point. Its seeded info matrix (PRIOR_EPS·I + prior / s) has a null
    direction, the quaternion's scale, whose eigenvalue sits within float32
    round-off of zero: −3.5e-6 at one torch thread and −3.0e-5 at two,
    against a largest of ~1,081. Which round's Cholesky fails, if any, turns
    on summation order (the port picks 20 at one thread, 0 at two; the
    reference, fed the port's one-thread inputs, 50), so no test can hold
    the step there to the reference's. What is held: with that eigenvalue
    moved out of the round-off band (to `shift`), the port's selection on
    the room factors and prior picks what the reference's picks on the same
    inputs, none where the matrix is indefinite (the reference's Cholesky
    returns NaN; the port's partial factor used to pick 100) and 100 where
    it is definite."""
    import jax.numpy as jnp

    from gf_orb_slam_tpu.gf import selection as jsel

    arrays, meta = fx
    select = selection.greedy_maxlogdet_lowrank
    assert int(arrays["trk3_gf_picks"]) == 0 and int(arrays["trk3_frame"]) == 236
    _, calls = selection_inputs(arrays, meta, 3, monkeypatch)
    factors, valid, prior, _ = calls[0]
    _, s = selection.normalize_factors(t(factors), t(valid))
    lam, vec = np.linalg.eigh(selection.PRIOR_EPS * np.eye(7) + prior.astype(np.float64) / float(s))
    print("frame 236 seeded matrix eigenvalues", lam)
    assert abs(lam[0]) <= np.finfo(np.float32).eps * lam[-1], lam
    moved = (prior + float(s) * (shift - lam[0]) * np.outer(vec[:, 0], vec[:, 0])).astype(np.float32)
    moved = (moved + moved.T) / 2
    got = select(t(factors), t(valid), 100, batch=batch, info_prior=t(moved))
    want = jsel.greedy_maxlogdet_lowrank(jnp.asarray(factors), jnp.asarray(valid), 100, batch=batch,
                                         info_prior=jnp.asarray(moved))
    print("shift", shift, "batch", batch, "picks", int(got.n_selected), "reference", int(want.n_selected))
    assert int(got.n_selected) == int(want.n_selected) == (0 if shift < 0 else 100)
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(want.selected))


# ---------------------------------------------------------------------------
# (c) the loop correction, (d) global BA of the final map
# ---------------------------------------------------------------------------


def test_room_correct_loop(fx):
    arrays, meta = fx
    m = port_map(arrays, "loop_in")
    got = loop_closing.correct_loop(m, int(arrays["loop_query_kf"]), int(arrays["loop_loop_kf"]),
                                    t(arrays["loop_S12"]), t(arrays["loop_covis"]), cam=camera(meta))
    want = map_delta.decode(arrays, "loop_out")
    rep = diff_report(got, want)
    print("correct_loop", rep)
    assert rep["kf_pose"] <= 1e-4 and rep["pt_pos"] <= 1e-4, rep
    assert rep["pt_valid"] == 1.0 and rep["kf_obs_point"] == 1.0, (
        f"correct_loop on the reference's room inputs falls below the planes tolerance: {rep}")
    g = ms.to_numpy(got)
    for k in ("pt_visible", "pt_found"):
        np.testing.assert_array_equal(g[k], want[k], err_msg=k)


def reference_graph_problem(arrays) -> dict:
    """The essential-graph problem the reference's compiled correct_loop
    hands its optimizer on the fixture's loop, field → numpy. A stand-in
    optimizer records it and returns its input, which spares the 20 steps
    (the problem is bit for bit the one the real optimizer receives)."""
    import jax
    import jax.numpy as jnp

    from gf_orb_slam_tpu.loop import loop_closing as jlc
    from gf_orb_slam_tpu.mapping import map_state as jms
    from gf_orb_slam_tpu.solvers import pose_graph as jpg

    rec = {}

    def recording(prob, n_iters=20):
        jax.debug.callback(lambda *a: rec.update(zip(prob._fields, (np.asarray(x) for x in a))), *prob)
        return prob.poses

    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in map_delta.decode(arrays, "loop_in").items()})
    mp = pytest.MonkeyPatch()
    mp.setattr(jpg, "optimize_pose_graph", recording)
    try:
        fn = jax.jit(jlc.correct_loop.__wrapped__, static_argnames=("cam", "n_iters"))
        fn(jm, jnp.asarray(int(arrays["loop_query_kf"])), jnp.asarray(int(arrays["loop_loop_kf"])),
           jnp.asarray(arrays["loop_S12"]), jnp.asarray(arrays["loop_covis"]))
        jax.effects_barrier()
    finally:
        mp.undo()
    return rec


def reference_jacobian_finite(S_iw, S_jw, meas) -> np.ndarray:
    """(E,) bool: the reference's jacfwd of pose_graph._edge_residual at
    ξ = 0, compiled as its optimizer compiles it, finite per edge."""
    import jax
    import jax.numpy as jnp

    from gf_orb_slam_tpu.solvers import pose_graph as jpg

    z = jnp.zeros((S_iw.shape[0], 7))
    Ji, Jj = jax.jit(jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=(0, 1))))(
        z, z, jnp.asarray(S_iw), jnp.asarray(S_jw), jnp.asarray(meas))
    return np.isfinite(np.asarray(Ji)).all(axis=(1, 2)) & np.isfinite(np.asarray(Jj)).all(axis=(1, 2))


def test_reference_tangent_overflow_predicate(fx):
    """`pose_graph.reference_tangent_overflow` against the finiteness of the
    reference's forward-mode Jacobians: on a log-spaced float32 sweep of θ
    and σ (residual rotations about one axis, scales e^σ, either sign), and
    on every edge of the room fixture's loop as the reference's correct_loop
    builds it. Disagreements on the sweep must lie within 1% of the range's
    edge (a 1% step in θ or σ flips the predicate there) and are printed;
    on the fixture there must be none. Then the port's optimizer returns
    that problem's poses exactly, as the reference's does (it rejects all 20
    steps there; `loop_S_opt`, its output on an uncompiled replay of the
    same correction, is its input too)."""
    arrays, _ = fx
    axis = np.asarray([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    grid = np.concatenate([[0.0], np.logspace(-8.5, -5, 141)])

    def sim3_of(theta, sigma):
        q = np.concatenate([np.cos(theta / 2)[:, None], np.sin(theta / 2)[:, None] * axis], axis=1)
        tr = np.broadcast_to([0.3, -0.2, 0.1], (theta.shape[0], 3))
        return np.concatenate([q, tr, np.exp(sigma)[:, None]], axis=1).astype(np.float32)

    def predicate(theta, sigma):
        S = sim3_of(theta, sigma)
        eye = np.tile(np.asarray([1, 0, 0, 0, 0, 0, 0, 1], np.float32), (S.shape[0], 1))
        E = S.shape[0]
        return pose_graph.reference_tangent_overflow(t(np.concatenate([S, eye])), torch.arange(E),
                                                     torch.arange(E) + E, t(eye)).numpy(), S, eye

    th, sg = np.meshgrid(grid, np.concatenate([grid, -grid[1:]]), indexing="ij")
    th, sg = th.ravel(), sg.ravel()
    pred, S, eye = predicate(th, sg)
    prob = reference_graph_problem(arrays)
    P, E = prob["poses"], len(th)
    # One compiled Jacobian for the sweep and the loop's edges together.
    finite = reference_jacobian_finite(np.concatenate([S, P[prob["edge_i"]]]), np.concatenate([eye, P[prob["edge_j"]]]),
                                       np.concatenate([eye, prob["edge_meas"]]))
    finite, room_finite = finite[:E], finite[E:]
    off = np.flatnonzero(pred == finite)
    print(f"sweep: {len(th)} points, {int((~finite).sum())} with non-finite reference tangents, "
          f"{len(off)} disagreements", [(float(th[k]), float(sg[k])) for k in off[:20]])
    assert (~finite).sum() > 0
    near = np.zeros(len(off), bool)
    for f in (0.99, 1.01):
        near |= (predicate(th[off] * f, sg[off])[0] != pred[off]) | (predicate(th[off], sg[off] * f)[0] != pred[off])
    assert near.all(), "a disagreement away from the range's edge"

    pred = pose_graph.reference_tangent_overflow(t(P), t(prob["edge_i"]), t(prob["edge_j"]),
                                                 t(prob["edge_meas"])).numpy()
    print(f"room loop: {len(pred)} edges, {int((~room_finite).sum())} with non-finite reference tangents "
          f"({int((~room_finite & prob['edge_valid']).sum())} valid), {int((pred == room_finite).sum())} disagreements")
    assert len(pred) == 32897 and (~room_finite).sum() > 0
    np.testing.assert_array_equal(pred, ~room_finite)

    got = pose_graph.optimize_pose_graph(pose_graph.PoseGraphProblem(*(t(prob[k]) for k in prob)))
    np.testing.assert_array_equal(got.numpy(), P)


def test_room_global_bundle_adjust(fx):
    """The port's Schur global BA (5 + 40 LM) of the reference's final room
    map, built as SlamSystem.ba_problem builds it: keyframe ATE within 5% of
    the reference's own solve of the same map."""
    arrays, meta = fx
    m = port_map(arrays, "map")
    ids = arrays["final_kf_ids"].tolist()
    system = run_slam.SlamSystem(camera(meta), run_slam.room_config(), device="cpu")
    prob, _, _, _ = system.ba_problem(m, ids, fixed_ids=ids[:1])
    res = local_ba.bundle_adjust(camera(meta), prob, iters_stage1=5, iters_stage2=40)
    gt = arrays["final_kf_gt_centers"].astype(np.float64)

    def ate(poses):
        c = run_slam.camera_centers(poses).astype(np.float64)
        s, R, tt = evaluation.umeyama_alignment(c, gt)
        return float(np.sqrt((np.linalg.norm((s * (R @ c.T)).T + tt - gt, axis=1) ** 2).mean()))

    got, want = ate(res.poses.numpy()), float(arrays["final_schur_5_40_keyframe_ate_m"])
    print("global BA keyframe ATE", {"map": ate(prob.poses.numpy()), "port": got, "reference": want})
    np.testing.assert_allclose(ate(prob.poses.numpy()), float(arrays["final_keyframe_ate_m"]), rtol=1e-4)
    assert abs(got - want) <= 0.05 * want, (got, want)


