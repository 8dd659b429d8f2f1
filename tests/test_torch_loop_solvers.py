"""The port's loop-closing solvers against the JAX reference on the same
numpy inputs: Sim(3) algebra, Horn alignment, EPnP RANSAC and Sim3 RANSAC
with the reference's samples injected, OptimizeSim3, and the essential-graph
pose-graph optimization.

Tolerances (float32 throughout): Sim(3) algebra 1e-5 absolute; exp/log and
their forward-mode Jacobians 1e-4; Horn rotations 1e-5 as matrices (the
port takes Horn's quaternion method, the reference an SVD); refined PnP and
Sim3 poses 1e-4 (rotation 1e-4 rad), inlier counts within max(3, 2%) of the
reference's; the essential graph's edges exact, its measurements 1e-5; the
12-keyframe pose graph after 20 iterations 1e-3 (on measurements the
reference's tangents survive) or exact (where they overflow and the
reference rejects every step; see the last tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry import camera as jcam
from gf_orb_slam_tpu.geometry import quat as jquat
from gf_orb_slam_tpu.geometry import se3 as jse3
from gf_orb_slam_tpu.geometry import sim3 as js3
from gf_orb_slam_tpu.solvers import horn as jhorn
from gf_orb_slam_tpu.solvers import pnp as jpnp
from gf_orb_slam_tpu.solvers import pose_graph as jpg
from gf_orb_slam_tpu.solvers import sim3_solver as jsim3
from gf_orb_slam_tpu_torch.geometry import camera
from gf_orb_slam_tpu_torch.geometry import quat, se3
from gf_orb_slam_tpu_torch.geometry import sim3 as s3
from gf_orb_slam_tpu_torch.solvers import horn, pnp, pose_graph, sim3_solver

CAM = camera.EUROC_CAM._replace(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
JCAM = jcam.CameraModel(**CAM._asdict())


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def random_sim3(rng, batch=(), s_range=(0.5, 2.0)):
    q = rng.normal(size=batch + (4,)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.where(q[..., :1] < 0, -1.0, 1.0).astype(np.float32)
    tr = rng.normal(size=batch + (3,)).astype(np.float32)
    s = rng.uniform(*s_range, size=batch).astype(np.float32)
    return np.concatenate([q, tr, s[..., None]], axis=-1)


def rot_angle(q1, q2):
    d = np.abs(np.sum(q1 * q2, -1)) / (np.linalg.norm(q1, axis=-1) * np.linalg.norm(q2, axis=-1))
    return 2 * np.arccos(np.clip(d, 0, 1))


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------


def test_sim3_algebra(rng):
    A, B = random_sim3(rng, (16,)), random_sim3(rng, (16,))
    x = rng.normal(size=(16, 3)).astype(np.float32)
    for name, got, want in [
        ("compose", s3.compose(t(A), t(B)), js3.compose(A, B)),
        ("inverse", s3.inverse(t(A)), js3.inverse(A)),
        ("transform", s3.transform_point(t(A), t(x)), js3.transform_point(A, x)),
        ("to_se3", s3.to_se3(t(A)), js3.to_se3(A)),
        ("from_se3", s3.from_se3(s3.to_se3(t(A)), 1.5), js3.from_se3(js3.to_se3(A), 1.5)),
    ]:
        np.testing.assert_allclose(n(got), n(want), atol=1e-5, rtol=1e-5, err_msg=name)
    # Round trips.
    np.testing.assert_allclose(n(s3.transform_point(s3.inverse(t(A)), s3.transform_point(t(A), t(x)))), x, atol=1e-5)
    np.testing.assert_allclose(n(s3.compose(t(A), s3.inverse(t(A)))), np.broadcast_to(n(s3.identity()), (16, 8)),
                               atol=1e-5)
    # Composition is associative.
    C = random_sim3(rng, (16,))
    np.testing.assert_allclose(n(s3.compose(s3.compose(t(A), t(B)), t(C))),
                               n(s3.compose(t(A), s3.compose(t(B), t(C)))), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-9, 1e-3, 0.3, 1.5])
def test_sim3_exp_log(rng, scale):
    xi = (scale * rng.normal(size=(32, 7))).astype(np.float32)
    xi[:4, 3:6] = 0.0     # θ = 0 exactly
    xi[4:8, 6] = 0.0      # σ = 0 exactly
    S_t, S_j = s3.exp(t(xi)), js3.exp(jnp.asarray(xi))
    np.testing.assert_allclose(n(S_t), n(S_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(n(s3.log(S_t)), n(js3.log(S_j)), atol=1e-4, rtol=1e-4)
    if scale < 1.0:  # beyond π the rotation vector wraps
        np.testing.assert_allclose(n(s3.log(S_t)), xi, atol=1e-4, rtol=1e-3)
    S = random_sim3(rng, (8,))
    np.testing.assert_allclose(n(s3.exp(s3.log(t(S)))), S, atol=1e-4, rtol=1e-4)


def test_sim3_jacobians_at_zero_are_finite_and_match(rng):
    """Forward-mode Jacobians through exp/log at θ = σ = 0 exactly (the
    double-where guards)."""
    S = random_sim3(rng, (4,))
    for k in range(4):
        def f_t(xi, S_=t(S[k])):
            return s3.log(s3.compose(s3.exp(xi), S_))

        def f_j(xi, S_=jnp.asarray(S[k])):
            return js3.log(js3.compose(js3.exp(xi), S_))

        J_t = torch.func.jacfwd(f_t)(torch.zeros(7))
        J_j = jax.jacfwd(f_j)(jnp.zeros(7))
        assert torch.isfinite(J_t).all()
        np.testing.assert_allclose(n(J_t), n(J_j), atol=1e-4, rtol=1e-3)
    J0 = torch.func.jacfwd(s3.log)(s3.exp(torch.zeros(7)))
    assert torch.isfinite(J0).all()


# ---------------------------------------------------------------------------
# Horn alignment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_align(rng, with_scale):
    src = rng.normal(size=(64, 6, 3)).astype(np.float32)
    S = random_sim3(rng, (64,), s_range=(0.7, 1.4) if with_scale else (1.0, 1.0))
    dst = np.asarray(js3.transform_point(S[:, None, :], src)) + 0.01 * rng.normal(size=src.shape).astype(np.float32)
    w = rng.uniform(0, 1, (64, 6)).astype(np.float32)
    qj, tj, sj = jhorn.horn_align(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale=with_scale)
    qt, tt, st = horn.horn_align(t(src), t(dst), t(w), with_scale=with_scale)
    np.testing.assert_allclose(n(quat.q2r(qt)), n(jquat.q2r(qj)), atol=1e-5)
    np.testing.assert_allclose(n(tt), n(tj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(st), n(sj), atol=1e-5, rtol=1e-5)
    assert (n(qt)[:, 0] >= 0).all()
    # A reflection-only best fit: the reference's fix and the quaternion
    # method both return the best proper rotation.
    mirror = src[:4] * np.asarray([1, 1, -1], np.float32)
    qj, _, _ = jhorn.horn_align(jnp.asarray(src[:4]), jnp.asarray(mirror), jnp.ones((4, 6)))
    qt, _, _ = horn.horn_align(t(src[:4]), t(mirror), torch.ones(4, 6))
    np.testing.assert_allclose(n(quat.q2r(qt)), n(jquat.q2r(qj)), atol=1e-4)


# ---------------------------------------------------------------------------
# RANSAC solvers with the reference's samples
# ---------------------------------------------------------------------------


def reference_samples(key, valid, n_hyp, size):
    keys = jax.random.split(key, n_hyp)

    def sample(k):
        g = jax.random.gumbel(k, (valid.shape[0],)) + jnp.where(valid, 0.0, -1e9)
        return jax.lax.top_k(g, size)[1]

    return np.asarray(jax.vmap(sample)(keys)).astype(np.int64)


def pnp_scene(rng, N=240, outliers=0.3, noise=0.1):
    pose = np.concatenate([np.asarray(jquat.v2q(jnp.asarray([0.05, -0.1, 0.03]))), [0.2, -0.1, 0.3]]).astype(np.float32)
    xc = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(4, 12, N)], -1).astype(np.float32)
    pts_w = np.asarray(jse3.transform_point(jse3.inverse(jnp.asarray(pose)), xc))
    uv, _, _ = jcam.project(JCAM, jnp.asarray(xc))
    octave = rng.integers(0, 4, N)
    sigma2 = (1.2 ** (2 * octave)).astype(np.float32)
    uv = np.asarray(uv) + rng.normal(0, noise, (N, 2)).astype(np.float32) * np.sqrt(sigma2)[:, None]
    bad = rng.random(N) < outliers
    uv[bad] += rng.uniform(-80, 80, (int(bad.sum()), 2)).astype(np.float32)
    valid = rng.random(N) < 0.95
    return pose, pts_w.astype(np.float32), uv.astype(np.float32), sigma2, valid


def test_epnp_minimal_recovers_exact_pose(rng):
    pose, pts_w, _, _, _ = pnp_scene(rng, N=6)
    xc = np.asarray(jse3.transform_point(jnp.asarray(pose), pts_w))
    uv = np.asarray(jcam.project(JCAM, jnp.asarray(xc))[0])
    got = n(pnp.epnp_minimal(CAM, t(pts_w), t(uv)))
    want = np.asarray(jpnp._epnp_minimal(JCAM, jnp.asarray(pts_w), jnp.asarray(uv)))
    assert rot_angle(got[:4], pose[:4]) < 1e-3 and np.abs(got[4:] - pose[4:]).max() < 1e-2
    assert rot_angle(got[:4], want[:4]) < 1e-3 and np.abs(got[4:] - want[4:]).max() < 1e-2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_with_reference_samples(seed):
    """EPnP on a noisy minimal set depends on the control points, whose
    principal-axis signs differ between backends (LAPACK's eigh against the
    port's closed form); at 0.1 px of noise every clean hypothesis lands on
    the same pose, so the two RANSACs pick equivalent winners."""
    rng = np.random.default_rng(seed)
    pose, pts_w, uv, sigma2, valid = pnp_scene(rng)
    key = jax.random.PRNGKey(seed)
    samples = reference_samples(key, jnp.asarray(valid), 128, pnp.MIN_SET)
    want = jpnp.pnp_ransac(JCAM, jnp.asarray(pts_w), jnp.asarray(uv), jnp.asarray(sigma2), jnp.asarray(valid), key)
    got = pnp.pnp_ransac(CAM, t(pts_w), t(uv), t(sigma2), t(valid), t(samples))
    assert bool(got.ok) == bool(want.ok) is True
    n_w = int(want.n_inliers)
    assert abs(int(got.n_inliers) - n_w) <= max(3, 0.02 * n_w)
    assert rot_angle(n(got.pose)[:4], n(want.pose)[:4]) < 1e-4
    np.testing.assert_allclose(n(got.pose)[4:], n(want.pose)[4:], atol=1e-4)
    assert (n(got.inliers) == n(want.inliers)).mean() > 0.98


def test_sample_pnp_draws_valid_distinct_sets():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[::3] = True
    g = torch.Generator().manual_seed(0)
    s = pnp.sample_pnp(valid, 64, g)
    assert s.shape == (64, 6) and valid[s].all()
    assert all(len(set(row.tolist())) == 6 for row in s)
    s3_ = sim3_solver.sample_sim3(valid, 32, g)
    assert s3_.shape == (32, 3) and valid[s3_].all()


def sim3_scene(rng, N=200, outliers=0.3):
    S12 = random_sim3(rng, (), s_range=(0.8, 1.3))
    S12[4:7] *= 0.3
    x2 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(4, 9, N)], -1).astype(np.float32)
    x1 = np.array(js3.transform_point(jnp.asarray(S12)[None], x2))
    x1 += 0.02 * rng.normal(size=x1.shape).astype(np.float32)
    bad = rng.random(N) < outliers
    x1[bad] += rng.normal(0, 1.0, (int(bad.sum()), 3)).astype(np.float32)
    uv1 = np.asarray(jsim3._project(JCAM, jnp.asarray(x1))) + rng.normal(0, 0.5, (N, 2)).astype(np.float32)
    uv2 = np.asarray(jsim3._project(JCAM, jnp.asarray(x2))) + rng.normal(0, 0.5, (N, 2)).astype(np.float32)
    s1 = (1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32)
    s2 = (1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32)
    valid = rng.random(N) < 0.9
    return S12, x1.astype(np.float32), x2, uv1.astype(np.float32), uv2.astype(np.float32), s1, s2, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_sim3_ransac_with_reference_samples(seed):
    rng = np.random.default_rng(seed)
    S12, *args, valid = sim3_scene(rng)
    key = jax.random.PRNGKey(seed + 10)
    samples = reference_samples(key, jnp.asarray(valid), 128, 3)
    want = jsim3.solve_sim3_ransac(JCAM, *map(jnp.asarray, args), jnp.asarray(valid), key)
    got = sim3_solver.solve_sim3_ransac(CAM, *map(t, args), t(valid), t(samples))
    assert bool(got.ok) == bool(want.ok) is True
    n_w = int(want.n_inliers)
    assert abs(int(got.n_inliers) - n_w) <= max(3, 0.02 * n_w)
    assert rot_angle(n(got.S12)[:4], n(want.S12)[:4]) < 1e-4
    np.testing.assert_allclose(n(got.S12)[4:], n(want.S12)[4:], atol=1e-4, rtol=1e-4)
    assert abs(n(got.S12)[7] - S12[7]) < 0.02


def test_optimize_sim3(rng):
    S12, *args, valid = sim3_scene(rng, outliers=0.15)
    S0 = np.asarray(js3.compose(js3.exp(jnp.asarray([0.003, -0.004, 0.002, 0.002, 0.001, -0.002, 0.01])),
                                jnp.asarray(S12)))
    Sj, inl_j = jsim3.optimize_sim3(JCAM, jnp.asarray(S0), *map(jnp.asarray, args), jnp.asarray(valid))
    St, inl_t = sim3_solver.optimize_sim3(CAM, t(S0), *map(t, args), t(valid))
    assert rot_angle(n(St)[:4], n(Sj)[:4]) < 1e-4
    np.testing.assert_allclose(n(St)[4:], n(Sj)[4:], atol=1e-4, rtol=1e-4)
    assert abs(int(inl_t.sum()) - int(inl_j.sum())) <= max(3, 0.02 * int(inl_j.sum()))
    assert not np.allclose(n(St), S0)  # it moved


# ---------------------------------------------------------------------------
# Essential graph
# ---------------------------------------------------------------------------


def pose_graph_problem(rng, K=12):
    """A chain of K keyframe poses (SE3, unit scale, as the map's) with strong
    covisibility between neighbours, rotation and translation drift along
    the chain, and a loop edge from the last back to the first."""
    poses_gt = random_sim3(rng, (K,), s_range=(1.0, 1.0))
    covis = np.zeros((K, K), np.int32)
    for k in range(K - 1):
        covis[k, k + 1] = covis[k + 1, k] = int(rng.integers(80, 200))
    covis[2, 5] = covis[5, 2] = 150
    xi = 0.01 * np.arange(K)[:, None] * rng.normal(size=(K, 7)).astype(np.float32)
    xi[:, 6] = 0.0
    drift = np.asarray(js3.exp(jnp.asarray(xi)))
    poses = np.asarray(js3.compose(jnp.asarray(drift), jnp.asarray(poses_gt)))
    valid = np.ones(K, bool)
    valid[7] = False
    return poses_gt, poses, covis, valid


def test_build_essential_edges_exact(rng):
    _, poses, covis, valid = pose_graph_problem(rng)
    parent = np.asarray([-1] + list(range(11)), np.int32)
    parent[8] = 6
    li, lj, lv = np.asarray([0], np.int32), np.asarray([11], np.int32), np.ones(1, bool)
    want = jpg.build_essential_edges(jnp.asarray(covis), jnp.asarray(parent), jnp.asarray(valid), jnp.asarray(li),
                                     jnp.asarray(lj), jnp.asarray(lv), jnp.asarray(poses))
    got = pose_graph.build_essential_edges(t(covis), t(parent), t(valid), t(li), t(lj), t(lv), t(poses))
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 2:
            np.testing.assert_allclose(n(g), n(w), atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(n(g), n(w))
    assert int(n(got[3]).sum()) == 10 + 9 + 1  # tree + strong covisibility + loop


def essential_problem(rng, noisy_meas: bool):
    poses_gt, poses, covis, valid = pose_graph_problem(rng)
    K = poses.shape[0]
    parent = np.asarray([-1] + list(range(K - 1)), np.int32)
    li, lj = np.asarray([0], np.int32), np.asarray([K - 1], np.int32)
    ei, ej, meas, ev, w = jpg.build_essential_edges(jnp.asarray(covis), jnp.asarray(parent), jnp.asarray(valid),
                                                    jnp.asarray(li), jnp.asarray(lj), jnp.ones(1, bool),
                                                    jnp.asarray(poses))
    meas = np.array(meas)
    if noisy_meas:
        # Every measurement 0.01-0.05 rad off the current estimate: no
        # residual sits in the float32 window where exp's limits cancel.
        xi = rng.normal(size=(meas.shape[0], 7)).astype(np.float32) * 0.02
        xi[:, 3:6] += 0.01 * np.sign(xi[:, 3:6])
        xi[:, 6] = 0.0
        meas = np.array(js3.compose(js3.exp(jnp.asarray(xi)), jnp.asarray(meas)))
    # The loop edge measures the true relative pose with a 5% scale drift.
    meas[-1] = np.asarray(jpg.relative_sim3(jnp.asarray(poses_gt), 0, K - 1))
    meas[-1, 7] = 1.05
    fixed = np.zeros(K, bool)
    fixed[0] = True
    jprob = jpg.PoseGraphProblem(jnp.asarray(poses), jnp.asarray(fixed), jnp.asarray(valid), ei, ej,
                                 jnp.asarray(meas), ev, w)
    tprob = pose_graph.PoseGraphProblem(t(poses), t(fixed), t(valid), t(ei), t(ej), t(meas), t(ev), t(w))
    return poses, meas, jprob, tprob


def test_optimize_pose_graph_small(rng):
    poses, meas, jprob, tprob = essential_problem(rng, noisy_meas=True)
    K = poses.shape[0]
    want = np.asarray(jpg.optimize_pose_graph(jprob, n_iters=20))
    got = n(pose_graph.optimize_pose_graph(tprob, n_iters=20))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(got[7], poses[7])  # an invalid vertex stays
    np.testing.assert_array_equal(got[0], poses[0])  # the fixed one too
    err = lambda P: np.abs(np.asarray(jpg.relative_sim3(jnp.asarray(P), 0, K - 1)) - meas[-1]).max()  # noqa: E731
    assert err(got) < 0.5 * err(poses)


def test_reference_pose_graph_is_a_no_op_on_consistent_static_edges(rng):
    """Reference behaviour (ROADMAP C), mirrored: with measurements taken
    from the current poses (as correct_loop takes them), float32 round-off
    leaves some static residual rotations in the window where exp's limit
    formulas divide by a cube whose square flushes to zero; XLA's
    forward-mode tangents there are not finite, NaN·0 poisons the normal
    equations even from invalid edges, and every step is rejected. The port
    rejects the same steps (`pose_graph.reference_tangent_overflow`), so it
    returns the reference's poses exactly."""
    poses, meas, jprob, tprob = essential_problem(rng, noisy_meas=False)
    want = np.asarray(jpg.optimize_pose_graph(jprob, n_iters=5))
    got = n(pose_graph.optimize_pose_graph(tprob, n_iters=5))
    np.testing.assert_array_equal(want, poses)
    np.testing.assert_array_equal(got, want)


def test_reference_pose_graph_rejects_steps_once_a_masked_residual_overflows(rng):
    """The mirror inside the loop: no residual overflows at the input, the
    first step is accepted, and after it a masked edge's residual sits at
    θ = 2e-7, where the reference's tangents overflow. The reference then
    rejects every later step and returns its one-step poses; the port
    rejects them too. The band is narrow: the two sides' first steps agree
    to ~1e-6, so a residual put within that of the band's edge can part
    them; 2e-7 lies inside on both sides for 7 of seeds 0-7 and for this
    one, which the asserts on `overflow` below check."""
    poses, meas, jprob, tprob = essential_problem(rng, noisy_meas=True)
    one_step = n(pose_graph.optimize_pose_graph(tprob, n_iters=1))
    e = int(np.nonzero(~np.asarray(jprob.edge_valid))[0][0])
    ei, ej, meas = np.array(jprob.edge_i), np.array(jprob.edge_j), np.array(meas)
    ei[e], ej[e] = 2, 5
    xi = np.zeros(7, np.float32)
    xi[3] = 2e-7
    meas[e] = np.asarray(js3.compose(js3.exp(jnp.asarray(xi)), jpg.relative_sim3(jnp.asarray(one_step), 2, 5)))
    jprob2 = jprob._replace(edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej), edge_meas=jnp.asarray(meas))
    tprob2 = tprob._replace(edge_i=t(ei), edge_j=t(ej), edge_meas=t(meas))

    def overflow(P):
        return bool(pose_graph.reference_tangent_overflow(t(P), t(ei), t(ej), t(meas)).any())

    want = np.asarray(jpg.optimize_pose_graph(jprob2, n_iters=20))
    got = n(pose_graph.optimize_pose_graph(tprob2, n_iters=20))
    assert not overflow(poses) and overflow(want) and overflow(got)
    np.testing.assert_array_equal(got, one_step)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # Without the masked edge both go on: the rejection is what holds them.
    moved_on = np.asarray(jpg.optimize_pose_graph(jprob, n_iters=20))
    assert np.abs(moved_on - want).max() > 1e-3
    assert np.abs(one_step - poses).max() > 1e-2


def test_reference_exp_tangent_overflows_just_above_unit_scale():
    """Reference fault (ROADMAP C), not mirrored because it lives in XLA's
    tangent arithmetic, not in the formulas, which the port copies: for
    1e-7 < σ < ~1e-5 the θ→0 limit of sim3.exp cancels catastrophically in
    float32 and JAX's forward-mode tangents overflow to NaN (one such edge,
    valid or not, makes every pose-graph step non-finite and rejected);
    torch's stay finite. Map keyframe poses enter the graph at unit scale, so
    the system's static edges have σ = 0 exactly and avoid it."""
    S = np.asarray([1, 0, 0, 0, 0.3, -0.2, 0.1, np.nextafter(np.float32(1), np.float32(2))], np.float32)
    J_j = jax.jacfwd(lambda xi: js3.log(js3.compose(js3.exp(xi), jnp.asarray(S))))(jnp.zeros(7))
    J_t = torch.func.jacfwd(lambda xi: s3.log(s3.compose(s3.exp(xi), t(S))))(torch.zeros(7))
    assert not np.isfinite(np.asarray(J_j)).all()
    assert torch.isfinite(J_t).all()
