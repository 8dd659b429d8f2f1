"""Parity of the PyTorch port's matching, pose optimizer and Good-Feature
selection with the JAX reference on the same numpy inputs.

Matching and selection make discrete choices, so they must agree exactly
(ties planted on purpose go to the lowest index on both sides). The pose
optimizer sums residuals in another order than XLA, so poses agree at
atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry import se3 as jse3
from gf_orb_slam_tpu.geometry.camera import CameraModel as JCam
from gf_orb_slam_tpu.gf import observability as jobs
from gf_orb_slam_tpu.gf import selection as jsel
from gf_orb_slam_tpu.ops import matching as jm
from gf_orb_slam_tpu.solvers import pose_opt as jpo
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel as TCam
from gf_orb_slam_tpu_torch.gf import observability as tobs
from gf_orb_slam_tpu_torch.gf import selection as tsel
from gf_orb_slam_tpu_torch.ops import matching as tm
from gf_orb_slam_tpu_torch.solvers import pose_opt as tpo

CAM = dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480)


def both(x):
    x = np.asarray(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def eq(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def planted_dist(rng, nq=40, nt=50):
    """Distances with many exact ties: small value range, repeated minima."""
    d = rng.integers(0, 12, size=(nq, nt)).astype(np.int32)
    d[0, [3, 7, 9]] = 0        # three-way tie for the best of row 0
    d[[4, 11], 5] = 0          # two queries tie for target 5
    mask = rng.random((nq, nt)) < 0.6
    mask[0, [3, 7, 9]] = True
    mask[[4, 11], 5] = True
    mask[13] = False           # a row with no candidate at all
    return d, mask


def test_masked_best2_and_mutual_with_ties(rng):
    d, mask = planted_dist(rng)
    dj, dt = both(d)
    mj, mt = both(mask)
    idx_j, best_j, sec_j = jm.masked_best2(dj, mj)
    idx_t, best_t, sec_t = tm.masked_best2(dt, mt)
    eq(idx_j, idx_t)
    eq(best_j, best_t)
    eq(sec_j, sec_t)
    assert int(idx_t[0]) == 3
    matched = best_t <= 6
    eq(jm.mutual_filter(dj, mj, idx_j, jnp.asarray(matched.numpy())), tm.mutual_filter(dt, mt, idx_t, matched))


@pytest.mark.parametrize("ratio,mutual", [(1.0, False), (0.8, True), (0.9, True)])
def test_match(rng, ratio, mutual):
    q = rng.integers(0, 2**32, size=(60, 8), dtype=np.uint32)
    t = np.concatenate([q[:30] ^ np.uint32(1 << 5), rng.integers(0, 2**32, size=(40, 8), dtype=np.uint32)])
    t[40] = t[0]  # duplicate target: a tie on distance
    mask = rng.random((60, 70)) < 0.7
    mask[:30, :30] |= np.eye(30, dtype=bool)
    mj, mt = both(mask)
    rj = jm.match(jnp.asarray(q), jnp.asarray(t), mj, max_dist=jm.TH_HIGH, ratio=ratio, mutual=mutual)
    rt = tm.match(torch.from_numpy(q.view(np.int32).copy()), torch.from_numpy(t.view(np.int32).copy()), mt,
                  max_dist=tm.TH_HIGH, ratio=ratio, mutual=mutual)
    eq(rj.idx, rt.idx)
    eq(rj.dist, rt.dist)
    eq(rj.matched, rt.matched)
    assert int(rt.matched.sum()) >= 10


def test_mask_builders(rng):
    uv_q = rng.uniform(0, 752, size=(80, 2)).astype(np.float32)
    uv_t = rng.uniform(0, 752, size=(90, 2)).astype(np.float32)
    uv_t[:10] = uv_q[:10] + 15.0  # exactly on the radius
    rad = rng.uniform(5, 40, size=80).astype(np.float32)
    rad[:10] = 15.0
    vq, vt = rng.random(80) < 0.9, rng.random(90) < 0.9
    oq = rng.integers(0, 8, 80).astype(np.int32)
    ot = rng.integers(0, 8, 90).astype(np.int32)
    args = [uv_q, vq, uv_t, ot, vt, rad, oq]
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a.copy()) for a in args]
    eq(jm.projection_mask(*jargs), tm.projection_mask(*targs))
    eq(jm.window_mask(jargs[0], jargs[2], 30.0, jargs[1], jargs[4]),
       tm.window_mask(targs[0], targs[2], 30.0, targs[1], targs[4]))


def pose_problem(rng, n=300, outliers=40):
    """Points in front of a camera, observations with noise and outliers,
    and an initial pose perturbed off the truth."""
    pose_true = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.1)))
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], 1).astype(np.float32)
    xw = np.asarray(jse3.transform_point(jse3.inverse(jnp.asarray(pose_true)), jnp.asarray(pts)))
    uv = np.stack([458 * pts[:, 0] / pts[:, 2] + 376, 458 * pts[:, 1] / pts[:, 2] + 240], 1)
    uv = uv + rng.normal(size=uv.shape) * 0.8
    uv[:outliers] += rng.uniform(-40, 40, size=(outliers, 2))
    pose0 = np.asarray(jse3.apply_left_update(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.02),
                                              jnp.asarray(pose_true)))
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    return pose_true, pose0, xw.astype(np.float32), uv.astype(np.float32), inv_s2, valid


def test_optimize_pose(rng):
    pose_true, *inputs = pose_problem(rng)
    jin = [jnp.asarray(a) for a in inputs]
    tin = [torch.from_numpy(np.asarray(a).copy()) for a in inputs]
    rj = jpo.optimize_pose(JCam(**CAM), *jin)
    rt = tpo.optimize_pose(TCam(**CAM), *tin)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.pose.numpy(), pose_true, atol=1e-2, rtol=0)
    inl_j, inl_t = np.asarray(rj.inliers), rt.inliers.numpy()
    assert (inl_j != inl_t).sum() <= 2  # only χ²-gate near-ties may flip
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert rt.n_inliers.dtype == torch.int32


def test_measurement_jacobians_and_whiten(rng):
    Xv = np.zeros(13, np.float32)
    Xv[0:3] = rng.normal(size=3) * 0.2
    q = rng.normal(size=4)
    q[0] += 4.0
    Xv[3:7] = q / np.linalg.norm(q)
    Xv[7:] = rng.normal(size=6) * 0.1
    pts = np.stack([rng.uniform(-4, 4, 200), rng.uniform(-3, 3, 200), rng.uniform(-2, 12, 200)], 1).astype(np.float32)
    xj, xt = both(Xv)
    pj, pt = both(pts)
    aj = jobs.measurement_jacobians(JCam(**CAM), xj, pj)
    at = tobs.measurement_jacobians(TCam(**CAM), xt, pt)
    eq(aj.visible, at.visible)
    vis = at.visible.numpy()
    for f in ("H13", "H47", "H", "uv"):
        a, b = np.asarray(getattr(aj, f))[vis], getattr(at, f).numpy()[vis]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3 * np.abs(a).max())
    s2 = (1.2 ** (2 * rng.integers(0, 8, 200))).astype(np.float32)
    np.testing.assert_allclose(tobs.whiten(at.H, torch.from_numpy(s2)).numpy(),
                               np.asarray(jobs.whiten(aj.H, jnp.asarray(s2))), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_logdet_eye_plus(rng, r):
    A = rng.normal(size=(64, r, r)).astype(np.float32)
    G = A @ A.transpose(0, 2, 1)
    gj, gt = both(G)
    np.testing.assert_allclose(tsel._logdet_eye_plus(gt).numpy(), np.asarray(jsel._logdet_eye_plus(gj)),
                               rtol=1e-5, atol=1e-5)


def gf_factors(rng, n=400):
    F = rng.normal(size=(n, 2, 7)).astype(np.float32) * rng.uniform(0.1, 3.0, size=(n, 1, 1)).astype(np.float32)
    valid = rng.random(n) < 0.8
    F[~valid] = 0.0
    prior_f = rng.normal(size=(30, 7)).astype(np.float32)
    return F, valid, (prior_f.T @ prior_f).astype(np.float32)


def prior_with_min_eigenvalue(rng, F, valid, lam_min):
    """An info prior whose seeded matrix (PRIOR_EPS·I + prior / s, s the
    factors' normalization) has smallest eigenvalue lam_min."""
    _, s = tsel.normalize_factors(torch.from_numpy(F), torch.from_numpy(valid))
    Q = np.linalg.qr(rng.normal(size=(7, 7)))[0]
    p = float(s) * (Q * np.asarray([lam_min - tsel.PRIOR_EPS, 0.5, 1, 2, 4, 8, 16])) @ Q.T
    return ((p + p.T) / 2).astype(np.float32)


@pytest.mark.parametrize("batch,with_prior", [(10, True), (1, True), (10, False), (10, -2e-5), (1, -2e-5),
                                              (10, 1e-3), (1, 1e-3)])
def test_greedy_maxlogdet_lowrank(rng, batch, with_prior):
    """with_prior: True a random PSD prior, False none, a number a prior
    whose seeded matrix has that smallest eigenvalue. The room path's prior
    is often indefinite within float32 round-off (its quaternion-scale
    direction is null); the reference's Cholesky then returns NaN and its
    greedy picks nothing, at batch 1 (argmax of NaN gains) and at batch 10
    alike, and the port must too."""
    F, valid, prior = gf_factors(rng)
    if isinstance(with_prior, float):
        prior = prior_with_min_eigenvalue(rng, F, valid, with_prior)
    fj, ft = both(F)
    vj, vt = both(valid)
    pj, pt = both(prior) if with_prior is not False else (None, None)
    sj = jsel.greedy_maxlogdet_lowrank(fj, vj, k=100, batch=batch, info_prior=pj)
    st = tsel.greedy_maxlogdet_lowrank(ft, vt, k=100, batch=batch, info_prior=pt)
    eq(sj.selected, st.selected)
    n = 0 if isinstance(with_prior, float) and with_prior < 0 else 100
    assert int(st.n_selected) == int(sj.n_selected) == n
    np.testing.assert_allclose(float(st.logdet), float(sj.logdet), rtol=1e-4)
    np.testing.assert_allclose(st.info_total.numpy(), np.asarray(sj.info_total), rtol=1e-3,
                               atol=1e-3 * float(np.abs(np.asarray(sj.info_total)).max()))


def test_normalize_factors(rng):
    F, valid, _ = gf_factors(rng, 50)
    fj, ft = both(F)
    vj, vt = both(valid)
    (aj, sj), (at, st) = jsel.normalize_factors(fj, vj), tsel.normalize_factors(ft, vt)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
