"""The port's Schur bundle adjustment against the JAX reference: a seeded
synthetic problem (4 cameras, 200 points, 2 fixed cameras, 10% outliers)
and the reference's own initial BA problem from the bench run (system
fixture). Poses within 1e-4, points within 1e-3, obs_active agreement
≥ 99.5%, final cost within 1e-3 relative."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry.camera import CameraModel as JCam
from gf_orb_slam_tpu.solvers import local_ba as jba
from gf_orb_slam_tpu_torch.geometry import se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.solvers import local_ba

SYSTEM_FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data",
                              "system_fixture.npz")
CAM = dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0)


def synthetic_problem(seed=0, C=4, P=200, outlier_share=0.1):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-3, 3, (P, 2)), rng.uniform(4, 9, (P, 1))], axis=1).astype(np.float32)
    xi = np.zeros((C, 6), np.float32)
    xi[:, :3] = rng.normal(0, 0.5, (C, 3))
    xi[:, 3:] = rng.normal(0, 0.03, (C, 3))
    xi[0] = 0.0
    poses = se3.exp_se3(torch.from_numpy(xi))
    xc = se3.transform_point(poses[:, None, :], torch.from_numpy(X)[None])       # (C, P, 3)
    uv = torch.stack([xc[..., 0] / xc[..., 2] * 458.0 + 376.0, xc[..., 1] / xc[..., 2] * 458.0 + 240.0], -1)
    uv = uv.numpy() + rng.normal(0, 0.5, (C, P, 2)).astype(np.float32)
    outlier = rng.random((C, P)) < outlier_share
    uv[outlier] += rng.normal(0, 30, (int(outlier.sum()), 2)).astype(np.float32)
    obs_point = np.where(rng.random((C, P)) < 0.9, np.arange(P)[None], -1).astype(np.int32)
    octave = rng.integers(0, 3, (C, P))
    # Perturbed start for the free cameras and all points.
    dxi = np.zeros((C, 6), np.float32)
    dxi[2:] = rng.normal(0, [0.02, 0.02, 0.02, 0.004, 0.004, 0.004], (C - 2, 6))
    poses0 = se3.apply_left_update(torch.from_numpy(dxi), poses).numpy()
    return dict(
        poses=poses0, points=(X + rng.normal(0, 0.03, X.shape)).astype(np.float32),
        fixed=np.arange(C) < 2, point_valid=np.ones(P, bool), obs_uv=uv.astype(np.float32),
        obs_point=obs_point, obs_w=np.where(obs_point >= 0, 1.2 ** (-2 * octave), 0).astype(np.float32),
    )


def run_both(prob, iters):
    got = local_ba.bundle_adjust(CameraModel(**CAM), local_ba.BAProblem(**{k: torch.from_numpy(np.asarray(v))
                                                                            for k, v in prob.items()}),
                                 iters_stage1=iters[0], iters_stage2=iters[1])
    want = jba.bundle_adjust(JCam(**CAM), jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()}),
                             iters_stage1=iters[0], iters_stage2=iters[1])
    return got, want


def assert_ba_close(got, want, point_valid):
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-4, rtol=0)
    pv = np.asarray(point_valid)
    np.testing.assert_allclose(got.points.numpy()[pv], np.asarray(want.points)[pv], atol=1e-3, rtol=0)
    assert (got.obs_active.numpy() == np.asarray(want.obs_active)).mean() >= 0.995
    c, wc = float(got.cost), float(want.cost)
    assert abs(c - wc) <= 1e-3 * abs(wc), (c, wc)


def test_bundle_adjust_synthetic():
    prob = synthetic_problem()
    got, want = run_both(prob, (5, 10))
    assert_ba_close(got, want, prob["point_valid"])
    # The fixed cameras stay put; the outliers are classified out.
    np.testing.assert_array_equal(got.poses.numpy()[:2], prob["poses"][:2])
    assert got.obs_active.numpy().sum() < (prob["obs_point"] >= 0).sum()


def test_bundle_adjust_reference_init_problem():
    with np.load(SYSTEM_FIXTURE) as z:
        prob = {k[len("init_ba_"):]: z[k] for k in z.files if k.startswith("init_ba_")}
    iters = tuple(int(i) for i in prob.pop("iters"))
    assert iters == (8, 12) and prob["poses"].shape == (2, 7)
    got, want = run_both(prob, iters)
    assert_ba_close(got, want, prob["point_valid"])


@pytest.mark.parametrize("fixed", [[True, True, True], [True, True, False], [True, True, False, False]])
def test_lm_step_matches_reference(fixed):
    # Two fixed cameras fix the gauge (monocular scale included).
    prob = synthetic_problem(seed=1, C=len(fixed), P=60)
    prob["fixed"] = np.asarray(fixed)
    tp = local_ba.BAProblem(**{k: torch.from_numpy(np.asarray(v)) for k, v in prob.items()})
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    active = prob["obs_point"] >= 0
    dc, dp, cost = local_ba._lm_step(CameraModel(**CAM), tp, torch.from_numpy(active), torch.tensor(1e-4))
    jdc, jdp, jcost = jba._lm_step(JCam(**CAM), jp, jnp.asarray(active), jnp.asarray(1e-4, jnp.float32))
    # One undamped-ish step from a perturbed start: the steps of points whose
    # observations are mostly outliers are weakly determined (measured up to
    # 6.3e-5 apart on steps of ~1e-2); the BA's result is held tighter above.
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), atol=1e-4, rtol=1e-3)
    assert abs(float(cost) - float(jcost)) <= 1e-5 * abs(float(jcost))
