"""Parity of the PyTorch port's geometry (quat, se3, camera, pwls, linalg)
with the JAX reference on the same numpy inputs, at atol 1e-5 (float32
elementwise math; the two frameworks' sin/cos/atan2/sqrt differ by ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry import camera as jcam
from gf_orb_slam_tpu.geometry import linalg as jlinalg
from gf_orb_slam_tpu.geometry import pwls as jpwls
from gf_orb_slam_tpu.geometry import quat as jquat
from gf_orb_slam_tpu.geometry import se3 as jse3
from gf_orb_slam_tpu_torch.geometry import camera as tcam
from gf_orb_slam_tpu_torch.geometry import linalg as tlinalg
from gf_orb_slam_tpu_torch.geometry import pwls as tpwls
from gf_orb_slam_tpu_torch.geometry import quat as tquat
from gf_orb_slam_tpu_torch.geometry import se3 as tse3

ATOL = 1e-5


def both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def rand_quat(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def rand_pose(rng, n):
    return np.concatenate([rand_quat(rng, n), rng.normal(size=(n, 3))], axis=1).astype(np.float32)


@pytest.mark.parametrize("fn", ["qconj", "qnormalize", "q2r", "q2v"])
def test_quat_unary(rng, fn):
    qj, qt = both(rand_quat(rng, 64) * 1.7)
    close(getattr(jquat, fn)(qj), getattr(tquat, fn)(qt))


def test_quat_binary_and_v2q(rng):
    q1j, q1t = both(rand_quat(rng, 64))
    q2j, q2t = both(rand_quat(rng, 64))
    close(jquat.qprod(q1j, q2j), tquat.qprod(q1t, q2t))
    vj, vt = both(rng.normal(size=(64, 3)))
    close(jquat.rotate(q1j, vj), tquat.rotate(q1t, vt))
    close(jquat.dRq_a_dq(q1j, vj), tquat.dRq_a_dq(q1t, vt))
    # v2q across the small-angle branch.
    v = np.concatenate([rng.normal(size=(32, 3)), 1e-9 * rng.normal(size=(4, 3)), np.zeros((1, 3))])
    vj, vt = both(v)
    close(jquat.v2q(vj), tquat.v2q(vt))
    # Broadcast of one quaternion over many vectors, as transform_point uses it.
    close(jquat.rotate(q1j[0], vj), tquat.rotate(q1t[0], vt))


def test_se3(rng):
    p1j, p1t = both(rand_pose(rng, 32))
    p2j, p2t = both(rand_pose(rng, 32))
    close(jse3.compose(p1j, p2j), tse3.compose(p1t, p2t))
    close(jse3.inverse(p1j), tse3.inverse(p1t))
    xj, xt = both(rng.normal(size=(50, 3)))
    close(jse3.transform_point(p1j[3], xj), tse3.transform_point(p1t[3], xt))
    close(jse3.hat(xj), tse3.hat(xt))
    xi = np.concatenate([rng.normal(size=(16, 6)) * 0.3, 1e-9 * rng.normal(size=(2, 6))])
    xij, xit = both(xi)
    close(jse3.exp_se3(xij), tse3.exp_se3(xit))
    close(jse3.apply_left_update(xij[0], p1j[0]), tse3.apply_left_update(xit[0], p1t[0]))


@pytest.mark.parametrize("distorted", [False, True])
def test_camera(rng, distorted):
    kw = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480)
    if distorted:
        kw.update(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
    cj, ct = jcam.CameraModel(**kw), tcam.CameraModel(**kw)
    assert ct.has_distortion == cj.has_distortion
    uv = np.stack([rng.uniform(0, 752, 200), rng.uniform(0, 480, 200)], axis=1)
    uj, ut = both(uv)
    close(jcam.undistort_pixels(cj, uj), tcam.undistort_pixels(ct, ut), atol=1e-3)  # pixels
    close(jcam.pixel_to_normalized(cj, uj), tcam.pixel_to_normalized(ct, ut))
    close(jcam.undistort_normalized(cj, jcam.pixel_to_normalized(cj, uj)),
          tcam.undistort_normalized(ct, tcam.pixel_to_normalized(ct, ut)))
    xc = rng.normal(size=(200, 3)) + np.asarray([0.0, 0.0, 3.0])
    xc[:5, 2] = [-1.0, 0.0, 1e-8, -1e-8, 2.0]
    xj, xt = both(xc)
    for a, b in zip(jcam.project(cj, xj), tcam.project(ct, xt)):
        if b.dtype == torch.bool:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(tcam.projection_jacobian(ct, xt).numpy(),
                               np.asarray(jcam.projection_jacobian(cj, xj)), rtol=1e-5, atol=1e-3)


def test_pwls_state_from_pose_pair(rng):
    p0j, p0t = both(rand_pose(rng, 1)[0])
    xi = jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.02)  # one frame's motion
    p1j, p1t = both(jse3.apply_left_update(xi, p0j))
    j = jpwls.state_from_pose_pair(jnp.float32(0.0), p0j, jnp.float32(0.05), p1j)
    t = tpwls.state_from_pose_pair(torch.tensor(0.0), p0t, torch.tensor(0.05), p1t)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_logdet_psd_and_sentinel(rng):
    A = rng.normal(size=(16, 7, 7))
    M = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(7)).astype(np.float32)
    M[3] = -np.eye(7)                      # negative definite
    M[5] = np.diag([1, 1, 1, -1e-3, 1, 1, 1])  # indefinite
    mj, mt = both(M)
    j = np.asarray(jlinalg.logdet_psd(mj))
    t = tlinalg.logdet_psd(mt).numpy()
    assert j[3] == -1e30 and j[5] == -1e30
    np.testing.assert_array_equal(t[[3, 5]], np.float32([-1e30, -1e30]))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-4)


def test_solve_psd(rng):
    A = rng.normal(size=(8, 6, 6))
    M = (A @ A.transpose(0, 2, 1) + np.eye(6)).astype(np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    mj, mt = both(M)
    bj, bt = both(b)
    np.testing.assert_allclose(tlinalg.solve_psd(mt, bt).numpy(), np.asarray(jlinalg.solve_psd(mj, bj)),
                               rtol=1e-4, atol=1e-4)
