"""The port's two-view bootstrap and its linear algebra against the JAX
reference. Eigenvectors are compared up to sign (backends differ in it);
`initialize_two_view` runs on the reference's recorded initialization pair
with the reference's own hypothesis samples injected (system fixture,
tools/make_torch_system_fixture.py), and is held to its recorded outputs:
the chosen motion within 1e-3 rad and 1e-3 in translation direction, ≥ 99%
agreement on which points triangulate, points within 1e-3 relative at the
median and 2.5e-3 at the farthest (see the test)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry import linalg as jlinalg
from gf_orb_slam_tpu.solvers import initializer as jinit
from gf_orb_slam_tpu_torch.geometry import linalg
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.solvers import initializer

SYSTEM_FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data",
                              "system_fixture.npz")
CAM = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0)


@pytest.fixture(scope="module")
def fx():
    with np.load(SYSTEM_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def rot_err(q1, q2):
    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return 2.0 * np.arccos(min(1.0, d))


def test_inv3(rng):
    M = (rng.normal(0, 1, (64, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    M[0] = 0.0  # singular: the determinant is clamped to eps
    got = linalg.inv3(torch.from_numpy(M)).numpy()
    want = np.asarray(jlinalg.inv3(jnp.asarray(M)))
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0], want[0])


def test_normalize_points_2d(rng):
    pts = (rng.random((300, 2)) * [752, 480]).astype(np.float32)
    mask = rng.random(300) < 0.6
    n, T = linalg.normalize_points_2d(torch.from_numpy(pts), torch.from_numpy(mask))
    jn, jT = jlinalg.normalize_points_2d(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-5, rtol=0)


def test_smallest_eigvec_sym_up_to_sign(rng):
    Q, _ = np.linalg.qr(rng.normal(0, 1, (32, 9, 9)))
    ev = np.sort(rng.random((32, 9)) + np.arange(9), axis=-1)  # well-separated spectrum
    M = np.einsum("bij,bj,bkj->bik", Q, ev, Q).astype(np.float32)
    got = linalg.smallest_eigvec_sym(torch.from_numpy(M)).numpy()
    want = np.asarray(jlinalg.smallest_eigvec_sym(jnp.asarray(M)))
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=1e-5, rtol=0)


def test_triangulate_dlt(rng):
    K = np.asarray([[458.0, 0, 376.0], [0, 458.0, 240.0], [0, 0, 1]], np.float32)
    X = np.concatenate([rng.uniform(-3, 3, (200, 2)), rng.uniform(4, 12, (200, 1))], axis=1).astype(np.float32)
    R2 = np.asarray(jinit.quat.q2r(jnp.asarray([0.999, 0.02, -0.03, 0.01], jnp.float32)))
    R2 = R2 / np.linalg.norm(R2[0])
    P1 = K @ np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    P2 = K @ np.concatenate([R2, [[0.4], [0.05], [0.1]]], axis=1)

    def proj(P):
        x = np.concatenate([X, np.ones((200, 1))], axis=1) @ P.T
        return (x[:, :2] / x[:, 2:] + rng.normal(0, 0.3, (200, 2))).astype(np.float32)

    uv1, uv2 = proj(P1), proj(P2)
    P1, P2 = P1.astype(np.float32), P2.astype(np.float32)
    got = initializer.triangulate_dlt(*(torch.from_numpy(a) for a in (P1, P2, uv1, uv2))).numpy()
    want = np.asarray(jinit.triangulate_dlt(*(jnp.asarray(a) for a in (P1, P2, uv1, uv2))))
    # Relative to each point's distance: a coordinate near 0 would turn the
    # float32 noise of the 3×3 normal equations into a large ratio.
    err = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert err.max() <= 1e-4, err.max()


def test_initialize_two_view_on_recorded_pair(fx):
    i_ok = int(np.flatnonzero(fx["init_success"])[-1])
    args = [torch.from_numpy(fx[k]) for k in ("init_uv1", "init_uv2", "init_matched")]
    two = initializer.initialize_two_view(CAM, *args, torch.from_numpy(fx["init_samples"][i_ok]).long())
    assert bool(two.success) and bool(two.used_homography) == bool(fx["init_used_homography"][i_ok])
    p, rp = two.pose21.numpy(), fx["init_pose21"]
    assert rot_err(p[:4], rp[:4]) <= 1e-3
    assert np.linalg.norm(p[4:] / np.linalg.norm(p[4:]) - rp[4:] / np.linalg.norm(rp[4:])) <= 1e-3
    tri, rtri = two.is_triangulated.numpy(), fx["init_is_triangulated"]
    assert (tri == rtri).mean() >= 0.99 and rtri.sum() >= 50
    both = tri & rtri
    X, rX = two.points3d.numpy()[both], fx["init_points3d"][both]
    err = np.linalg.norm(X - rX, axis=1) / np.linalg.norm(rX, axis=1)
    # Measured: median 1.5e-4, max 1.8e-3. The error of a triangulated point
    # grows with its depth over the baseline (up to 64 here), which turns the
    # motions' float32 differences (5e-7 rad) into ~1e-3 at the far points.
    assert np.median(err) <= 1e-3 and err.max() <= 2.5e-3, (np.median(err), err.max())
    assert int(two.n_good) == int(tri.sum())


def reference_two_view(uv1, uv2, matched, samples):
    """The reference's initialize_two_view body (unjitted) with its
    key-derived Gumbel draws replaced by scores that rank `samples` first."""
    import jax

    S, N = samples.shape[0], uv1.shape[0]
    scores = np.zeros((S, N), np.float32)
    scores[np.arange(S)[:, None], samples] = 1e6 - np.arange(8, dtype=np.float32)
    split, gumbel = jax.random.split, jax.random.gumbel
    jax.random.split = lambda key, n: jnp.arange(n)
    jax.random.gumbel = lambda k, shape: jnp.asarray(scores)[k]
    try:
        fn = jax.jit(jinit.initialize_two_view.__wrapped__, static_argnames=("cam", "n_hypotheses"))
        return fn(jinit.CameraModel(**CAM._asdict()), jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(matched),
                  jnp.asarray(0), n_hypotheses=S)
    finally:
        jax.random.split, jax.random.gumbel = split, gumbel


def test_recorded_samples_reproduce_the_reference_init(fx):
    i_ok = int(np.flatnonzero(fx["init_success"])[-1])
    ref = reference_two_view(fx["init_uv1"], fx["init_uv2"], fx["init_matched"], fx["init_samples"][i_ok])
    assert bool(ref.success)
    assert rot_err(np.asarray(ref.pose21)[:4], fx["init_pose21"][:4]) <= 1e-5
    np.testing.assert_array_equal(np.asarray(ref.is_triangulated), fx["init_is_triangulated"])


def test_initialize_two_view_thinned_matches(fx):
    """Half the recorded matches dropped: the port decides as the reference
    does on the same input and samples."""
    i_ok = int(np.flatnonzero(fx["init_success"])[-1])
    matched = fx["init_matched"].copy()
    keep = np.flatnonzero(matched)
    matched[keep[::2]] = False
    rng = np.random.default_rng(5)
    samples = np.stack([rng.choice(keep[1::2], 8, replace=False) for _ in range(200)]).astype(np.int32)
    uv1, uv2 = fx["init_uv1"], fx["init_uv2"]
    two = initializer.initialize_two_view(CAM, torch.from_numpy(uv1), torch.from_numpy(uv2),
                                          torch.from_numpy(matched), torch.from_numpy(samples).long())
    ref = reference_two_view(uv1, uv2, matched, samples)
    assert bool(two.success) == bool(ref.success)
    assert bool(two.used_homography) == bool(ref.used_homography)
    assert rot_err(two.pose21.numpy()[:4], np.asarray(ref.pose21)[:4]) <= 1e-3
    assert (two.is_triangulated.numpy() == np.asarray(ref.is_triangulated)).mean() >= 0.99


def test_sample_hypotheses(rng):
    matched = torch.from_numpy(rng.random(1600) < 0.1)
    g = torch.Generator().manual_seed(7)
    s = initializer.sample_hypotheses(matched, 200, g)
    assert s.shape == (200, 8)
    assert bool(matched[s].all())
    assert all(len(set(row.tolist())) == 8 for row in s)
    again = initializer.sample_hypotheses(matched, 200, torch.Generator().manual_seed(7))
    assert torch.equal(s, again)
    other = initializer.sample_hypotheses(matched, 200, torch.Generator().manual_seed(8))
    assert not torch.equal(s, other)
