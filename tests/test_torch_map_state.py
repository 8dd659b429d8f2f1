"""The write side of the port's MapState against the JAX reference, on the
tracking fixture's map (the reference's map after 120 bench frames: 14
keyframe slots, 5 valid) with seeded inputs. Integers and bools must be
equal; floats agree to atol 1e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.mapping import map_state as jms
from gf_orb_slam_tpu_torch.io_utils import snapshot
from gf_orb_slam_tpu_torch.mapping import map_state as ms

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
CPU = torch.device("cpu")
ATOL = 1e-5


@pytest.fixture(scope="module")
def maps():
    jm, _, _ = jsnap.load_map(FIXTURE)
    return snapshot.load_map(FIXTURE, CPU)[0], jm


def t(a):
    return snapshot.to_tensor(np.asarray(a), CPU)


def assert_map_close(m, jm, atol=ATOL):
    got = ms.to_numpy(m)
    for k in ms.MapState._fields:
        want = np.asarray(getattr(jm, k))
        g = got[k]
        assert g.shape == want.shape, k
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(g, want, atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, want, err_msg=k)


def test_empty_map_matches_reference():
    m = ms.empty_map(max_keyframes=8, max_points=64, max_kps=16, device=CPU)
    assert_map_close(m, jms.empty_map(max_keyframes=8, max_points=64, max_kps=16), atol=0)


def test_incidence_and_observation_counts(maps):
    m, jm = maps
    np.testing.assert_array_equal(ms.incidence(m).numpy(), np.asarray(jms.incidence(jm)))
    np.testing.assert_array_equal(ms.point_observation_count_raw(m).numpy(),
                                  np.asarray(jms.point_observation_count_raw(jm)))
    np.testing.assert_array_equal(ms.point_observation_count(m).numpy(),
                                  np.asarray(jms.point_observation_count(jm)))


def test_covisibility_row(maps):
    m, jm = maps
    for k in range(16):  # the 14 used slots (5 valid) and two empty ones
        want = np.asarray(jms.covisibility_row(jm, jnp.asarray(k)))
        np.testing.assert_array_equal(ms.covisibility_row(m, k).numpy(), want, err_msg=str(k))
        np.testing.assert_array_equal(ms.covisibility_row(m, torch.tensor(k, dtype=torch.int32)).numpy(), want)


@pytest.mark.parametrize("n", [1, 800, 1600])
def test_free_point_slots(maps, n):
    m, jm = maps
    np.testing.assert_array_equal(ms.free_point_slots(m, n).numpy(), np.asarray(jms.free_point_slots(jm, n)))


def test_add_keyframe(maps):
    m, jm = maps
    rng = np.random.default_rng(1)
    N = m.kp_capacity
    args = [
        np.concatenate([[1.0], rng.normal(0, 0.05, 3), rng.normal(0, 1, 3)]).astype(np.float32),
        (rng.random((N, 2)) * 700).astype(np.float32),
        rng.integers(0, 8, N).astype(np.int32),
        rng.random(N).astype(np.float32),
        rng.integers(0, 2**32, (N, 8), dtype=np.uint32),
        rng.random(N) < 0.8,
        np.where(rng.random(N) < 0.3, rng.integers(0, m.pt_capacity, N), -1).astype(np.int32),
    ]
    pose, rest = args[0], args[1:]
    m2, k = ms.add_keyframe(m, t(pose), 321, 16.25, *[t(a) for a in rest])
    jm2, jk = jms.add_keyframe(jm, jnp.asarray(pose), jnp.asarray(321), jnp.asarray(16.25, jnp.float32),
                               *[jnp.asarray(a) for a in rest])
    assert int(k) == int(jk) and k.dtype == torch.int32
    assert_map_close(m2, jm2, atol=0)
    assert int(m.n_kf) == int(jm.n_kf)  # the input map is left intact


@pytest.mark.parametrize("scalar_first_kf", [True, False])
def test_add_points(maps, scalar_first_kf):
    m, jm = maps
    rng = np.random.default_rng(2)
    M = 1600
    slots = np.asarray(jms.free_point_slots(jm, M))
    pos = rng.normal(0, 3, (M, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    normal = rng.normal(0, 1, (M, 3)).astype(np.float32)
    mind = rng.random(M).astype(np.float32)
    maxd = (mind + rng.random(M) * 10).astype(np.float32)
    use = rng.random(M) < 0.4
    first_kf = 7 if scalar_first_kf else rng.integers(0, 14, M).astype(np.int32)
    m2 = ms.add_points(m, t(slots), t(pos), t(desc), t(normal), t(mind), t(maxd),
                       first_kf if scalar_first_kf else t(first_kf), torch.tensor(99), t(use))
    jm2 = jms.add_points(jm, jnp.asarray(slots), jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(normal),
                         jnp.asarray(mind), jnp.asarray(maxd), jnp.asarray(first_kf), jnp.asarray(99),
                         jnp.asarray(use))
    assert_map_close(m2, jm2, atol=0)


def test_erase_points_and_keyframe(maps):
    m, jm = maps
    kill = np.random.default_rng(3).random(m.pt_capacity) < 0.3
    assert_map_close(ms.erase_points(m, t(kill)), jms.erase_points(jm, jnp.asarray(kill)), atol=0)
    k = int(np.flatnonzero(np.asarray(jm.kf_valid))[2])
    assert_map_close(ms.erase_keyframe(m, k), jms.erase_keyframe(jm, jnp.asarray(k)), atol=0)
    assert_map_close(ms.erase_keyframe(m, torch.tensor(k)), jms.erase_keyframe(jm, jnp.asarray(k)), atol=0)


def test_compact_keyframes(maps):
    m, jm = maps
    assert m.kf_capacity == 256 and int(m.n_kf) == 14 and int(m.kf_valid.sum()) == 5
    m2, perm, n_valid = ms.compact_keyframes(m)
    jm2, jperm, jn = jms.compact_keyframes(jm)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(n_valid) == int(jn) == 5
    assert_map_close(m2, jm2, atol=0)
    assert bool(m2.kf_valid[:5].all()) and not bool(m2.kf_valid[5:].any())


@pytest.mark.parametrize("update_desc", [True, False])
def test_refresh_point_stats(maps, update_desc):
    m, jm = maps
    # Move the points so the refresh has something to recompute.
    shift = np.random.default_rng(4).normal(0, 0.05, (m.pt_capacity, 3)).astype(np.float32)
    m = m._replace(pt_pos=m.pt_pos + t(shift))
    jm = jm._replace(pt_pos=jm.pt_pos + jnp.asarray(shift))
    got = ms.refresh_point_stats(m, scale=1.2, n_levels=8, update_desc=update_desc)
    want = jms.refresh_point_stats(jm, scale=1.2, n_levels=8, update_desc=update_desc)
    assert_map_close(got, want)


def test_last_wins_and_set_drop():
    idx = torch.tensor([3, 1, 3, 0, 1, 3, 5])
    valid = torch.tensor([True, True, True, False, True, False, True])
    # Writes 2 (to 3), 4 (to 1) and 6 (to the dropped index 5) win.
    assert ms.last_wins(idx, valid, 5).tolist() == [False, False, True, False, True, False, True]
    out = ms.set_drop(torch.zeros(5, dtype=torch.int32), torch.where(ms.last_wins(idx, valid, 5), idx, 5),
                      torch.arange(7))
    assert out.tolist() == [0, 4, 0, 2, 0]
    want = jnp.zeros(5, jnp.int32).at[jnp.where(jnp.asarray(valid.numpy()), jnp.asarray(idx.numpy()), 5)].set(
        jnp.arange(7), mode="drop")
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
