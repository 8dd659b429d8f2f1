"""Parity of the port's Good-Feature modes with the JAX reference, function by
function, on the same seeded numpy inputs: the quaternion product matrices,
the PWLS propagation and its F matrix (to 1e-5), the information and hybrid
blocks (1e-5 relative), block normalization (1e-6 relative), and every
selection variant. Selections are discrete choices and must pick the same
set: the randomized ones (lazier, auto, grouped) get the reference's own
Gumbel draws, made here with jax.random exactly as the JAX functions make
them, and logdets agree to 1e-4.

Rank-2 blocks (one observation's 2×7 Jacobian) leave the accumulated matrix
rank-deficient until four are in: there every candidate's logdet carries
five 1e-5 prior pivots whose float32 Cholesky round-off differs between two
LAPACK builds by more than the gaps between a lazier sample's few
candidates, so those picks are ranked by round-off on both sides (ROADMAP
C). Exact greedy and deletion are held on rank-2 blocks; the randomized
selections and active matching on full-rank blocks (rank 8), where every
decision is well-conditioned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry import pwls as jpwls
from gf_orb_slam_tpu.geometry import quat as jquat
from gf_orb_slam_tpu.gf import active_matching as jam
from gf_orb_slam_tpu.gf import observability as jobs
from gf_orb_slam_tpu.gf import selection as jsel
from gf_orb_slam_tpu_torch.geometry import pwls, quat
from gf_orb_slam_tpu_torch.gf import active_matching as am
from gf_orb_slam_tpu_torch.gf import observability as obs
from gf_orb_slam_tpu_torch.gf import selection as sel
from gf_orb_slam_tpu_torch.pipeline import tracking


def both(x):
    x = np.asarray(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def state(rng, w_scale=0.3):
    Xv = np.zeros(13, np.float32)
    Xv[0:3] = rng.normal(size=3) * 0.5
    Xv[3:7] = unit_quats(rng, 1)[0]
    Xv[7:10] = rng.normal(size=3) * 0.2
    Xv[10:13] = rng.normal(size=3) * w_scale
    return Xv


# ---------------------------------------------------------------------------
# Geometry: quaternion product matrices, PWLS kinematics
# ---------------------------------------------------------------------------


def test_prod_matrices(rng):
    q, p = unit_quats(rng, 16), unit_quats(rng, 16)
    (qj, qt), (pj, pt) = both(q), both(p)
    close(quat.left_prod_matrix(qt), jquat.left_prod_matrix(qj))
    close(quat.right_prod_matrix(qt), jquat.right_prod_matrix(qj))
    # The defining identities: q⊗p = L(q)p = Rm(p)q.
    close((quat.left_prod_matrix(qt) @ pt[..., None])[..., 0], jquat.qprod(qj, pj))
    close((quat.right_prod_matrix(pt) @ qt[..., None])[..., 0], jquat.qprod(qj, pj))


@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
def test_slerp(rng, t):
    q0, q1 = unit_quats(rng, 8), unit_quats(rng, 8)
    q1[0] = q0[0]  # parallel: the linear branch
    (aj, at), (bj, bt) = both(q0), both(q1)
    close(quat.slerp(at, bt, t), jquat.slerp(aj, bj, t))


@pytest.mark.parametrize("w", ["random", "zero", "tiny"])
def test_dq_dt_by_domega(rng, w):
    ws = rng.normal(size=(8, 3)).astype(np.float32) * 2.0
    if w == "zero":
        ws[:] = 0.0
    elif w == "tiny":
        ws *= 1e-8  # below the 1e-6 ω→0 switch
    (wj, wt) = both(ws)
    for dt in (0.05, 0.5):
        got = pwls.dq_dt_by_domega(wt, dt)
        assert got.shape == (8, 4, 3)
        close(got, jpwls.dq_dt_by_domega(wj, jnp.asarray(dt)))
    if w == "zero":
        want = np.zeros((4, 3), np.float32)
        want[1:] = 0.05 / 2 * np.eye(3)
        close(pwls.dq_dt_by_domega(wt, 0.05)[0], want)


@pytest.mark.parametrize("w_scale", [0.0, 0.3, 2.0])
def test_f_matrix(rng, w_scale):
    Xv = state(rng, w_scale)
    xj, xt = both(Xv)
    close(pwls.f_matrix(xt, 0.05), jpwls.f_matrix(xj, jnp.asarray(0.05)))
    # A device-tensor dt and a batch of states.
    X2 = np.stack([state(rng, w_scale) for _ in range(3)])
    dts = np.asarray([0.05, 0.1, 0.02], np.float32)
    (x2j, x2t), (dj, dt_t) = both(X2), both(dts)
    close(pwls.f_matrix(x2t, dt_t), jpwls.f_matrix(x2j, dj))


def test_propagate_and_pose_from_state(rng):
    X = np.stack([state(rng) for _ in range(4)])
    X[:, 3:7] *= 1.1  # not unit: the normalizing and the raw step differ
    xj, xt = both(X)
    close(pwls.propagate(xt, 0.05), jpwls.propagate(xj, 0.05))
    close(pwls.propagate_unnormalized(xt, 0.05), jpwls.propagate_unnormalized(xj, 0.05))
    close(pwls.pose_cw_from_state(xt), jpwls.pose_cw_from_state(xj))
    # F is the Jacobian of the unnormalized step.
    x0 = torch.from_numpy(state(rng)).double()
    jac = torch.autograd.functional.jacobian(lambda x: pwls.propagate_unnormalized(x, 0.05), x0)
    np.testing.assert_allclose(pwls.f_matrix(x0, 0.05).numpy(), jac.numpy(), atol=1e-9)


# ---------------------------------------------------------------------------
# Observability blocks
# ---------------------------------------------------------------------------


def whitened_jacobians(rng, n=120):
    H = rng.normal(size=(n, 2, 7)).astype(np.float32) * rng.uniform(1.0, 300.0, size=(n, 1, 1)).astype(np.float32)
    visible = rng.random(n) < 0.8
    return H, visible


def rel_close(t, j, rtol=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


def test_info_and_hybrid_blocks(rng):
    H, vis = whitened_jacobians(rng)
    F = np.asarray(jpwls.f_matrix(jnp.asarray(state(rng)), jnp.asarray(0.05)))
    (hj, ht), (vj, vt), (fj, ft) = both(H), both(vis), both(F)
    rel_close(obs.info_matrices(ht, vt), jobs.info_matrices(hj, vj))
    fac = obs.hybrid_factors(ht, ft, vt)
    assert fac.shape == (120, 4, 13) and not fac[~vt].any()
    rel_close(fac, jobs.hybrid_factors(hj, fj, vj))
    rel_close(obs.hybrid_matrices(ht, ft, vt), jobs.hybrid_matrices(hj, fj, vj))


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


def make_blocks(rng, n=200, d=7, rank=2):
    """Information blocks FᵀF of (rank, d) factors over a wide scale range
    (as pixel Jacobians at different depths), about a fifth invalid."""
    Fa = rng.normal(size=(n, rank, d)).astype(np.float32) * rng.uniform(1.0, 300.0, size=(n, 1, 1)).astype(np.float32)
    valid = rng.random(n) < 0.8
    blocks = np.einsum("nri,nrj->nij", Fa, Fa).astype(np.float32)
    return blocks, valid


def assert_same_selection(st, sj, logdet=True):
    np.testing.assert_array_equal(st.selected.numpy(), np.asarray(sj.selected))
    assert int(st.n_selected) == int(sj.n_selected)
    if logdet:
        np.testing.assert_allclose(float(st.logdet), float(sj.logdet), rtol=1e-4, atol=1e-4)


def gumbel_rounds(key, rounds, n):
    """The Gumbel rows the reference draws inside its scan: one per split key."""
    return np.stack([np.asarray(jax.random.gumbel(k, (n,))) for k in jax.random.split(key, rounds)])


def test_normalize_blocks(rng):
    blocks, valid = make_blocks(rng, 60)
    (bj, bt), (vj, vt) = both(blocks), both(valid)
    (nj, sj), (nt, st) = jsel.normalize_blocks(bj, vj), sel.normalize_blocks(bt, vt)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6, atol=1e-6 * float(np.abs(np.asarray(nj)).max()))


@pytest.mark.parametrize("k", [4, 25])
def test_greedy_maxlogdet(rng, k):
    """k ≥ 4 rank-2 blocks span the 7 dimensions; below that the logdet is
    five 1e-5 prior pivots whose float32 round-off differs between any two
    Cholesky implementations (the picks still agree)."""
    blocks, valid = make_blocks(rng)
    (bj, bt), (vj, vt) = both(blocks), both(valid)
    st, sj = sel.greedy_maxlogdet(bt, vt, k), jsel.greedy_maxlogdet(bj, vj, k)
    assert_same_selection(st, sj)
    assert int(st.n_selected) == k


@pytest.mark.parametrize("k_remove", [10, 60])
def test_maxvol_deletion(rng, k_remove):
    blocks, valid = make_blocks(rng, 100)
    (bj, bt), (vj, vt) = both(blocks), both(valid)
    st, sj = sel.maxvol_deletion(bt, vt, k_remove), jsel.maxvol_deletion(bj, vj, k_remove)
    assert_same_selection(st, sj)
    assert int(st.n_selected) == int(valid.sum()) - k_remove


def test_maxvol_deletion_through_non_pd_remainders(rng):
    """Removing most of a rank-deficient pool leaves non-PD remainders: the
    −1e30 sentinel (keyed on cholesky_ex's info in the port, on NaN in the
    reference) must drive the same removals."""
    blocks, valid = make_blocks(rng, 12)
    valid[:] = True
    (bj, bt), (vj, vt) = both(blocks), both(valid)
    st, sj = sel.maxvol_deletion(bt, vt, 10), jsel.maxvol_deletion(bj, vj, 10)
    assert_same_selection(st, sj, logdet=False)


@pytest.mark.parametrize("batch", [1, 10])
def test_lazier_greedy_with_reference_draws(rng, batch):
    blocks, valid = make_blocks(rng, 300, rank=8)
    (bj, bt), (vj, vt) = both(blocks), both(valid)
    k, key = 40, jax.random.PRNGKey(11)
    _, rounds, _ = sel.lazier_sizes(300, k, batch=batch)
    g = torch.from_numpy(gumbel_rounds(key, rounds, 300))
    st = sel.lazier_greedy_maxlogdet(bt, vt, k, g, batch=batch)
    sj = jsel.lazier_greedy_maxlogdet(bj, vj, k=k, key=key, batch=batch)
    assert_same_selection(st, sj)
    assert int(st.n_selected) == k
    with pytest.raises(ValueError, match="gumbel has shape"):
        sel.lazier_greedy_maxlogdet(bt, vt, k, g[:-1], batch=batch)


@pytest.mark.parametrize("min_gain", [0.01, 0.8])
def test_auto_maxlogdet_with_reference_draws(rng, min_gain):
    blocks, valid = make_blocks(rng, 300, rank=8)
    (bj, bt), (vj, vt) = both(blocks), both(valid)
    k_max, key = 60, jax.random.PRNGKey(7)
    g = torch.from_numpy(gumbel_rounds(key, k_max, 300))
    st = sel.auto_maxlogdet(bt, vt, k_max, g, min_gain=min_gain)
    sj = jsel.auto_maxlogdet(bj, vj, k_max=k_max, key=key, min_gain=min_gain)
    assert_same_selection(st, sj)
    if min_gain == 0.8:
        assert 0 < int(st.n_selected) < k_max  # stopped on the gain floor


def test_grouped_lazier_greedy_with_reference_draws(rng):
    blocks, valid = make_blocks(rng, 203, rank=8)  # padded to 204: four shards of 51
    (bj, bt), (vj, vt) = both(blocks), both(valid)
    k, n_shards, key = 30, 4, jax.random.PRNGKey(3)
    shard = 51
    _, rounds, _ = sel.lazier_sizes(shard, -(-k // n_shards))
    g = np.stack([gumbel_rounds(kk, rounds, shard) for kk in jax.random.split(key, n_shards)])
    st = sel.grouped_lazier_greedy(bt, vt, k, torch.from_numpy(g), n_shards=n_shards)
    sj = jsel.grouped_lazier_greedy(bj, vj, k=k, key=key, n_shards=n_shards)
    assert_same_selection(st, sj)
    assert int(st.n_selected) == k


@pytest.mark.parametrize("budget,chunk,with_prior", [(40, 8, True), (100, 8, False), (21, 5, True)])
def test_active_match(rng, budget, chunk, with_prior):
    blocks, valid = make_blocks(rng, 300, rank=8)
    match_ok = rng.random(300) < 0.6
    match_kp = rng.permutation(800)[:300].astype(np.int32)
    prior_f = rng.normal(size=(30, 7)).astype(np.float32) * 50.0
    info = (prior_f.T @ prior_f).astype(np.float32) if with_prior else np.zeros((7, 7), np.float32)
    args = [both(a) for a in (blocks, valid, match_ok, match_kp, info)]
    rt = am.active_match(*(t for _, t in args), budget=budget, chunk=chunk)
    rj = jam.active_match(*(j for j, _ in args), budget=budget, chunk=chunk)
    np.testing.assert_array_equal(rt.matched.numpy(), np.asarray(rj.matched))
    np.testing.assert_array_equal(rt.kp_of_point.numpy(), np.asarray(rj.kp_of_point))
    assert int(rt.n_attempted) == int(rj.n_attempted) and int(rt.n_matched) == int(rj.n_matched)
    assert rt.kp_of_point.dtype == torch.int32
    rel_close(rt.info_total, rj.info_total, rtol=1e-4)


def test_sample_gumbel_and_gf_noise():
    g = torch.Generator().manual_seed(0)
    x = sel.sample_gumbel(50, 4096, g)
    assert x.shape == (50, 4096) and torch.isfinite(x).all()
    # Standard Gumbel: mean γ ≈ 0.5772, variance π²/6.
    assert abs(float(x.mean()) - 0.5772) < 0.01 and abs(float(x.var()) - np.pi**2 / 6) < 0.03
    again = sel.sample_gumbel(50, 4096, torch.Generator().manual_seed(0))
    assert torch.equal(x, again)
    shapes = {m: tracking.gf_noise_shape(m, 4096, 100, 10) for m in tracking.GF_MODES}
    assert shapes == {"subset": None, "hybrid": None, "lazier": (10, 4096), "auto": (100, 4096),
                      "active": None, "random": (4096,), "longlive": None}
    for m, shape in shapes.items():
        n = tracking.sample_gf_noise(m, 4096, 100, 10, g)
        assert (n is None) if shape is None else (n.shape == shape and n.device == g.device)
    u = tracking.sample_gf_noise("random", 4096, 100, 10, g)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
