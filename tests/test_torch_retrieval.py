"""The port's BoW vocabulary and keyframe database against the JAX
reference (gf_orb_slam_tpu/retrieval), on the same numpy inputs.

Tolerances: training, quantization, word ids, database ids and masks,
candidate ids and their ok flags are exact; BoW vectors, tf-idf values and
scores agree to 1e-6 (float32 sums in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.mapping import map_state as jms
from gf_orb_slam_tpu.retrieval import keyframe_db as jkdb
from gf_orb_slam_tpu.retrieval import vocabulary as jvoc
from gf_orb_slam_tpu_torch.io_utils import snapshot
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
TOL = 1e-6


def t(a):
    return snapshot.to_tensor(np.asarray(a), CPU)


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def random_descs(rng, n_desc):
    return rng.integers(0, 2**32, (n_desc, 8), dtype=np.uint32)


def clustered_descs(rng, n_desc, n_centres=40, flips=20):
    """Descriptors around a few centres (a realistic, clumpy corpus)."""
    centres = random_descs(rng, n_centres)
    bits = np.unpackbits(centres[rng.integers(0, n_centres, n_desc)].view(np.uint8), axis=1)
    for row in bits:
        row[rng.choice(256, flips, replace=False)] ^= 1
    return np.packbits(bits, axis=1).view(np.uint32).reshape(n_desc, 8)


def port_voc(jv):
    opt = {f: t(getattr(jv, f)) for f in ("children", "word_of_node") if getattr(jv, f) is not None}
    return voc_mod.Vocabulary(centers=t(jv.centers), weights=t(jv.weights), k=jv.k, L=jv.L, **opt)


@pytest.fixture(scope="module")
def voc1m():
    path = voc_mod.default_vocabulary_path()
    assert path.endswith("vocab_1m.npz")
    return jvoc.load_binary(path), voc_mod.load_binary(path, CPU)


@pytest.fixture(scope="module")
def small_voc():
    corpus = clustered_descs(np.random.default_rng(3), 3000)
    return jvoc.train_vocabulary(corpus, k=8, L=2, seed=1)


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,L,n_desc", [(10, 3, 4000), (8, 2, 1500), (5, 3, 30)])
def test_train_vocabulary_bit_exact(k, L, n_desc):
    corpus = clustered_descs(np.random.default_rng(k * 10 + L), n_desc)
    want = jvoc.train_vocabulary(corpus, k=k, L=L, seed=7)
    got = voc_mod.train_vocabulary(corpus, k=k, L=L, seed=7, device=CPU)
    np.testing.assert_array_equal(n(got.centers).view(np.uint32), np.asarray(want.centers))
    np.testing.assert_array_equal(n(got.weights), np.asarray(want.weights))
    assert got.n_words == want.n_words and got.first_leaf() == want.first_leaf()


def test_quantize_implicit_tree(small_voc, rng):
    descs = random_descs(rng, 700)
    valid = rng.random(700) < 0.9
    w_j, m_j = jvoc.quantize(small_voc, jnp.asarray(descs), jnp.asarray(valid))
    w_t, m_t = voc_mod.quantize(port_voc(small_voc), t(descs), t(valid))
    np.testing.assert_array_equal(n(w_t), np.asarray(w_j))
    np.testing.assert_array_equal(n(m_t), np.asarray(m_j))


def explicit_incomplete_tree(rng, k=4):
    """A DBoW2-style explicit tree: nodes with fewer than k children (rows
    padded with the first child), leaves at levels 1, 2 and 3, words in
    creation order."""
    children, parents, is_leaf = [[]], [], []
    frontier = [(0, 0)]
    while frontier:
        node, depth = frontier.pop(0)
        n_ch = int(rng.integers(2, k + 1))
        for _ in range(n_ch):
            cid = len(children)
            children.append([])
            children[node].append(cid)
            leaf = depth + 1 == 3 or rng.random() < 0.25
            is_leaf.append(leaf)
            if not leaf:
                frontier.append((cid, depth + 1))
    n_nodes = len(children)
    table = np.zeros((n_nodes, k), np.int32)
    word_of_node = np.full(n_nodes, -1, np.int32)
    n_words = 0
    for node in range(n_nodes):
        ch = children[node]
        table[node] = (ch + [ch[0]] * (k - len(ch))) if ch else [node] * k
        if node > 0 and is_leaf[node - 1]:
            word_of_node[node] = n_words
            n_words += 1
    centers = random_descs(rng, n_nodes)
    weights = rng.uniform(0.1, 3.0, n_words).astype(np.float32)
    return jvoc.Vocabulary(centers=jnp.asarray(centers), weights=jnp.asarray(weights), k=k, L=3,
                           children=jnp.asarray(table), word_of_node=jnp.asarray(word_of_node))


def test_quantize_explicit_incomplete_tree(rng):
    jv = explicit_incomplete_tree(rng)
    assert (np.asarray(jv.word_of_node) >= 0).sum() == jv.n_words
    descs = random_descs(rng, 500)
    valid = np.ones(500, bool)
    w_j, m_j = jvoc.quantize(jv, jnp.asarray(descs), jnp.asarray(valid))
    w_t, m_t = voc_mod.quantize(port_voc(jv), t(descs), t(valid))
    np.testing.assert_array_equal(n(w_t), np.asarray(w_j))
    np.testing.assert_array_equal(n(m_t), np.asarray(m_j))
    assert len(np.unique(np.asarray(w_j))) > 5  # the descent reaches leaves at several levels


def test_quantize_packaged_1m_tree(voc1m):
    jv, tv_ = voc1m
    assert (jv.k, jv.L, jv.n_words, tv_.n_words) == (10, 6, 1_000_000, 1_000_000)
    assert tv_.centers.shape == (1_111_111, 8) and tv_.centers.dtype == torch.int32
    with np.load(FIXTURE) as z:
        kv = z["map_kf_kp_valid"]
        k = int(np.flatnonzero(kv.sum(1))[0])
        descs, valid = z["map_kf_kp_desc"][k][:800], kv[k][:800]
    w_j, m_j = jvoc.quantize(jv, jnp.asarray(descs), jnp.asarray(valid))
    w_t, m_t = voc_mod.quantize(tv_, t(descs), t(valid))
    np.testing.assert_array_equal(n(w_t), np.asarray(w_j))
    np.testing.assert_array_equal(n(m_t), np.asarray(m_j))
    v_j, v_t = jvoc.bow_vector(jv, w_j), voc_mod.bow_vector(tv_, w_t)
    np.testing.assert_allclose(n(v_t), np.asarray(v_j), atol=TOL, rtol=0)


def test_bow_vector_and_l1_score(small_voc, rng):
    tv_ = port_voc(small_voc)
    words = rng.integers(-1, small_voc.n_words, (5, 300)).astype(np.int32)
    vj = [jvoc.bow_vector(small_voc, jnp.asarray(w)) for w in words]
    vt = [voc_mod.bow_vector(tv_, t(w)) for w in words]
    for a, b in zip(vj, vt):
        np.testing.assert_allclose(n(b), np.asarray(a), atol=TOL, rtol=0)
        assert abs(float(b.abs().sum()) - 1.0) < 1e-5
    sj = jvoc.l1_score(vj[0], jnp.stack(vj[1:]))
    st = voc_mod.l1_score(vt[0], torch.stack(vt[1:]))
    np.testing.assert_allclose(n(st), np.asarray(sj), atol=TOL, rtol=0)


def test_load_vocabulary_and_default_path(voc1m, tmp_path):
    jv, _ = voc1m
    assert os.path.samefile(voc_mod.default_vocabulary_path(), jvoc.default_vocabulary_path())
    small = explicit_incomplete_tree(np.random.default_rng(0))
    jvoc.save_binary(str(tmp_path / "v.npz"), small)
    got = voc_mod.load_vocabulary(str(tmp_path / "v.npz"), CPU)
    for f in ("centers", "weights", "children", "word_of_node"):
        want = np.asarray(getattr(small, f))
        np.testing.assert_array_equal(n(getattr(got, f)).view(want.dtype), want)
    # '.txt' is the DBoW2 text format, read as the reference reads it.
    jvoc.save_dbow2_text(str(tmp_path / "v.txt"), small)
    got = voc_mod.load_vocabulary(str(tmp_path / "v.txt"), CPU)
    want_txt = jvoc.load_vocabulary(str(tmp_path / "v.txt"))
    for f in ("centers", "weights", "children", "word_of_node"):
        want = np.asarray(getattr(want_txt, f))
        np.testing.assert_array_equal(n(getattr(got, f)).view(want.dtype), want)


# ---------------------------------------------------------------------------
# Keyframe database
# ---------------------------------------------------------------------------


def assert_db_equal(got: kdb.BowDatabase, want: jkdb.BowDatabase):
    for f in ("bow_ids", "words", "mid_nodes", "valid"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(n(got.bow_vals), np.asarray(want.bow_vals), atol=TOL, rtol=0)


def revisit_database(rng, voc, K=12, N=96):
    """K keyframes; 0-3 and 8-11 view the same place (shared descriptors),
    4-7 view elsewhere; a covisibility matrix chaining neighbours."""
    place_a, place_b = clustered_descs(rng, N, n_centres=30, flips=4), clustered_descs(rng, N, n_centres=30, flips=4)
    descs = np.zeros((K, N, 8), np.uint32)
    valid = rng.random((K, N)) < 0.85
    for k in range(K):
        base = place_b if 4 <= k < 8 else place_a
        noisy = np.unpackbits(base.view(np.uint8), axis=1)
        noisy[rng.random(noisy.shape) < 0.01] ^= 1
        descs[k] = np.packbits(noisy, axis=1).view(np.uint32).reshape(N, 8)
    covis = np.zeros((K, K), np.int32)
    for k in range(K - 1):
        covis[k, k + 1] = covis[k + 1, k] = int(rng.integers(10, 60))
    jdb = jkdb.empty_db(K, N, voc.n_words)
    tdb = kdb.empty_db(K, N, voc.n_words, device=CPU)
    tv_ = port_voc(voc)
    for k in range(K):
        jdb = jkdb.add_keyframe(jdb, voc, jnp.asarray(k), jnp.asarray(descs[k]), jnp.asarray(valid[k]))
        tdb = kdb.add_keyframe(tdb, tv_, torch.tensor(k), t(descs[k]), t(valid[k]))
    return jdb, tdb, covis, descs, valid


def test_add_erase_permute(small_voc, rng):
    jdb, tdb, _, _, _ = revisit_database(rng, small_voc)
    assert_db_equal(tdb, jdb)
    assert kdb.empty_db(3, 5, 64).bow_ids.eq(64).all()
    jdb, tdb = jkdb.erase_keyframe(jdb, jnp.asarray(5)), kdb.erase_keyframe(tdb, 5)
    assert_db_equal(tdb, jdb)
    perm = rng.permutation(12).astype(np.int32)
    assert_db_equal(kdb.permute(tdb, t(perm)), jkdb.permute(jdb, jnp.asarray(perm)))


def test_query_scores(small_voc, rng):
    jdb, tdb, _, descs, valid = revisit_database(rng, small_voc)
    jdb, tdb = jkdb.erase_keyframe(jdb, jnp.asarray(2)), kdb.erase_keyframe(tdb, 2)
    w, _ = jvoc.quantize(small_voc, jnp.asarray(descs[9]), jnp.asarray(valid[9]))
    v = jvoc.bow_vector(small_voc, w)
    want = jkdb.query_scores(jdb, v)
    got = kdb.query_scores(tdb, t(v))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=TOL, rtol=0)
    assert n(got)[2] == -1.0 and n(got)[8] > n(got)[5]


@pytest.mark.parametrize("query,exclude", [(11, -1), (10, 1), (6, -1), (0, 3)])
def test_detect_loop_candidates(small_voc, rng, query, exclude):
    jdb, tdb, covis, _, _ = revisit_database(rng, small_voc)
    cj, oj = jkdb.detect_loop_candidates(jdb, jnp.asarray(covis), jnp.asarray(query), max_candidates=6,
                                         exclude_kf=exclude, n_words=small_voc.n_words)
    ct, ot = kdb.detect_loop_candidates(tdb, t(covis), torch.tensor(query), max_candidates=6,
                                        exclude_kf=torch.tensor(exclude), n_words=small_voc.n_words)
    np.testing.assert_array_equal(n(ot), np.asarray(oj))
    np.testing.assert_array_equal(n(ct), np.asarray(cj))
    if query >= 8:
        assert n(ot).any()  # the revisit is found


@pytest.mark.parametrize("kf", [9, 5])
def test_detect_reloc_candidates(small_voc, rng, kf):
    jdb, tdb, covis, descs, valid = revisit_database(rng, small_voc)
    w, _ = jvoc.quantize(small_voc, jnp.asarray(descs[kf]), jnp.asarray(valid[kf]))
    v = jvoc.bow_vector(small_voc, w)
    cj, oj = jkdb.detect_reloc_candidates(jdb, jnp.asarray(covis), v, max_candidates=4)
    ct, ot = kdb.detect_reloc_candidates(tdb, t(covis), t(v), max_candidates=4)
    np.testing.assert_array_equal(n(ot), np.asarray(oj))
    np.testing.assert_array_equal(n(ct), np.asarray(cj))
    assert n(ot)[0]


def test_register_and_detect_on_the_fixture_map(voc1m):
    jv, tv_ = voc1m
    jm, _, _ = jsnap.load_map(FIXTURE)
    m = snapshot.load_map(FIXTURE, CPU)[0]
    kfs = np.flatnonzero(np.asarray(jm.kf_valid))
    jdb = jkdb.empty_db(jm.kf_capacity, jm.kp_capacity, jv.n_words)
    tdb = kdb.empty_db(m.kf_capacity, m.kp_capacity, tv_.n_words, device=CPU)
    for k in kfs[:-1]:
        jdb = jkdb.add_keyframe(jdb, jv, jnp.asarray(int(k)), jm.kf_kp_desc[int(k)], jm.kf_kp_valid[int(k)])
        tdb = kdb.add_keyframe(tdb, tv_, int(k), m.kf_kp_desc[int(k)], m.kf_kp_valid[int(k)])
    q = int(kfs[-1])
    want = jkdb.register_and_detect(jdb, jv.centers, jv.weights, None, None, jm, jnp.asarray(q),
                                    jnp.asarray(int(kfs[0]), jnp.int32), k=jv.k, L=jv.L, n_words=jv.n_words,
                                    max_candidates=6, do_detect=True)
    got = kdb.register_and_detect(tdb, tv_, m, torch.tensor(q, dtype=torch.int32),
                                  torch.tensor(int(kfs[0]), dtype=torch.int32), max_candidates=6)
    assert_db_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    np.testing.assert_array_equal(n(got[1]), np.asarray(jms.covisibility(jm)))
    only = kdb.register_and_detect(tdb, tv_, m, q, -1, do_detect=False)
    assert only[1:] == (None,) * 5 and bool(only[0].valid[q])


def test_bow_match_mask(rng):
    wq, wt = rng.integers(-1, 6, 40).astype(np.int32), rng.integers(-1, 6, 50).astype(np.int32)
    vq, vt = rng.random(40) < 0.8, rng.random(50) < 0.8
    want = jkdb.bow_match_mask(jnp.asarray(wq), jnp.asarray(wt), jnp.asarray(vq), jnp.asarray(vt))
    got = kdb.bow_match_mask(t(wq), t(wt), t(vq), t(vt))
    np.testing.assert_array_equal(n(got), np.asarray(want))
