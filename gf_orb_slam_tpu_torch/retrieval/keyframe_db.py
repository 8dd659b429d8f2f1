"""Keyframe database: BoW-scored retrieval for loop closing and
relocalization (port of gf_orb_slam_tpu/retrieval/keyframe_db.py).

Each keyframe stores its distinct (word id, tf-idf value) pairs, so memory
is O(K·N) at any vocabulary size; scoring a query against every keyframe is
one gather of the query's dense vector and an elementwise min, the
Σ min(q, d) L1 score DBoW2 computes by walking its inverted file.

The reference's `mode="drop"` / `mode="fill"` accesses at the padding id
n_words go through an (n_words + 1)-long buffer whose last slot is cut off
or reads 0; its `top_k` (lowest index first among equal values) is the
port's `top_k_stable`. Keyframe ids are device tensors: nothing here reads
back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable
from gf_orb_slam_tpu_torch.retrieval import vocabulary as vocab_mod


class BowDatabase(NamedTuple):
    """Per-keyframe sparse BoW rows, aligned with the map's keyframe slots.
    bow_ids[k] holds keyframe k's distinct word ids in keypoint order (later
    duplicates and invalid slots padded with n_words); bow_vals their
    L1-normalised tf-idf values (0 at padding)."""

    bow_ids: torch.Tensor    # (K, N) int32 word ids (n_words = padding)
    bow_vals: torch.Tensor   # (K, N) float32
    words: torch.Tensor      # (K, N) int32 leaf word per keypoint (−1 invalid)
    mid_nodes: torch.Tensor  # (K, N) int32 mid-level node per keypoint
    valid: torch.Tensor      # (K,) bool registered keyframes


def empty_db(max_keyframes: int, max_kps: int, n_words: int, device=None) -> BowDatabase:
    i32 = dict(dtype=torch.int32, device=device)
    return BowDatabase(
        bow_ids=torch.full((max_keyframes, max_kps), n_words, **i32),
        bow_vals=torch.zeros((max_keyframes, max_kps), dtype=torch.float32, device=device),
        words=torch.full((max_keyframes, max_kps), -1, **i32),
        mid_nodes=torch.full((max_keyframes, max_kps), -1, **i32),
        valid=torch.zeros(max_keyframes, dtype=torch.bool, device=device),
    )


def add_keyframe(db: BowDatabase, voc: vocab_mod.Vocabulary, kf_id, desc, kp_valid) -> BowDatabase:
    """Register a keyframe: quantize its descriptors and store its sparse BoW
    row (KeyFrameDatabase::add + KeyFrame::ComputeBoW)."""
    dev = desc.device
    k1 = ms.kf_index(kf_id, dev)
    words, mid = vocab_mod.quantize(voc, desc, kp_valid)
    v = vocab_mod.bow_vector(voc, words)            # dense (n_words,), transient
    n_words = voc.n_words
    N = words.shape[0]
    w = torch.where(words >= 0, words, n_words)
    # Each distinct word contributes its value once, at its first keypoint.
    order = torch.argsort(w, stable=True)
    sw = w[order]
    first_sorted = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sw[1:] != sw[:-1]])
    first = torch.zeros(N, dtype=torch.bool, device=dev).scatter(0, order, first_sorted)
    ids = torch.where(first & (w < n_words), w, n_words)
    vals = torch.where(ids < n_words, v[torch.clamp(ids, max=n_words - 1).long()], 0.0)
    return db._replace(
        bow_ids=db.bow_ids.index_copy(0, k1, ids.to(torch.int32)[None]),
        bow_vals=db.bow_vals.index_copy(0, k1, vals[None]),
        words=db.words.index_copy(0, k1, words[None]),
        mid_nodes=db.mid_nodes.index_copy(0, k1, mid[None]),
        valid=db.valid.index_fill(0, k1, True),
    )


def erase_keyframe(db: BowDatabase, kf_id) -> BowDatabase:
    return db._replace(valid=db.valid.index_fill(0, ms.kf_index(kf_id, db.valid.device), False))


def permute(db: BowDatabase, perm: torch.Tensor) -> BowDatabase:
    """Apply a keyframe renumbering (map_state.compact_keyframes) so the rows
    stay aligned with the map's keyframe slots."""
    p = perm.long()
    return BowDatabase(*(f[p] for f in db))


def _scores_vs_dense(db: BowDatabase, v: torch.Tensor) -> torch.Tensor:
    """(K,) Σ min(q, d) against a dense (n_words,) query; padding ids read 0."""
    v_ext = torch.cat([v, v.new_zeros(1)])
    q = v_ext[db.bow_ids.long()]                              # (K, N)
    return torch.sum(torch.minimum(q, db.bow_vals), dim=1)


def query_scores(db: BowDatabase, v: torch.Tensor) -> torch.Tensor:
    """(n_words,) query against every keyframe → (K,) L1 scores; −1 invalid."""
    return torch.where(db.valid, _scores_vs_dense(db, v), -1.0)


def _group_rank(scores, eligible, covis, valid, max_candidates: int):
    """Each eligible keyframe's score plus its strongly covisible eligible
    neighbours' scores; the top `max_candidates` within 0.75 of the best."""
    neigh = covis > 15
    grp = scores[None, :] * (neigh & valid[None, :] & eligible[None, :])
    group_score = scores + torch.sum(torch.where(grp > 0, grp, 0.0), dim=1)
    group_score = torch.where(eligible, group_score, -1.0)
    best = torch.max(group_score)
    keep = eligible & (group_score >= 0.75 * best) & (best > 0)
    top_vals, top_ids = top_k_stable(torch.where(keep, group_score, -1.0), max_candidates)
    return top_ids.to(torch.int32), top_vals > 0


def detect_loop_candidates(
    db: BowDatabase,
    covis: torch.Tensor,        # (K, K) covisibility weights
    query_kf,                   # keyframe id (int or tensor)
    max_candidates: int = 8,
    exclude_kf=-1,              # e.g. a keyframe culled this round, not yet tombstoned
    *,
    n_words: int,
):
    """KeyFrameDatabase::DetectLoopCandidates: candidates are keyframes not
    connected to the query (covisibility < 15) that score at least the
    query's worst connected neighbour; ranked by group score. Returns
    (cand_ids (max_candidates,) int32, cand_ok (max_candidates,))."""
    if n_words <= 0:
        raise ValueError("detect_loop_candidates needs n_words > 0")
    K = db.bow_ids.shape[0]
    dev = db.bow_ids.device
    q1 = ms.kf_index(query_kf, dev)
    ids_q = db.bow_ids.index_select(0, q1)[0].long()
    v = torch.zeros(n_words + 1, dtype=torch.float32, device=dev).index_add_(
        0, ids_q, db.bow_vals.index_select(0, q1)[0])[:n_words]
    scores = _scores_vs_dense(db, v)
    connected = covis.index_select(0, q1)[0] >= 15
    ar = torch.arange(K, device=dev)
    is_self = ar == q1

    covis_scores = torch.where(connected & db.valid, scores, float("inf"))
    has_covis = torch.isfinite(covis_scores).any()
    min_score = torch.clamp(torch.where(has_covis, torch.min(covis_scores), 0.1), min=0.0)
    excl = exclude_kf.reshape(-1).to(dev) if isinstance(exclude_kf, torch.Tensor) else exclude_kf
    eligible = db.valid & ~connected & ~is_self & (scores >= min_score) & (ar != excl)
    return _group_rank(scores, eligible, covis, db.valid, max_candidates)


def detect_reloc_candidates(db: BowDatabase, covis: torch.Tensor, v_query: torch.Tensor, max_candidates: int = 8):
    """DetectRelocalisationCandidates: the same group ranking without the
    covisibility exclusion (the query is not in the map)."""
    scores = torch.where(db.valid, _scores_vs_dense(db, v_query), -1.0)
    return _group_rank(scores, db.valid & (scores > 0), covis, db.valid, max_candidates)


def register_and_detect(
    db: BowDatabase,
    voc: vocab_mod.Vocabulary,
    m: ms.MapState,
    kf_id,
    exclude_kf,
    max_candidates: int = 6,
    do_detect: bool = True,
):
    """The post-insertion place-recognition work, with no host read:
    quantize and register the new keyframe's BoW row, build the
    covisibility matrix and rank loop candidates. Returns (db', covis,
    covis[kf_id], covis[cand], cand, ok); all but db' are None when
    do_detect is False."""
    dev = m.kf_pose.device
    k1 = ms.kf_index(kf_id, dev)
    db = add_keyframe(db, voc, k1, m.kf_kp_desc.index_select(0, k1)[0], m.kf_kp_valid.index_select(0, k1)[0])
    if not do_detect:
        return db, None, None, None, None, None
    covis = ms.covisibility(m)
    cand, ok = detect_loop_candidates(db, covis, k1, max_candidates=max_candidates, exclude_kf=exclude_kf,
                                      n_words=voc.n_words)
    return db, covis, covis.index_select(0, k1)[0], covis[cand.long()], cand, ok


def bow_match_mask(words_q, words_t, valid_q, valid_t) -> torch.Tensor:
    """SearchByBoW's gate: only pairs quantized to the same node."""
    return ((words_q[:, None] == words_t[None, :]) & (words_q >= 0)[:, None] & (words_t >= 0)[None, :]
            & valid_q[:, None] & valid_t[None, :])
