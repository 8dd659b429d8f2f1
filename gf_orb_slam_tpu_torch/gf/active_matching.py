"""GF active matching: select-then-match by marginal logDet gain (port of
gf_orb_slam_tpu/gf/active_matching.py).

Match outcomes for every candidate are computed beforehand (one dense
masked Hamming match), then the gain-greedy runs in rounds of `chunk`
attempts: each round scores every remaining candidate's logdet(M + block)
in one batched Cholesky, attempts the top `chunk`, adds the blocks of the
candidates that matched and strikes the ones that did not. Budget =
⌈budget/chunk⌉ rounds of `chunk` attempts, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import linalg
from gf_orb_slam_tpu_torch.gf.selection import PRIOR_EPS, normalize_blocks
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable


class ActiveMatchResult(NamedTuple):
    matched: torch.Tensor      # (P,) bool — candidates matched during the run
    kp_of_point: torch.Tensor  # (P,) int32 — keypoint slot each matched to, else −1
    info_total: torch.Tensor   # (D, D)
    n_attempted: torch.Tensor  # () int32
    n_matched: torch.Tensor    # () int32


def active_match(
    blocks: torch.Tensor,      # (P, D, D) candidate information blocks
    candidate: torch.Tensor,   # (P,) bool — visible, unmatched candidates
    match_ok: torch.Tensor,    # (P,) bool — would the candidate's match succeed
    match_kp: torch.Tensor,    # (P,) int32 — the keypoint it would match
    info_init: torch.Tensor,   # (D, D) information of the matches already made
    budget: int = 100,
    chunk: int = 8,
) -> ActiveMatchResult:
    P, D, _ = blocks.shape
    dev = blocks.device
    n_rounds = -(-budget // chunk)
    # Blocks and the initial information share one scale (see
    # selection.normalize_blocks); gains and order do not depend on it.
    blocks, s = normalize_blocks(blocks, candidate)
    M = info_init / s + PRIOR_EPS * torch.eye(D, dtype=blocks.dtype, device=dev)
    matched = torch.zeros(P + 1, dtype=torch.bool, device=dev)   # slot P = dropped
    struck = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    attempts = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(n_rounds):
        avail = candidate & ~matched[:P] & ~struck[:P]
        gains = torch.where(avail, linalg.logdet_psd(M[None] + blocks), -torch.inf)
        top_g, top_i = top_k_stable(gains, chunk)
        ok_pick = torch.isfinite(top_g)
        success = ok_pick & match_ok[top_i]
        M = M + torch.sum(torch.where(success[:, None, None], blocks[top_i], 0.0), dim=0)
        matched.index_fill_(0, torch.where(success, top_i, P), True)
        struck.index_fill_(0, torch.where(ok_pick & ~success, top_i, P), True)
        attempts = attempts + ok_pick.sum(dtype=torch.int32)
    matched = matched[:P]
    return ActiveMatchResult(
        matched=matched,
        kp_of_point=torch.where(matched, match_kp, -1).to(torch.int32),
        info_total=M * s,
        n_attempted=attempts,
        n_matched=matched.sum(dtype=torch.int32),
    )
