"""Max-logDet submodular landmark selection (port of
gf_orb_slam_tpu/gf/selection.py): exact greedy over low-rank factors by the
matrix determinant lemma (the shipped subset and hybrid modes), blockwise
exact greedy, lazier-than-lazy greedy, the automatic-budget variant, the
deletion variant and the grouped (sharded) lazier greedy.

The reference's lax.scan over rounds is a Python loop, and its sticky or
masked rounds stay masked: nothing here reads the device on the host. The
randomized variants take their Gumbel noise as a tensor (`sample_gumbel`
draws it from a torch.Generator), because JAX's threefry streams cannot be
reproduced; tests inject the reference's own draws. Ties go to the lowest
index, as JAX's argmax and top_k (and approx_max_k on the CPU) give them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import linalg
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable

PRIOR_EPS = 1e-5  # ref: curMat = eye * 0.00001


class SelectionResult(NamedTuple):
    selected: torch.Tensor    # (N,) bool
    info_total: torch.Tensor  # (D, D) accumulated information matrix
    logdet: torch.Tensor      # () final logdet
    n_selected: torch.Tensor  # () int32


def normalize_blocks(blocks: torch.Tensor, valid: torch.Tensor):
    """Scale information blocks so the valid ones' mean diagonal is O(1);
    returns (blocks/s, s). Float32 Cholesky cannot factor the raw ~1e4–1e6
    pixel information beside the 1e-5 prior; a uniform scale shifts every
    logdet by D·log s and leaves gains and greedy order unchanged."""
    D = blocks.shape[-1]
    tr = torch.diagonal(blocks, dim1=-2, dim2=-1).sum(-1)
    s = torch.sum(torch.where(valid, tr, 0.0)) / (
        torch.clamp(torch.sum(valid.to(blocks.dtype)), min=1.0) * D
    )
    s = torch.clamp(s, min=1e-20)
    return blocks / s, s


def normalize_factors(factors: torch.Tensor, valid: torch.Tensor):
    """Scale factors so the valid blocks' mean diagonal is O(1); returns
    (factors/√s, s). Gains and the greedy order are invariant to s."""
    D = factors.shape[-1]
    tr = torch.sum(factors * factors, dim=(-2, -1))
    s = torch.sum(torch.where(valid, tr, 0.0)) / (
        torch.clamp(torch.sum(valid.to(factors.dtype)), min=1.0) * D
    )
    s = torch.clamp(s, min=1e-20)
    return factors / torch.sqrt(s), s


def _det2(A: torch.Tensor) -> torch.Tensor:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def _logdet_eye_plus(G: torch.Tensor) -> torch.Tensor:
    """logdet(I_r + G) for small PSD G (..., r, r): closed forms for r = 1, 2
    and 4 (2×2 block Schur), Cholesky otherwise."""
    r = G.shape[-1]
    M = G + torch.eye(r, dtype=G.dtype, device=G.device)
    tiny = 1e-30
    if r == 1:
        return torch.log(torch.clamp(M[..., 0, 0], min=tiny))
    if r == 2:
        return torch.log(torch.clamp(_det2(M), min=tiny))
    if r == 4:
        A = M[..., 0:2, 0:2]
        B = M[..., 0:2, 2:4]
        C = M[..., 2:4, 2:4]
        dA = torch.clamp(_det2(A), min=tiny)
        Ainv = torch.stack(
            [
                torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
                torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        ) / dA[..., None, None]
        S = C - B.mT @ Ainv @ B
        return torch.log(dA) + torch.log(torch.clamp(_det2(S), min=tiny))
    return linalg.logdet_psd(M)


def _denorm_logdet(cur: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    D = cur.shape[-1]
    return linalg.logdet_psd(cur) + D * torch.log(s)


def _result(selected: torch.Tensor, cur: torch.Tensor, s: torch.Tensor) -> SelectionResult:
    return SelectionResult(
        selected=selected,
        info_total=cur * s,
        logdet=_denorm_logdet(cur, s),
        n_selected=selected.sum(dtype=torch.int32),
    )


def greedy_maxlogdet_lowrank(
    factors: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    batch: int = 1,
    info_prior: torch.Tensor | None = None,
) -> SelectionResult:
    """Exact greedy Max-logDet over low-rank factors (block_i = F_iᵀF_i, F_i
    (r, D)). batch > 1 commits the top-`batch` gains per round (⌈k/batch⌉
    rounds); ties go to the lowest index as in the reference. info_prior
    (D, D) seeds the accumulated matrix, scaled into normalized block space."""
    N, r, D = factors.shape
    factors, s = normalize_factors(factors, valid)
    cur = PRIOR_EPS * torch.eye(D, dtype=factors.dtype, device=factors.device)
    if info_prior is not None:
        cur = cur + info_prior / s
    B = max(1, min(batch, k))
    rounds = -(-k // B)
    selected = torch.zeros(N + 1, dtype=torch.bool, device=factors.device)  # slot N = dropped
    n_sel = torch.zeros((), dtype=torch.int32, device=factors.device)
    Ft = factors.reshape(N * r, D).T  # (D, N·r) shared right-hand side
    offs = torch.arange(B, dtype=torch.int32, device=factors.device)

    for _ in range(rounds):
        L, info = torch.linalg.cholesky_ex(cur)
        Y = torch.linalg.solve_triangular(L, Ft, upper=False)  # (D, N·r)
        Yn = Y.reshape(D, N, r)
        G = torch.einsum("dnr,dns->nrs", Yn, Yn)
        # A non-PD accumulated matrix (an indefinite info prior in float32):
        # the reference's Cholesky returns NaN, so its gains are NaN and the
        # round, and every later one, takes nothing. cholesky_ex returns a
        # finite partial factor instead, whose gains would pick.
        gains = torch.where(info == 0, _logdet_eye_plus(G), torch.nan)
        gains = torch.where(valid & ~selected[:N], gains, -torch.inf)
        if B == 1:
            picks = torch.argmax(gains)[None]
            top_g = gains[picks]
        else:
            top_g, picks = top_k_stable(gains, B)
        take = torch.isfinite(top_g) & (n_sel + offs < k)
        Fp = torch.where(take[:, None, None], factors[picks], 0.0)
        cur = cur + torch.einsum("bri,brj->ij", Fp, Fp)
        selected.index_fill_(0, torch.where(take, picks, N), True)  # no host copy of the scalar
        n_sel = n_sel + take.sum(dtype=torch.int32)

    return _result(selected[:N], cur, s)


def sample_gumbel(rounds: int, n: int, generator: torch.Generator) -> torch.Tensor:
    """(rounds, n) standard Gumbel noise on the generator's device, drawn as
    jax.random.gumbel draws it: −log(−log(U)), U uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((rounds, n), generator=generator, device=generator.device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def _greedy_round(blocks, valid, cur, selected, cand_mask):
    """One blockwise greedy round over a candidate mask: the candidate with
    the largest logdet(cur + block) joins (a non-PD sentinel still counts
    as found, as in the reference). Returns the new cur; `selected` is
    updated in place."""
    cand = cand_mask & valid & ~selected
    lds = linalg.logdet_psd(cur[None, :, :] + blocks)
    lds = torch.where(cand, lds, -torch.inf)
    best = torch.argmax(lds, dim=0, keepdim=True)           # (1,), first of the maxima
    found = torch.isfinite(lds.index_select(0, best))[0]
    cur = torch.where(found, cur + blocks.index_select(0, best)[0], cur)
    selected.scatter_(0, best, found[None] | selected.index_select(0, best))
    return cur


def greedy_maxlogdet(blocks: torch.Tensor, valid: torch.Tensor, k: int) -> SelectionResult:
    """Exact greedy over (N, D, D) blocks: k rounds, each scanning every
    candidate (the reference's ground truth for the faster variants)."""
    N, D, _ = blocks.shape
    blocks, s = normalize_blocks(blocks, valid)
    cur = PRIOR_EPS * torch.eye(D, dtype=blocks.dtype, device=blocks.device)
    selected = torch.zeros(N, dtype=torch.bool, device=blocks.device)
    all_mask = torch.ones_like(selected)
    for _ in range(k):
        cur = _greedy_round(blocks, valid, cur, selected, all_mask)
    return _result(selected, cur, s)


def lazier_sizes(n: int, k: int, sample_scale: float = 2.3, batch: int = 1) -> tuple[int, int, int]:
    """(picks per round B, rounds, candidates per round S) of
    lazier_greedy_maxlogdet: S ≈ (N/k)·sample_scale·B, at least B."""
    B = max(1, min(batch, k))
    rounds = -(-k // B)
    S = max(min(int(round(n / max(k, 1) * sample_scale * B)), n), B)
    return B, rounds, S


def lazier_greedy_maxlogdet(
    blocks: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    gumbel: torch.Tensor,
    sample_scale: float = 2.3,
    batch: int = 1,
) -> SelectionResult:
    """Lazier-than-lazy greedy: each round scores a random subset of S
    unselected valid candidates (the top S of `gumbel[round]`, (rounds, N)
    noise) and commits its `batch` best by logdet, stopping at k."""
    N, D, _ = blocks.shape
    blocks, s = normalize_blocks(blocks, valid)
    B, rounds, S = lazier_sizes(N, k, sample_scale, batch)
    if tuple(gumbel.shape) != (rounds, N):
        raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, expected {(rounds, N)}")
    dev = blocks.device
    cur = PRIOR_EPS * torch.eye(D, dtype=blocks.dtype, device=dev)
    selected = torch.zeros(N + 1, dtype=torch.bool, device=dev)   # slot N = dropped
    n_sel = torch.zeros((), dtype=torch.int32, device=dev)
    offs = torch.arange(B, dtype=torch.int32, device=dev)
    for r in range(rounds):
        g = torch.where(valid & ~selected[:N], gumbel[r], -torch.inf)
        sub_idx = top_k_stable(g, S)[1]
        sub_ok = torch.isfinite(g[sub_idx])
        lds = linalg.logdet_psd(cur[None, :, :] + blocks[sub_idx])
        lds = torch.where(sub_ok, lds, -torch.inf)
        top_lds, jj = top_k_stable(lds, B)
        picks = sub_idx[jj]
        take = torch.isfinite(top_lds) & (n_sel + offs < k)
        cur = cur + torch.sum(torch.where(take[:, None, None], blocks[picks], 0.0), dim=0)
        selected.index_fill_(0, torch.where(take, picks, N), True)
        n_sel = n_sel + take.sum(dtype=torch.int32)
    return _result(selected[:N], cur, s)


def auto_maxlogdet(
    blocks: torch.Tensor,
    valid: torch.Tensor,
    k_max: int,
    gumbel: torch.Tensor,
    min_gain: float | torch.Tensor = 0.05,
    sample_scale: float = 2.3,
) -> SelectionResult:
    """Automatic-budget lazier greedy: rounds as in lazier greedy (one pick
    each), until the best sampled candidate's marginal logdet gain falls
    below `min_gain`. The stop is a sticky device flag, and the rounds after
    it are masked no-ops, so all k_max rounds run without a host read;
    `n_selected` is the budget found. `gumbel` is (k_max, N) noise."""
    N, D, _ = blocks.shape
    blocks, s = normalize_blocks(blocks, valid)
    # The lazier subset size over k_max, floored so that the early rounds
    # still see a sample when k_max is generous.
    S = max(min(int(round(N / max(k_max, 1) * sample_scale)), N), min(16, N))
    if tuple(gumbel.shape) != (k_max, N):
        raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, expected {(k_max, N)}")
    dev = blocks.device
    cur = PRIOR_EPS * torch.eye(D, dtype=blocks.dtype, device=dev)
    selected = torch.zeros(N, dtype=torch.bool, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for r in range(k_max):
        g = torch.where(valid & ~selected, gumbel[r], -torch.inf)
        sub_idx = top_k_stable(g, S)[1]
        sub_ok = torch.isfinite(g[sub_idx])
        lds = linalg.logdet_psd(cur[None, :, :] + blocks[sub_idx])
        lds = torch.where(sub_ok, lds, -torch.inf)
        j = torch.argmax(lds, dim=0, keepdim=True)
        best = sub_idx.index_select(0, j)
        ld_best = lds.index_select(0, j)[0]
        gain = ld_best - linalg.logdet_psd(cur)
        take = torch.isfinite(ld_best) & (gain >= min_gain) & ~stopped
        stopped = stopped | ~take
        cur = torch.where(take, cur + blocks.index_select(0, best)[0], cur)
        selected.scatter_(0, best, take[None] | selected.index_select(0, best))
    return _result(selected, cur, s)


def maxvol_deletion(blocks: torch.Tensor, valid: torch.Tensor, k_remove: int) -> SelectionResult:
    """Reverse greedy: from the valid set's information sum, remove k_remove
    times the landmark whose removal leaves the largest logdet (a non-PD
    remainder scores the −1e30 sentinel and still counts). Returns the
    surviving set as `selected`."""
    N, D, _ = blocks.shape
    blocks, s = normalize_blocks(blocks, valid)
    cur = PRIOR_EPS * torch.eye(D, dtype=blocks.dtype, device=blocks.device) + torch.sum(
        torch.where(valid[:, None, None], blocks, 0.0), dim=0
    )
    alive = valid.clone()
    for _ in range(k_remove):
        lds = linalg.logdet_psd(cur[None, :, :] - blocks)
        lds = torch.where(alive, lds, -torch.inf)
        worst = torch.argmax(lds, dim=0, keepdim=True)
        ok = torch.isfinite(lds.index_select(0, worst))[0]
        cur = torch.where(ok, cur - blocks.index_select(0, worst)[0], cur)
        alive.scatter_(0, worst, ~ok[None] & alive.index_select(0, worst))
    return _result(alive, cur, s)


def grouped_lazier_greedy(
    blocks: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    gumbel: torch.Tensor,
    n_shards: int = 4,
    sample_scale: float = 2.3,
) -> SelectionResult:
    """Grouped lazier greedy with a merge round: the pool padded and split
    into n_shards shards, lazier greedy for ⌈k/n_shards⌉ picks in each (a
    loop over shards where the reference vmaps; shard i takes gumbel[i] of
    (n_shards, rounds, shard size) noise), then exact blockwise greedy over
    the union down to k."""
    N, D, _ = blocks.shape
    pad = (-N) % n_shards
    Np = N + pad
    blocks_p = torch.cat([blocks, blocks.new_zeros((pad, D, D))])
    valid_p = torch.cat([valid, valid.new_zeros(pad)])
    shard = Np // n_shards
    k_shard = -(-k // n_shards)
    union = torch.cat([
        lazier_greedy_maxlogdet(blocks_p[i * shard : (i + 1) * shard], valid_p[i * shard : (i + 1) * shard],
                                k_shard, gumbel[i], sample_scale).selected
        for i in range(n_shards)
    ])[:N]
    return greedy_maxlogdet(torch.where(union[:, None, None], blocks, 0.0), union, k)
