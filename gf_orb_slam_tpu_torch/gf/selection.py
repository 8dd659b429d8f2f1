"""Exact greedy Max-logDet landmark selection via the matrix determinant
lemma (port of gf_orb_slam_tpu/gf/selection.py::greedy_maxlogdet_lowrank and
the helpers it calls; the lazier/auto/deletion variants are not ported).

The reference's lax.scan over rounds is a Python loop. Each round factors
the accumulated D×D matrix once (cholesky_ex, no error check, no host sync)
and scores every candidate's gain logdet(I_r + F_i cur⁻¹ F_iᵀ) in one batch.
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
        L, _ = torch.linalg.cholesky_ex(cur)
        Y = torch.linalg.solve_triangular(L, Ft, upper=False)  # (D, N·r)
        Yn = Y.reshape(D, N, r)
        G = torch.einsum("dnr,dns->nrs", Yn, Yn)
        gains = _logdet_eye_plus(G)
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

    selected = selected[:N]
    return SelectionResult(
        selected=selected,
        info_total=cur * s,
        logdet=_denorm_logdet(cur, s),
        n_selected=selected.sum(dtype=torch.int32),
    )
