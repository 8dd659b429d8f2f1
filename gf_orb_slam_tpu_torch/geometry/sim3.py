"""Sim(3) similarity transforms as 8-vectors [qw qx qy qz tx ty tz s]
(port of gf_orb_slam_tpu/geometry/sim3.py). Action: S(x) = s·R(q)·x + t.

Every function takes leading batch dimensions and is written for
`torch.func`: the pose graph and OptimizeSim3 take forward-mode Jacobians
of `exp` and `log`, so singular branches are guarded by double `where`s, as
the reference guards them. `log` inverts exp's V with the closed-form 3×3
inverse (`linalg.inv3`), which neither synchronises nor branches.
"""

from __future__ import annotations

import torch

from gf_orb_slam_tpu_torch.geometry import linalg, quat, se3

_EPS = 1e-7


def make_sim3(q: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q (...,4), t (...,3), s (...,) → (...,8)."""
    return torch.cat([q, t, s[..., None]], dim=-1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 0, 0, 0, 0, 0, 0, 1], built by a fill (no host→device copy)."""
    return torch.zeros(8, dtype=dtype, device=device).index_fill_(0, torch.arange(2, device=device) * 7, 1.0)


def q_of(S):
    return S[..., :4]


def t_of(S):
    return S[..., 4:7]


def s_of(S):
    return S[..., 7]


def from_se3(p: torch.Tensor, s=1.0) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=p.dtype, device=p.device).expand(p.shape[:-1])
    return make_sim3(se3.pose_q(p), se3.pose_t(p), s)


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """Scale folded into the translation: T = [R | t/s] (LoopClosing.cc:489-495)."""
    return se3.make_pose(q_of(S), t_of(S) / s_of(S)[..., None])


def transform_point(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return s_of(S)[..., None] * quat.rotate(q_of(S), x) + t_of(S)


def compose(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """S1 ∘ S2: s1 s2 R1 R2 x + s1 R1 t2 + t1."""
    q = quat.qnormalize(quat.qprod(q_of(S1), q_of(S2)))
    t = s_of(S1)[..., None] * quat.rotate(q_of(S1), t_of(S2)) + t_of(S1)
    return make_sim3(q, t, s_of(S1) * s_of(S2))


def inverse(S: torch.Tensor) -> torch.Tensor:
    qi = quat.qconj(q_of(S))
    si = torch.reciprocal(s_of(S))  # `1.0 / x` turns float64 under torch.func.vmap + jacfwd
    ti = -si[..., None] * quat.rotate(qi, t_of(S))
    return make_sim3(qi, ti, si)


# ---------------------------------------------------------------------------
# sim(3) exp/log — 7-dof tangent [rho(3), phi(3), sigma]
# ---------------------------------------------------------------------------


def th2_safe(th2, small):
    return torch.where(small, 1.0, th2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) exponential, xi = [rho, phi, sigma] → 8-vector (the g2o sim3.h
    V = A·I + B·W + C·W² with the σ→0 and θ→0 limits)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    q = quat.v2q(phi)

    theta2_raw = torch.sum(phi * phi, dim=-1)
    tiny = theta2_raw < _EPS * _EPS
    theta = torch.where(tiny, 0.0, torch.sqrt(torch.where(tiny, 1.0, theta2_raw)))
    W = se3.hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)

    sig = sigma[..., None, None]
    th = theta[..., None, None]
    th2 = th * th
    s_nn = s[..., None, None]

    small_sig = torch.abs(sig) < _EPS
    small_th = th < _EPS
    safe_sig = torch.where(small_sig, 1.0, sig)
    safe_th = torch.where(small_th, 1.0, th)

    A = torch.where(small_sig, 1.0 + sig / 2.0, (s_nn - 1.0) / safe_sig)
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    denom = sig * sig + th2
    safe_denom = torch.where(denom < _EPS * _EPS, 1.0, denom)
    a = s_nn * sin_th
    b = s_nn * cos_th

    B_gen = (a * sig + (1.0 - b) * th) / (safe_th * safe_denom)
    C_gen = (A - (b - 1.0) * sig / safe_denom - a * th / safe_denom) / th2_safe(th2, small_th)
    B_sig0 = torch.where(small_th, 0.5 - th2 / 24.0, (1.0 - cos_th) / th2_safe(th2, small_th))
    C_sig0 = torch.where(small_th, 1.0 / 6.0 - th2 / 120.0, (th - sin_th) / (th2_safe(th2, small_th) * safe_th))
    sig2 = safe_sig * safe_sig
    B_th0 = torch.where(small_sig, 0.5 + sig / 6.0, ((safe_sig - 1.0) * s_nn + 1.0) / sig2)
    C_th0 = torch.where(small_sig, 1.0 / 6.0 + sig / 24.0,
                        (s_nn * (sig * sig / 2.0 - sig + 1.0) - 1.0) / (sig2 * safe_sig))
    B = torch.where(small_th, B_th0, torch.where(small_sig, B_sig0, B_gen))
    C = torch.where(small_th, C_th0, torch.where(small_sig, C_sig0, C_gen))

    V = A * eye + B * W + C * (W @ W)
    t = (V @ rho[..., None])[..., 0]
    return make_sim3(q, t, s)


def log(S: torch.Tensor) -> torch.Tensor:
    """sim(3) log: φ and σ in closed form, then ρ = V⁻¹ t with V probed from
    exp() one basis vector at a time, as the reference builds it."""
    phi = quat.q2v(q_of(S))
    sigma = torch.log(s_of(S))
    zeros = torch.zeros_like(phi)
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    cols = [t_of(exp(torch.cat([(zeros + eye[i]), phi, sigma[..., None]], dim=-1))) for i in range(3)]
    V = torch.stack(cols, dim=-1)
    rho = (linalg.inv3(V) @ t_of(S)[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
