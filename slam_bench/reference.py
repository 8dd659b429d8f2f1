"""The plain reference that decides `correct`: NumPy only, and nothing of
the program. It reads the ground truth the benchmark rendered from and the
descriptors the benchmark captured at the kernel's inputs, works out every
alignment itself, and reads the program's outputs (poses, distance
matrices) only to judge them.

- System: the ATE of the window's poses against the ground truth after the
  Sim(3) that best aligns them (Umeyama), in cm.
- Mapping: sampled local-BA calls of the window, recomputed in float64
  from their inputs (the same Levenberg–Marquardt schedule, Schur
  complement, Huber weights and pruning); per call, the median distance
  between a point as the program leaves it and as the reference does (map
  units), the largest over the calls.
- Step: sampled calls of the matcher of the window, recomputed from their
  inputs with exact distances (best and second-best under the mask, the
  distance and ratio tests, the mutual check, the rotation histogram); the
  count of query rows whose match differs.
- Kernel: the Hamming distances of sampled kernel launches of the window,
  recomputed by XOR and popcount; the count of entries that differ.
"""

from __future__ import annotations

import numpy as np

NO_READING = 1e9  # a number with nothing to read (too few frames, no launch sampled): above every limit


def rotations(poses: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotations of (N, 7) [qw qx qy qz t] poses, normalized."""
    q = np.asarray(poses, np.float64)[:, :4]
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    r, x, y, z = q.T
    return np.stack([
        np.stack([r * r + x * x - y * y - z * z, 2 * (x * y - r * z), 2 * (z * x + r * y)], -1),
        np.stack([2 * (x * y + r * z), r * r - x * x + y * y - z * z, 2 * (y * z - r * x)], -1),
        np.stack([2 * (z * x - r * y), 2 * (y * z + r * x), r * r - x * x - y * y + z * z], -1),
    ], 1)


def centers(poses: np.ndarray) -> np.ndarray:
    """(N, 3) camera centres -R^T t of (N, 7) T_cw poses."""
    R = rotations(poses)
    return -np.einsum("nji,nj->ni", R, np.asarray(poses, np.float64)[:, 4:7])


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(s, R, t) minimising |dst - (s R src + t)|² over (N, 3) point sets."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(src), 1e-300))
    return s, R, mu_d - s * R @ mu_s


def ate_cm(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE in cm of the aligned camera centres of (N, 7) estimated poses
    against their (N, 7) ground truth (scene units are metres)."""
    ce, cg = centers(est), centers(gt)
    s, R, t = umeyama(ce, cg)
    return float(100.0 * np.sqrt((np.linalg.norm((s * (R @ ce.T)).T + t - cg, axis=1) ** 2).mean()))


def hamming(q: np.ndarray, t: np.ndarray, block: int = 512) -> np.ndarray:
    """(Nq, Nt) int32 Hamming distances of (Nq, 8) and (Nt, 8) int32 bit
    views of 256-bit descriptors."""
    qu, tu = np.ascontiguousarray(q).view(np.uint32), np.ascontiguousarray(t).view(np.uint32)
    out = np.empty((qu.shape[0], tu.shape[0]), np.int32)
    for r in range(0, qu.shape[0], block):
        x = qu[r : r + block, None, :] ^ tu[None, :, :]
        out[r : r + block] = np.bitwise_count(x).sum(-1, dtype=np.int32)
    return out


BIG = 10_000      # a masked-out distance (the matcher's convention)
HISTO_BINS = 30   # rotation histogram bins (ORBmatcher's rotHist)


def _top3(hist: np.ndarray) -> np.ndarray:
    """Indices of the 3 largest counts, lowest index first among equals."""
    return np.lexsort((np.arange(len(hist)), -hist))[:3]


def match(c: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx, best distance, matched) of one matcher call from its inputs:
    per query row the best and second-best target under the mask (ties to
    the lowest index), `best <= max_dist`, the ratio test in float32,
    optionally the mutual check and the rotation-histogram consistency
    (the 3 fullest of 30 bins of the angle difference, each at least a
    tenth of the fullest)."""
    d = np.where(c["mask"], hamming(c["desc_q"], c["desc_t"]), BIG)
    rows = np.arange(d.shape[0])
    idx = np.argmin(d, axis=1)
    best = d[rows, idx]
    second = np.where(np.arange(d.shape[1])[None, :] == idx[:, None], BIG, d).min(axis=1)
    matched = best <= c["max_dist"]
    if c["ratio"] < 1.0:
        matched &= best.astype(np.float32) <= np.float32(c["ratio"]) * second.astype(np.float32)
    if c["mutual"]:
        matched &= np.argmin(d, axis=0)[idx] == rows
    if c["angle_q"] is not None and c["angle_t"] is not None:
        two_pi = np.float32(2.0 * np.pi)
        dth = np.fmod(c["angle_q"] - c["angle_t"][idx], two_pi)
        dth = np.where(dth < 0, dth + two_pi, dth).astype(np.float32)
        bins = np.clip(np.mod(np.round(dth * np.float32(HISTO_BINS / (2.0 * np.pi))).astype(np.int32), HISTO_BINS),
                       0, HISTO_BINS - 1)
        hist = np.bincount(bins, weights=matched, minlength=HISTO_BINS).astype(np.int32)
        top = _top3(hist)
        floor = max(int(np.float32(0.1) * np.float32(hist[top[0]])), 1)
        ok_bin = np.zeros(HISTO_BINS, bool)
        ok_bin[top] = hist[top] >= floor
        matched &= ok_bin[bins]
    return idx.astype(np.int32), best.astype(np.int32), matched


def match_mismatch(c: dict) -> int:
    """Query rows where the program's match differs from the reference's:
    matched or not, and where matched, the target and its distance."""
    idx, best, matched = match(c)
    m = matched & c["matched"]
    return int((matched != c["matched"]).sum() + (m & ((idx != c["idx"]) | (best != c["dist"]))).sum())


# The local BA (the program's solvers/local_ba.py, the reference ORB-SLAM's
# LocalBundleAdjustment): its Huber threshold, the depth below which a point
# is behind the camera, and the angle below which the exponential map takes
# its series branch.
HUBER2 = 5.991
EPS_Z = 1e-6
SMALL = 1e-7


def _rotate(q, v):
    """v rotated by quaternion q (not normalised), as the program's
    quaternion rotation: v + w t + qv × t, t = 2 qv × v."""
    qv, v = np.broadcast_arrays(q[..., 1:], v)
    t = 2.0 * np.cross(qv, v)
    return v + q[..., :1] * t + np.cross(qv, t)


def _qprod(a, b):
    p, q, r, s = np.moveaxis(a, -1, 0)
    w, x, y, z = np.moveaxis(b, -1, 0)
    return np.stack([p * w - q * x - r * y - s * z, p * x + q * w + r * z - s * y,
                     p * y - q * z + r * w + s * x, p * z + q * y - r * x + s * w], -1)


def _hat(w):
    x, y, z = np.moveaxis(w, -1, 0)
    o = np.zeros_like(x)
    return np.stack([np.stack([o, -z, y], -1), np.stack([z, o, -x], -1), np.stack([-y, x, o], -1)], -2)


def _exp_se3(xi):
    """(C, 6) [rho, phi] → (C, 7) poses."""
    rho, phi = xi[:, :3], xi[:, 3:]
    th2 = (phi * phi).sum(-1)
    small = th2 < SMALL * SMALL
    th2s = np.where(small, 1.0, th2)
    th = np.sqrt(th2s)
    B = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / th2s)[:, None, None]
    Cc = np.where(small, 1.0 / 6.0 - th2 / 120.0, (th - np.sin(th)) / (th2s * th))[:, None, None]
    W = _hat(phi)
    V = np.eye(3) + B * W + Cc * (W @ W)
    t = (V @ rho[:, :, None])[:, :, 0]
    half_small = th2[:, None] < SMALL * SMALL
    a = np.sqrt(np.where(half_small, 1.0, th2[:, None]))
    sinc = np.where(half_small, 0.5 - th2[:, None] / 48.0, np.sin(0.5 * a) / a)
    w = np.where(half_small, 1.0 - th2[:, None] / 8.0, np.cos(0.5 * a))
    return np.concatenate([w, phi * sinc, t], -1)


def _compose(p1, p2):
    q = _qprod(p1[:, :4], p2[:, :4])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([q, _rotate(p1[:, :4], p2[:, 4:]) + p1[:, 4:]], -1)


def _project(cam, xc):
    z = xc[..., 2]
    zs = np.where(np.abs(z) < EPS_Z, EPS_Z, z)
    uv = np.stack([xc[..., 0] / zs * cam["fx"] + cam["cx"], xc[..., 1] / zs * cam["fy"] + cam["cy"]], -1)
    iz = 1.0 / zs
    o = np.zeros_like(z)
    J = np.stack([np.stack([cam["fx"] * iz, o, -xc[..., 0] * cam["fx"] * iz * iz], -1),
                  np.stack([o, cam["fy"] * iz, -xc[..., 1] * cam["fy"] * iz * iz], -1)], -2)
    return uv, J, z > EPS_Z


def _rho(chi2):
    return np.where(chi2 <= HUBER2, chi2, 2.0 * np.sqrt(HUBER2 * np.maximum(chi2, 1e-12)) - HUBER2)


def _residuals(cam, poses, points, c):
    lp = np.maximum(c["obs_point"], 0)
    xc = _rotate(poses[:, None, :4], points[lp]) + poses[:, None, 4:]
    uv, J, front = _project(cam, xc)
    return c["obs_uv"] - uv, J, xc, front


def _cost(cam, poses, points, c, active):
    r, _, _, front = _residuals(cam, poses, points, c)
    ok = active & front & (c["obs_point"] >= 0)
    return np.where(ok, _rho((r * r).sum(-1) * c["obs_w"]), 0.0).sum()


def _lm_step(cam, poses, points, c, active, lam):
    """One damped Schur-reduced Gauss–Newton step: (dξ (C, 6), dX (P, 3),
    the cost here)."""
    C, N = c["obs_point"].shape
    P = points.shape[0]
    fixed, valid = c["fixed"], c["point_valid"]
    r, Jp, xc, front = _residuals(cam, poses, points, c)
    ok = active & front & (c["obs_point"] >= 0)
    chi2 = (r * r).sum(-1) * c["obs_w"]
    w = np.where(ok, c["obs_w"] * np.where(chi2 > HUBER2, np.sqrt(HUBER2 / np.maximum(chi2, 1e-12)), 1.0), 0.0)
    cost = np.where(ok, _rho(chi2), 0.0).sum()
    Jpose = np.concatenate([Jp, -Jp @ _hat(xc)], -1)                      # (C, N, 2, 6)
    q = poses[:, :4] / np.linalg.norm(poses[:, :4], axis=-1, keepdims=True)
    Jpt = Jp @ rotations(np.concatenate([q, np.zeros((len(q), 3))], 1))[:, None]                                           # (C, N, 2, 3)
    U = np.einsum("cnri,cn,cnrj->cij", Jpose, w, Jpose)
    g_c = np.einsum("cnri,cn,cnr->ci", Jpose, w, r)
    Wedge = np.einsum("cnri,cn,cnrj->cnij", Jpose, w, Jpt)
    Wedge[fixed] = 0.0
    rows = (np.maximum(c["obs_point"], 0) * C + np.arange(C)[:, None])[ok]
    V = np.zeros((P * C, 3, 3))
    gp = np.zeros((P * C, 3))
    T = np.zeros((P * C, 6, 3))
    np.add.at(V, rows, np.einsum("nri,n,nrj->nij", Jpt[ok], w[ok], Jpt[ok]))
    np.add.at(gp, rows, np.einsum("nri,n,nr->ni", Jpt[ok], w[ok], r[ok]))
    np.add.at(T, rows, Wedge[ok])
    V, gp, T = V.reshape(P, C, 3, 3).sum(1), gp.reshape(P, C, 3).sum(1), T.reshape(P, C, 6, 3)
    dU = np.maximum(np.einsum("cii->ci", U), 1e-6)
    dV = np.maximum(np.einsum("pii->pi", V), 1e-6)
    U_d = U + lam * dU[:, :, None] * np.eye(6)
    V_d = V + lam * dV[:, :, None] * np.eye(3) + 1e-8 * np.eye(3)
    Vinv = np.where(valid[:, None, None], np.linalg.inv(V_d), 0.0)
    Y = np.einsum("pcij,pjk->pcik", T, Vinv)
    S = -np.einsum("pcij,pdkj->cidk", Y, T)
    idx = np.arange(C)
    S[idx, :, idx, :] += U_d
    b = g_c - np.einsum("pcij,pj->ci", Y, gp)
    free = (~fixed).astype(np.float64)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[idx, :, idx, :] += np.eye(6) * fixed.astype(np.float64)[:, None, None]
    b = b * free[:, None]
    dc = np.linalg.solve(S.reshape(C * 6, C * 6) + 1e-8 * np.eye(C * 6), b.reshape(-1)).reshape(C, 6)
    dp = np.einsum("pij,pj->pi", Vinv, gp - np.einsum("pcij,ci->pj", T, dc))
    return dc, np.where(valid[:, None], dp, 0.0), cost


def bundle_adjust(c: dict) -> tuple[np.ndarray, np.ndarray]:
    """The local BA of one captured call, in float64: (poses, points).
    Two stages (`iters_stage1`, `iters_stage2`) of Levenberg–Marquardt steps with the points
    marginalised by Schur complement, the cameras in `fixed` held, Huber
    weights (δ² = 5.991) and the χ² pruning of the edges between and after
    the stages; a step is kept where it lowers the cost."""
    cam = c["camera"]
    poses, points = c["poses"].astype(np.float64), c["points"].astype(np.float64)
    c = {k: (v.astype(np.float64) if k in ("obs_uv", "obs_w") else v) for k, v in c.items()}
    fixed = c["fixed"]

    def run(poses, points, active, iters):
        lam = 1e-4
        for _ in range(iters):
            dc, dp, c_old = _lm_step(cam, poses, points, c, active, lam)
            new_poses = np.where(fixed[:, None], poses, _compose(_exp_se3(dc), poses))
            new_points = points + dp
            good = _cost(cam, new_poses, new_points, c, active) < c_old
            if good:
                poses, points = new_poses, new_points
            lam = max(lam * 0.4, 1e-9) if good else min(lam * 5.0, 1e5)
        return poses, points

    def inliers(poses, points, active):
        r, _, _, front = _residuals(cam, poses, points, c)
        return active & front & (c["obs_point"] >= 0) & ((r * r).sum(-1) * c["obs_w"] <= c["chi2_prune"])

    active = (c["obs_point"] >= 0) & (c["obs_w"] > 0)
    poses, points = run(poses, points, active, c["iters_stage1"])
    poses, points = run(poses, points, inliers(poses, points, active), c["iters_stage2"])
    return poses, points


def ba_point_gap(c: dict) -> float:
    """The median distance, over one local-BA call's points, between a point
    as the program returned it and as the float64 reference does (map
    units). The median: where float32 and float64 part ways at an accepted
    or refused step, a few weakly held points move far either way."""
    _, points = bundle_adjust(c)
    d = np.linalg.norm(c["out_points"].astype(np.float64) - points, axis=1)[c["point_valid"]]
    return float(np.median(d)) if d.size else 0.0


def judge(session: dict, gt: np.ndarray) -> dict:
    """The compared numbers of a run. `session` holds `frames` (records
    with `index`, `pose` or None, `in_window`), `hamming` (captured (q, t,
    out) triples), `match` (captured matcher calls) and `ba` (captured
    local-BA calls), each with their inputs and outputs."""
    win = [f for f in session["frames"] if f["in_window"]]
    tracked = [f for f in win if f["pose"] is not None]
    ate = NO_READING
    if len(tracked) >= 3:
        ate = ate_cm(np.stack([f["pose"] for f in tracked]), gt[[f["index"] for f in tracked]])
    ham, mm, ba = session.get("hamming", []), session.get("match", []), session.get("ba", [])
    return {
        "ate_cm": ate,
        "untracked_frames": len(win) - len(tracked),
        "ba_point_gap": max(ba_point_gap(c) for c in ba) if ba else NO_READING,
        "ba_calls_checked": len(ba),
        "hamming_mismatch": sum(int((hamming(q, t) != out).sum()) for q, t, out in ham) if ham else NO_READING,
        "hamming_launches_checked": len(ham),
        "match_mismatch": sum(match_mismatch(c) for c in mm) if mm else NO_READING,
        "match_calls_checked": len(mm),
    }
