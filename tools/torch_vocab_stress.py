#!/usr/bin/env python3
"""Vocabulary retrieval at map scale on the PyTorch port (tools/vocab_stress.py on the port).

    python tools/torch_vocab_stress.py [--kfs 240] [--queries 80] [--revs 2.0] [--rings 2] [--varied] \
        [--vocab packaged] [--vocab tiny] [--vocab PATH] [--device cuda] [--out results/torch_vocab_stress.json]

A keyframe corpus of --kfs views on a --revs-revolution room circuit over
--rings rings of radius and height, and --queries held-out poses between
the stations with small pose noise (scene seed --seed), rendered on the CPU
and extracted by the port's ORB front-end (800 features) on the device.
A keyframe is relevant to a query where their viewing directions agree
within --gt-angle-deg and their centres lie within --gt-dist; "far"
distractors lie outside twice both. Per vocabulary (the packaged 1M-word
tree; `tiny`, k 10 L 3 trained on the first 20 keyframes' descriptors, the
fallback the system trains without one; or a file): P@1, R@5 and MRR of the
L1 tf-idf score Σ min(q, d) over sparse per-keyframe rows, the score margin
of the best relevant keyframe over the best far (and near) one, and the
host ms per frame of quantization. Runs on the first CUDA card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_views(n_kf: int, n_q: int, seed: int = 0, revs: float = 2.0, rings: int = 2, varied: bool = False):
    """(scene, camera, keyframe poses, query poses, (keyframe centres,
    directions), (query centres, directions)), as the reference tool builds
    them."""
    import torch

    from gf_orb_slam_tpu_torch.geometry import quat, se3
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import synthetic

    scene = synthetic.make_room_scene(seed=seed)
    if varied:
        trng = np.random.default_rng(5000 + seed)
        tex = np.stack([synthetic.varied_texture(trng, scene.tex_size) for _ in range(scene.textures.shape[0])])
        scene = scene._replace(textures=torch.as_tensor(tex))
    rng = np.random.default_rng(seed + 1)

    def pose_at(th, radius, bob):
        pos = torch.tensor([radius * np.sin(th), bob, radius * np.cos(th)], dtype=torch.float32)
        q_wc = quat.v2q(torch.tensor([0.0, th, 0.0], dtype=torch.float32))
        return se3.inverse(se3.make_pose(q_wc, pos))

    kf_poses = []
    for i in range(n_kf):
        th = 2.0 * np.pi * revs * i / n_kf
        ring = i % max(rings, 1)
        kf_poses.append(pose_at(th, 4.0 - 0.4 * ring, 0.12 * (ring - (rings - 1) / 2.0)))
    q_poses = []
    for j in range(n_q):
        i = (j * n_kf) // n_q
        th = 2.0 * np.pi * revs * (i + 0.5) / n_kf + rng.normal(0, 0.01)
        radius = 3.75 + rng.normal(0, 0.1)
        q_poses.append(pose_at(th, radius, rng.normal(0, 0.1)))

    def centers_dirs(poses):
        cs, ds = [], []
        for p in poses:
            p_wc = se3.inverse(p)
            cs.append(se3.pose_t(p_wc).numpy())
            ds.append(quat.q2r(se3.pose_q(p_wc)).numpy()[:, 2])  # the camera's +z in the world
        return np.stack(cs), np.stack(ds)

    return scene, EUROC_CAM, kf_poses, q_poses, centers_dirs(kf_poses), centers_dirs(q_poses)


def extract_all(scene, cam, poses, dev, n_features: int = 800) -> list:
    """(descriptors, validity) per pose, each frame rendered on the CPU and
    extracted on `dev`."""
    from gf_orb_slam_tpu_torch.io_utils import synthetic
    from gf_orb_slam_tpu_torch.ops import orb

    cfg = orb.OrbConfig(n_features=n_features)
    out = []
    for p in poses:
        kp = orb.extract_orb(synthetic.render_general(scene, cam, p).to(dev), cfg)
        out.append((kp.desc, kp.valid))
    return out


def sparse_bow(voc, desc, valid):
    """A frame's (word ids, L1-normalised tf-idf values)."""
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    words, _ = voc_mod.quantize(voc, desc, valid)
    w = words.cpu().numpy()
    ids, tf = np.unique(w[w >= 0], return_counts=True)
    vals = tf.astype(np.float64) * voc.weights.cpu().numpy()[ids]
    s = vals.sum()
    return ids, (vals / s if s > 0 else vals).astype(np.float32)


def l1_score_sparse(q_ids, q_vals, d_ids, d_vals) -> float:
    """Σ min(q, d) over the words both rows hold."""
    qi = {int(i): float(v) for i, v in zip(q_ids, q_vals)}
    return sum(min(qi[int(i)], float(v)) for i, v in zip(d_ids, d_vals) if int(i) in qi)


def evaluate(voc, kf_feats, q_feats, gt_mat, far_mat) -> dict:
    """P@1, R@5, MRR, the score margins over far and near distractors
    (mean and 10th percentile) and quantization ms per frame."""
    t0 = time.perf_counter()
    kf_bows = [sparse_bow(voc, d, v) for d, v in kf_feats]
    q_bows = [sparse_bow(voc, d, v) for d, v in q_feats]
    quant_ms = (time.perf_counter() - t0) * 1000.0 / (len(kf_feats) + len(q_feats))
    p1 = r5 = mrr = 0.0
    margins, margins_near = [], []
    n_q = len(q_bows)
    for qi, (qid, qv) in enumerate(q_bows):
        scores = np.asarray([l1_score_sparse(qid, qv, did, dv) for did, dv in kf_bows])
        order = np.argsort(-scores)
        rel, far = gt_mat[qi], far_mat[qi]
        near = ~rel & ~far
        if not rel.any():
            n_q -= 1
            continue
        p1 += float(rel[order[0]])
        r5 += float(rel[order[:5]].any())
        mrr += 1.0 / (1 + int(np.argmax(rel[order])))
        if far.any():
            margins.append(scores[rel].max() / max(scores[far].max(), 1e-9))
        if near.any():
            margins_near.append(scores[rel].max() / max(scores[near].max(), 1e-9))
    n_q = max(n_q, 1)

    def stats(xs):
        return (round(float(np.mean(xs)), 3), round(float(np.percentile(xs, 10)), 3)) if xs else (None, None)

    m_mean, m_p10 = stats(margins)
    mn_mean, mn_p10 = stats(margins_near)
    return {"p_at_1": round(p1 / n_q, 4), "r_at_5": round(r5 / n_q, 4), "mrr": round(mrr / n_q, 4),
            "margin_mean": m_mean, "margin_p10": m_p10, "margin_near_mean": mn_mean, "margin_near_p10": mn_p10,
            "quantize_ms_per_frame": round(quant_ms, 2), "n_words": int(voc.n_words), "depth_L": int(voc.L)}


def ground_truth(kc, kd, qc, qd, gt_angle_deg: float, gt_dist: float):
    """(relevant, far) boolean (queries, keyframes) matrices."""
    dist = np.linalg.norm(qc[:, None] - kc[None, :], axis=-1)
    gt = ((qd @ kd.T) > np.cos(np.deg2rad(gt_angle_deg))) & (dist < gt_dist)
    far = ((qd @ kd.T) < np.cos(np.deg2rad(2.0 * gt_angle_deg))) | (dist > 2.0 * gt_dist)
    return gt, far


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kfs", type=int, default=240)
    ap.add_argument("--queries", type=int, default=80)
    ap.add_argument("--revs", type=float, default=2.0)
    ap.add_argument("--rings", type=int, default=2)
    ap.add_argument("--varied", action="store_true", help="held-out widened-texture walls")
    ap.add_argument("--vocab", action="append", default=[], help="'packaged', 'tiny' or a path; repeatable")
    ap.add_argument("--gt-angle-deg", type=float, default=25.0)
    ap.add_argument("--gt-dist", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "torch_vocab_stress.json"))
    args = ap.parse_args(argv)

    import torch

    from gf_orb_slam_tpu_torch.pipeline.system import resolve_device
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    dev = resolve_device(args.device)
    header = {"torch": torch.__version__, "device": str(dev)}
    if dev.type == "cuda":
        header["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                              capture_output=True, text=True).stdout.strip()
    scene, cam, kf_poses, q_poses, (kc, kd), (qc, qd) = build_views(args.kfs, args.queries, args.seed,
                                                                    revs=args.revs, rings=args.rings,
                                                                    varied=args.varied)
    t0 = time.perf_counter()
    kf_feats = extract_all(scene, cam, kf_poses, dev)
    q_feats = extract_all(scene, cam, q_poses, dev)
    extract_s = time.perf_counter() - t0
    gt, far = ground_truth(kc, kd, qc, qd, args.gt_angle_deg, args.gt_dist)
    results = {}
    for spec in args.vocab or ["packaged", "tiny"]:
        if spec == "packaged":
            voc = voc_mod.load_default_vocabulary(dev)
        elif spec == "tiny":
            descs = np.concatenate([d.cpu().numpy()[v.cpu().numpy()] for d, v in kf_feats[:20]])
            voc = voc_mod.train_vocabulary(descs, k=10, L=3, seed=0, device=dev)
        else:
            voc = voc_mod.load_vocabulary(spec, dev)
        results[spec] = evaluate(voc, kf_feats, q_feats, gt, far)
        print(spec, json.dumps(results[spec]), flush=True)
    payload = {**header, "protocol": {"keyframes": args.kfs, "queries": args.queries, "gt_angle_deg": args.gt_angle_deg,
                                      "gt_dist_m": args.gt_dist, "gt_mean_relevant": float(gt.sum(1).mean()),
                                      "seed": args.seed, "extract_seconds": round(extract_s, 2)},
               "results": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
