#!/usr/bin/env python3
"""Train an ORB vocabulary offline from rendered synthetic views with the
PyTorch port (tools/train_vocabulary.py on the port).

    python tools/torch_train_vocabulary.py --out voc.npz [--k 10] [--L 5] [--scenes 6] \
        [--frames-per-scene 40] [--varied] [--corpus-cache PATH] [--device cuda]

Renders --frames-per-scene views of each of --scenes scenes on the CPU (even
scenes: the plane field with the bench camera along its trajectory; odd: the
room with the EuRoC camera around its circuit; scene seed = its index;
--varied swaps in textures of the widened family, seeded 1000 + index),
extracts ORB (800 features) with the port's front-end on the device
(`mapping/frame.make_frame`), keeps the valid descriptors, trains a k^L-word
tree by hierarchical binary k-medians (`retrieval/vocabulary.train_vocabulary`,
numpy) and saves it in the binary (.npz) form. --corpus-cache reuses (or
writes) the descriptor corpus. Runs on the first CUDA card unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_corpus(n_scenes: int, frames_per_scene: int, dev, n_features: int = 800, varied: bool = False):
    """(D, 8) uint32 valid descriptors of every rendered view."""
    import torch

    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM, CameraModel
    from gf_orb_slam_tpu_torch.io_utils import synthetic
    from gf_orb_slam_tpu_torch.mapping import frame as frame_mod
    from gf_orb_slam_tpu_torch.ops import orb

    cam_plain = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0)
    cfg = orb.OrbConfig(n_features=n_features)
    descs = []
    t0 = time.time()
    for s in range(n_scenes):
        if s % 2 == 0:
            scene = synthetic.make_scene(seed=s)
            _, poses = synthetic.trajectory(frames_per_scene, fps=20.0)
            cam, render = cam_plain, synthetic.render
        else:
            scene = synthetic.make_room_scene(seed=s)
            _, poses = synthetic.circuit_trajectory(frames_per_scene, radius=4.0)
            cam, render = EUROC_CAM, synthetic.render_general
        if varied:
            rng = np.random.default_rng(1000 + s)
            tex = np.stack([synthetic.varied_texture(rng, scene.tex_size) for _ in range(scene.textures.shape[0])])
            scene = scene._replace(textures=torch.as_tensor(tex))
        for i in range(frames_per_scene):
            f = frame_mod.make_frame(render(scene, cam, torch.as_tensor(poses[i])).to(dev), cam, cfg)
            descs.append(f.desc.cpu().numpy()[f.valid.cpu().numpy()].view(np.uint32))
        print(f"scene {s + 1}/{n_scenes}: corpus {sum(len(d) for d in descs)} descs ({time.time() - t0:.0f}s)",
              flush=True)
    return np.concatenate(descs, axis=0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=5)
    ap.add_argument("--scenes", type=int, default=6)
    ap.add_argument("--frames-per-scene", type=int, default=40)
    ap.add_argument("--corpus-cache", default="")
    ap.add_argument("--varied", action="store_true", help="widened texture and lighting corpus")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gf_orb_slam_tpu_torch.pipeline.system import resolve_device
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    dev = resolve_device(args.device)
    if args.corpus_cache and os.path.exists(args.corpus_cache):
        corpus = np.load(args.corpus_cache)["descs"]
        print(f"loaded cached corpus: {len(corpus)} descriptors")
    else:
        t0 = time.time()
        corpus = build_corpus(args.scenes, args.frames_per_scene, dev, varied=args.varied)
        print(f"corpus: {len(corpus)} descriptors ({time.time() - t0:.1f}s)")
        if args.corpus_cache:
            np.savez_compressed(args.corpus_cache, descs=corpus)
    t0 = time.time()
    voc = voc_mod.train_vocabulary(corpus, k=args.k, L=args.L, device="cpu")
    print(f"trained k={args.k} L={args.L} ({voc.n_words} words) in {time.time() - t0:.1f}s")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    voc_mod.save_binary(args.out, voc)
    path = args.out if args.out.endswith(".npz") else args.out + ".npz"
    print(f"saved {args.out} ({os.path.getsize(path) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
