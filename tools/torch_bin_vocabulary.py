#!/usr/bin/env python3
"""Vocabulary format converter of the PyTorch port (tools/bin_vocabulary.py
on the port; the C++ reference's tools/bin_vocabulary.cc converts DBoW2 text
vocabularies to a fast-loading binary form).

    python tools/torch_bin_vocabulary.py ORBvoc.txt ORBvoc.npz   # text → binary
    python tools/torch_bin_vocabulary.py voc.npz voc.txt         # binary → text

Reads and writes with `retrieval/vocabulary.py` on the CPU and prints the
tree's branching, depth, word count and the load and save seconds.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    src, dst = argv
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    t0 = time.perf_counter()
    voc = voc_mod.load_vocabulary(src, "cpu")
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    if dst.endswith(".txt"):
        voc_mod.save_dbow2_text(dst, voc)
    else:
        voc_mod.save_binary(dst, voc)
    t_save = time.perf_counter() - t0
    print(f"{src} → {dst}: k={voc.k} L={voc.L} words={voc.n_words} (load {t_load:.2f}s, save {t_save:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
