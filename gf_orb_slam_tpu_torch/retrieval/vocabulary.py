"""Binary bag-of-words vocabulary tree (port of
gf_orb_slam_tpu/retrieval/vocabulary.py): a k-ary tree of packed binary
centres, quantization of a frame's descriptors by L levels of batched XOR +
popcount argmin, and dense (n_words,) tf-idf BoW vectors.

Training (hierarchical binary k-medians) is the reference's host numpy code,
copied: it draws from `np.random.default_rng` and must agree bit for bit.
Descriptors on the device are int32 bit views of the reference's uint32
words, as everywhere in the port.

The packaged pretrained trees live in the JAX package's data directory; the
port reads them by file path with numpy and imports nothing from there.
Files: the DBoW2 text format (ORBvoc.txt) and the reference's binary npz,
read and written in host numpy as the reference does.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from gf_orb_slam_tpu_torch.io_utils.snapshot import to_tensor
from gf_orb_slam_tpu_torch.ops.matching import _popcount32

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "gf_orb_slam_tpu", "data")


class Vocabulary(NamedTuple):
    centers: torch.Tensor   # (n_nodes, 8) int32 — k-ary tree, root at 0
    weights: torch.Tensor   # (n_words,) float32 idf weights
    k: int                  # branching factor
    L: int                  # depth (levels below the root)
    # Explicit (possibly incomplete) trees only; None ⇒ implicit complete
    # tree with the node*k+1 layout.
    children: torch.Tensor | None = None      # (n_nodes, k) int32 child ids
    word_of_node: torch.Tensor | None = None  # (n_nodes,) int32 word id or −1

    @property
    def n_words(self) -> int:
        if self.word_of_node is not None:
            return int(self.weights.shape[0])
        return self.k**self.L

    def first_leaf(self) -> int:
        return (self.k**self.L - 1) // (self.k - 1)

    def to(self, device) -> "Vocabulary":
        return self._replace(**{f: getattr(self, f).to(device) for f in ("centers", "weights", "children",
                                                                        "word_of_node")
                                if getattr(self, f) is not None})


# ---------------------------------------------------------------------------
# Training (host numpy, copied from the reference)
# ---------------------------------------------------------------------------


def _unpack_bits(descs: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 → (N, 256) uint8 bits."""
    b = descs.view(np.uint8).reshape(len(descs), 32)
    return np.unpackbits(b, axis=1, bitorder="little")


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, 256) → (N, 8) uint32."""
    by = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return by.reshape(len(bits), 32).view(np.uint32).reshape(len(bits), 8)


def _kmedians_binary(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians: majority-bit centers; returns (centers (k,8), assign)."""
    n = len(descs)
    if n <= k:
        centers = np.zeros((k, 8), np.uint32)
        centers[:n] = descs
        return centers, np.arange(n) % k
    idx = rng.choice(n, k, replace=False)
    centers = descs[idx].copy()
    bits = _unpack_bits(descs)
    for _ in range(iters):
        # Hamming distances to centers (vectorized popcount; numpy ≥ 2).
        x = descs[:, None, :] ^ centers[None, :, :]
        d = np.bitwise_count(x).sum(axis=2, dtype=np.int32)
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = bits[assign == c]
            if len(sel) == 0:
                centers[c] = descs[rng.integers(n)]
            else:
                centers[c] = _pack_bits((sel.mean(axis=0) > 0.5)[None, :])[0]
    return centers, assign


def train_numpy(descs: np.ndarray, k: int = 10, L: int = 3, seed: int = 0):
    """Hierarchical binary k-medians (DBoW2 create()) on (M, 8) uint32
    descriptors: (centers (n_nodes, 8) uint32, idf weights (k^L,) float32)."""
    rng = np.random.default_rng(seed)
    n_nodes = (k ** (L + 1) - 1) // (k - 1)
    centers = np.zeros((n_nodes, 8), np.uint32)

    # Recursive split, breadth-first; node 0 is the root (center unused).
    groups = {0: np.arange(len(descs))}
    for level in range(L):
        new_groups = {}
        for node, idxs in groups.items():
            child0 = node * k + 1
            if len(idxs) == 0:
                for c in range(k):
                    new_groups[child0 + c] = idxs
                continue
            c_centers, assign = _kmedians_binary(descs[idxs], k, rng)
            for c in range(k):
                centers[child0 + c] = c_centers[c]
                new_groups[child0 + c] = idxs[assign == c]
        groups = new_groups

    # idf weights from the training corpus (TemplatedVocabulary::setWeights).
    n_words = k**L
    first_leaf = (k**L - 1) // (k - 1)
    counts = np.zeros(n_words)
    for node, idxs in groups.items():
        counts[node - first_leaf] = len(idxs)
    n_docs = max(len(descs), 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0))
    return centers, idf.astype(np.float32)


def train_vocabulary(descs: np.ndarray, k: int = 10, L: int = 3, seed: int = 0, device=None) -> Vocabulary:
    """The trained tree on `device`; descs (M, 8) uint32 (or their int32 view)."""
    centers, weights = train_numpy(np.ascontiguousarray(descs).view(np.uint32), k, L, seed)
    return Vocabulary(centers=to_tensor(centers, device), weights=to_tensor(weights, device), k=k, L=L)


def random_vocabulary(k: int = 10, L: int = 3, seed: int = 0, device=None) -> Vocabulary:
    """Random-centre vocabulary (uniform bits), the reference's draw: enough
    for quantization to be consistent where no training corpus exists."""
    rng = np.random.default_rng(seed)
    n_nodes = (k ** (L + 1) - 1) // (k - 1)
    centers = rng.integers(0, 2**32, (n_nodes, 8), dtype=np.uint32)
    return Vocabulary(centers=to_tensor(centers, device), weights=torch.ones(k**L, device=device), k=k, L=L)


# ---------------------------------------------------------------------------
# Quantization and BoW vectors
# ---------------------------------------------------------------------------


def _descend(centers, descs, cand_of, L: int):
    """L levels of argmin over the (N, k) candidate children of each node;
    returns (leaf node, mid-level node). argmin keeps the first of equal
    distances, as the reference's does."""
    N = descs.shape[0]
    node = torch.zeros(N, dtype=torch.int64, device=descs.device)
    mid = node
    mid_level = max(L // 2, 1)
    for level in range(L):
        cand = cand_of(node)                                         # (N, k)
        x = torch.bitwise_xor(descs[:, None, :], centers[cand])      # (N, k, 8)
        d = _popcount32(x).sum(dim=-1)
        node = torch.gather(cand, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
        if level + 1 == mid_level:
            mid = node
    return node, mid


def quantize(voc: Vocabulary, descs: torch.Tensor, valid: torch.Tensor):
    """(N, 8) descriptors → (word ids (N,), mid-level node ids (N,)) int32;
    invalid slots −1."""
    if voc.children is not None:
        children = voc.children.long()
        node, mid = _descend(voc.centers, descs, lambda n: children[n], voc.L)
        words = voc.word_of_node[node]
    else:
        ar = torch.arange(voc.k, device=descs.device)
        node, mid = _descend(voc.centers, descs, lambda n: (n * voc.k + 1)[:, None] + ar[None, :], voc.L)
        words = (node - voc.first_leaf()).to(torch.int32)
    return torch.where(valid, words, -1), torch.where(valid, mid.to(torch.int32), -1)


def bow_vector(voc: Vocabulary, word_ids: torch.Tensor) -> torch.Tensor:
    """Dense L1-normalised tf-idf vector (n_words,) (BowVector). Counts are
    whole numbers, exact in float32 whatever order the adds run in."""
    W = voc.n_words
    idx = torch.where(word_ids >= 0, word_ids, W).long()
    counts = torch.zeros(W + 1, dtype=torch.float32, device=word_ids.device)
    counts = counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))[:W]
    v = counts * voc.weights
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 1 − ½|v1 − v2|₁ of L1-normalised vectors, batched
    over the leading dims of v2."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def load_binary(path: str, device=None) -> Vocabulary:
    """A vocabulary written by the reference's `save_binary` (npz)."""
    with np.load(path) as z:
        k, L = (int(x) for x in z["kL"])
        return Vocabulary(
            centers=to_tensor(z["centers"], device), weights=to_tensor(z["weights"], device), k=k, L=L,
            children=to_tensor(z["children"], device) if "children" in z.files else None,
            word_of_node=to_tensor(z["word_of_node"], device) if "word_of_node" in z.files else None,
        )


def save_binary(path: str, voc: Vocabulary) -> None:
    """The reference's binary vocabulary (npz): centres uint32, idf
    weights, (k, L), and an explicit tree's child table."""
    arrays = {"centers": voc.centers.cpu().numpy().view(np.uint32), "weights": voc.weights.cpu().numpy(),
              "kL": np.asarray([voc.k, voc.L])}
    if voc.children is not None:
        arrays["children"] = voc.children.cpu().numpy()
        arrays["word_of_node"] = voc.word_of_node.cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_dbow2_text(path: str, device=None) -> Vocabulary:
    """A DBoW2 text vocabulary (ORBvoc.txt, TemplatedVocabulary::saveToTextFile).

    Header `k L scoring weighting`, then one line per node in creation
    order: `parent_id is_leaf b0..b31 weight`, the 32 descriptor bytes in
    decimal. Node ids are implicit (root 0, first line 1, …); leaves take
    word ids in file order. Such trees are incomplete, so the result has an
    explicit child table: rows padded with their first child (argmin's
    first-index tie-break then lands on a real node), leaves and childless
    nodes pointing to themselves (the descent parks there)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaf_flags, descs, node_weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(int(parts[1]) != 0)
            descs.append([int(b) for b in parts[2:34]])
            node_weights.append(float(parts[34]))
    n = len(parents) + 1  # + root
    centers = np.zeros((n, 32), np.uint8)
    centers[1:] = np.asarray(descs, np.uint8)
    centers = centers.view(np.uint32).reshape(n, 8)

    children = np.full((n, k), -1, np.int64)
    n_children = np.zeros(n, np.int64)
    for i, p in enumerate(parents):
        node = i + 1
        if n_children[p] < k:
            children[p, n_children[p]] = node
            n_children[p] += 1
    word_of_node = np.full(n, -1, np.int64)  # word ids in file order of leaves (createWords())
    word_weights = []
    for i, is_leaf in enumerate(leaf_flags):
        if is_leaf:
            word_of_node[i + 1] = len(word_weights)
            word_weights.append(node_weights[i])
    for node in range(n):
        if n_children[node] == 0:
            children[node] = node
        else:
            children[node, n_children[node]:] = children[node, 0]
    return Vocabulary(centers=to_tensor(centers, device), weights=to_tensor(np.asarray(word_weights, np.float32), device),
                      k=k, L=L, children=to_tensor(children.astype(np.int32), device),
                      word_of_node=to_tensor(word_of_node.astype(np.int32), device))


def save_dbow2_text(path: str, voc: Vocabulary) -> None:
    """The DBoW2 text format (the inverse of load_dbow2_text), of an
    explicit or an implicit complete tree."""
    centers = voc.centers.cpu().numpy().view(np.uint8).reshape(-1, 32)
    n = len(centers)
    if voc.children is not None:
        children = voc.children.cpu().numpy()
        word_of_node = voc.word_of_node.cpu().numpy()
        parents = np.zeros(n, np.int64)
        is_leaf = word_of_node >= 0
        for node in range(n):
            for c in children[node]:
                if c != node and parents[c] == 0 and c != 0:
                    parents[c] = node
        node_weight = np.zeros(n, np.float64)
        node_weight[is_leaf] = voc.weights.cpu().numpy()[word_of_node[is_leaf]]
    else:
        parents = (np.arange(n) - 1) // voc.k
        parents[0] = 0
        first_leaf = voc.first_leaf()
        is_leaf = np.arange(n) >= first_leaf
        node_weight = np.zeros(n, np.float64)
        node_weight[first_leaf:] = voc.weights.cpu().numpy().astype(np.float64)
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.L} 0 0\n")
        for node in range(1, n):
            bytes_s = " ".join(str(b) for b in centers[node])
            f.write(f"{parents[node]} {1 if is_leaf[node] else 0} {bytes_s} {node_weight[node]:.6f}\n")


def load_vocabulary(path: str, device=None) -> Vocabulary:
    """'.txt' is the DBoW2 text format; anything else the binary npz."""
    return load_dbow2_text(path, device) if path.endswith(".txt") else load_binary(path, device)


def default_vocabulary_path() -> str:
    """The packaged pretrained tree: the 1M-word k=10 L=6 tree, else the
    100k-word one (gf_orb_slam_tpu/data, read by path)."""
    p1m = os.path.join(DATA_DIR, "vocab_1m.npz")
    return p1m if os.path.exists(p1m) else os.path.join(DATA_DIR, "vocab_100k.npz")


def load_default_vocabulary(device=None) -> Vocabulary | None:
    """The packaged pretrained vocabulary on `device`, or None if absent."""
    p = default_vocabulary_path()
    return load_binary(p, device) if os.path.exists(p) else None
