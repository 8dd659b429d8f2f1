"""Map snapshots (port of gf_orb_slam_tpu/io_utils/snapshot.py) and
in-memory numpy state as the port's tensors.

A snapshot is one npz of the map's fields (`map_*`), the vocabulary
(`voc_*`) and the BoW database (`db_*`) in the reference's schema, so each
side reads the other's files. Descriptor arrays are uint32 on disk and int32
bit views in the port; bool arrays become torch.bool; everything else keeps
its dtype. Only numpy is needed to read or write.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gf_orb_slam_tpu_torch.mapping.frame import FrameData
from gf_orb_slam_tpu_torch.mapping.map_state import MapState, to_numpy
from gf_orb_slam_tpu_torch.pipeline.track_view import TrackView


def to_tensor(a, device) -> torch.Tensor:
    """numpy array → tensor on `device`; uint32 becomes its int32 bit view."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)  # copy: npz arrays are read-only


def _select(arrays: Mapping[str, np.ndarray], prefix: str, fields, device) -> dict:
    missing = [f for f in fields if prefix + f not in arrays]
    if missing:
        raise KeyError(f"missing {prefix}* keys: {missing}")
    return {f: to_tensor(arrays[prefix + f], device) for f in fields}


def map_state_from_numpy(arrays: Mapping[str, np.ndarray], device, prefix: str = "") -> MapState:
    """MapState from a field → array mapping (keys may carry `prefix`)."""
    return MapState(**_select(arrays, prefix, MapState._fields, device))


def track_view_from_numpy(arrays: Mapping[str, np.ndarray], device, prefix: str = "") -> TrackView:
    return TrackView(**_select(arrays, prefix, TrackView._fields, device))


def frame_from_numpy(arrays: Mapping[str, np.ndarray], device, prefix: str = "") -> FrameData:
    return FrameData(**_select(arrays, prefix, FrameData._fields, device))


def save_map(path: str, m: MapState, voc=None, db=None) -> None:
    """Write the map, and the vocabulary and BoW database where given, in
    the reference's npz schema (descriptors and vocabulary centres uint32)."""
    arrays = {f"map_{k}": v for k, v in to_numpy(m).items()}
    if voc is not None:
        arrays.update(voc_centers=voc.centers.cpu().numpy().view(np.uint32), voc_weights=voc.weights.cpu().numpy(),
                      voc_kL=np.asarray([voc.k, voc.L]))
        if voc.children is not None:
            arrays.update(voc_children=voc.children.cpu().numpy(), voc_word_of_node=voc.word_of_node.cpu().numpy())
    if db is not None:
        arrays.update({f"db_{k}": v.cpu().numpy() for k, v in db._asdict().items()})
    np.savez_compressed(path, **arrays)


def rebuild_legacy_db(arrays: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The sparse database fields (numpy) of a snapshot from before the
    sparse BoW database: its dense (K, n_words) `db_bow` becomes each
    keyframe's (word id, tf-idf) row, word ids in keypoint order of first
    occurrence, so that resuming keeps the loop-closing and relocalization
    state (a copy of the reference's rebuild)."""
    bow = np.asarray(arrays["db_bow"])                     # (K, n_words)
    words = np.asarray(arrays["db_words"])                 # (K, N)
    K, N = words.shape
    n_words = bow.shape[1]
    ids = np.full((K, N), n_words, np.int32)
    vals = np.zeros((K, N), np.float32)
    for k in range(K):
        w = words[k]
        uniq, first = np.unique(w[w >= 0], return_index=True)
        pos = np.flatnonzero(w >= 0)[first]
        ids[k, pos] = uniq
        vals[k, pos] = bow[k, uniq]
    return {"db_bow_ids": ids, "db_bow_vals": vals, "db_words": words,
            "db_mid_nodes": np.asarray(arrays["db_mid_nodes"]), "db_valid": np.asarray(arrays["db_valid"])}


def load_map(path: str, device):
    """A snapshot (this module's or the reference's `save_map`) on `device`:
    (MapState, Vocabulary or None, BowDatabase or None). A snapshot from
    before the sparse BoW database (a dense `db_bow`) has its database
    rebuilt (rebuild_legacy_db)."""
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    m = map_state_from_numpy({k: v for k, v in arrays.items() if k.startswith("map_")}, device, prefix="map_")
    voc = None
    if "voc_centers" in arrays:
        k, L = (int(x) for x in arrays["voc_kL"])
        opt = {f: to_tensor(arrays[f"voc_{f}"], device) for f in ("children", "word_of_node")
               if f"voc_{f}" in arrays}
        voc = voc_mod.Vocabulary(centers=to_tensor(arrays["voc_centers"], device),
                                 weights=to_tensor(arrays["voc_weights"], device), k=k, L=L, **opt)
    db = None
    if "db_bow_ids" not in arrays and "db_bow" in arrays:
        arrays.update(rebuild_legacy_db(arrays))
    if "db_bow_ids" in arrays:
        db = kdb.BowDatabase(**_select(arrays, "db_", kdb.BowDatabase._fields, device))
    return m, voc, db
