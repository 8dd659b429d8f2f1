"""Reading the reference's map snapshots and in-memory numpy state into the
port's tensors (the read side of gf_orb_slam_tpu/io_utils/snapshot.py).

uint32 arrays (descriptors) become int32 bit views; bool arrays become
torch.bool; everything else keeps its dtype. Only numpy is needed to read.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gf_orb_slam_tpu_torch.mapping.frame import FrameData
from gf_orb_slam_tpu_torch.mapping.map_state import MapState
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


def load_map(path: str, device):
    """A reference snapshot (`save_map`) on `device`: (MapState, Vocabulary
    or None, BowDatabase or None). Snapshots from before the sparse BoW
    database (a dense `db_bow`) carry no database here."""
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
    if "db_bow_ids" in arrays:
        db = kdb.BowDatabase(**_select(arrays, "db_", kdb.BowDatabase._fields, device))
    return m, voc, db
