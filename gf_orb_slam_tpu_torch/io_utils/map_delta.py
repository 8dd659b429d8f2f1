"""Map states stored as row deltas in one npz, numpy only.

A stage fixture holds several maps of one run that differ in few rows: the
map before and after a keyframe insertion, each intermediate map of the
insertion, the map at the next tracked frames. One map is stored whole in
the snapshot schema (`map_*` keys, io_utils/snapshot.py); every other map
`name` stores, for each field, the rows where it differs from its base map
(`name__base`), as `name__<field>__rows` (int32 row ids) and
`name__<field>__vals`. 0-d fields (the counters) are stored whole as
`name__<field>`. `decode` follows the chain of bases back to the whole map.
`agreement` holds one map against another, field by field.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

WHOLE = "map"


def _differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(rows,) bool: rows of a that differ from b (NaN equals NaN)."""
    d = a != b
    if np.issubdtype(a.dtype, np.floating):
        d &= ~(np.isnan(a) & np.isnan(b))
    return d.reshape(d.shape[0], -1).any(axis=1)


def encode(name: str, cur: Mapping[str, np.ndarray], base: Mapping[str, np.ndarray], base_name: str) -> dict:
    """The npz entries of map `cur` as row deltas against map `base`, which
    is stored under `base_name`."""
    out = {f"{name}__base": np.asarray(base_name)}
    for f, a in cur.items():
        a = np.asarray(a)
        if a.ndim == 0:
            out[f"{name}__{f}"] = a
            continue
        b = np.asarray(base[f])
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}.{f}: {a.shape} {a.dtype} against the base's {b.shape} {b.dtype}")
        rows = np.flatnonzero(_differ(a, b)).astype(np.int32)
        out[f"{name}__{f}__rows"] = rows
        out[f"{name}__{f}__vals"] = a[rows]
    return out


def whole(arrays: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The map stored whole (`map_*` keys), field → array."""
    n = len(WHOLE) + 1
    return {k[n:]: np.asarray(v) for k, v in arrays.items() if k.startswith(WHOLE + "_")}


def decode(arrays: Mapping[str, np.ndarray], name: str) -> dict[str, np.ndarray]:
    """Map `name` (field → array) from the npz entries `arrays`."""
    if name == WHOLE:
        return whole(arrays)
    out = decode(arrays, str(arrays[f"{name}__base"]))
    for f in list(out):
        if f"{name}__{f}" in arrays:
            out[f] = np.asarray(arrays[f"{name}__{f}"])
        elif f"{name}__{f}__rows" in arrays:
            a = out[f].copy()
            a[arrays[f"{name}__{f}__rows"]] = arrays[f"{name}__{f}__vals"]
            out[f] = a
    return out


def agreement(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> dict:
    """Map `got` against map `want` (numpy fields): the share of pt_valid
    that agrees, the share of kf_obs_point that agrees over the slots either
    side fills, how many points differ in validity or observations, whether
    keyframe validity is equal, and the largest keyframe-pose gap (keyframes
    valid on both sides) and point gap (points valid on both sides)."""
    pv, wpv = np.asarray(got["pt_valid"]), np.asarray(want["pt_valid"])
    o, wo = np.asarray(got["kf_obs_point"]), np.asarray(want["kf_obs_point"])
    kv = np.asarray(got["kf_valid"]) & np.asarray(want["kf_valid"])
    either, both, moved = (o >= 0) | (wo >= 0), pv & wpv, o != wo
    differ = np.union1d(np.flatnonzero(pv != wpv), np.concatenate([o[moved], wo[moved]]))
    return {"pt_valid": float((pv == wpv).mean()),
            "kf_obs_point": float((o == wo)[either].mean()) if either.any() else 1.0,
            "points_differ": int((differ >= 0).sum()),
            "kf_valid_equal": bool(np.array_equal(got["kf_valid"], want["kf_valid"])),
            "kf_pose": float(np.abs(got["kf_pose"][kv] - want["kf_pose"][kv]).max(initial=0.0)),
            "pt_pos": float(np.abs(got["pt_pos"][both] - want["pt_pos"][both]).max(initial=0.0))}
