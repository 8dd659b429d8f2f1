#!/usr/bin/env python3
"""Locates the first op whose output parts two runs of one input (the port
on one device, in one process).

    python tools/torch_repeat_probe.py [--witness schur distributed correct system] [--frames 60]
                                       [--device cpu] [--out results/repeat_probe.json]

Each witness runs once to fill first-use caches, then twice under a
`TorchDispatchMode` that records every aten
op in call order: its name, the innermost frames of the repository's code
that called it, and an on-device checksum of each output's bits (their
int64 sum weighted by position, so equal checksums mean equal bits up to a
hash collision). For a scatter it also records how many
addends the busiest output row takes and how many rows take two and three
or more (`index_add`, `index_put` with one index tensor, `scatter_add` /
`scatter_reduce` with a flat index). Nothing is read back to the host
until a run ends. Then the tool prints, for each witness, whether the
outputs repeat bit for bit, the first op whose output differs (with its
stack and its addends where it is a scatter), the first differing op of
each other site in order, and the number of differing ops. A plain write
(`index_put_` without accumulate) whose only repeated index is a dropped
row, as `map_state.set_drop` makes, differs there without reaching any
output.

The witnesses, on the card unless --device cpu:

1. schur — `local_ba.bundle_adjust` (5 + 10 LM) of the room fixture's final
   map (the reference's room map after its loop, the BA problem built as
   `SlamSystem.ba_problem` builds it, the first keyframe fixed);
2. distributed — `global_ba.distributed_bundle_adjust` (10 LM, 25 PCG) of
   the same problem on a group of one (NCCL on the card, gloo on the CPU);
3. correct — `loop_closing.correct_loop` on the room fixture's loop, its
   pose graph taking steps: every free vertex of the graph it builds moved
   ~0.01 off (seeded), as `chip_smoke.py` phase 15 moves it;
4. system — `SlamSystem.process` over the bench sequence's first --frames
   frames in bench.py's configuration with the packaged 1M-word vocabulary
   (seed 0): per-frame poses and `obs_point`, and the final map.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROOM_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "room_fixture.npz")
PLACE_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "place_fixture.npz")
WITNESSES = ("schur", "distributed", "correct", "system")
SITE_DEPTH = 4
CHUNK = 4096
SCATTERS = ("index_add", "index_put", "_index_put_impl_", "scatter_add", "scatter_reduce")
# Ops whose outputs hold memory as they found it: no checksum.
UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_"})


def _site() -> tuple:
    """The innermost SITE_DEPTH frames of the repository's code (this tool
    left out), as 'path:line function'."""
    out = []
    f = sys._getframe(2)
    me = os.path.abspath(__file__)
    while f is not None and len(out) < SITE_DEPTH:
        path = f.f_code.co_filename
        if path.startswith(REPO) and os.path.abspath(path) != me:
            out.append(f"{os.path.relpath(path, REPO)}:{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return tuple(out)


def _bits(t):
    """The bits of t as a flat int64 tensor."""
    import torch

    t = t.detach().reshape(-1)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    view = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[t.element_size()]
    return t.contiguous().view(view).to(torch.int64)


class OpRecorder:
    """Records every aten op dispatched while it is active (see the module
    docstring); `finish()` reads the checksums back once."""

    def __init__(self):
        self.names: list[str] = []
        self.sites: list[tuple] = []
        self.scatter: dict[int, object] = {}   # op index → device (3,) [max addends, rows ≥ 2, rows ≥ 3]
        self._pending, self._chunks = [], []
        self._weights = {}

    def _weight(self, n: int, dev):
        import torch

        w = self._weights.get(dev)
        if w is None or w.numel() < n:
            w = torch.arange(max(n, 2 * (0 if w is None else w.numel()), 1 << 16), device=dev) % 65521 + 1
            self._weights[dev] = w
        return w[:n]

    def _checksum(self, out):
        """The int64 sum of the outputs' bits weighted by position (0-d, on
        the outputs' device), or None where there is nothing to read."""
        import torch

        flat = [t for t in (out if isinstance(out, (tuple, list)) else (out,)) if isinstance(t, torch.Tensor)]
        s = None
        for k, t in enumerate(flat):
            # Inside torch.func transforms (the pose graph's vmap(jacfwd))
            # outputs may be wrapped, or zero tensors without storage; the
            # transform's results are recorded when it returns.
            if (t.numel() == 0 or t.is_meta or t.layout != torch.strided or t._is_zerotensor()
                    or torch._C._functorch.is_functorch_wrapped_tensor(t)):
                continue
            b = _bits(t)
            x = (b * self._weight(b.numel(), b.device)).sum()
            s = x if s is None else s + (k + 1) * x.to(s.device)
        return s

    def _addends(self, name: str, args, kwargs):
        import torch

        idx = None
        if name.startswith("index_add") and len(args) > 2:
            idx = args[2]
        elif name.startswith(("index_put", "_index_put_impl_")) and len(args) > 1:
            ind = [i for i in args[1] if i is not None]
            if len(ind) == 1 and ind[0].dtype != torch.bool:
                idx = ind[0]
        elif name.startswith(("scatter_add", "scatter_reduce")) and len(args) > 2 and args[2].dim() == 1:
            idx = args[2]
        if idx is None or idx.numel() == 0:
            return None
        counts = torch.bincount(idx.reshape(-1).long().clamp(min=0))
        return torch.stack([counts.max(), (counts >= 2).sum(), (counts >= 3).sum()])

    def record(self, func, args, kwargs, out):
        name = str(func.overloadpacket.__name__) if hasattr(func, "overloadpacket") else str(func)
        i = len(self.names)
        self.names.append(str(func))
        self.sites.append(_site())
        # A collective's output is written when its work completes: it is
        # recorded as the input of the op that reads it.
        skip = name in UNINITIALISED or self.names[-1].startswith("c10d.")
        self._pending.append(None if skip else self._checksum(out))
        if name.startswith(SCATTERS):
            self.scatter[i] = self._addends(name, args, kwargs or {})
        if len(self._pending) >= CHUNK:
            self._flush()

    def _flush(self):
        import torch

        if not self._pending:
            return
        dev = next((c.device for c in self._pending if c is not None), torch.device("cpu"))
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        self._chunks.append(torch.stack([zero if c is None else c.to(dev) for c in self._pending]))
        self._pending = []

    def finish(self) -> dict:
        """{names, sites, checksums (n,) numpy (0 where nothing was read), scatter {i: [max, ≥2, ≥3]}}."""
        import numpy as np

        self._flush()
        sums = np.concatenate([c.cpu().numpy() for c in self._chunks]) if self._chunks else np.zeros(0)
        scatter = {i: (None if v is None else [int(x) for x in v.cpu()]) for i, v in self.scatter.items()}
        return {"names": self.names, "sites": self.sites, "checksums": sums, "scatter": scatter}


def recording(rec: OpRecorder):
    """A TorchDispatchMode that hands every op to `rec` (ops run inside the
    handler are not dispatched to it again)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            rec.record(func, args, kwargs, out)
            return out

    return Mode()


def compare(a: dict, b: dict, limit: int = 12) -> dict:
    """Where two recorded runs part: the first differing op, the first
    differing op of each other site (up to `limit`), the count."""
    import numpy as np

    n = min(len(a["names"]), len(b["names"]))
    same_name = np.array([a["names"][i] == b["names"][i] for i in range(n)], bool)
    diverge = int(np.argmin(same_name)) if n and not same_name.all() else None
    m = n if diverge is None else diverge
    differ = np.flatnonzero(a["checksums"][:m] != b["checksums"][:m])

    def op(i):
        return {"index": int(i), "op": a["names"][i], "stack": list(a["sites"][i]),
                "scatter_addends_max_rows2_rows3": a["scatter"].get(int(i))}

    sites, firsts = set(), []
    for i in differ:
        s = a["sites"][i][:1]
        if s not in sites:
            sites.add(s)
            firsts.append(op(i))
            if len(firsts) >= limit:
                break
    return {"ops": [len(a["names"]), len(b["names"])], "op_sequence_diverges_at": diverge,
            "ops_differing": int(len(differ)), "first_differing_op": op(differ[0]) if len(differ) else None,
            "first_differing_op_by_site": firsts}


def equal_bits(x, y) -> bool:
    import numpy as np

    x, y = np.asarray(x), np.asarray(y)
    return x.shape == y.shape and x.dtype == y.dtype and x.tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# The witnesses: each returns a function that runs it once and returns
# {name: numpy array} of its outputs.
# ---------------------------------------------------------------------------


def _room(dev):
    import numpy as np

    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel

    with np.load(ROOM_FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    return z, CameraModel(**meta["camera"])


def room_ba_problem(dev):
    """(camera, BAProblem) of the room fixture's final map, as
    SlamSystem.ba_problem builds it with the first keyframe fixed."""
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import map_delta, snapshot

    z, cam = _room(dev)
    m = snapshot.map_state_from_numpy(map_delta.decode(z, "map"), dev)
    ids = z["final_kf_ids"].tolist()
    system = run_slam.SlamSystem(cam, run_slam.room_config(), device=dev)
    prob, _, _, _ = system.ba_problem(m, ids, fixed_ids=ids[:1])
    return cam, prob


def _ba_out(res) -> dict:
    return {k: getattr(res, k).cpu().numpy() for k in ("poses", "points", "obs_active", "cost")}


def witness_schur(dev, args):
    from gf_orb_slam_tpu_torch.solvers import local_ba

    cam, prob = room_ba_problem(dev)
    return lambda: _ba_out(local_ba.bundle_adjust(cam, prob))


def witness_distributed(dev, args):
    from gf_orb_slam_tpu_torch.parallel import global_ba, launch

    cam, prob = room_ba_problem(dev)

    def run():
        with (launch.nccl_group() if dev.type == "cuda" else launch.gloo_group()) as g:
            res = global_ba.distributed_bundle_adjust(cam, prob, g)
            return _ba_out(global_ba.gather_result(res, prob.poses.shape[0], g))

    return run


def stepping(optimize):
    """optimize_pose_graph with every free vertex first moved ~0.01 off
    (seeded; the scale left alone), so that the graph takes steps."""
    import torch

    from gf_orb_slam_tpu_torch.geometry import sim3 as s3

    def call(prob, **kw):
        xi = 0.01 * torch.randn(prob.poses.shape[0], 7, generator=torch.Generator().manual_seed(0))
        xi[:, 6] = 0.0
        moved = torch.where(~prob.fixed[:, None], s3.compose(s3.exp(xi.to(prob.poses.device)), prob.poses),
                            prob.poses)
        return optimize(prob._replace(poses=moved), **kw)

    return call


def witness_correct(dev, args):
    from gf_orb_slam_tpu_torch.io_utils import map_delta, snapshot
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.solvers import pose_graph

    z, cam = _room(dev)
    m = snapshot.map_state_from_numpy(map_delta.decode(z, "loop_in"), dev)

    def t(a):
        return snapshot.to_tensor(a, dev)

    def run():
        optimize = pose_graph.optimize_pose_graph
        pose_graph.optimize_pose_graph = stepping(optimize)
        try:
            got = loop_closing.correct_loop(m, int(z["loop_query_kf"]), int(z["loop_loop_kf"]), t(z["loop_S12"]),
                                            t(z["loop_covis"]), cam=cam)
        finally:
            pose_graph.optimize_pose_graph = optimize
        return ms.to_numpy(got)

    return run


def bench_inputs(dev, frames: int):
    """(camera, timestamps, ground truth, frames on dev) of the bench
    sequence's first `frames` frames, rendered on the CPU."""
    import numpy as np

    from gf_orb_slam_tpu_torch import run_slam

    with np.load(PLACE_FIXTURE) as zf:
        meta = json.loads(str(zf["bench_meta"]))
    cam = run_slam.BENCH_CAMERA._replace(**{k: meta["camera"][k] for k in ("fx", "fy", "cx", "cy", "width",
                                                                          "height", "fps")})
    ts, poses_gt, imgs = run_slam.render_sequence(cam, frames, meta["scene_seed"], dev)
    return cam, ts, poses_gt, imgs


def bench_system_outputs(cam, ts, imgs, voc, dev) -> dict:
    """One run of `SlamSystem.process` over `imgs` in bench.py's
    configuration with `voc` preset (seed 0): per-frame poses (NaN where
    none) and `obs_point` rows (-2 where none), and the final map."""
    import numpy as np

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.mapping import map_state as ms

    system = run_slam.SlamSystem(cam, run_slam.bench_config(), device=dev, seed=0)
    system.set_vocabulary(voc)
    poses, obs = [], []

    def on_frame(i, log):
        poses.append(np.full(7, np.nan, np.float32) if log.pose_cw is None else np.asarray(log.pose_cw))
        obs.append(None if system.last_obs is None else system.last_obs.clone())

    run_slam.process_frames(system, ((ts[i], imgs[i]) for i in range(imgs.shape[0])), on_frame)
    obs_np = np.full((len(obs), max((o.shape[0] for o in obs if o is not None), default=0)), -2, np.int32)
    for i, o in enumerate(obs):
        if o is not None:
            obs_np[i, : o.shape[0]] = o.cpu().numpy()
    final = ms.to_numpy(system.map)
    return {"frame_poses": np.stack(poses), "frame_obs_point": obs_np,
            **{f"map_{k}": final[k] for k in ("kf_pose", "pt_pos", "kf_obs_point", "pt_valid", "kf_valid")}}


def witness_system(dev, args):
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    cam, ts, _, imgs = bench_inputs(dev, args.frames)
    voc = voc_mod.load_default_vocabulary(dev)
    return lambda: bench_system_outputs(cam, ts, imgs, voc, dev)


def probe(name: str, dev, args) -> dict:
    """The witness run once to warm up, then twice under the recorder; its
    report."""
    import numpy as np
    import torch

    run = {"schur": witness_schur, "distributed": witness_distributed, "correct": witness_correct,
           "system": witness_system}[name](dev, args)
    warm = run()  # first-use caches (device constants, cuBLAS handles) filled before the recorded runs
    outs, recs, secs = [], [], []
    for _ in range(2):
        rec = OpRecorder()
        t0 = time.perf_counter()
        with recording(rec):
            outs.append(run())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        recs.append(rec.finish())
    keys = sorted(outs[0])
    differ = [k for k in keys if not equal_bits(outs[0][k], outs[1][k])]
    warm_differ = [k for k in keys if not equal_bits(warm[k], outs[0][k])]
    report = {"witness": name, "device": str(dev), "seconds": secs, "outputs": keys,
              "outputs_repeat": not differ, "outputs_differing": differ,
              "warm_up_run_outputs_differing": warm_differ, **compare(*recs)}
    for k in differ:
        a, b = outs[0][k].astype(float), outs[1][k].astype(float)
        with_nan = ~(np.isnan(a) & np.isnan(b)) if a.shape == b.shape else None
        report.setdefault("max_abs_diff", {})[k] = (float(np.nanmax(np.abs(a - b)[with_nan]))
                                                    if with_nan is not None and with_nan.any() else None)
    return report


def main(argv=None) -> list:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--witness", nargs="+", choices=WITNESSES, default=list(WITNESSES))
    ap.add_argument("--frames", type=int, default=60, help="bench-system frames (witness 4)")
    ap.add_argument("--device", default=None, help="the first CUDA card unless given (cpu for a rehearsal)")
    ap.add_argument("--out", help="write the reports as JSON here")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu")
    dev = torch.device(args.device or "cuda")
    reports = []
    for name in args.witness:
        rep = probe(name, dev, args)
        reports.append(rep)
        print(json.dumps(rep), flush=True)
    print(json.dumps({"summary": {r["witness"]: {"outputs_repeat": r["outputs_repeat"],
                                                 "ops_differing": r["ops_differing"],
                                                 "first": (r["first_differing_op"] or {}).get("stack", [None])[:1]}
                                  for r in reports}}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    return reports


if __name__ == "__main__":
    main()
