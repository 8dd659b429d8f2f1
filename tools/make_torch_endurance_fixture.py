#!/usr/bin/env python
"""Write the endurance fixture that the PyTorch port's loop closing is held
against stage by stage: one run of the JAX reference over
`tools/endurance.py --frames 1200 --pipeline 1 --cpu` (the room circuit at
0.99° of yaw per frame, 3.3 revolutions, the EuRoC camera, keyframe cadence
6, GF subset at budget 100, the packaged 1M-word vocabulary, 256 keyframe
and 16,384 point slots, synchronous, frames as rendered), with the loop
functions wrapped to record what they received and returned. About 25
minutes on the CPU at one XLA thread.

    python tools/make_torch_endurance_fixture.py [--frames 1200] [--threads 1] \
        [--out PATH] [--summary PATH]

--threads sets XLA's CPU threads (1: no Eigen threading); the run's rounding,
and so its trajectory, depends on it. Output (under 8 MB; maps as row deltas
against the final map, io_utils/map_delta.py):

* per loop closure j (`loop{j}_*`): the verification's inputs, the map
  (`loop{j}_map`), the query and candidate keyframes, the two rows of the
  BoW database's mid-level nodes that the verification reads
  (`loop{j}_db_mid_q`, `_db_mid_c`), the reference's own Sim3-RANSAC
  minimal sets (`loop{j}_samples`, (128, 3), recorded inside its solver),
  and its outputs `ok`, `S12`, `n_bow`, `n_ransac`, `n_guided`,
  `n_inliers`; the correction's inputs (that map, the verified `S12`,
  `loop{j}_covis`) and output map (`loop{j}_out`), with the essential
  graph's input and optimized poses (`loop{j}_graph_in`, `_graph_out`);
* the first candidate the reference verified and rejected (`reject_*`,
  verification only);
* the final map (`map_*`, the snapshot schema).

Per-keypoint rows (`kf_kp_uv`, `kf_kp_angle`, `kf_kp_desc`) are kept only for
keyframes a recorded stage reads (each stage's query and candidate, and the
top-8 covisible neighbours of the query and the loop keyframe, which hold
the fuse's targets and sources); the rest are zeroed. The tool re-runs every
recorded stage on the stored inputs and stops unless each reproduces its
recorded output exactly. `meta` holds the configuration, the run's summary
(segment ATEs, closures with their rotation error and scale against the
ground truth, `io_utils/loop_eval.sim3_against_ground_truth`, as
`tools/torch_endurance.py` reads them) and the git commit;
--summary writes that summary as JSON too.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "endurance_fixture.npz")
MAX_BYTES = 8 * 1024 * 1024
KP_ROWS = ("kf_kp_uv", "kf_kp_angle", "kf_kp_desc")
N_NEIGHBOURS = 8
VERIFY_OUT = ("ok", "S12", "n_bow", "n_ransac", "n_guided", "n_inliers")


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def host(tree) -> dict:
    """A NamedTuple of arrays as field → numpy copy."""
    return {k: np.array(v, copy=True) for k, v in tree._asdict().items()}


def xla_flags(threads: int) -> str:
    if threads == 1:
        return "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    return f"--xla_cpu_multi_thread_eigen=true intra_op_parallelism_threads={threads}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--segment", type=int, default=600)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--summary", default="")
    ap.add_argument("--state", default="", help="pickle the run's records here before writing the fixture")
    ap.add_argument("--resume", default="", help="write the fixture from a --state pickle instead of running")
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = xla_flags(args.threads)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu.loop import loop_closing
    from gf_orb_slam_tpu.retrieval import keyframe_db as kdb

    cam = EUROC_CAM
    verify, correct = loop_closing.verify_candidate, loop_closing.correct_loop
    if args.resume:
        with open(args.resume, "rb") as f:
            run = pickle.load(f)
    else:
        run = record_run(args, cam)
        if args.state:
            with open(args.state, "wb") as f:
                pickle.dump(run, f, protocol=4)
    stages, final, summary, cfg_d, revs = run["stages"], run["final"], run["summary"], run["cfg"], run["revs"]
    db = kdb.BowDatabase(**{k: jnp.asarray(v) for k, v in run["db"].items()})
    closures = [s for s in stages if s["ok"]]
    rejects = [s for s in stages if not s["ok"]]
    if not closures or not rejects:
        raise SystemExit(f"{len(closures)} closures and {len(rejects)} rejected candidates: the fixture needs one "
                         "of each")
    if summary["compactions"]:
        raise SystemExit("the run compacted its keyframe slab; the maps would not share keypoint rows")
    write_fixture(args, cam, stages, final, summary, cfg_d, revs, db, verify, correct)


def record_run(args, cam) -> dict:
    """The reference's endurance run with its loop functions wrapped; returns
    the recorded stages, the final map and database and the run's summary."""
    import jax
    import jax.numpy as jnp

    from gf_orb_slam_tpu.geometry import se3
    from gf_orb_slam_tpu.io_utils import evaluation, synthetic
    from gf_orb_slam_tpu.loop import loop_closing
    from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem
    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod
    from gf_orb_slam_tpu.solvers import pose_graph, sim3_solver
    from gf_orb_slam_tpu_torch.io_utils import loop_eval

    n = args.frames
    scene = synthetic.make_room_scene(seed=0)
    revs = n * 0.99 / 360.0
    ts, poses_gt = synthetic.circuit_trajectory(n, fps=cam.fps, radius=4.0, revs=revs)
    poses_gt = np.asarray(poses_gt)
    cfg = SlamConfig(max_frames_between_kf=6, use_gf=True, gf_budget=100, pipelined=False, pipeline_depth=1)
    system = SlamSystem(cam, cfg)
    system.set_vocabulary(voc_mod.load_default_vocabulary())

    # The reference's minimal sets, recorded inside its RANSAC: the wrapper
    # draws them with the solver's own code (sim3_solver.py:120-126) and
    # hands them to the host; the solver itself runs unchanged.
    drawn: list = []
    ransac = sim3_solver.solve_sim3_ransac

    def recording_ransac(cam_, x1, x2, uv1, uv2, s1, s2, valid, key, n_hypotheses=128, **kw):
        keys = jax.random.split(key, n_hypotheses)

        def sample3(k):
            g = jax.random.gumbel(k, (x1.shape[0],)) + jnp.where(valid, 0.0, -1e9)
            return jax.lax.top_k(g, 3)[1]

        jax.debug.callback(lambda i, v: drawn.append((np.asarray(i), np.asarray(v))), jax.vmap(sample3)(keys), valid)
        return ransac(cam_, x1, x2, uv1, uv2, s1, s2, valid, key, n_hypotheses=n_hypotheses, **kw)

    graphs: list = []
    optimize = pose_graph.optimize_pose_graph

    def recording_graph(prob, n_iters=20):
        out = optimize(prob, n_iters=n_iters)
        jax.debug.callback(lambda a, b: graphs.append((np.asarray(a), np.asarray(b))), prob.poses, out)
        return out

    stages: list = []          # verifications (accepted or the first rejected), in order
    verify = loop_closing.verify_candidate
    correct = loop_closing.correct_loop

    def recording_verify(cam_, m, db, query_kf, cand_kf, key, **kw):
        lm = verify(cam_, m, db, query_kf, cand_kf, key, **kw)
        jax.effects_barrier()
        outs = {k: np.asarray(getattr(lm, k)) for k in VERIFY_OUT}
        samples, valid = drawn[-1]
        if int(valid.sum()) != int(outs["n_bow"]):
            raise SystemExit(f"frame {system.frame_id}: the recorded draw's mask holds {int(valid.sum())} matches, "
                             f"the verification {int(outs['n_bow'])}")
        if bool(outs["ok"]) or not any(not s["ok"] for s in stages):
            q, c = int(query_kf), int(cand_kf)
            stages.append({"frame": system.frame_id, "map": host(m), "query_kf": q, "cand_kf": c,
                           "key": np.asarray(key), "kw": kw, "samples": samples,
                           "db_mid_q": np.asarray(db.mid_nodes[q]), "db_mid_c": np.asarray(db.mid_nodes[c]),
                           "ok": bool(outs["ok"]), "outs": outs})
        return lm

    def recording_correct(m, query_kf, loop_kf, S12, covis, **kw):
        res = correct(m, query_kf, loop_kf, S12, covis, **kw)
        jax.effects_barrier()
        st = stages[-1]
        if not (st["ok"] and st["query_kf"] == int(query_kf) and st["cand_kf"] == int(loop_kf)
                and np.array_equal(st["outs"]["S12"], np.asarray(S12))):
            raise SystemExit(f"frame {system.frame_id}: a correction without its verification")
        q, lk, fid = int(query_kf), int(loop_kf), np.asarray(m.kf_frame_id)
        row = loop_eval.sim3_against_ground_truth(np.asarray(S12), q, lk, np.asarray(m.kf_pose), fid,
                                                  np.asarray(m.kf_valid), poses_gt)
        st.update(covis=np.asarray(covis), correct_kw=kw, out=host(res), graph=graphs[-1],
                  closure={"frame": system.frame_id, "query_frame": int(fid[q]), "loop_frame": int(fid[lk]),
                           **{k: round(v, 4) for k, v in row.items()}})
        print("closure", json.dumps(st["closure"]), flush=True)
        return res

    sim3_solver.solve_sim3_ransac = recording_ransac
    pose_graph.optimize_pose_graph = recording_graph
    loop_closing.verify_candidate = recording_verify
    loop_closing.correct_loop = recording_correct
    seg_rows = []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            system.process(synthetic.render_general(scene, cam, jnp.asarray(poses_gt[i])), float(ts[i]))
            if (i + 1) % args.segment == 0:
                system.flush()
                seg_rows.append({"frame": i + 1, "live_keyframes": int(np.asarray(system.map.kf_valid).sum()),
                                 "live_points": int(np.asarray(system.map.pt_valid).sum()),
                                 "loops_closed": system.n_loops_closed, "compactions": system.n_compactions,
                                 "seconds": round(time.perf_counter() - t0, 1)})
                print(json.dumps(seg_rows[-1]), flush=True)
        system.flush()
    finally:
        loop_closing.verify_candidate = verify
        loop_closing.correct_loop = correct
    seconds = time.perf_counter() - t0

    est_ts, est_poses = system.get_trajectory()
    centers = lambda P: np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in P])  # noqa: E731
    gt_by_t = {round(float(t), 6): c for t, c in zip(ts, centers(poses_gt))}
    est_pos = centers(est_poses)
    gt_pos = np.stack([gt_by_t[round(float(t), 6)] for t in est_ts])
    tarr = np.asarray(est_ts)
    seg_ate = []
    for s0 in range(0, n, args.segment):
        msk = (tarr >= ts[s0]) & (tarr < ts[min(s0 + args.segment, n - 1)])
        seg_ate.append(round(evaluation.ate_rmse(est_pos[msk], gt_pos[msk]), 4) if msk.sum() > 30 else None)
    summary = {"xla_flags": os.environ["XLA_FLAGS"], "frames": n, "tracked": len(est_poses),
               "ate_rmse_m": evaluation.ate_rmse(est_pos, gt_pos), "segment_ate_m": seg_ate,
               "loops_closed": system.n_loops_closed, "closures": [s["closure"] for s in stages if s["ok"]],
               "compactions": system.n_compactions, "seconds": round(seconds, 1), "segments": seg_rows}
    print(json.dumps(summary), flush=True)
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)), exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump(summary, f, indent=1)
    for st in stages:
        st["kw"] = dict(st["kw"])
    return {"stages": stages, "final": host(system.map), "db": host(system.bow_db), "summary": summary,
            "cfg": {k: v for k, v in cfg.__dict__.items() if isinstance(v, (int, float, bool, str, tuple))},
            "revs": revs}


def write_fixture(args, cam, stages, final, summary, cfg_d, revs, db, verify, correct) -> None:
    """The fixture from the recorded run, each stage checked on its stored inputs."""
    import jax.numpy as jnp

    from gf_orb_slam_tpu.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.io_utils import map_delta

    def to_map(d: dict) -> ms.MapState:
        return ms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})

    closures = [s for s in stages if s["ok"]]
    rejects = [s for s in stages if not s["ok"]]

    # Keep per-keypoint rows only where a recorded stage reads them.
    keep = set()
    for s in stages:
        keep |= {s["query_kf"], s["cand_kf"]}
        if "covis" in s:
            for k in (s["query_kf"], s["cand_kf"]):
                keep |= set(np.argsort(-s["covis"][k], kind="stable")[:N_NEIGHBOURS].tolist())
    drop = np.setdiff1d(np.arange(final["kf_valid"].shape[0]), sorted(keep))

    def reduce(d: dict) -> dict:
        d = dict(d)
        for f in KP_ROWS:
            d[f] = d[f].copy()
            d[f][drop] = 0
        return d

    # Every stage again on the stored inputs, against its recorded output.
    for s in stages:
        m_in = reduce(s["map"])
        mid = np.array(db.mid_nodes, copy=True)
        mid[s["query_kf"]], mid[s["cand_kf"]] = s["db_mid_q"], s["db_mid_c"]
        lm = verify(cam, to_map(m_in), db._replace(mid_nodes=jnp.asarray(mid)), jnp.asarray(s["query_kf"]),
                    jnp.asarray(s["cand_kf"]), jnp.asarray(s["key"]), **s["kw"])
        for k in VERIFY_OUT:
            if not np.array_equal(np.asarray(getattr(lm, k)), s["outs"][k]):
                raise SystemExit(f"frame {s['frame']}: the verification on the stored inputs gives another {k}")
        if "covis" in s:
            res = host(correct(to_map(m_in), jnp.asarray(s["query_kf"]), jnp.asarray(s["cand_kf"]),
                               jnp.asarray(s["outs"]["S12"]), jnp.asarray(s["covis"]), **s["correct_kw"]))
            want = reduce(s["out"])
            bad = [k for k in want if not np.array_equal(res[k], want[k])]
            if bad:
                raise SystemExit(f"frame {s['frame']}: the correction on the stored inputs differs in {bad}: "
                                 f"{map_delta.agreement(res, want)}")

    out = {f"map_{k}": v for k, v in reduce(final).items()}
    base = reduce(final)
    for name, s in [(f"loop{j}", s) for j, s in enumerate(closures)] + [("reject", rejects[0])]:
        m_in = reduce(s["map"])
        out.update(map_delta.encode(f"{name}_map", m_in, base, "map"))
        out.update({f"{name}_query_kf": np.int32(s["query_kf"]), f"{name}_cand_kf": np.int32(s["cand_kf"]),
                    f"{name}_frame": np.int32(s["frame"]), f"{name}_key": s["key"],
                    f"{name}_samples": s["samples"].astype(np.int32), f"{name}_db_mid_q": s["db_mid_q"],
                    f"{name}_db_mid_c": s["db_mid_c"]})
        out.update({f"{name}_{k}": v for k, v in s["outs"].items()})
        if "covis" in s:
            out.update(map_delta.encode(f"{name}_out", reduce(s["out"]), m_in, f"{name}_map"))
            out.update({f"{name}_covis": s["covis"].astype(np.int32), f"{name}_graph_in": s["graph"][0],
                        f"{name}_graph_out": s["graph"][1]})
    graph_moves = [float(np.abs(s["graph"][1] - s["graph"][0]).max()) for s in closures]
    meta = {
        "camera": cam._asdict(),
        "slam_config": cfg_d,
        "verify_kw": closures[0]["kw"], "correct_kw": {k: v for k, v in closures[0]["correct_kw"].items()
                                                       if k != "cam"},
        "scene_seed": 0, "frames": args.frames, "revolutions": revs, "n_loops": len(closures),
        "kp_rows_kept": sorted(int(k) for k in keep), "graph_max_move": graph_moves,
        "summary": summary, "commit": _commit(),
    }
    out["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    size = os.path.getsize(args.out)
    print(json.dumps({"out": args.out, "bytes": size, "n_loops": len(closures), "graph_max_move": graph_moves,
                      "kp_rows_kept": len(keep)}))
    if size > MAX_BYTES:
        raise SystemExit(f"{args.out} is {size} bytes, over {MAX_BYTES}")


if __name__ == "__main__":
    main()
