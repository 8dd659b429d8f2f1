"""Keyframe-slab compaction and relocalization recall: the port against the
JAX reference.

* System-level compaction: the reference's own compaction configuration
  (tests/test_pipeline_e2e.py::test_keyframe_slab_compaction_on_long_runs:
  50 planes frames, 600 features, keyframe cadence 3, `max_keyframes=12`),
  recorded by tools/make_torch_churn_fixture.py with the packaged
  vocabulary and the reference's initializer samples. Only the port runs
  here, with those samples injected: the compaction and insertion frames,
  `n_kf`, the live keyframes and the poses (at the system test's
  tolerances) must be the reference's.
* Compaction of a map with a tombstoned keyframe: both systems compact the
  tracking fixture's map (14 slots, 5 valid) with one more keyframe erased;
  the map, the permuted BoW database, the track view and the
  relocalization candidates afterwards must be equal.
* io_utils/reloc_eval.py against tools/reloc_recall.py's own measurement,
  run over a stand-in system that replays a given run.
* A keyframe capacity below the track view's 12 neighbours raises, where
  the reference fails at its first track view.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry import se3 as jse3
from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.io_utils import synthetic as jsyn
from gf_orb_slam_tpu.mapping import map_state as jms
from gf_orb_slam_tpu.pipeline import system as jsys
from gf_orb_slam_tpu.pipeline import track_view as jtv
from gf_orb_slam_tpu.retrieval import keyframe_db as jkdb
from gf_orb_slam_tpu.retrieval import vocabulary as jvoc
from gf_orb_slam_tpu_torch import run_slam
from gf_orb_slam_tpu_torch.io_utils import reloc_eval, snapshot, synthetic
from gf_orb_slam_tpu_torch.mapping import frame as frame_mod
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops import orb
from gf_orb_slam_tpu_torch.pipeline import system
from gf_orb_slam_tpu_torch.pipeline import track_view as tv
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu_torch.solvers import initializer
from test_torch_map_state import assert_map_close
from test_torch_retrieval import assert_db_equal, port_voc
from test_torch_system import rot_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import reloc_recall  # noqa: E402

DATA = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data")
CHURN_FIXTURE = os.path.join(DATA, "churn_fixture.npz")
TRACK_FIXTURE = os.path.join(DATA, "track_fixture.npz")
CPU = torch.device("cpu")
CAM = run_slam.BENCH_CAMERA


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jvoc1m():
    return jvoc.load_default_vocabulary()


# ---------------------------------------------------------------------------
# System-level compaction against the reference's run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planes_run(jvoc1m):
    """The port over the planes run's frames with the reference's
    initializer samples injected; per frame the state, the pose and the
    live keyframes."""
    with np.load(CHURN_FIXTURE) as z:
        fx = {k[len("planes_"):]: z[k] for k in z.files if k.startswith("planes_")}
    meta = json.loads(str(fx["meta"]))
    cfg_ref = meta["slam_config"]
    cfg = system.SlamConfig(n_features=cfg_ref["n_features"], max_frames_between_kf=cfg_ref["max_frames_between_kf"],
                            max_keyframes=cfg_ref["max_keyframes"])
    n = meta["frames"]
    scene = synthetic.make_scene(seed=meta["scene_seed"])
    ts, poses_gt = synthetic.trajectory(meta["trajectory_frames"], fps=CAM.fps)
    frames = torch.stack([torch.clamp(torch.round(synthetic.render(scene, CAM, torch.from_numpy(poses_gt[i]))), 0, 255)
                          for i in range(n)])
    samples = [torch.from_numpy(s).long() for s in fx["init_samples"]]
    draws = []

    def recorded(matched, n_hypotheses, generator):
        draws.append(n_hypotheses)
        return samples[len(draws) - 1]

    mp = pytest.MonkeyPatch()
    mp.setattr(initializer, "sample_hypotheses", recorded)
    try:
        s, result = run_slam.run_sequence(CAM, cfg, ts[:n], poses_gt[:n], frames, device="cpu", seed=0,
                                          vocabulary=port_voc(jvoc1m))
    finally:
        mp.undo()
    return fx, meta, s, result, draws


def test_planes_run_is_the_reference_compaction_configuration(planes_run):
    fx, meta, _, _, draws = planes_run
    cfg = meta["slam_config"]
    assert (cfg["n_features"], cfg["max_frames_between_kf"], cfg["max_keyframes"]) == (600, 3, 12)
    assert meta["frames"] == meta["trajectory_frames"] == 50 and meta["scene"] == "planes"
    assert meta["summary"]["compactions"] >= 1  # the fixture reaches the path under test
    assert len(draws) == len(fx["init_samples"])


def test_planes_compactions_and_insertions_match_the_reference(planes_run):
    fx, meta, s, _, _ = planes_run
    inserted = [i for i, lg in enumerate(s.logs) if "keyframe_insert" in lg.timing_ms]
    working = [i for i, lg in enumerate(s.logs) if lg.state == "WORKING"]
    assert [working[0]] + inserted == fx["insert_frames"].tolist()
    assert [list(c) for c in s.compactions] == fx["compactions"].tolist()
    assert s.n_compactions == len(s.compactions) == meta["summary"]["compactions"]
    assert int(s.map.kf_valid.sum()) == meta["summary"]["keyframes_valid"] <= 12
    assert s.n_kf == int(s.map.n_kf)
    states = [system.State[lg.state].value for lg in s.logs]
    assert states == fx["state"].tolist()


def test_planes_poses_match_the_reference(planes_run):
    fx, meta, s, result, _ = planes_run
    assert result["tracked"] == meta["summary"]["tracked"] == 49  # the initialization frame's pose too
    for i, lg in enumerate(s.logs):
        ref = fx["pose"][i]
        assert (lg.pose_cw is None) == (not np.isfinite(ref[0])), i
        if lg.pose_cw is not None:
            assert rot_err(lg.pose_cw[:4], ref[:4]) <= 2e-3, i
            assert np.linalg.norm(lg.pose_cw[4:] - ref[4:]) <= 5e-3, i


# ---------------------------------------------------------------------------
# Compaction of a map with a tombstoned keyframe, in both systems
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compacted(jvoc1m):
    """Both systems on the tracking fixture's map and its BoW database, one
    more keyframe erased (as culling does), then compacted."""
    jm, _, _ = jsnap.load_map(TRACK_FIXTURE)
    m = snapshot.load_map(TRACK_FIXTURE, CPU)[0]
    cfg = dict(n_features=800, max_frames_between_kf=10, use_gf=True, gf_budget=100, gf_warmup_frames=10)
    ref = jsys.SlamSystem(CAM, jsys.SlamConfig(pipelined=False, **cfg))
    port = system.SlamSystem(CAM, system.SlamConfig(**cfg), device="cpu")
    voc = port_voc(jvoc1m)
    ref.set_vocabulary(jvoc1m)  # starts an empty database: register the map's keyframes as the port does
    ref.map, port.map = jm, m
    live = np.flatnonzero(np.asarray(jm.kf_valid))
    db = ref.bow_db
    for k in live:
        db = jkdb.add_keyframe(db, jvoc1m, jnp.asarray(k), jm.kf_kp_desc[k], jm.kf_kp_valid[k])
    ref.bow_db = db
    port.set_vocabulary(voc)
    gone = int(live[1])
    ref.map, ref.bow_db = jms.erase_keyframe(ref.map, jnp.asarray(gone)), jkdb.erase_keyframe(ref.bow_db, gone)
    port.map, port.bow_db = ms.erase_keyframe(port.map, gone), kdb.erase_keyframe(port.bow_db, gone)
    ref.n_kf = port.n_kf = int(jm.n_kf)
    # A query: frame 0 of the fixture's chained frames.
    with np.load(TRACK_FIXTURE) as z:
        img = torch.from_numpy(z["frames"][0])
    fr = frame_mod.make_frame(img, CAM, orb.OrbConfig(n_features=800))
    q_desc, q_valid = fr.desc.numpy(), fr.valid.numpy()

    def reloc_candidates():
        jw, _ = jvoc.quantize(jvoc1m, jnp.asarray(q_desc.view(np.uint32)), jnp.asarray(q_valid))
        jc = jkdb.detect_reloc_candidates(ref.bow_db, jms.covisibility(ref.map), jvoc.bow_vector(jvoc1m, jw),
                                          max_candidates=4)
        w, _ = voc_mod.quantize(voc, fr.desc, fr.valid)
        c = kdb.detect_reloc_candidates(port.bow_db, ms.covisibility(port.map), voc_mod.bow_vector(voc, w),
                                        max_candidates=4)
        return [np.asarray(a) for a in jc], [a.numpy() for a in c]

    before = reloc_candidates()
    perm_ref = jms.compact_keyframes(ref.map)[1]
    ref._compact_keyframes()
    port._compact_keyframes()
    return {"ref": ref, "port": port, "gone": gone, "before": before, "after": reloc_candidates(),
            "perm": np.asarray(perm_ref), "live": live}


def test_tombstoned_compaction_map_and_database_equal(compacted):
    ref, port = compacted["ref"], compacted["port"]
    assert port.n_kf == ref.n_kf == len(compacted["live"]) - 1 == 4
    assert port.n_compactions == ref.n_compactions == 1 and port.compactions == [(port.frame_id, 4)]
    assert_map_close(port.map, ref.map, atol=0)
    assert_db_equal(port.bow_db, ref.bow_db)
    assert bool(port.bow_db.valid[:4].all()) and not bool(port.bow_db.valid[4:].any())


def test_tombstoned_compaction_track_view_equal(compacted):
    ref, port = compacted["ref"], compacted["port"]
    for f in ("ids", "valid", "desc"):
        got = getattr(port.track_view, f).numpy()
        np.testing.assert_array_equal(got.view(np.uint32) if f == "desc" else got,
                                      np.asarray(getattr(ref.track_view, f)), err_msg=f)
    for f in ("normal", "min_dist", "max_dist"):
        np.testing.assert_allclose(getattr(port.track_view, f).numpy(), np.asarray(getattr(ref.track_view, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    assert int(port.track_view.valid.sum()) > 100


def test_tombstoned_compaction_reloc_candidates(compacted):
    (jc0, jok0), (c0, ok0) = compacted["before"]
    (jc1, jok1), (c1, ok1) = compacted["after"]
    # The order of candidates whose group scores tie is float32 round-off
    # (ROADMAP, reference behaviours): compare the sets.
    for (jc, jok), (c, ok) in (((jc0, jok0), (c0, ok0)), ((jc1, jok1), (c1, ok1))):
        np.testing.assert_array_equal(ok, jok)
        assert sorted(c[ok]) == sorted(jc[jok])
    # The candidates renumbered: the same keyframes under their new ids.
    inv = np.argsort(compacted["perm"])
    assert ok1.sum() == ok0.sum() >= 1
    assert sorted(c1[ok1]) == sorted(inv[c0[ok0]])
    assert compacted["gone"] not in c0[ok0].tolist()


# ---------------------------------------------------------------------------
# reloc_eval against tools/reloc_recall.py's measurement
# ---------------------------------------------------------------------------


class ReplaySystem:
    """Stands in for the reference's SlamSystem inside reloc_recall.run_one:
    processes nothing and returns the given run's logs in order."""

    logs: list = []
    shown: list = []

    def __init__(self, cam, cfg):
        self.cfg = cfg
        self._logs = iter(ReplaySystem.logs)
        self.n_kf = 30
        self.state = jsys.State.WORKING

    def set_vocabulary(self, voc):
        pass

    def process(self, img, t):
        return next(self._logs)

    def flush(self):
        pass


def replayed_run(rng, kind, n, revs, recover_at, false_at=None):
    """A run's logs: the ground truth shown, in a scaled and rotated gauge
    with noise, LOST over the black frames until `recover_at`, and metres
    off from `false_at` on."""
    src = reloc_eval.frame_src(n, kind, revs)
    _, poses_gt = jsyn.circuit_trajectory(n, fps=20.0, radius=4.0, revs=revs)
    g = jnp.asarray([np.cos(0.3), 0.0, np.sin(0.3), 0.0, 0.4, -0.2, 1.0], jnp.float32)
    logs, b0 = [], src.index(-1)
    for i, s in enumerate(src):
        if s < 0 or (b0 <= i < recover_at):
            logs.append(jsys.FrameLog(timestamp=i / 20.0, state="LOST", pose_cw=None, n_inliers=0))
            continue
        p = np.array(jse3.compose(jnp.asarray(poses_gt[s]), g))
        p[4:] = p[4:] * 0.7 + rng.normal(0, 0.003, 3)
        if false_at is not None and i >= false_at:
            p[4:] += 3.0
        logs.append(jsys.FrameLog(timestamp=i / 20.0, state="WORKING", pose_cw=p.astype(np.float32), n_inliers=50))
    return logs, src


@pytest.mark.parametrize("kind,recover_after,false_reloc", [
    ("blackout", 0, False), ("kidnap", 0, False), ("kidnap", 5, False), ("kidnap", 2, True), ("blackout", None, False),
])
def test_reloc_eval_equals_the_reference_tool(monkeypatch, kind, recover_after, false_reloc):
    n = 300  # the recall tool's length: the kidnap jumps back 68 frames
    revs = min(1.1, n / 270.0)
    rng = np.random.default_rng(7)
    b0 = reloc_eval.blackout_start(n)
    end = b0 + reloc_eval.BLACKOUT_LEN
    recover_at = n if recover_after is None else end + recover_after
    logs, src = replayed_run(rng, kind, n, revs, recover_at, false_at=recover_at if false_reloc else None)
    shown = []
    monkeypatch.setattr(jsys, "SlamSystem", ReplaySystem)
    monkeypatch.setattr(jsyn, "make_room_scene", lambda seed: None)
    monkeypatch.setattr(jsyn, "render_general", lambda scene, cam, pose: shown.append(np.asarray(pose)))
    monkeypatch.setattr(jvoc, "load_default_vocabulary", lambda: None)
    ReplaySystem.logs = logs
    want = reloc_recall.run_one(0, kind, n, 100)
    # The schedule: the frames the tool rendered are the ground truth frame_src names.
    _, poses_gt = jsyn.circuit_trajectory(n, fps=20.0, radius=4.0, revs=revs)
    np.testing.assert_array_equal(np.stack(shown), poses_gt[[s for s in src if s >= 0]])
    assert want["blackout_at"] == b0 and want["blackout_len"] == reloc_eval.BLACKOUT_LEN
    gt = run_slam.camera_centers(poses_gt)
    got = reloc_eval.recovery([lg.state for lg in logs],
                              [None if lg.pose_cw is None else run_slam.camera_centers(lg.pose_cw[None])[0]
                               for lg in logs], src, gt)
    for k in ("blackout_at", "blackout_len", "recovered", "frames_to_recover", "false_reloc"):
        assert got[k] == want[k], k
    if want["post_recovery_err_m"] is None:
        assert got["post_recovery_err_m"] is None
    else:
        np.testing.assert_allclose(got["post_recovery_err_m"], want["post_recovery_err_m"], rtol=1e-4, atol=1e-6)
    assert got["false_reloc"] == false_reloc and got["recovered"] == (recover_after is not None)
    rows = [dict(got), dict(got, recovered=False, frames_to_recover=None)]
    s = reloc_eval.recall_summary(rows)
    assert s["episodes"] == 2 and s["recovered_true"] == (0 if false_reloc or recover_after is None else 1)


def test_reloc_eval_schedule():
    src = reloc_eval.frame_src(300, "kidnap", 1.1)
    assert src[179] == 179 and src[180:188] == [-1] * 8 and src[188] == 188 - 68 and src[-1] == 299 - 68
    assert reloc_eval.frame_src(300, "blackout", 1.1)[188:] == list(range(188, 300))
    with pytest.raises(ValueError):
        reloc_eval.frame_src(300, "teleport", 1.1)


# ---------------------------------------------------------------------------
# Small keyframe capacities
# ---------------------------------------------------------------------------


def test_keyframe_capacity_below_the_track_view_raises():
    with pytest.raises(ValueError, match="max_keyframes 11"):
        system.SlamConfig(max_keyframes=11)
    cfg = system.SlamConfig()
    cfg.max_keyframes = 10  # a field set after construction
    with pytest.raises(ValueError, match="max_keyframes 10"):
        system.SlamSystem(CAM, cfg, device="cpu")
    assert system.SlamConfig(max_keyframes=tv.N_NEIGHBOR_KFS).max_keyframes == 12
    # The reference accepts the configuration and fails at its first track view.
    jm = jms.empty_map(max_keyframes=10, max_points=64, max_kps=16)
    with pytest.raises(ValueError):
        jtv.compute_track_view(jm, jnp.asarray(0))
    jsys.SlamConfig(max_keyframes=10)


def test_first_use_device_constants_are_built_at_construction():
    """The constants that tracking, GF selection and insertion cache per
    device on first use are built when the system is constructed: on the
    card each one built later is a host→device copy, and so a host sync on
    the first tracked, insertion or GF frame of a process (room-churn run
    alone read 10 syncs on its first insertion and 3 on its first GF frame)."""
    from gf_orb_slam_tpu_torch.geometry import quat
    from gf_orb_slam_tpu_torch.ops import pyramid

    cached = (orb._level_layout, pyramid.level_consts, initializer.camera_K, initializer.camera_K_inv,
              quat.dqbar_by_dq)
    for fn in cached:
        fn.cache_clear()
    cfg = run_slam.bench_config(max_frames_between_kf=5, gf_warmup_frames=2)
    ts, poses_gt, frames = run_slam.render_sequence(CAM, 9, 0, "cpu")
    s = system.SlamSystem(CAM, cfg, device="cpu")
    misses, states, inserted = [], [], []
    for i in range(len(frames)):
        before = [fn.cache_info().misses for fn in cached]
        log = s.process(frames[i], float(ts[i]))
        misses.append([fn.cache_info().misses - b for fn, b in zip(cached, before)])
        states.append(log.state)
        inserted.append("keyframe_insert" in log.timing_ms)
    first = states.index("WORKING")
    assert any(inserted[first + 1:]) and s.frames_since_init > cfg.gf_warmup_frames + 1, (states, inserted)
    assert all(m == [0] * len(cached) for m in misses[first + 1:]), misses
