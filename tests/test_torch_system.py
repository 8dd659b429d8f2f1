"""The port's system layer against the JAX reference: the synthetic scenes
and renderers (planes and room), the copied host-side evaluation and timing
code, the keyframe decision, place recognition at the system level (the
reference's default flags, a preset vocabulary, resuming from a reference
snapshot), and the first 20 frames of the bench sequence at full size
through `SlamSystem.process` with the reference's recorded initializer
samples injected.

The 20-frame run is held to the reference's recorded run (system fixture,
tools/make_torch_system_fixture.py): the same first WORKING frame (4), the
same insertion frames (4, 5, 15), and every pose within 2e-3 rad and 5e-3
map units of the reference's. Renders agree within one grey level on
≥ 99.9% of the pixels; the room's textures and walls exactly, its circuit
poses to 2e-6 (four float32 ulps of the circuit's 4 m radius)."""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry import camera as jcamera
from gf_orb_slam_tpu.geometry.camera import CameraModel as JCam
from gf_orb_slam_tpu.io_utils import evaluation as jeval
from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.io_utils import synthetic as jsyn
from gf_orb_slam_tpu.io_utils import timing as jtiming
from gf_orb_slam_tpu.pipeline import tracking as jtrk
from gf_orb_slam_tpu.retrieval import keyframe_db as jkdb
from gf_orb_slam_tpu.retrieval import vocabulary as jvoc
from gf_orb_slam_tpu_torch import run_slam
from gf_orb_slam_tpu_torch.geometry import camera
from gf_orb_slam_tpu_torch.io_utils import evaluation, snapshot, synthetic, timing
from gf_orb_slam_tpu_torch.pipeline import system, tracking
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu_torch.solvers import initializer

SYSTEM_FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data",
                              "system_fixture.npz")
TRACK_FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
CAM = run_slam.BENCH_CAMERA
N_FRAMES = 20


@pytest.fixture(scope="module")
def fx():
    with np.load(SYSTEM_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def rot_err(q1, q2):
    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return 2.0 * np.arccos(min(1.0, d))


# ---------------------------------------------------------------------------
# Scene, renderer, trajectory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,tex_size", [(0, 1024), (5, 256)])
def test_make_scene_textures_exact(seed, tex_size):
    got = synthetic.make_scene(seed=seed, tex_size=tex_size)
    want = jsyn.make_scene(seed=seed, tex_size=tex_size)
    np.testing.assert_array_equal(got.textures.numpy(), np.asarray(want.textures))
    for k in ("depths", "centers", "extents"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def test_trajectory_matches_reference():
    ts, poses = synthetic.trajectory(240, fps=20.0)
    jts, jposes = jsyn.trajectory(240, fps=20.0)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(poses, jposes, atol=1e-6, rtol=0)


def test_render_matches_reference():
    scene, jscene = synthetic.make_scene(seed=0), jsyn.make_scene(seed=0)
    _, poses = jsyn.trajectory(240, fps=20.0)
    for i in (0, 77, 191):
        got = np.clip(np.round(synthetic.render(scene, CAM, torch.from_numpy(poses[i])).numpy()), 0, 255)
        want = np.clip(np.round(np.asarray(jsyn.render(jscene, JCam(**CAM._asdict()), jnp.asarray(poses[i])))), 0, 255)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1, (i, (diff == 0).mean(), diff.max())


def test_euroc_camera_copy_equal():
    assert camera.EUROC_CAM._asdict() == jcamera.EUROC_CAM._asdict()


@pytest.mark.parametrize("seed,tex_size", [(0, 1024), (3, 256)])
def test_make_room_scene_exact(seed, tex_size):
    got = synthetic.make_room_scene(seed=seed, tex_size=tex_size)
    want = jsyn.make_room_scene(seed=seed, tex_size=tex_size)
    for k in ("textures", "plane_q", "plane_c", "extents"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    assert got.tex_size == want.tex_size


@pytest.mark.parametrize("n_frames", [420, 300])
def test_circuit_trajectory_matches_reference(n_frames):
    kw = dict(fps=20.0, radius=4.0, revs=min(1.1, n_frames / 270.0))
    ts, poses = synthetic.circuit_trajectory(n_frames, **kw)
    jts, jposes = jsyn.circuit_trajectory(n_frames, **kw)
    np.testing.assert_array_equal(ts, jts)
    # 2e-6: four float32 ulps of the 4 m circuit radius (sin/cos of the port
    # and of XLA round differently; small components inherit the radius's).
    np.testing.assert_allclose(poses, jposes, atol=2e-6, rtol=1e-6)


def test_render_general_with_distortion_matches_reference():
    """The distorted EuRoC camera: the fixed-point undistortion of each
    pixel's ray in float32 rounds a few pixels the other way."""
    scene, jscene = synthetic.make_room_scene(seed=0), jsyn.make_room_scene(seed=0)
    _, poses = jsyn.circuit_trajectory(420, fps=20.0, radius=4.0, revs=1.1)
    jcam_ = JCam(**camera.EUROC_CAM._asdict())
    for i in (0, 150, 377):
        got = np.clip(np.round(synthetic.render_general(scene, camera.EUROC_CAM, torch.from_numpy(poses[i])).numpy()),
                      0, 255)
        want = np.clip(np.round(np.asarray(jsyn.render_general(jscene, jcam_, jnp.asarray(poses[i])))), 0, 255)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert (diff <= 1).mean() >= 0.999, (i, (diff <= 1).mean(), diff.max())
        assert got.std() > 20  # textured walls, not background


# ---------------------------------------------------------------------------
# Copied host code
# ---------------------------------------------------------------------------


def test_evaluation_copy_equal(rng, tmp_path):
    est = rng.normal(0, 1, (50, 3))
    gt = 2.5 * est @ np.linalg.qr(rng.normal(0, 1, (3, 3)))[0].T + [1.0, -2.0, 0.5] + rng.normal(0, 0.01, (50, 3))
    for with_scale in (True, False):
        a, b = evaluation.umeyama_alignment(est, gt, with_scale), jeval.umeyama_alignment(est, gt, with_scale)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert evaluation.ate_rmse(est, gt, with_scale) == jeval.ate_rmse(est, gt, with_scale)
    _, poses = jsyn.trajectory(30, fps=20.0)
    ts = np.arange(30) / 20.0
    evaluation.write_tum_trajectory(str(tmp_path / "port.txt"), ts, poses)
    jeval.write_tum_trajectory(str(tmp_path / "ref.txt"), ts, poses)
    got, want = np.loadtxt(tmp_path / "port.txt"), np.loadtxt(tmp_path / "ref.txt")
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_timing_copy_equal(tmp_path, monkeypatch):
    ticks = np.arange(0.0, 100.0, 0.0125).tolist()

    def drive(mod):
        # A scripted clock seen by this module alone.
        it = iter(ticks)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: next(it)))
        log = mod.TimeLog()
        for f in range(6):
            log.start_frame(f * 0.05)
            log.begin("extraction")
            log.end()
            log.begin("local_map_track")
            if f % 3 == 0:
                log.begin("keyframe_insert")
                log.end("keyframe_insert")
            log.end("local_map_track")
            log.end_frame(lmk_tracked=f, lmk_inlier=2 * f)
        log.end()  # after the last frame: nothing to charge
        log.save(str(tmp_path / f"{mod.__name__}.txt"))
        monkeypatch.undo()
        return log.summary(), (tmp_path / f"{mod.__name__}.txt").read_text()

    assert drive(timing) == drive(jtiming)


# ---------------------------------------------------------------------------
# Keyframe decision and refusals
# ---------------------------------------------------------------------------


def test_need_new_keyframe_grid():
    for n_inl in (0, 14, 15, 60, 89, 90, 200):
        for n_ref in (0, 50, 100, 300):
            for since_kf in (0, 1, 9, 10, 12):
                for since_reloc in (3, 10, 10**9):
                    args = (n_inl, n_ref, since_kf, since_reloc, 10)
                    assert tracking.need_new_keyframe(*args) == jtrk.need_new_keyframe(*args, min_frames=0), args


def test_system_runs_with_the_reference_default_flags_on_cpu():
    cfg = system.SlamConfig()
    assert cfg.enable_loop_closing and cfg.enable_relocalization  # the reference's defaults
    assert not hasattr(cfg, "pipelined")
    ts, poses_gt, frames = run_slam.render_sequence(CAM, 6, device="cpu")
    s = system.SlamSystem(CAM, cfg, device="cpu")
    states = [s.process(frames[i], float(ts[i])).state for i in range(6)]
    assert "WORKING" in states and s.n_kf == 2
    assert s.voc is None and s.bow_db is None  # trained once vocab_train_kfs keyframes exist
    probe = system.SlamSystem(CAM, system.SlamConfig(loop_probe_floor=5), device="cpu")  # no longer refused
    assert probe.loop_gate_events == [] and probe.loop_events == [] and probe.loop_gt_overlap is None


@pytest.fixture(scope="module")
def voc1m():
    return voc_mod.load_default_vocabulary(torch.device("cpu"))


def test_set_vocabulary_registers_the_existing_keyframes(run20, voc1m):
    """Unlike the reference's (which starts an empty database and forgets
    the map's keyframes, ROADMAP C), the port's set_vocabulary registers
    every valid keyframe; reset() keeps the preset vocabulary."""
    s, _, _ = run20
    assert s.voc is not None and s.voc.n_words == 1000  # trained on the fly (k=10, L=3) at the 4th keyframe
    s.set_vocabulary(voc1m)
    assert s.voc.n_words == 1_000_000
    kf = s.map.kf_valid
    assert torch.equal(s.bow_db.valid, kf) and int(kf.sum()) >= 3
    k = int(torch.nonzero(kf).flatten()[-1])
    want = kdb.add_keyframe(kdb.empty_db(s.map.kf_capacity, s.map.kp_capacity, voc1m.n_words, device="cpu"),
                            voc1m, k, s.map.kf_kp_desc[k], s.map.kf_kp_valid[k])
    assert torch.equal(s.bow_db.bow_ids[k], want.bow_ids[k]) and torch.equal(s.bow_db.mid_nodes[k], want.mid_nodes[k])
    fresh = system.SlamSystem(CAM, run_slam.bench_config(), device="cpu")
    fresh.set_vocabulary(voc1m)
    fresh.reset()
    assert fresh.voc.n_words == 1_000_000 and fresh.bow_db is not None and not fresh.bow_db.valid.any()


def test_load_map_state_of_a_reference_snapshot_relocalizes(tmp_path, voc1m):
    """A reference `save_map` snapshot (the track fixture's map, the 1M
    vocabulary and the reference's BoW database) resumes LOST and the first
    frame relocalizes to WORKING, near the pose the reference tracked."""
    jm, _, _ = jsnap.load_map(TRACK_FIXTURE)
    jv = jvoc.load_binary(jvoc.default_vocabulary_path())
    jdb = jkdb.empty_db(jm.kf_capacity, jm.kp_capacity, jv.n_words)
    for k in np.flatnonzero(np.asarray(jm.kf_valid)):
        jdb = jkdb.add_keyframe(jdb, jv, jnp.asarray(int(k)), jm.kf_kp_desc[int(k)], jm.kf_kp_valid[int(k)])
    path = str(tmp_path / "snap.npz")
    jsnap.save_map(path, jm, jv, jdb)
    m, voc, db = snapshot.load_map(path, "cpu")
    assert voc.n_words == 1_000_000 and torch.equal(db.valid, m.kf_valid)
    np.testing.assert_array_equal(db.bow_ids.numpy(), np.asarray(jdb.bow_ids))
    with np.load(TRACK_FIXTURE) as z:
        img, ref_pose = z["frames"][0].astype(np.float32), z["ref_pose"][0]
    s = system.SlamSystem(CAM, run_slam.bench_config(), device="cpu")
    s.load_map_state(m, voc, db)
    assert s.state == system.State.LOST and s.n_kf == int(np.asarray(jm.kf_valid).sum())
    log = s.process(img, 0.0)
    assert log.state == "WORKING" and s.last_reloc_frame == 0 and log.n_inliers >= 25
    assert rot_err(log.pose_cw[:4], ref_pose[:4]) < 5e-3 and np.linalg.norm(log.pose_cw[4:] - ref_pose[4:]) < 5e-3
    with pytest.raises(ValueError, match="capacity"):
        system.SlamSystem(CAM, run_slam.bench_config(n_features=400), device="cpu").load_map_state(m)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "SlamSystem": lambda tmp: system.SlamSystem(CAM, run_slam.bench_config()),
    "render_sequence": lambda tmp: run_slam.render_sequence(CAM, 1),
    "run_sequence": lambda tmp: run_slam.run_sequence(CAM, run_slam.bench_config(), np.zeros(1), np.zeros((1, 7)),
                                                      torch.zeros((1, CAM.height, CAM.width))),
    "main": lambda tmp: run_slam.main(["--synthetic", "1", "--out", str(tmp / "cli")]),
}


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_run_on_the_card_unless_given_the_cpu(no_card, tmp_path, entry):
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        ENTRY_POINTS[entry](tmp_path)
    assert not (tmp_path / "cli_result.json").exists()


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    assert system.SlamSystem(CAM, run_slam.bench_config(), device="cpu").device == torch.device("cpu")
    ts, poses_gt, frames = run_slam.render_sequence(CAM, 2, device="cpu")
    assert frames.device == torch.device("cpu") and frames.shape == (2, CAM.height, CAM.width)
    s, result = run_slam.run_sequence(CAM, run_slam.bench_config(), ts, poses_gt, frames, device="cpu")
    assert result["frames"] == 2 and s.map.kf_pose.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# The first 20 bench frames through SlamSystem.process
# ---------------------------------------------------------------------------


def run_bench_frames(fx, cfg, n_frames, on_frame=None):
    """The first n_frames bench frames through run_sequence on the CPU, with
    the reference's recorded initializer samples injected. Returns (system,
    result, the sample draws' sizes)."""
    meta = json.loads(str(fx["meta"]))
    assert meta["scene_seed"] == 0 and meta["summary"]["first_working"] == 4
    scene = synthetic.make_scene(seed=meta["scene_seed"])
    ts, poses_gt = synthetic.trajectory(meta["trajectory_frames"], fps=CAM.fps)
    frames = torch.stack([torch.clamp(torch.round(synthetic.render(scene, CAM, torch.from_numpy(poses_gt[i]))), 0, 255)
                          for i in range(n_frames)])
    samples = [torch.from_numpy(s).long() for s in fx["init_samples"]]
    calls = []

    def recorded(matched, n_hypotheses, generator):
        calls.append(n_hypotheses)
        return samples[len(calls) - 1]

    mp = pytest.MonkeyPatch()
    mp.setattr(initializer, "sample_hypotheses", recorded)
    try:
        s, result = run_slam.run_sequence(CAM, cfg, ts[:n_frames], poses_gt[:n_frames], frames,
                                          device="cpu", seed=0, on_frame=on_frame)
    finally:
        mp.undo()
    return s, result, calls


@pytest.fixture(scope="module")
def run20(fx):
    return run_bench_frames(fx, run_slam.bench_config(), N_FRAMES)


def test_run20_initializes_at_the_reference_frame(fx, run20):
    s, _, calls = run20
    states = [lg.state for lg in s.logs]
    assert states.index("WORKING") == int(np.flatnonzero(fx["state"] == system.State.WORKING.value)[0]) == 4
    assert len(calls) == 4 and calls == [200] * 4  # one draw per attempt, as the reference
    assert all(st == "WORKING" for st in states[4:])


def test_run20_inserts_at_the_reference_frames(fx, run20):
    s, _, _ = run20
    inserted = [i for i, lg in enumerate(s.logs) if "keyframe_insert" in lg.timing_ms]
    ref = [int(f) for f in fx["insert_frames"] if f < N_FRAMES]
    assert ref == [4, 5, 15] and [4] + inserted == ref
    assert s.n_kf == 4


def test_run20_poses_match_reference(fx, run20):
    s, result, _ = run20
    assert result["tracked"] == int(np.isfinite(fx["pose"][:N_FRAMES, 0]).sum()) == 16
    for t, p in s.trajectory:
        i = int(round(t * CAM.fps))
        ref = fx["pose"][i]
        assert np.isfinite(p).all() and p.shape == (7,)
        assert rot_err(p[:4], ref[:4]) <= 2e-3, i
        assert np.linalg.norm(p[4:] - ref[4:]) <= 5e-3, i


def test_write_outputs(run20, tmp_path):
    s, result, _ = run20
    run_slam.write_outputs(s, result, str(tmp_path / "run"))
    allf = np.loadtxt(tmp_path / "run_AllFrameTrajectory.txt")
    kf = np.loadtxt(tmp_path / "run_KeyFrameTrajectory.txt")
    assert allf.shape == (16, 8) and kf.shape == (4, 8)
    assert json.loads((tmp_path / "run_result.json").read_text())["tracked"] == 16
    assert (tmp_path / "run_TimeLog.txt").read_text().startswith("#timestamp extraction")


def test_cli_runs_on_cpu(tmp_path, capsys):
    assert run_slam.main(["--synthetic", "6", "--gf-budget", "100", "--device", "cpu",
                          "--out", str(tmp_path / "cli")]) == 0
    result = json.loads((tmp_path / "cli_result.json").read_text())
    assert result["frames"] == 6 and result["loops_closed"] == 0


# ---------------------------------------------------------------------------
# The other GF modes through SlamSystem, and their configuration
# ---------------------------------------------------------------------------

GF_FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "gf_modes_fixture.npz")


@pytest.mark.parametrize("mode", ["active", "lazier"])
def test_system_runs_gf_mode_past_the_warmup_on_cpu(fx, mode, monkeypatch):
    """The first 20 bench frames in bench.py's configuration with `gf_mode`
    changed: GF selection runs from frame 16 (after the 10-frame warm-up).
    The deterministic active mode holds the reference's recorded run of the
    same mode (gf_modes_fixture.npz) pose by pose; lazier draws its Gumbel
    noise from the system's generator on its device each GF frame, and its
    poses are held to the reference's lazier run (drawn from JAX's stream)
    at the same tolerance: four GF frames move no pose by more than 2.3e-4."""
    with np.load(GF_FIXTURE) as z:
        ref_pose, ref_state = z[f"{mode}_pose"], z[f"{mode}_state"]
    draws, gf_frames, frame_no = [], [], []
    sample = tracking.sample_gf_noise
    step = tracking.track_frame_fused

    def counted_sample(*a, **kw):
        out = sample(*a, **kw)
        draws.append((frame_no[-1], a[-1], out))
        return out

    def counted_step(*a, **kw):
        if kw["use_gf"]:
            gf_frames.append(frame_no[-1])
        return step(*a, **kw)

    monkeypatch.setattr(tracking, "sample_gf_noise", counted_sample)
    monkeypatch.setattr(tracking, "track_frame_fused", counted_step)
    frame_no.append(0)
    s, result, _ = run_bench_frames(fx, run_slam.bench_config(gf_mode=mode), N_FRAMES,
                                    on_frame=lambda i, log: frame_no.append(i + 1))
    assert gf_frames == [16, 17, 18, 19]
    assert result["tracked"] == 16 and [lg.state for lg in s.logs[4:]] == ["WORKING"] * 16
    assert all(ref_state[i] == system.State.WORKING.value for i in range(4, N_FRAMES))
    if mode == "lazier":
        assert [f for f, _, _ in draws] == gf_frames
        assert all(gen is s.generator and n.shape == (10, 4096) and n.device == s.device for _, gen, n in draws)
        assert not torch.equal(draws[0][2], draws[1][2])
    else:
        assert [n for _, _, n in draws] == [None] * 4
    for t, p in s.trajectory:
        i = int(round(t * CAM.fps))
        assert np.isfinite(p).all()
        assert rot_err(p[:4], ref_pose[i][:4]) <= 2e-3, i
        assert np.linalg.norm(p[4:] - ref_pose[i][4:]) <= 5e-3, i


def test_gf_mode_is_checked_at_construction():
    for mode in tracking.GF_MODES:
        assert system.SlamConfig(gf_mode=mode).gf_mode == mode
    with pytest.raises(ValueError, match="unknown gf_mode 'bogus'"):
        system.SlamConfig(gf_mode="bogus")
    cfg = run_slam.bench_config()
    cfg.gf_mode = "bogus"  # set after construction: the system refuses it before any frame
    with pytest.raises(ValueError, match="unknown gf_mode 'bogus'"):
        system.SlamSystem(CAM, cfg, device="cpu")


def test_cli_gf_mode_and_warmup():
    cam, cfg = run_slam.config_from_args(run_slam.parse_args(
        ["--synthetic", "5", "--gf-budget", "80", "--gf-mode", "active", "--gf-warmup", "3"]))
    assert cam == run_slam.BENCH_CAMERA
    assert (cfg.use_gf, cfg.gf_budget, cfg.gf_mode, cfg.gf_warmup_frames) == (True, 80, "active", 3)
    _, cfg = run_slam.config_from_args(run_slam.parse_args(["--synthetic", "5", "--scene", "room"]))
    assert (cfg.use_gf, cfg.gf_mode, cfg.gf_warmup_frames) == (False, "subset", system.SlamConfig().gf_warmup_frames)
    for mode in tracking.GF_MODES:
        assert run_slam.parse_args(["--synthetic", "1", "--gf-mode", mode]).gf_mode == mode
    with pytest.raises(SystemExit):
        run_slam.parse_args(["--synthetic", "1", "--gf-mode", "bogus"])
