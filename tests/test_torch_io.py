"""The port's I/O against the JAX reference's, on the same files: settings,
the EuRoC / TUM / NUIM loaders and ground-truth association on sequences
written by tools/dump_dataset.py; the port's PNG / PGM reader bit-equal to
cv2; the prefetcher's frames equal to the reader's; map snapshots (with a
legacy dense BoW database) and vocabulary files read both ways; the command
line's dataset flags, and `--seq` equal to the same frames from memory.
"""

import dataclasses
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.io_utils import datasets as jds
from gf_orb_slam_tpu.io_utils import settings as jsettings
from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.retrieval import keyframe_db as jkdb
from gf_orb_slam_tpu.retrieval import vocabulary as jvoc
from gf_orb_slam_tpu_torch import run_slam
from gf_orb_slam_tpu_torch.io_utils import datasets, images, prefetch, settings, snapshot, stage_probe
from gf_orb_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACK_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
N_FRAMES = 20
EUROC_YAML = (
    "%YAML:1.0\n"
    "Camera.fx: 458.654\nCamera.fy: 457.296\nCamera.cx: 367.215\nCamera.cy: 248.375\n"
    "Camera.k1: -0.28340811\nCamera.k2: 0.07395907\nCamera.p1: 0.00019359\nCamera.p2: 1.76187114e-05\n"
    "Camera.fps: 30.0 # comment\nCamera2.nRows: 480\nCamera2.nCols: 752\n"
    "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
    "ORBextractor.fastTh: 20\nUseMotionModel: 0\n"
)


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    """N_FRAMES rendered bench-camera frames written by the reference's
    tools/dump_dataset.py (cv2 PNGs) in the EuRoC and TUM layouts, and the
    same frames rearranged into the NUIM layout."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import dump_dataset

    root = tmp_path_factory.mktemp("dumped")
    for layout in ("euroc", "tum"):
        dump_dataset.main(["--out", str(root / layout), "--layout", layout, "--frames", str(N_FRAMES)])
    nuim = root / "nuim"
    (nuim / "rgb").mkdir(parents=True)
    tum = jds.load_tum_rgbd(str(root / "tum"))
    for i, p in enumerate(tum.image_paths):
        shutil.copy(p, nuim / "rgb" / f"{i}.png")
    with open(nuim / "livingRoom0.gt.freiburg", "w") as f:
        for i, (p, q) in enumerate(zip(tum.gt_positions, tum.gt_quaternions)):
            f.write(f"{i} {p[0]} {p[1]} {p[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")
    return root


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    several processes' full thread pools slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_sequences_equal(got, want):
    assert got.name == want.name and got.timestamps == want.timestamps and got.image_paths == want.image_paths
    for k in ("gt_timestamps", "gt_positions", "gt_quaternions"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


# ---------------------------------------------------------------------------
# Settings and sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["dumped", "euroc_yaml"])
def test_settings_match_reference(which, dumped, tmp_path):
    path = str(dumped / "euroc" / "settings.yaml")
    if which == "euroc_yaml":
        path = str(tmp_path / "EuRoC.yaml")
        with open(path, "w") as f:
            f.write(EUROC_YAML)
    cam, cfg = settings.load_settings(path)
    jcam, jcfg = jsettings.load_settings(path)
    assert tuple(cam) == tuple(jcam)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    back = str(tmp_path / "back.yaml")
    settings.write_settings(back, cam, cfg)
    assert settings.load_settings(back) == (cam, cfg) and jsettings.load_settings(back)[0] == jcam


@pytest.mark.parametrize("layout", ["euroc", "tum", "nuim"])
def test_loaders_match_reference(layout, dumped):
    d = str(dumped / layout)
    loader = {"euroc": "load_euroc", "tum": "load_tum_rgbd", "nuim": "load_nuim"}[layout]
    got, want = getattr(datasets, loader)(d), getattr(jds, loader)(d)
    assert_sequences_equal(got, want)
    assert_sequences_equal(datasets.detect_and_load(d), jds.detect_and_load(d))
    assert len(got) == N_FRAMES
    est_ts = np.concatenate([np.asarray(got.timestamps) + np.random.default_rng(0).normal(0, 0.02, N_FRAMES),
                             [-1.0, 1e3]])  # off either end of the ground truth
    gp, ok = datasets.associate_ground_truth(got, est_ts)
    jgp, jok = jds.associate_ground_truth(want, est_ts)
    np.testing.assert_array_equal(gp, jgp)
    np.testing.assert_array_equal(ok, jok)
    assert ok[:N_FRAMES].all() and not ok[N_FRAMES:].any()


def test_unknown_layout_and_missing_ground_truth(tmp_path):
    with pytest.raises(ValueError, match="unrecognized"):
        datasets.detect_and_load(str(tmp_path))
    seq = datasets.Sequence("x", [0.0], ["a.png"])
    assert datasets.associate_ground_truth(seq, np.zeros(1)) == (None, None)


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------


def test_reader_bit_equal_to_cv2_on_dumped_frames(dumped):
    cv2 = pytest.importorskip("cv2")
    seq = datasets.load_euroc(str(dumped / "euroc"))
    for p in seq.image_paths:
        np.testing.assert_array_equal(images.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(datasets._imread_gray(p), jds._imread_gray(p))


def test_reader_every_png_filter_and_pgm(tmp_path):
    """cv2 with a compression level picks Sub, Up, Average and Paeth row by
    row; filter 0 and PGM come from the port's own chunks."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    _, _, frames = run_slam.render_sequence(run_slam.BENCH_CAMERA, 2, device="cpu")
    img = frames[1].numpy().astype(np.uint8)
    p = str(tmp_path / "f.png")
    cv2.imwrite(p, img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    np.testing.assert_array_equal(images.read_gray(p), img)
    noise = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    raw = np.concatenate([np.zeros((37, 1), np.uint8), noise], axis=1)
    import struct
    import zlib

    with open(p, "wb") as f:
        f.write(images.PNG_SIGNATURE + images._chunk(b"IHDR", struct.pack(">IIBBBBB", 53, 37, 8, 0, 0, 0, 0))
                + images._chunk(b"IDAT", zlib.compress(raw.tobytes())) + images._chunk(b"IEND", b""))
    np.testing.assert_array_equal(images.read_gray(p), noise)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), noise)
    for name in ("w.png", "w.pgm"):
        q = str(tmp_path / name)
        images.write_gray(q, noise)
        np.testing.assert_array_equal(images.read_gray(q), noise)
        np.testing.assert_array_equal(cv2.imread(q, cv2.IMREAD_GRAYSCALE), noise)
    cv2.imwrite(str(tmp_path / "c.pgm"), noise)
    np.testing.assert_array_equal(images.read_gray(str(tmp_path / "c.pgm")), noise)
    cv2.imwrite(str(tmp_path / "rgb.png"), np.stack([noise] * 3, axis=-1))
    with pytest.raises(ValueError, match="grayscale"):
        images.read_gray(str(tmp_path / "rgb.png"))


def test_write_euroc_reads_back_in_the_reference(tmp_path):
    ts, poses, frames = run_slam.render_sequence(run_slam.BENCH_CAMERA, 4, device="cpu")
    u8 = frames.numpy().astype(np.uint8)
    seq = datasets.write_euroc(str(tmp_path / "s"), ts, u8, poses)
    want = jds.load_euroc(str(tmp_path / "s"))
    assert_sequences_equal(seq, want)
    np.testing.assert_allclose(want.timestamps, ts, atol=1e-9)
    np.testing.assert_allclose(want.gt_positions, run_slam.camera_centers(poses), atol=1e-6)
    for p, img in zip(want.image_paths, u8):
        np.testing.assert_array_equal(jds._imread_gray(p), img.astype(np.float32))


@pytest.mark.parametrize("native", [True, False])
def test_prefetcher_frames_equal_the_readers(native, dumped, monkeypatch):
    seq = datasets.load_tum_rgbd(str(dumped / "tum"))
    if not native:
        monkeypatch.setitem(prefetch._NATIVE, "lib", None)
    elif not prefetch.native_available():
        pytest.skip("native/libgfslam_io.so does not run on this host")
    with prefetch.FramePrefetcher(seq.image_paths, 752, 480, queue_depth=3) as pf:
        assert pf.native == native
        got = list(pf)
    assert [i for i, _ in got] == list(range(N_FRAMES))
    for (_, img), p in zip(got, seq.image_paths):
        np.testing.assert_array_equal(img, datasets._imread_gray(p))
    if native:
        np.testing.assert_array_equal(prefetch.decode_gray(seq.image_paths[0]), got[0][1])


# ---------------------------------------------------------------------------
# Snapshots and vocabulary files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def map_voc_db():
    """The track fixture's map, a random 1000-word vocabulary and the port's
    database of every valid keyframe."""
    m, _, _ = snapshot.load_map(TRACK_FIXTURE, "cpu")
    voc = voc_mod.random_vocabulary(10, 3, seed=3)
    db = kdb.empty_db(m.kf_capacity, m.kp_capacity, voc.n_words, device="cpu")
    for k in np.flatnonzero(m.kf_valid.numpy()):
        db = kdb.add_keyframe(db, voc, int(k), m.kf_kp_desc[int(k)], m.kf_kp_valid[int(k)])
    return m, voc, db


def test_save_map_reads_in_the_reference_and_back(map_voc_db, tmp_path):
    m, voc, db = map_voc_db
    path = str(tmp_path / "port.npz")
    snapshot.save_map(path, m, voc, db)
    jm, jv, jdb = jsnap.load_map(path)
    with np.load(TRACK_FIXTURE) as z:
        for k in jm._fields:
            a, ref = np.asarray(getattr(jm, k)), z[f"map_{k}"]
            assert a.dtype == ref.dtype, k
            np.testing.assert_array_equal(a, ref, err_msg=k)
    np.testing.assert_array_equal(np.asarray(jv.centers), voc.centers.numpy().view(np.uint32))
    for k in db._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jdb, k)), getattr(db, k).numpy(), err_msg=k)
    # The reference's file of the same state reads back into the same tensors.
    back = str(tmp_path / "ref.npz")
    jsnap.save_map(back, jm, jv, jdb)
    for got, want in zip(snapshot.load_map(back, "cpu"), (m, voc, db)):
        for a, b in zip(got, want):
            assert (a == b) if not isinstance(a, torch.Tensor) else torch.equal(a, b)


def test_legacy_dense_bow_snapshot_rebuilds_the_database(map_voc_db, tmp_path):
    """A snapshot from before the sparse database (dense (K, n_words)
    db_bow): both loaders rebuild the same sparse rows, equal to the
    database it was made from."""
    m, voc, db = map_voc_db
    K = m.kf_capacity
    dense = np.zeros((K, voc.n_words + 1), np.float32)
    np.put_along_axis(dense, db.bow_ids.numpy().astype(np.int64), db.bow_vals.numpy(), axis=1)
    path = str(tmp_path / "legacy.npz")
    arrays = {f"map_{k}": v for k, v in jsnap.load_map(TRACK_FIXTURE)[0]._asdict().items()}
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()}, db_bow=dense[:, :-1],
                        db_words=db.words.numpy(), db_mid_nodes=db.mid_nodes.numpy(), db_valid=db.valid.numpy())
    _, _, got = snapshot.load_map(path, "cpu")
    _, _, want = jsnap.load_map(path)
    for k in db._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(db, k).numpy(), err_msg=k)


def vocab_equal(got, want):
    assert (got.k, got.L) == (want.k, want.L)
    np.testing.assert_array_equal(got.centers.numpy().view(np.uint32), np.asarray(want.centers))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    assert (got.children is None) == (want.children is None)
    if got.children is not None:
        np.testing.assert_array_equal(got.children.numpy(), np.asarray(want.children))
        np.testing.assert_array_equal(got.word_of_node.numpy(), np.asarray(want.word_of_node))


def test_random_vocabulary_matches_reference():
    vocab_equal(voc_mod.random_vocabulary(10, 3, seed=7), jvoc.random_vocabulary(10, 3, seed=7))


def test_vocabulary_files_both_ways(tmp_path):
    """DBoW2 text and binary npz: each side's file read by the other, for an
    implicit complete tree and for the explicit tree a text file loads as."""
    voc, jv = voc_mod.random_vocabulary(4, 3, seed=1), jvoc.random_vocabulary(4, 3, seed=1)
    voc = voc._replace(weights=torch.linspace(0.5, 2.0, 64))
    jv = jv._replace(weights=jnp.asarray(voc.weights.numpy()))
    txt, jtxt = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    voc_mod.save_dbow2_text(txt, voc)
    jvoc.save_dbow2_text(jtxt, jv)
    assert open(txt).read() == open(jtxt).read()
    explicit, jexplicit = voc_mod.load_vocabulary(txt), jvoc.load_vocabulary(jtxt)
    vocab_equal(explicit, jexplicit)
    assert explicit.children is not None and explicit.n_words == 64
    voc_mod.save_dbow2_text(txt, explicit)
    jvoc.save_dbow2_text(jtxt, jexplicit)
    assert open(txt).read() == open(jtxt).read()
    for v, jvv in ((voc, jv), (explicit, jexplicit)):
        npz, jnpz = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
        voc_mod.save_binary(npz, v)
        jvoc.save_binary(jnpz, jvv)
        vocab_equal(voc_mod.load_vocabulary(jnpz), jvoc.load_vocabulary(npz))
    # Quantization agrees through the explicit tree.
    desc = np.random.default_rng(2).integers(0, 2**32, (50, 8), dtype=np.uint32)
    w, mid = voc_mod.quantize(explicit, torch.from_numpy(desc.view(np.int32)), torch.ones(50, dtype=torch.bool))
    jw, jmid = jvoc.quantize(jexplicit, jnp.asarray(desc), jnp.ones(50, bool))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(mid.numpy(), np.asarray(jmid))


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_cli_dataset_flags(dumped):
    yaml = str(dumped / "euroc" / "settings.yaml")
    args = run_slam.parse_args(["--seq", "d", "--settings", yaml, "--gf-budget", "100", "--gf-mode", "active",
                                "--init-gate", "30", "--max-frames", "12", "--save-map", "a.npz", "--load-map",
                                "b.npz", "--probe-stages"])
    cam, cfg = run_slam.config_from_args(args)
    jcam, jcfg = jsettings.load_settings(yaml)
    assert tuple(cam) == tuple(jcam) and cfg.n_features == jcfg.n_features == 600
    assert (cfg.use_gf, cfg.gf_budget, cfg.gf_mode, cfg.init_min_points) == (True, 100, "active", 30)
    assert (args.seq, args.max_frames, args.save_map, args.load_map, args.probe_stages) == (
        "d", 12, "a.npz", "b.npz", True)
    args = run_slam.parse_args(["--synthetic", "5"])
    assert (args.seq, args.max_frames, args.init_gate, args.save_map, args.load_map, args.probe_stages) == (
        None, 0, -1, None, None, False)
    assert run_slam.config_from_args(args)[1].init_min_points == SlamConfig().init_min_points
    for bad in ([], ["--seq", "d", "--synthetic", "5"]):
        with pytest.raises(SystemExit):
            run_slam.parse_args(bad)


@pytest.fixture(scope="module")
def seq_run(dumped, tmp_path_factory):
    """`--seq` over the dumped EuRoC sequence on the CPU (GF after 2
    frames), saving the map and probing the stages."""
    out = tmp_path_factory.mktemp("seq_run")
    argv = ["--seq", str(dumped / "euroc"), "--settings", str(dumped / "euroc" / "settings.yaml"),
            "--gf-budget", "100", "--gf-warmup", "2", "--device", "cpu"]
    import json

    run_slam.main(argv + ["--save-map", str(out / "map.npz"), "--probe-stages", "--out", str(out / "seq")])
    with open(out / "seq_result.json") as f:
        return argv, out, json.load(f)


def test_cli_seq_equals_the_frames_from_memory(seq_run, dumped):
    argv, out, result = seq_run
    seq = jds.load_euroc(str(dumped / "euroc"))
    cam, cfg = run_slam.config_from_args(run_slam.parse_args(argv))
    system = SlamSystem(cam, cfg, device="cpu")
    system.set_vocabulary(voc_mod.load_default_vocabulary("cpu"))
    frames = [(t, torch.from_numpy(jds._imread_gray(p))) for t, p in zip(seq.timestamps, seq.image_paths)]
    n = run_slam.process_frames(system, frames)
    run_slam.write_outputs(system, run_slam.summarize(system, n), str(out / "mem"))
    for suffix in ("_AllFrameTrajectory.txt", "_KeyFrameTrajectory.txt"):
        assert open(out / f"seq{suffix}").read() == open(out / f"mem{suffix}").read()
    assert result["frames"] == N_FRAMES and result["tracked"] >= N_FRAMES - 6
    assert result["ate_rmse_m"] < 0.05
    # The stage probe's keys are the reference's, each finite and ≥ 0.
    assert list(result["device_stages_ms"]) == list(stage_probe.STAGES)
    assert all(np.isfinite(v) and v >= 0 for v in result["device_stages_ms"].values())
    assert "device-stage" in open(out / "seq_TimeLog.txt").read()


def test_cli_load_map_resumes(seq_run, dumped):
    """The saved map (the reference reads it too) resumes LOST and
    relocalizes on the sequence's last frames."""
    argv, out, _ = seq_run
    jm, jv, jdb = jsnap.load_map(str(out / "map.npz"))
    valid, kf_valid = np.asarray(jdb.valid), np.asarray(jm.kf_valid)
    # Every inserted keyframe is registered; the two bootstrap keyframes are
    # not, in the reference's run as in the port's (ROADMAP C).
    assert jv.n_words == 1_000_000 and kf_valid.sum() >= 3 and valid.sum() == kf_valid.sum() - 2
    assert not (valid & ~kf_valid).any()
    tail = out / "tail"
    seq = datasets.load_euroc(str(dumped / "euroc"))
    datasets.write_euroc(str(tail), seq.timestamps[-5:], [images.read_gray(p) for p in seq.image_paths[-5:]],
                         np.zeros((5, 7), np.float32) + np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32))
    argv = [a if a != str(dumped / "euroc") else str(tail) for a in argv]
    run_slam.main(argv + ["--load-map", str(out / "map.npz"), "--max-frames", "3", "--out", str(out / "resumed")])
    tracked = open(out / "resumed_AllFrameTrajectory.txt").read().splitlines()
    assert len(tracked) == 3  # relocalized on the first frame, tracked on the next two


@pytest.mark.parametrize("scene,cam", [("planes", run_slam.BENCH_CAMERA), ("room", run_slam.EUROC_CAM)])
def test_render_frames_shares_equal_the_whole_sequence(scene, cam):
    """Frames [start, stop) rendered on their own, at one torch thread (as
    chip_smoke.py's render processes render them), hold the bits of the same
    frames of render_sequence's whole sequence at the default thread count;
    the timestamps and ground truth are the whole sequence's either way."""
    n = 4
    ts, poses, whole = run_slam.render_sequence(cam, n, 0, "cpu", scene=scene)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        shares = [run_slam.render_frames(cam, n, 0, scene, a, b) for a, b in ((0, 1), (1, 3), (3, 4), (4, 4))]
    finally:
        torch.set_num_threads(threads)
    for s_ts, s_poses, frames in shares:
        np.testing.assert_array_equal(s_ts, ts)
        np.testing.assert_array_equal(s_poses, poses)
        assert frames.dtype == torch.uint8
    assert shares[-1][2].shape == (0, cam.height, cam.width)
    assert torch.equal(torch.cat([f for _, _, f in shares]).to(torch.float32), whole)
