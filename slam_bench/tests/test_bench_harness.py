"""The harness's arithmetic and files, on the CPU."""

import importlib.util
import json
import sys

import numpy as np
import pytest

from slam_bench import peaks, reference, run, session, trace

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    spec = run.cell_spec(workload)
    assert spec["traffic"]["frames"] <= spec["config"]["sequence_frames"]
    compared = set(reference.judge({"frames": []}, np.zeros((0, 7))))
    assert set(spec["limits"]["compare"]) | set(spec["config"]["limits"]) <= compared
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.reader(m["name"]))
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "frames_per_s", "frame_ms_p95"}


def test_benchmark_entries_name_existing_files():
    for c in BENCH["configs"]:
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and set(c["reduced"]) <= set(cfg["reduced"]) <= set(cfg)
        assert (run.ROOT / cfg["vocabulary"]).exists()
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(f.stem in {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               for f in (run.BENCH / "metrics").glob("*.py"))


def test_frame_ms_p95_is_taken_once_over_all_frames():
    rng = np.random.default_rng(0)
    ms = [rng.gamma(2.0, 100.0, 50 + 40 * k) for k in range(4)]  # rounds of different lengths
    frames = [{"ms": float(x), "pass": k} for k, a in enumerate(ms) for x in a]
    got = run.reader("frame_ms_p95")({"frames": frames})
    assert got == pytest.approx(np.percentile(np.concatenate(ms), 95))
    assert got != pytest.approx(np.mean([np.percentile(a, 95) for a in ms]))


def test_frames_per_s_counts_every_frame_of_the_window():
    frames = [{"ms": 1.0}] * 90
    assert run.reader("frames_per_s")({"frames": frames, "seconds": 30.0}) == 3.0


def _kernels(iv):
    a = np.asarray(iv, np.int64)
    return (a[:, 0], a[:, 1], np.zeros(len(a), np.int32), ["k"])


def test_idle_share_is_of_the_union_of_intervals():
    k = _kernels([(0, 10), (5, 15), (20, 30), (100, 120)])  # a copy overlapping a kernel is counted once
    assert trace.busy_ns(k, (0, 40)) == 25  # [0, 15) and [20, 30)
    assert trace.busy_ns(k, (5, 30)) == 20
    gaps = trace.idle_gaps(k, (0, 40), lambda ns: f"at{ns}")
    assert gaps[0] == ["at30", 10 / 1e9] and gaps[1] == ["at15", 5 / 1e9]
    assert trace.device_ops(k, (0, 40)) == [["k", 30 / 1e9]]  # time by name sums overlaps
    run_ = {"trace": {"window_s": 40e-9, "busy_s": 25e-9}}
    assert run.reader("device_idle_pct")(run_) == pytest.approx(37.5)


def test_hamming_byte_bound_at_4096_by_800():
    assert peaks.hamming_bytes(4096, 800) == 32 * 4896 + 4 * 4096 * 800
    assert peaks.hamming_bound_s(4096, 800) * 1e6 == pytest.approx(3.959, abs=5e-4)


def test_reference_hamming_counts_bits():
    rng = np.random.default_rng(1)
    q = rng.integers(-2**31, 2**31, (37, 8), dtype=np.int64).astype(np.int32)
    t = rng.integers(-2**31, 2**31, (53, 8), dtype=np.int64).astype(np.int32)
    bits = lambda a: np.unpackbits(a.view(np.uint8), axis=1)  # noqa: E731
    want = (bits(q)[:, None, :] != bits(t)[None, :, :]).sum(-1)
    assert np.array_equal(reference.hamming(q, t, block=8), want)


def test_reference_ate_is_invariant_to_a_similarity():
    rng = np.random.default_rng(2)
    from slam_bench import scenes

    gt = scenes.planes_trajectory(60, 20.0, 1.2, 0.4, 0.06)
    q, t, s = scenes.v2q([0.3, -0.2, 0.1]), np.array([1.0, 2.0, 3.0]), 0.37
    R = scenes.q2r(q)
    # The same trajectory in another gauge: world' = s R world + t.
    est = []
    for p in gt:
        Rcw = scenes.q2r(p[:4])
        c = -Rcw.T @ p[4:]
        est.append(scenes.pose_cw(_mul(q, p[:4] * [1, -1, -1, -1]), s * R @ c + t))
    assert reference.ate_cm(np.stack(est), gt) < 1e-9
    noisy = np.stack(est) + np.r_[0, 0, 0, 0, 0.01, 0, 0] * rng.standard_normal((60, 1))
    assert reference.ate_cm(noisy, gt) > 0.01


def _mul(a, b):
    w, x, y, z = b
    p, q, r, s = a
    return np.array([p * w - q * x - r * y - s * z, p * x + q * w + r * z - s * y,
                     p * y - q * z + r * w + s * x, p * z + q * y - r * x + s * w])


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("gf_orb_slam_tpu_torch.x", "jaxtyping", "flaxen", "gf_orb_slam_tpu_extra"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert session.forbidden_modules() == [m for m in sorted(sys.modules) if m.split(".")[0] in session.FORBIDDEN]
    monkeypatch.setitem(sys.modules, "gf_orb_slam_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert {"gf_orb_slam_tpu.ops", "jax"} <= set(session.forbidden_modules())
    assert "gf_orb_slam_tpu_torch.x" not in session.forbidden_modules()


def test_metric_readers_return_nothing_without_a_trace():
    empty = {"frames": [], "session": {"records": [], "trace": None}, "seconds": 1.0, "setup_s": 1.0, "trace": None}
    for m in BENCH["per_layer"]:
        assert run.reader(m["name"])(empty) is None, m["name"]


def test_run_and_session_modules_import_nothing_of_jax():
    spec = importlib.util.find_spec("slam_bench.run")
    src = open(spec.origin).read() + open(importlib.util.find_spec("slam_bench.session").origin).read()
    assert "import jax" not in src and "from gf_orb_slam_tpu " not in src and "from gf_orb_slam_tpu." not in src


def test_the_seed_draws_sensor_noise_over_one_scene():
    from slam_bench import scenes

    traffic = dict(run.cell_spec("room-gf100-rounds")["traffic"], frames=2)
    cam = run.cell_spec("room-gf100-rounds")["config"]["camera"]
    _, gt, a = scenes.make_sequence(traffic, cam, 2**31 + 5, "cpu")
    _, _, b = scenes.make_sequence(traffic, cam, 2**31 + 5, "cpu")
    _, gt2, c = scenes.make_sequence(traffic, cam, 2**31 + 6, "cpu")
    assert np.array_equal(a.numpy(), b.numpy()) and np.array_equal(gt, gt2)
    d = (a - c).abs()
    assert 0.5 < float(d.mean()) < 2.0 and float(d.max()) <= 12  # two draws of sigma-1 noise, one scene


def _ba_problem(rng, C=4, P=60):
    """A small local-BA problem: C cameras on an arc looking at P points,
    noisy observations, the first two cameras fixed, perturbed estimates."""
    from slam_bench import scenes

    pts = rng.uniform([-2, -2, 6], [2, 2, 10], (P, 3))
    poses = np.stack([scenes.pose_cw(scenes.v2q([0, 0.05 * c, 0]), np.array([0.3 * c, 0, 0])) for c in range(C)])
    cam = {"fx": 458.0, "fy": 458.0, "cx": 376.0, "cy": 240.0}
    xc = reference._rotate(poses[:, None, :4], pts[None]) + poses[:, None, 4:]
    uv = np.stack([xc[..., 0] / xc[..., 2] * cam["fx"] + cam["cx"], xc[..., 1] / xc[..., 2] * cam["fy"] + cam["cy"]], -1)
    obs_point = np.tile(np.arange(P, dtype=np.int32), (C, 1))
    obs_point[:, -5:] = -1
    noisy = poses + np.r_[0, 0.002, 0.002, 0.002, 0.01, 0.01, 0.01] * rng.standard_normal((C, 7))
    noisy[:, :4] /= np.linalg.norm(noisy[:, :4], axis=1, keepdims=True)
    noisy[:2] = poses[:2]
    return {"camera": cam, "poses": noisy, "points": pts + 0.05 * rng.standard_normal((P, 3)),
            "fixed": np.arange(C) < 2, "point_valid": np.arange(P) < P - 3,
            "obs_uv": uv + 0.7 * rng.standard_normal(uv.shape), "obs_point": obs_point,
            "obs_w": np.where(obs_point >= 0, 1.0, 0.0), "iters_stage1": 5, "iters_stage2": 10, "chi2_prune": 5.991}


def test_reference_ba_follows_the_program_in_float64():
    """The reference BA is written apart from the program; run in float64
    on one problem, the two agree far below float32's gaps (~1e-4, PERF.md)."""
    import torch

    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.solvers import local_ba

    c = _ba_problem(np.random.default_rng(3))
    t = {k: torch.from_numpy(np.asarray(c[k])) for k in ("poses", "points", "fixed", "point_valid", "obs_uv", "obs_point", "obs_w")}
    out = local_ba.bundle_adjust(CameraModel(**c["camera"]), local_ba.BAProblem(**t), iters_stage1=5, iters_stage2=10)
    poses, points = reference.bundle_adjust(c)
    assert np.abs(out.poses.numpy() - poses).max() < 1e-7
    assert np.abs(out.points.numpy() - points).max() < 1e-7
    assert np.abs(points - c["points"]).max() > 1e-3  # the problem moves its points
    assert reference.ba_point_gap(dict(c, out_points=out.points.numpy())) < 1e-7
    assert reference.ba_point_gap(dict(c, out_points=c["points"])) > 1e-3
