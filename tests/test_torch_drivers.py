"""The port's measurement tools (tools/torch_*.py) against the
reference's tools at small sizes, on the CPU:

* loop gate study: the offline sweep (`io_utils/loop_eval.gate_sweep`,
  `tools/torch_loop_gate_study.py --analyze`) equal to the reference tool's
  `analyze` on its recorded events (docs/loop_gate_events*.json), and
  `loop_eval.sim3_against_ground_truth` on a Sim3 built from the ground truth;
* vocabulary stress: the views, ground truth and retrieval scores equal on
  the same descriptors and vocabulary;
* vocabulary device cost: both tools run and time the same four programs;
* selection bench: the pool's information blocks (1e-4, 1e-5 of the
  largest) and the exact greedy's logdet (1e-4 relative) equal, lazier picks
  no better than it;
* vocabulary training and conversion: the same tree from the same corpus,
  byte-identical text and equal binary files;
* dataset dump: the same files, settings text, timestamps and ground truth
  (1e-5), frames within a few grey levels (the two renderers round apart).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import bin_vocabulary  # noqa: E402
import dump_dataset  # noqa: E402
import loop_gate_study  # noqa: E402
import torch_bin_vocabulary  # noqa: E402
import torch_dump_dataset  # noqa: E402
import torch_loop_gate_study  # noqa: E402
import torch_selection_bench  # noqa: E402
import torch_train_vocabulary  # noqa: E402
import torch_vocab_onchip  # noqa: E402
import torch_vocab_stress  # noqa: E402
import train_vocabulary  # noqa: E402
import vocab_onchip  # noqa: E402
import vocab_stress  # noqa: E402

from gf_orb_slam_tpu_torch.io_utils import loop_eval  # noqa: E402
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod  # noqa: E402

DOCS = os.path.join(REPO, "docs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("files", [["loop_gate_events.json"], ["loop_gate_events.json", "loop_gate_events_endur.json"]])
def test_loop_gate_analyze_matches_reference(files, tmp_path):
    paths = [os.path.join(DOCS, f) for f in files]
    want = loop_gate_study.analyze(paths, str(tmp_path / "ref.json"))
    runs = []
    for p in paths:
        with open(p) as f:
            runs.extend(json.load(f)["runs"])
    got = torch_loop_gate_study.analyze(runs)
    assert got == want
    if len(files) == 2:
        with open(os.path.join(DOCS, "loop_gate_pr.json")) as f:
            assert got["operating_points"] == json.load(f)["operating_points"]


def test_sim3_against_ground_truth():
    """A Sim3 built from the ground truth reads 0° and the map's scale ratio."""
    from gf_orb_slam_tpu_torch.geometry import sim3
    from gf_orb_slam_tpu_torch.io_utils import synthetic

    _, poses_gt = synthetic.circuit_trajectory(40, fps=20.0, radius=4.0, revs=1.0)
    gt = torch.as_tensor(poses_gt)
    ids = [0, 1, 30, 31]
    kf_pose = gt[ids].clone()
    kf_pose[2:, 4:] *= 2.0        # the map's scale doubles between the two halves
    S = sim3.compose(sim3.from_se3(gt[30], 2.0), sim3.inverse(sim3.from_se3(gt[0], 1.0)))
    r = loop_eval.sim3_against_ground_truth(S.numpy(), 2, 0, kf_pose.numpy(), np.asarray(ids), np.ones(4, bool),
                                            poses_gt)
    assert r["rotation_error_deg"] < 1e-3 and abs(r["map_scale_ratio"] - 2.0) < 1e-4
    assert abs(r["scale_error"] - 1.0) < 1e-4


def test_vocab_stress_matches_reference():
    import jax.numpy as jnp

    from gf_orb_slam_tpu.retrieval import vocabulary as jvoc

    want = vocab_stress.build_views(10, 4, seed=0, revs=2.0, rings=2)
    got = torch_vocab_stress.build_views(10, 4, seed=0, revs=2.0, rings=2)
    for (wc, wd), (gc, gd) in zip(want[4:], got[4:]):
        np.testing.assert_allclose(gc, wc, atol=1e-5)
        np.testing.assert_allclose(gd, wd, atol=1e-5)
    gt, far = torch_vocab_stress.ground_truth(*got[4], *got[5], 25.0, 1.2)
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, 2**32, (600, 8), dtype=np.uint32)
    jv = jvoc.train_vocabulary(corpus, k=4, L=2, seed=0)
    tv = voc_mod.train_vocabulary(corpus, k=4, L=2, seed=0)
    # Keyframes and queries share words: queries copy part of a keyframe.
    kf = [rng.integers(0, 2**32, (64, 8), dtype=np.uint32) for _ in range(10)]
    qs = [np.concatenate([kf[(2 * j + 1) % 10][:40], rng.integers(0, 2**32, (24, 8), dtype=np.uint32)]) for j in range(4)]
    valid = np.ones(64, bool)
    w = vocab_stress.evaluate(jv, [(jnp.asarray(d), jnp.asarray(valid)) for d in kf],
                              [(jnp.asarray(d), jnp.asarray(valid)) for d in qs], gt | np.eye(4, 10, 1, bool), far)
    g = torch_vocab_stress.evaluate(tv, [(torch.from_numpy(d.view(np.int32)), torch.from_numpy(valid)) for d in kf],
                                    [(torch.from_numpy(d.view(np.int32)), torch.from_numpy(valid)) for d in qs],
                                    gt | np.eye(4, 10, 1, bool), far)
    w.pop("quantize_ms_per_frame"), g.pop("quantize_ms_per_frame")
    print(g)
    assert g == w


def test_vocab_onchip_times_the_reference_programs(tmp_path, monkeypatch):
    from gf_orb_slam_tpu.retrieval import vocabulary as jvoc

    rng = np.random.default_rng(1)
    voc = voc_mod.train_vocabulary(rng.integers(0, 2**32, (300, 8), dtype=np.uint32), k=3, L=2, seed=0)
    path = str(tmp_path / "voc.npz")
    voc_mod.save_binary(path, voc)
    got = torch_vocab_onchip.main(["--kfs", "8", "--n-kps", "32", "--reps", "1", "--vocabulary", path,
                                   "--device", "cpu"])
    monkeypatch.setattr(jvoc, "load_default_vocabulary", lambda: jvoc.load_vocabulary(path))
    monkeypatch.setattr(sys, "argv", ["vocab_onchip.py", "--cpu", "--kfs", "8", "--n-kps", "32", "--chain", "1",
                                      "--out", str(tmp_path / "ref.json")])
    vocab_onchip.main()
    with open(tmp_path / "ref.json") as f:
        want = json.load(f)
    assert list(got["programs_ms"]) == list(want["programs_ms"])
    assert all(np.isfinite(v) and v > 0 for v in got["programs_ms"].values())
    assert (got["K"], got["N"], got["n_words"]) == (want["K"], want["N"], want["n_words"])


def test_selection_bench_matches_reference():
    import jax.numpy as jnp

    from gf_orb_slam_tpu.geometry import camera as jcam
    from gf_orb_slam_tpu.gf import observability as jobs
    from gf_orb_slam_tpu.gf import selection as jsel

    rows = torch_selection_bench.main(["--pools", "60", "--k", "10", "--reps", "1", "--device", "cpu"])
    blocks, visible, xc = torch_selection_bench.pool_blocks(60, np.random.default_rng(0), torch.device("cpu"))
    jac = jobs.measurement_jacobians(jcam.EUROC_CAM, jnp.zeros(13).at[3].set(1.0), jnp.asarray(xc, jnp.float32))
    jb = jobs.info_matrices(jobs.whiten(jac.H, jnp.ones(60)), jac.visible)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5 * float(np.abs(jb).max()))
    from gf_orb_slam_tpu_torch.gf import selection

    want = float(jsel.greedy_maxlogdet(jb, jac.visible, k=10).logdet)
    got = float(selection.greedy_maxlogdet(blocks, visible, k=10).logdet)
    assert abs(got - want) <= 1e-4 * abs(want)
    by = {r["method"]: r for r in rows}
    assert by["greedy_exact"]["logdet_gap"] == 0.0
    assert by["lazier_greedy"]["logdet_gap"] >= -1e-4 and by["grouped_lazier"]["logdet_gap"] >= -1e-4


def test_train_and_bin_vocabulary_match_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    cache = str(tmp_path / "corpus.npz")
    np.savez_compressed(cache, descs=rng.integers(0, 2**32, (500, 8), dtype=np.uint32))
    torch_train_vocabulary.main(["--out", str(tmp_path / "port.npz"), "--k", "4", "--L", "2", "--corpus-cache", cache,
                                 "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train_vocabulary.py", "--out", str(tmp_path / "ref.npz"), "--k", "4", "--L",
                                      "2", "--corpus-cache", cache, "--cpu"])
    train_vocabulary.main()
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert torch_bin_vocabulary.main([str(tmp_path / "port.npz"), str(tmp_path / "port.txt")]) == 0
    assert bin_vocabulary.main([str(tmp_path / "ref.npz"), str(tmp_path / "ref.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    assert torch_bin_vocabulary.main([str(tmp_path / "port.txt"), str(tmp_path / "back.npz")]) == 0
    assert bin_vocabulary.main([str(tmp_path / "ref.txt"), str(tmp_path / "ref_back.npz")]) == 0
    with np.load(tmp_path / "back.npz") as a, np.load(tmp_path / "ref_back.npz") as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout", ["euroc", "tum"])
def test_dump_dataset_matches_reference(layout, tmp_path):
    from gf_orb_slam_tpu_torch.io_utils.images import read_gray

    args = ["--layout", layout, "--frames", "2", "--scene", "planes"]
    torch_dump_dataset.main(["--out", str(tmp_path / "port")] + args)
    dump_dataset.main(["--out", str(tmp_path / "ref"), "--cpu"] + args)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    assert files(tmp_path / "port") == files(tmp_path / "ref")
    for rel in files(tmp_path / "ref"):
        a, b = tmp_path / "port" / rel, tmp_path / "ref" / rel
        if rel.endswith(".png"):
            d = np.abs(read_gray(str(a)).astype(int) - read_gray(str(b)).astype(int))
            print(rel, "pixels differing", int((d > 0).sum()), "max", int(d.max()))
            assert d.max() <= 4 and (d > 0).mean() < 1e-3
        elif rel.endswith(".yaml"):
            assert a.read_text() == b.read_text()
        else:
            la, lb = a.read_text().splitlines(), b.read_text().splitlines()
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                if x.startswith("#"):
                    assert x == y
                    continue
                xs, ys = x.replace(",", " ").split(), y.replace(",", " ").split()
                assert xs[0] == ys[0] and len(xs) == len(ys)
                nums = [i for i, v in enumerate(ys) if not v.endswith(".png")]
                np.testing.assert_allclose([float(xs[i]) for i in nums], [float(ys[i]) for i in nums], atol=1e-5)
