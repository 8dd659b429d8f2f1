"""Repeatability of the port's float scatter-adds and of the probe that
locates what parts two runs (tools/torch_repeat_probe.py), on the CPU:

* `ops/scatter.py`'s planned sum against a float64 sum, with rows that take 0,
  1, 2, 3 and 17 addends, dropped addends and no addend at all, in the
  layouts its callers give it (flat, per-point 3-vectors and 3×3 blocks),
  and equal bit for bit to the sequential `index_add_` on the CPU; one
  plan used for several sources;
* the global BA's point scatter and the pose graph's normal equations
  equal, bit for bit, to the index_add_ calls they replaced;
* the probe's recorder: two runs that part at one planted op are reported
  at that op, its site and its scatter's addends; two equal runs are not.

The repeat on the card itself is held by the `cuda` cases in
tests/test_torch_cuda.py and by chip_smoke.py's repeat gates.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_repeat_probe  # noqa: E402

from gf_orb_slam_tpu_torch.ops import scatter  # noqa: E402

COUNTS = [0, 1, 2, 3, 17]


def index_sum(index, src, n_rows):
    return scatter.planned_sum(scatter.sum_plan(index, n_rows), src)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def addends(tail: tuple, seed: int = 0):
    """(index, src, rows): rows with COUNTS addends each (shuffled, so a
    row's addends are not adjacent), values spread over six decades so the
    order of a sum shows in its bits."""
    rng = np.random.default_rng(seed)
    index = np.concatenate([np.full(c, r) for r, c in enumerate(COUNTS)])
    rng.shuffle(index)
    src = rng.normal(size=(len(index),) + tail) * 10.0 ** rng.integers(-3, 4, size=(len(index),) + tail)
    return torch.from_numpy(index), torch.from_numpy(src.astype(np.float32)), len(COUNTS)


@pytest.mark.parametrize("tail", [(), (3,), (3, 3)], ids=["flat", "vec3", "block3x3"])
def test_index_sum_against_float64(tail):
    index, src, rows = addends(tail)
    # Addends past the last row are dropped.
    index = torch.cat([index, torch.tensor([rows, rows + 3])])
    src = torch.cat([src, torch.full((2,) + tail, 1e6, dtype=torch.float32)])
    got = index_sum(index, src, rows)
    keep = index < rows
    want = np.zeros((rows,) + tail)
    np.add.at(want, index[keep].numpy(), src[keep].numpy().astype(np.float64))
    mag = np.zeros((rows,) + tail)
    np.add.at(mag, index[keep].numpy(), np.abs(src[keep].numpy().astype(np.float64)))
    for r, c in enumerate(COUNTS):
        # float32 sums of c addends: within c ulps of the sum of magnitudes.
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=0, atol=max(c, 1) * 2**-23 * mag[r].max())
    assert (got[0] == 0).all() and torch.equal(got[1], src[index == 1][0])
    # index_add_'s sequential order, bit for bit, on the CPU.
    assert torch.equal(got, torch.zeros((rows + 4,) + tail).index_add_(0, index, src)[:rows])


def test_index_sum_of_nothing():
    got = index_sum(torch.zeros(0, dtype=torch.int64), torch.zeros(0, 3), 4)
    assert got.shape == (4, 3) and (got == 0).all()


def test_one_plan_sums_many_sources():
    index, _, rows = addends(())
    plan = scatter.sum_plan(index, rows)
    for seed in range(3):
        _, src, _ = addends((3,), seed)
        assert torch.equal(scatter.planned_sum(plan, src), torch.zeros(rows, 3).index_add_(0, index, src))


def test_global_ba_point_scatter_keeps_its_cpu_bits():
    from gf_orb_slam_tpu_torch.parallel import global_ba

    rng = np.random.default_rng(1)
    C, N, P = 6, 40, 30
    obs_point = torch.from_numpy(rng.integers(-1, P, (C, N)))
    active = torch.from_numpy(rng.random((C, N)) < 0.8) & (obs_point >= 0)
    vals = torch.from_numpy(rng.normal(size=(C, N, 3, 3)).astype(np.float32))
    got = global_ba._scatter_point(vals, global_ba._point_plan(obs_point, active, P))
    drop = torch.where(active, obs_point, P).reshape(-1)
    want = torch.zeros(P + 1, 3, 3).index_add_(0, drop, vals.reshape(-1, 3, 3))[:P]
    assert torch.equal(got, want)
    assert torch.bincount(obs_point[active], minlength=P).max() >= 3  # rows the atomic order would part


def test_pose_graph_normal_equations_keep_their_cpu_bits(monkeypatch):
    """Three LM iterations of optimize_pose_graph give the poses that
    index_add_ onto zeros gave (the CPU's sequential order is kept)."""
    from gf_orb_slam_tpu_torch.geometry import sim3 as s3
    from gf_orb_slam_tpu_torch.solvers import pose_graph

    K = 8
    g = torch.Generator().manual_seed(0)
    poses = s3.exp(0.3 * torch.randn(K, 7, generator=g))
    iu, ju = torch.triu_indices(K, K, 1)
    meas = pose_graph.relative_sim3(poses, iu, ju)
    xi = 0.01 * torch.randn(K, 7, generator=g)
    xi[:, 6] = 0
    prob = pose_graph.PoseGraphProblem(
        poses=s3.compose(s3.exp(xi), poses), fixed=torch.arange(K) == 0, vertex_valid=torch.ones(K, dtype=torch.bool),
        edge_i=iu.int(), edge_j=ju.int(), edge_meas=meas, edge_valid=torch.ones(iu.shape[0], dtype=torch.bool),
        edge_weight=torch.ones(iu.shape[0]))
    got = pose_graph.optimize_pose_graph(prob, n_iters=3)
    calls = []

    def index_add(plan, src):
        index, n_rows = plan
        calls.append(index.shape[0])
        return torch.zeros((n_rows,) + src.shape[1:], dtype=src.dtype).index_add_(0, index, src)

    monkeypatch.setattr(scatter, "sum_plan", lambda index, n_rows: (index, n_rows))
    monkeypatch.setattr(scatter, "planned_sum", index_add)
    want = pose_graph.optimize_pose_graph(prob, n_iters=3)
    assert calls and torch.equal(got, want)
    assert not torch.equal(got, prob.poses)  # the graph took steps


def test_probe_reports_the_first_op_that_parts_two_runs():
    rec_runs = []
    for run in range(2):
        rec = torch_repeat_probe.OpRecorder()
        x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        with torch_repeat_probe.recording(rec):
            y = x * 2.0
            idx = torch.tensor([0, 0, 0, 1])
            y = y + (1e-3 if run else 0.0)  # the planted difference
            z = torch.zeros(2, 3).index_add_(0, idx, y)
            z.sum()
        rec_runs.append(rec.finish())
    rep = torch_repeat_probe.compare(*rec_runs)
    first = rep["first_differing_op"]
    assert rep["op_sequence_diverges_at"] is None and rep["ops_differing"] >= 2
    assert first["op"].startswith("aten.add") and "test_torch_repeat.py" in first["stack"][0]
    scatter_ops = [o for o in rep["first_differing_op_by_site"] if o["op"].startswith("aten.index_add_")]
    assert scatter_ops and scatter_ops[0]["scatter_addends_max_rows2_rows3"] == [3, 1, 1]


def test_probe_finds_nothing_in_equal_runs():
    recs = []
    for _ in range(2):
        rec = torch_repeat_probe.OpRecorder()
        with torch_repeat_probe.recording(rec):
            torch.linspace(0, 1, 50).cumsum(0).reshape(5, 10).softmax(-1)
        recs.append(rec.finish())
    rep = torch_repeat_probe.compare(*recs)
    assert rep["ops_differing"] == 0 and rep["first_differing_op"] is None and rep["ops"][0] == rep["ops"][1] > 0
