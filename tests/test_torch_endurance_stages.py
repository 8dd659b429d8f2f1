"""The port's loop closing held stage by stage against the JAX reference's
1,200-frame endurance run (tools/endurance.py --frames 1200 --pipeline 1
--cpu: the room circuit over 3.3 revolutions, 256 keyframe and 16,384 point
slots): every loop verification the reference accepted, and the first one
it rejected, fed its inputs from
gf_orb_slam_tpu_torch/data/endurance_fixture.npz
(tools/make_torch_endurance_fixture.py) with the reference's own Sim3-RANSAC
minimal sets injected, and every loop correction fed its map, Sim3 and
covisibility, the essential graph the port's own.

Tolerances: the verification's n_bow, n_ransac, n_guided, n_inliers and ok
exact, its S12 within 1e-4; the correction's keyframe poses and points
within 1e-4, pt_valid, kf_obs_point and the point counters exact (the room
stages' tolerance, tests/test_torch_room_stages.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.io_utils import map_delta, snapshot
from gf_orb_slam_tpu_torch.loop import loop_closing
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.solvers import sim3_solver

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "endurance_fixture.npz")
CPU = torch.device("cpu")
with np.load(FIXTURE) as _z:
    META = json.loads(str(_z["meta"]))
LOOPS = [f"loop{j}" for j in range(META["n_loops"])]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def t(a) -> torch.Tensor:
    return snapshot.to_tensor(np.asarray(a), CPU)


def stage_inputs(arrays, name):
    """The stage's map, and a BoW database holding the two rows of
    mid-level nodes the verification reads (it reads nothing else)."""
    m = snapshot.map_state_from_numpy(map_delta.decode(arrays, f"{name}_map"), CPU)
    K, N = m.kf_kp_desc.shape[:2]
    q, c = int(arrays[f"{name}_query_kf"]), int(arrays[f"{name}_cand_kf"])
    mid = np.zeros((K, N), np.int32)
    mid[q], mid[c] = arrays[f"{name}_db_mid_q"], arrays[f"{name}_db_mid_c"]
    z = torch.zeros((K, N), dtype=torch.int32)
    db = kdb.BowDatabase(bow_ids=z, bow_vals=z.float(), words=z, mid_nodes=t(mid),
                         valid=torch.zeros(K, dtype=torch.bool))
    return m, db, q, c


@pytest.mark.parametrize("name", LOOPS + ["reject"])
def test_endurance_verify_candidate(arrays, name, monkeypatch):
    m, db, q, c = stage_inputs(arrays, name)
    draws = []

    def reference_draw(valid, n_hypotheses, generator):
        draws.append(int(valid.sum()))
        return t(arrays[f"{name}_samples"]).long()

    monkeypatch.setattr(sim3_solver, "sample_sim3", reference_draw)
    lm = loop_closing.verify_candidate(CameraModel(**META["camera"]), m, db, q, c, torch.Generator(),
                                       **META["verify_kw"])
    got = {k: int(getattr(lm, k)) for k in ("n_bow", "n_ransac", "n_guided", "n_inliers")}
    want = {k: int(arrays[f"{name}_{k}"]) for k in got}
    s_err = float(np.abs(lm.S12.numpy() - arrays[f"{name}_S12"]).max())
    print(name, "frame", int(arrays[f"{name}_frame"]), "port", got, bool(lm.ok), "reference", want,
          bool(arrays[f"{name}_ok"]), "S12 max |Δ|", s_err)
    assert draws == [want["n_bow"]]
    assert got == want and bool(lm.ok) == bool(arrays[f"{name}_ok"])
    assert bool(lm.ok) == (name != "reject")
    assert s_err <= 1e-4


@pytest.mark.parametrize("name", LOOPS)
def test_endurance_correct_loop(arrays, name):
    m, _, q, c = stage_inputs(arrays, name)
    kw = META["correct_kw"]
    got = loop_closing.correct_loop(m, q, c, t(arrays[f"{name}_S12"]), t(arrays[f"{name}_covis"]),
                                    cam=CameraModel(**META["camera"]), **kw)
    want = map_delta.decode(arrays, f"{name}_out")
    rep = map_delta.agreement(ms.to_numpy(got), want)
    graph_move = float(np.abs(arrays[f"{name}_graph_out"] - arrays[f"{name}_graph_in"]).max())
    print(name, "frame", int(arrays[f"{name}_frame"]), rep, "reference graph max move", graph_move)
    assert rep["kf_valid_equal"] and rep["kf_pose"] <= 1e-4 and rep["pt_pos"] <= 1e-4, rep
    assert rep["pt_valid"] == 1.0 and rep["kf_obs_point"] == 1.0, rep
    g = ms.to_numpy(got)
    for k in ("pt_visible", "pt_found"):
        np.testing.assert_array_equal(g[k], want[k], err_msg=k)
