"""The port's loop instrumentation against the JAX reference's:

* io_utils/loop_eval.py against the reference's own measurement code
  (tools/loop_recall.py and tools/loop_gate_study.py, run over a stand-in
  system that replays a given event list): the same ground-truth overlap
  test, episodes, recall counts and false closures on the same events;
* SlamSystem's loop rounds with the recall hook and the probe
  (`loop_probe_floor=8`) on the reference's drifted-map scenario
  (tests/test_loop_closing.py), the same pending inputs fed to both
  systems for three rounds and the reference's Sim3 RANSAC draws injected:
  recall events and gate records equal, the funnel's RANSAC, guided and
  refined counts within max(3, 2%) (float32 solvers, as
  tests/test_torch_loop_closing.py holds verify_candidate);
* the hook on a short run of the port: the same trajectory as without it,
  one event per loop round, built from the insertion's one packed read.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_closing as ref_scenario
from gf_orb_slam_tpu.io_utils import synthetic as jsyn
from gf_orb_slam_tpu.mapping import map_state as jms
from gf_orb_slam_tpu.pipeline import system as jsys
from gf_orb_slam_tpu.retrieval import vocabulary as jvoc
from gf_orb_slam_tpu_torch import run_slam
from gf_orb_slam_tpu_torch.geometry import camera
from gf_orb_slam_tpu_torch.io_utils import loop_eval, synthetic
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.pipeline import system
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu_torch.solvers import sim3_solver
from test_torch_loop_closing import gumbel_top_k, to_port_db, to_port_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import loop_gate_study  # noqa: E402
import loop_recall  # noqa: E402

N_FRAMES, REVS = 60, 1.15


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# loop_eval against the reference tools' code
# ---------------------------------------------------------------------------


def random_events(rng, n_kf=40):
    """Loop rounds over keyframes 11.. with runs of opportunity events,
    some closed onto a keyframe whose frame is near (a true closure) or
    far (a false one); frame ids along a 60-frame circuit."""
    fid = np.sort(rng.choice(N_FRAMES, n_kf, replace=False)).astype(np.int32)
    events, k = [], 11
    while k < n_kf:
        run = int(rng.integers(1, 5))
        opp = bool(rng.random() < 0.6)
        for j in range(run):
            if k >= n_kf:
                break
            closed = opp and j == run - 1 and rng.random() < 0.7
            matched = None
            if closed:
                d = np.abs(2 * np.pi * REVS * (fid[k] - fid[:k]) / N_FRAMES) % (2 * np.pi)
                near = np.flatnonzero(np.minimum(d, 2 * np.pi - d) < np.deg2rad(30))
                matched = int(near[0]) if near.size and rng.random() < 0.7 else int(rng.integers(0, k))
            events.append({"kf": k, "frame": int(fid[k]), "opportunity": opp, "closed": closed, "matched_kf": matched})
            k += 1
    return events, fid


class ReplaySystem:
    """Stands in for the reference's SlamSystem inside the reference tools:
    processes nothing and reports the given events and keyframe frame ids."""

    events: list = []
    fid = None
    hooks: list = []

    def __init__(self, cam, cfg):
        self.cfg = cfg
        self.loop_events = copy.deepcopy(ReplaySystem.events)
        self.loop_gate_events = []
        self.map = jms.empty_map(max_keyframes=len(ReplaySystem.fid), max_points=8, max_kps=8)._replace(
            kf_frame_id=jnp.asarray(ReplaySystem.fid))
        self.state = jsys.State.WORKING
        self.n_kf = len(ReplaySystem.fid)
        self.n_loops_closed = sum(e["closed"] for e in self.loop_events)
        ReplaySystem.hooks.append(self)

    def set_vocabulary(self, voc):
        pass

    def process(self, img, t):
        pass

    def flush(self):
        pass


@pytest.fixture()
def replay(monkeypatch):
    """The reference tools' run_one with the system, scene, render and
    vocabulary stood in for."""
    monkeypatch.setattr(jsys, "SlamSystem", ReplaySystem)
    monkeypatch.setattr(jsyn, "make_room_scene", lambda seed: None)
    monkeypatch.setattr(jsyn, "render_general", lambda scene, cam, pose: None)
    monkeypatch.setattr(jvoc, "load_default_vocabulary", lambda: None)
    ReplaySystem.hooks = []

    def run(events, fid):
        ReplaySystem.events, ReplaySystem.fid = events, fid
        rec = loop_recall.run_one(0, N_FRAMES, REVS, True, 100)
        gate = loop_gate_study.run_one(0, N_FRAMES, REVS, 100, 8)
        return rec, gate, ReplaySystem.hooks[0].loop_gt_overlap
    return run


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_eval_equals_the_reference_tools(replay, seed):
    rng = np.random.default_rng(seed)
    events, fid = random_events(rng)
    rec, gate, gt_ref = replay(events, fid)
    gt = loop_eval.circuit_gt_overlap(N_FRAMES, REVS)
    pairs = [(a, b) for a in range(N_FRAMES) for b in range(0, N_FRAMES, 3)]
    for deg in (25.0, 45.0):
        assert [gt(a, b, max_deg=deg) for a, b in pairs] == [bool(gt_ref(a, b, max_deg=deg)) for a, b in pairs]
    got = loop_eval.recall_summary(events, fid, gt)
    assert got == {k: rec[k] for k in got}
    assert rec["closed_episodes"] >= 1 and got["false_closures"] + got["closed_episodes"] >= 1
    eps = loop_eval.episodes(events)
    assert [{"kfs": e["kfs"], "closed": e["closed"]} for e in eps] == gate["episodes"]
    np.testing.assert_array_equal(loop_eval.events_to_array(loop_eval.events_from_array(
        loop_eval.events_to_array(events))), loop_eval.events_to_array(events))


def test_closed_episodes_missed():
    ev = [{"kf": k, "frame": f, "opportunity": o, "closed": c, "matched_kf": 0 if c else None}
          for k, (f, o, c) in enumerate([(10, False, False), (20, True, False), (26, True, True), (40, False, False),
                                         (60, True, False)])]
    moved = [dict(e, frame=e["frame"] + 10) for e in ev]
    assert loop_eval.closed_episodes_missed(ev, ev, slack=0) == []
    assert loop_eval.closed_episodes_missed(ev, moved, slack=12) == []
    assert loop_eval.closed_episodes_missed(ev, moved, slack=2) == [(20, 26)]
    assert loop_eval.closed_episodes_missed(ev, [dict(e, closed=False) for e in ev], slack=50) == [(20, 26)]


# ---------------------------------------------------------------------------
# The system's loop rounds with the hook and the probe
# ---------------------------------------------------------------------------


def gt_overlap(fid_q, fid_k, max_deg=25.0):
    """The drifted map's keyframe k is frame k; its first and last
    keyframes see the same landmarks."""
    return abs(fid_q - fid_k) >= 6


@pytest.fixture(scope="module")
def drifted():
    """The drifted map in 16 keyframe slots (the track view after a
    correction takes the query's 12 best covisible keyframes)."""
    rng = np.random.default_rng(42)
    jm8, _, _, _ = ref_scenario.build_drifted_map(rng)
    jm = jms.empty_map(max_keyframes=16, max_points=jm8.pt_capacity, max_kps=jm8.kp_capacity)
    jm = jm._replace(**{f: getattr(jm, f).at[:8].set(getattr(jm8, f)) if f.startswith("kf_") else getattr(jm8, f)
                        for f in jm._fields})
    voc = jvoc.train_vocabulary(rng.integers(0, 2**32, (2000, 8), dtype=np.uint32), k=8, L=2)
    from gf_orb_slam_tpu.retrieval import keyframe_db as jkdb

    jdb = jkdb.empty_db(16, jm.kp_capacity, voc.n_words)
    for k in range(8):
        jdb = jkdb.add_keyframe(jdb, voc, jnp.asarray(k), jm.kf_kp_desc[k], jm.kf_kp_valid[k])
    return jm, jdb


def test_probe_rounds_equal_the_reference(drifted):
    jm, jdb = drifted
    cfg = dict(loop_probe_floor=8, loop_min_kf_gap=5, view_size=jm.pt_capacity)
    cand, ok = np.asarray([0, 1], np.int32), np.asarray([True, True])
    covis = np.asarray(jms.covisibility(jm))

    ref = jsys.SlamSystem(ref_scenario.CAM, jsys.SlamConfig(pipelined=False, **cfg))
    ref.map, ref.bow_db, ref.loop_gt_overlap = jm, jdb, gt_overlap
    keys, key = [], ref._key  # the keys the reference's rounds will split off, in order
    for _ in range(3):
        key, k = jax.random.split(key)
        keys.append(k)
    pending = {"cand": jnp.asarray(cand), "ok": jnp.asarray(ok), "covis_q": jnp.asarray(covis[7]),
               "covis_c": jnp.asarray(covis[cand]), "covis": jnp.asarray(covis)}
    closed_ref = [ref._try_close_loop(7, dict(pending)) for _ in range(3)]

    port = system.SlamSystem(camera.CameraModel(**ref_scenario.CAM._asdict()), system.SlamConfig(**cfg), device="cpu")
    port.map, port.bow_db, port.loop_gt_overlap = to_port_map(jm), to_port_db(jdb), gt_overlap
    draws = []

    def reference_draw(valid, n_hypotheses, generator):
        draws.append(n_hypotheses)
        return gumbel_top_k(keys[len(draws) - 1], jnp.asarray(valid.numpy()), n_hypotheses, 3)

    p = {"kf": 7, "cand": cand, "ok": ok, "covis_c": covis[cand], "covis": torch.from_numpy(covis.copy()),
         "covis_q": covis[7], "kf_frame_id": np.asarray(jm.kf_frame_id), "kf_valid": np.asarray(jm.kf_valid)}
    mp = pytest.MonkeyPatch()
    mp.setattr(sim3_solver, "sample_sim3", reference_draw)
    try:
        closed = [port._try_close_loop(dict(p)) for _ in range(3)]
    finally:
        mp.undo()

    assert closed == closed_ref and port.n_loops_closed == ref.n_loops_closed
    assert len(draws) == len(keys) and ref._key is not None
    assert port.loop_events == ref.loop_events
    assert [e["opportunity"] for e in ref.loop_events] == [True] * 3
    assert len(port.loop_gate_events) == len(ref.loop_gate_events)
    n_verified = 0
    for got, want in zip(port.loop_gate_events, ref.loop_gate_events):
        exact = {k: v for k, v in want.items() if k not in ("n_ransac", "n_guided", "n_opt")}
        assert {k: got[k] for k in exact} == exact and set(got) == set(want)
        for k in ("n_ransac", "n_guided", "n_opt"):
            if k in want:
                n_verified += k == "n_opt"
                assert abs(got[k] - want[k]) <= max(3, 0.02 * want[k]), (k, got, want)
    assert n_verified == 3  # rounds 2 and 3 verified (round 3 accepts the first)


# ---------------------------------------------------------------------------
# The hook on a short run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def short_runs():
    """Seven bench frames (keyframes at 4 and 5), loops checked from the
    third keyframe on, with and without the hook."""
    cam = run_slam.BENCH_CAMERA
    ts, poses_gt = synthetic.trajectory(240, fps=cam.fps)  # the bench's motion
    scene = synthetic.make_scene(seed=0)
    frames = torch.stack([torch.clamp(torch.round(synthetic.render(scene, cam, torch.from_numpy(poses_gt[i]))), 0, 255)
                          for i in range(7)])
    voc = voc_mod.load_default_vocabulary(torch.device("cpu"))
    cfg = run_slam.bench_config(loop_min_kf_gap=1)
    pendings = []
    plain = system.SlamSystem._try_close_loop

    def recording(self, p):
        pendings.append(p)
        return plain(self, p)

    mp = pytest.MonkeyPatch()
    mp.setattr(system.SlamSystem, "_try_close_loop", recording)
    try:
        out = [run_slam.run_sequence(cam, cfg, ts[:7], poses_gt[:7], frames, "cpu", vocabulary=voc, loop_gt_overlap=h)[0]
               for h in (None, lambda a, b: True)]
    finally:
        mp.undo()
    return out, pendings


def test_hook_changes_nothing_else(short_runs):
    (plain, hooked), pendings = short_runs
    assert len(plain.trajectory) == len(hooked.trajectory) >= 3
    for (t0, p0), (t1, p1) in zip(plain.trajectory, hooked.trajectory):
        assert t0 == t1
        np.testing.assert_array_equal(p0, p1)
    assert plain.loop_events == [] and plain.loop_gate_events == [] and hooked.loop_gate_events == []
    rounds = [p for p in pendings if "covis_q" in p]
    assert len(hooked.loop_events) == len(rounds) >= 1 and len(pendings) == 2 * len(rounds)
    assert all("covis_q" not in p for p in pendings[: len(rounds)])
    m = hooked.map
    for ev, p in zip(hooked.loop_events, rounds):
        assert ev["frame"] == p["kf_frame_id"][ev["kf"]] == m.kf_frame_id[ev["kf"]] == 5
        assert ev["closed"] is False and ev["matched_kf"] is None
        assert p["kf_valid"][ev["kf"]] and ev["opportunity"] == any(
            p["covis_q"][k] <= 0 for k in np.flatnonzero(p["kf_valid"]) if k < ev["kf"] - 1)
    last = rounds[-1]
    np.testing.assert_array_equal(last["covis_q"], ms.covisibility(m)[last["kf"]].numpy())
