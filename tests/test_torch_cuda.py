"""Tests of the port that need a CUDA GPU: the hand-written Hamming kernels
against their plain version (path shapes, tile boundaries, extreme
descriptors, `out=`, replay in a CUDA graph), the entry points' default
device, the tracking step on the card against the
reference's recorded outputs, and the host synchronisations of the tracking
stages (in every GF mode), of the batched logdet, of the random modes'
draws, of the keyframe insertion, of the BoW registration and of the
relocalization, and the one host read of a keyframe-slab compaction; the
patch-matmul descriptors, BoxLOG and the prior-pose
initializer on the card against the CPU, the entry step, and the
fixed-order float sums (each repaired solver called twice gives equal
bits). They skip where there is no GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch

from gf_orb_slam_tpu_torch.geometry import pwls, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.io_utils import snapshot
from gf_orb_slam_tpu_torch.kernels import hamming
from gf_orb_slam_tpu_torch.mapping.frame import make_frame
from gf_orb_slam_tpu_torch.ops import matching
from gf_orb_slam_tpu_torch.ops.orb import OrbConfig
from gf_orb_slam_tpu_torch.pipeline import local_mapping
from gf_orb_slam_tpu_torch.pipeline import track_view as tv
from gf_orb_slam_tpu_torch.pipeline import tracking

# Tracking (4096×800, 800×800, 1600×800), bootstrap and triangulation
# (1600×1600), fusion (2048×1600), relocalization (800×1600), the loop's
# SearchAndFuse (4800×1600) and the entry step (512×512).
PATH_SHAPES = [(4096, 800), (800, 800), (1600, 800), (1600, 1600), (2048, 1600), (800, 1600), (4800, 1600),
               (512, 512)]
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def words(rng, n):
    d = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    d[::2, 0] |= np.uint32(1 << 31)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nt", [(1, 1), (31, 33), (127, 129), (1000, 777), (0, 8), (8, 0)] + PATH_SHAPES)
def test_kernel_bit_identical_to_plain(cuda, nq, nt):
    rng = np.random.default_rng(nq * 10007 + nt)
    q, t = snapshot.to_tensor(words(rng, nq), cuda), snapshot.to_tensor(words(rng, nt), cuda)
    got = hamming.hamming_matrix_cuda(q, t)
    torch.cuda.synchronize()
    assert got.shape == (nq, nt) and got.dtype == torch.int32
    assert torch.equal(got, matching.hamming_matrix_torch(q, t))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nt", PATH_SHAPES + [(1000, 777), (8, 0)])
def test_simt_kernel_bit_identical_to_plain(cuda, nq, nt):
    rng = np.random.default_rng(nq + nt)
    q, t = snapshot.to_tensor(words(rng, nq), cuda), snapshot.to_tensor(words(rng, nt), cuda)
    got = hamming.hamming_matrix_simt_cuda(q, t)
    torch.cuda.synchronize()
    assert torch.equal(got, matching.hamming_matrix_torch(q, t))


@pytest.mark.cuda
def test_kernel_bit_identical_at_tile_boundaries(cuda):
    bm, bn = hamming.BM, hamming.BN
    rng = np.random.default_rng(bm * 1000 + bn)
    for nq in (bm - 1, bm, bm + 1, 3 * bm + 1):
        for nt in (bn - 1, bn, bn + 1, 3 * bn - 1):
            q, t = snapshot.to_tensor(words(rng, nq), cuda), snapshot.to_tensor(words(rng, nt), cuda)
            got = hamming.hamming_matrix_cuda(q, t)
            torch.cuda.synchronize()
            assert torch.equal(got, matching.hamming_matrix_torch(q, t)), (nq, nt)


@pytest.mark.cuda
def test_kernel_on_all_zero_and_all_ones_descriptors(cuda):
    q = torch.zeros((130, 8), dtype=torch.int32, device=cuda)
    q[1::2] = -1
    t = torch.zeros((70, 8), dtype=torch.int32, device=cuda)
    t[::3] = -1
    got = hamming.hamming_matrix_cuda(q, t)
    assert torch.equal(got, matching.hamming_matrix_torch(q, t))
    assert set(got.unique().tolist()) == {0, 256}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])  # 1: a 4-byte offset, so the kernel stores word by word
def test_kernel_writes_into_out(cuda, offset):
    rng = np.random.default_rng(3)
    q, t = snapshot.to_tensor(words(rng, 300), cuda), snapshot.to_tensor(words(rng, 600), cuda)
    flat = torch.full((offset + 300 * 600 + 1,), -7, dtype=torch.int32, device=cuda)
    out = flat[offset:offset + 300 * 600].view(300, 600)
    before = hamming.LAUNCHES
    assert hamming.hamming_matrix_cuda(q, t, out=out) is out
    assert hamming.LAUNCHES == before + 1
    assert torch.equal(out, matching.hamming_matrix_torch(q, t))
    assert int(flat[-1]) == -7 and (offset == 0 or int(flat[0]) == -7)  # nothing written outside
    with pytest.raises(ValueError, match="out is on cpu"):
        hamming.hamming_matrix_cuda(q, t, out=torch.empty((300, 600), dtype=torch.int32))


@pytest.mark.cuda
def test_kernel_replays_in_a_cuda_graph_over_an_output_ring(cuda):
    rng = np.random.default_rng(4)
    q, t = snapshot.to_tensor(words(rng, 1600), cuda), snapshot.to_tensor(words(rng, 800), cuda)
    ring = [torch.empty((1600, 800), dtype=torch.int32, device=cuda) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hamming.hamming_matrix_cuda(q, t, out=ring[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(6):
            hamming.hamming_matrix_cuda(q, t, out=ring[i % 3])
    for o in ring:
        o.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    want = matching.hamming_matrix_torch(q, t)
    assert all(torch.equal(o, want) for o in ring)


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda):
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.pipeline import system

    assert system.SlamSystem(run_slam.BENCH_CAMERA, run_slam.bench_config()).device == cuda
    _, _, frames = run_slam.render_sequence(run_slam.BENCH_CAMERA, 1)
    assert frames.device == cuda


@pytest.mark.cuda
def test_matching_routes_cuda_tensors_to_the_kernel(cuda):
    rng = np.random.default_rng(1)
    q, t = snapshot.to_tensor(words(rng, 50), cuda), snapshot.to_tensor(words(rng, 60), cuda)
    before, by_shape = hamming.LAUNCHES, hamming.LAUNCHES_BY_SHAPE[(50, 60)]
    got = matching.hamming_matrix(q, t)
    assert hamming.LAUNCHES == before + 1 and hamming.LAUNCHES_BY_SHAPE[(50, 60)] == by_shape + 1
    assert torch.equal(got, matching.hamming_matrix_torch(q, t))


def load_fixture(dev):
    with np.load(FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    m, _, _ = snapshot.load_map(FIXTURE, dev)
    view = tv.compute_track_view(m, int(z["center_kf"]), view_size=meta["view_size"])
    state = [snapshot.to_tensor(z[k], dev) for k in ("last_pose", "last_obs", "last_uv", "velocity")]
    return z, meta, m, view, state


@pytest.mark.cuda
def test_tracking_step_on_cuda_matches_reference_outputs(cuda):
    z, meta, m, view, state = load_fixture(cuda)
    gf = meta["gf"]
    before = hamming.LAUNCHES
    r = tracking.track_frame_fused(
        CameraModel(**meta["camera"]), OrbConfig(**meta["orb_config"]), m, view,
        snapshot.to_tensor(z["frames"][0], cuda).float(), *state, meta["dt"],
        torch.tensor([0, 1], device=cuda), gf_budget=gf["gf_budget"], use_gf=True,
        gf_mode=gf["gf_mode"], gf_batch=gf["gf_batch"],
    )
    torch.cuda.synchronize()
    assert hamming.LAUNCHES - before >= 2
    assert bool(r.ok) == bool(z["ref_ok"][0])
    assert np.abs(r.pose.cpu().numpy() - z["ref_pose"][0]).max() <= 1e-3
    want = int(z["ref_n_inliers"][0])
    assert abs(int(r.n_inliers) - want) <= max(3, 0.02 * want)
    o, ro = r.obs_point.cpu().numpy(), z["ref_obs_point"][0]
    either = (o >= 0) | (ro >= 0)
    assert (o == ro)[either].mean() >= 0.95


@pytest.mark.cuda
def test_tracking_stages_never_synchronise(cuda):
    """Extraction, motion-model and local-map tracking make no host sync (the
    step's one sync is its wide-radius retry branch, between the stages)."""
    z, meta, m, view, (pose, obs, uv, vel) = load_fixture(cuda)
    cam, cfg, gf = CameraModel(**meta["camera"]), OrbConfig(**meta["orb_config"]), meta["gf"]
    img = snapshot.to_tensor(z["frames"][0], cuda).float()
    dt = torch.tensor(meta["dt"], device=cuda)

    def stages():
        frame = make_frame(img, cam, cfg)
        r1 = tracking.track_with_motion_model(cam, m, frame, se3.compose(vel, pose), obs, uv)
        t0 = torch.zeros((), device=cuda)
        Xv = pwls.state_from_pose_pair(t0, pose, t0 + dt, r1.pose)
        return tracking.track_local_map(
            cam, m, view, frame, r1.pose, r1.obs_point, Xv, gf_budget=gf["gf_budget"],
            use_gf=True, gf_mode=gf["gf_mode"], gf_batch=gf["gf_batch"],
        )

    stages()  # the first call builds the kernel library and caches device constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r2 = stages()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(r2.ok)


@pytest.mark.cuda
def test_insert_keyframe_fused_never_synchronises(cuda):
    """The whole keyframe insertion (triangulation, culling, fusion, BA,
    descriptors, keyframe culling, the new view) makes no host sync."""
    z, meta, m, view, state = load_fixture(cuda)
    cam, gf = CameraModel(**meta["camera"]), meta["gf"]
    r = tracking.track_frame_fused(
        cam, OrbConfig(**meta["orb_config"]), m, view, snapshot.to_tensor(z["frames"][0], cuda).float(), *state,
        meta["dt"], torch.tensor([0, 1], device=cuda), gf_budget=gf["gf_budget"], use_gf=True,
        gf_mode=gf["gf_mode"], gf_batch=gf["gf_batch"],
    )
    pad = m.kp_capacity - r.frame_uv.shape[0]

    def pz(a, fill=0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    args = (cam, m._replace(pt_visible=r.pt_visible, pt_found=r.pt_found), r.pose, 132, 6.6,
            pz(r.frame_uv), pz(r.frame_octave), pz(r.frame_angle), pz(r.frame_desc), pz(r.frame_valid, False),
            pz(r.obs_point, -1))
    first = local_mapping.insert_keyframe_fused(*args)  # caches device constants
    torch.cuda.synchronize()
    before = hamming.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = local_mapping.insert_keyframe_fused(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert hamming.LAUNCHES - before == 8  # 3 triangulation + 5 fusion matches
    assert int(again.kf_id) == int(first.kf_id) == 14


@pytest.mark.cuda
def test_register_and_detect_never_synchronises(cuda):
    """Quantizing a keyframe with the 1M-word vocabulary, registering its BoW
    row, the covisibility matrix and the loop-candidate ranking make no host
    sync."""
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    _, _, m, _, _ = load_fixture(cuda)
    voc = voc_mod.load_default_vocabulary(cuda)
    db = kdb.empty_db(m.kf_capacity, m.kp_capacity, voc.n_words, device=cuda)
    kfs = torch.nonzero(m.kf_valid).flatten().tolist()
    for k in kfs[:-1]:
        db = kdb.add_keyframe(db, voc, k, m.kf_kp_desc[k], m.kf_kp_valid[k])
    q = torch.full((), kfs[-1], dtype=torch.int32, device=cuda)
    excl = torch.full((), -1, dtype=torch.int32, device=cuda)
    kdb.register_and_detect(db, voc, m, q, excl)  # caches device constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        db2, covis, _, _, cand, ok = kdb.register_and_detect(db, voc, m, q, excl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(db2.valid[kfs[-1]]) and cand.shape == (6,) and covis.shape == (m.kf_capacity,) * 2


@pytest.mark.cuda
def test_relocalize_fused_never_synchronises(cuda):
    """A lost frame's relocalization (BoW candidates, 4 × BoW-gated matching
    and EPnP RANSAC, local-map tracking) makes no host sync: the system's one
    read per lost frame comes after it."""
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    z, meta, m, _, _ = load_fixture(cuda)
    cam = CameraModel(**meta["camera"])
    voc = voc_mod.load_default_vocabulary(cuda)
    db = kdb.empty_db(m.kf_capacity, m.kp_capacity, voc.n_words, device=cuda)
    for k in torch.nonzero(m.kf_valid).flatten().tolist():
        db = kdb.add_keyframe(db, voc, k, m.kf_kp_desc[k], m.kf_kp_valid[k])
    frame = make_frame(snapshot.to_tensor(z["frames"][0], cuda).float(), cam, OrbConfig(**meta["orb_config"]))
    gen = torch.Generator(device=cuda)

    def reloc():
        words, _ = voc_mod.quantize(voc, frame.desc, frame.valid)
        cand, ok = kdb.detect_reloc_candidates(db, ms.covisibility(m), voc_mod.bow_vector(voc, words), 4)
        return tracking.relocalize_fused(cam, m, db.words, frame, words, cand, ok, gen)

    reloc()
    torch.cuda.synchronize()
    before = dict(hamming.LAUNCHES_BY_SHAPE)
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, _ = reloc()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert hamming.LAUNCHES_BY_SHAPE[(800, 1600)] - before.get((800, 1600), 0) == 4
    assert bool(res.ok)
    assert np.abs(res.pose.cpu().numpy() - z["ref_pose"][0]).max() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hybrid", "lazier", "auto", "active", "random", "longlive"])
def test_track_local_map_never_synchronises_in_any_gf_mode(cuda, mode):
    """Local-map tracking with GF selection in `mode` (its noise drawn on
    the card, dt a device tensor) makes no host sync, and tracks."""
    z, meta, m, view, (pose, obs, uv, vel) = load_fixture(cuda)
    cam, cfg, gf = CameraModel(**meta["camera"]), OrbConfig(**meta["orb_config"]), meta["gf"]
    frame = make_frame(snapshot.to_tensor(z["frames"][0], cuda).float(), cam, cfg)
    r1 = tracking.track_with_motion_model(cam, m, frame, se3.compose(vel, pose), obs, uv)
    dt = torch.full((), meta["dt"], device=cuda)
    t0 = torch.zeros((), device=cuda)
    Xv = pwls.state_from_pose_pair(t0, pose, t0 + dt, r1.pose)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)

    def local_map():
        noise = tracking.sample_gf_noise(mode, view.capacity, gf["gf_budget"], gf["gf_batch"], gen)
        return tracking.track_local_map(cam, m, view, frame, r1.pose, r1.obs_point, Xv, noise, dt=dt,
                                        gf_budget=gf["gf_budget"], use_gf=True, gf_mode=mode, gf_batch=gf["gf_batch"])

    local_map()  # caches device constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r2 = local_map()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(r2.ok) and int(r2.gf_selected.sum()) > 0
    assert np.abs(r2.pose.cpu().numpy() - z["ref_pose"][0]).max() <= 5e-3


@pytest.mark.cuda
def test_gf_noise_is_drawn_on_the_card(cuda):
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.pipeline import system

    s = system.SlamSystem(run_slam.BENCH_CAMERA, run_slam.bench_config(gf_mode="lazier"))
    assert s.generator.device == cuda
    torch.cuda.set_sync_debug_mode("error")
    try:
        draws = {mode: tracking.sample_gf_noise(mode, 4096, 100, 10, s.generator) for mode in tracking.GF_MODES}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for mode, n in draws.items():
        shape = tracking.gf_noise_shape(mode, 4096, 100, 10)
        assert (n is None) if shape is None else (n.device == cuda and tuple(n.shape) == shape)
    assert torch.isfinite(draws["auto"]).all() and 0.0 <= float(draws["random"].min()) < float(draws["random"].max()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [7, 13])
def test_batched_logdet_sentinel_without_a_host_read(cuda, d):
    """The batched Cholesky of logdet_psd (4096 candidates, as active
    matching scores them) marks non-PD matrices with the −1e30 sentinel from
    cholesky_ex's info, on the card and without a host read."""
    from gf_orb_slam_tpu_torch.geometry import linalg

    rng = np.random.default_rng(d)
    A = torch.from_numpy(rng.normal(size=(4096, d, d + 2)).astype(np.float32)).to(cuda)
    M = A @ A.mT + 0.1 * torch.eye(d, device=cuda)
    bad = torch.zeros(4096, dtype=torch.bool, device=cuda)
    bad[::7] = True
    M = torch.where(bad[:, None, None], M - 100.0 * torch.eye(d, device=cuda), M)  # indefinite
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ld = linalg.logdet_psd(M)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ld = ld.cpu()
    assert torch.equal(ld[bad.cpu()], torch.full((int(bad.sum()),), -1e30))
    want = torch.logdet(M[~bad].double().cpu()).float()
    torch.testing.assert_close(ld[~bad.cpu()], want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_distributed_ba_on_nccl_world1_never_synchronises(cuda):
    """The keyframe-sharded global BA on an in-process NCCL group of one
    (10 LM × 25 PCG) makes no host sync, keeps its fixed keyframes
    bit-equal, and agrees with the same solve on a gloo group of one on the
    CPU (poses 1e-3, final cost 1%)."""
    from gf_orb_slam_tpu_torch.parallel import launch

    arrays = launch.dryrun_problem(4)  # 8 keyframes, 96 points
    with launch.gloo_group():
        want = launch.solve_numpy(arrays)
    with launch.nccl_group():
        launch.solve_numpy(arrays)  # first call: NCCL communicator, cuBLAS handles
        torch.cuda.synchronize()
        from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
        from gf_orb_slam_tpu_torch.parallel import global_ba
        from gf_orb_slam_tpu_torch.solvers.local_ba import BAProblem

        prob = BAProblem(**{k: torch.from_numpy(v).to(cuda) for k, v in arrays.items()})
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = global_ba.distributed_bundle_adjust(EUROC_CAM, prob)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    fixed = arrays["fixed"]
    got = res.poses.cpu().numpy()
    np.testing.assert_array_equal(got[fixed], arrays["poses"][fixed])
    assert np.abs(got - want["poses"]).max() <= 1e-3
    assert abs(float(res.cost) - float(want["cost"])) <= 0.01 * abs(float(want["cost"]))
    assert launch.dryrun_multichip(1) == pytest.approx(launch.dryrun_multichip(1, device="cpu"), rel=0.01)


@pytest.mark.cuda
def test_stage_probe_on_the_card(cuda):
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import stage_probe

    ts, poses_gt, frames = run_slam.render_sequence(run_slam.BENCH_CAMERA, 240, device=cuda)
    system, _ = run_slam.run_sequence(run_slam.BENCH_CAMERA, run_slam.bench_config(gf_warmup_frames=2), ts[:16],
                                      poses_gt[:16], frames[:16], device=cuda)
    assert system.state.name == "WORKING"
    out = stage_probe.probe_device_stages(system, frames[16])
    assert list(out) == list(stage_probe.STAGES) and system.time_log.device_stages_ms == out
    assert all(np.isfinite(v) and v >= 0 for v in out.values()), out
    assert out["extraction"] > 0 and out["keyframe_insert"] > 0


@pytest.mark.cuda
def test_load_map_onto_the_card(cuda, tmp_path):
    """A snapshot the port wrote from the CPU loads onto the card equal, and
    the system resumes from it there (LOST, then relocalized)."""
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.pipeline import system as system_mod
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    m, _, _ = snapshot.load_map(FIXTURE, "cpu")
    voc = voc_mod.load_default_vocabulary("cpu")
    db = kdb.empty_db(m.kf_capacity, m.kp_capacity, voc.n_words, device="cpu")
    for k in np.flatnonzero(m.kf_valid.numpy()):
        db = kdb.add_keyframe(db, voc, int(k), m.kf_kp_desc[int(k)], m.kf_kp_valid[int(k)])
    path = str(tmp_path / "snap.npz")
    snapshot.save_map(path, m, voc, db)
    gm, gv, gdb = snapshot.load_map(path, cuda)
    for got, want in ((gm, m), (gdb, db)):
        for a, b in zip(got, want):
            assert a.device == cuda and torch.equal(a.cpu(), b)
    assert torch.equal(gv.centers.cpu(), voc.centers) and gv.n_words == voc.n_words
    with np.load(FIXTURE) as z:
        img = z["frames"][0].astype(np.float32)
    s = system_mod.SlamSystem(run_slam.BENCH_CAMERA, run_slam.bench_config(), device=cuda)
    s.load_map_state(gm, gv, gdb)
    assert s.state == system_mod.State.LOST
    assert s.process(img, 0.0).state == "WORKING"


def bench_frame(i: int = 0) -> np.ndarray:
    """Bench frame i (the port's CPU render, rounded to uint8 values)."""
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import synthetic

    _, poses = synthetic.trajectory(240, fps=20.0)
    img = synthetic.render(synthetic.make_scene(seed=0), run_slam.BENCH_CAMERA, torch.from_numpy(poses[i]))
    return torch.clamp(torch.round(img), 0, 255).numpy()


@pytest.mark.cuda
def test_patch_desc_on_the_card_equals_the_cpu(cuda):
    """The patch path's products are exact, so the card's descriptors equal
    the CPU's bit for bit wherever the keypoints agree."""
    from gf_orb_slam_tpu_torch.ops import orb

    img = torch.from_numpy(bench_frame())
    cfg = OrbConfig(patch_desc=True)
    kc, kg = orb.extract_orb(img, cfg), orb.extract_orb(img.to(cuda), cfg)
    same = (kg.uv.cpu() == kc.uv).all(dim=1) & kg.valid.cpu() & kc.valid
    assert same.sum() >= 0.98 * kc.valid.sum()
    assert torch.equal(kg.desc.cpu()[same], kc.desc[same])
    assert (kg.angle.cpu() - kc.angle)[same].abs().max() <= 1e-5


@pytest.mark.cuda
def test_detect_blobs_on_the_card_equals_the_cpu(cuda):
    from gf_orb_slam_tpu_torch.ops import boxlog

    img = torch.from_numpy(bench_frame(7))
    xc, vc, okc = boxlog.detect_blobs(img, n_keep=400)
    xg, vg, okg = (a.cpu() for a in boxlog.detect_blobs(img.to(cuda), n_keep=400))
    tol = 1e-4 * float(vc.max())
    assert torch.equal(okg, okc) and (vg - vc).abs().max() <= tol
    differ = ~(xg == xc).all(dim=1)
    assert differ.float().mean() <= 0.05
    for i in torch.nonzero(differ).flatten().tolist():  # only near-ties change places
        assert int(((vc - vc[i]).abs() <= 2 * tol).sum()) >= 2


@pytest.mark.cuda
def test_initialize_with_prior_on_the_card(cuda):
    from gf_orb_slam_tpu_torch.geometry import quat
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM, project
    from gf_orb_slam_tpu_torch.solvers import initializer

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform([-3, -2, 4.0], [3, 2, 12.0], (400, 3)).astype(np.float32))
    pose21 = se3.make_pose(quat.v2q(torch.tensor([0.0, 0.03, 0.0])), torch.tensor([-0.4, 0.0, 0.02]))
    uv1, _, ok1 = project(EUROC_CAM, X)
    uv2, _, ok2 = project(EUROC_CAM, se3.transform_point(pose21, X))
    args = (uv1 + torch.from_numpy(rng.normal(0, 0.4, (400, 2)).astype(np.float32)), uv2, ok1 & ok2, pose21)
    want = initializer.initialize_with_prior(EUROC_CAM, *args)
    args = [a.to(cuda) for a in args]
    initializer.initialize_with_prior(EUROC_CAM, *args)  # caches K on the card (one copy)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = initializer.initialize_with_prior(EUROC_CAM, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(got.n_good) == int(want.n_good) > 300 and bool(got.success)
    assert torch.equal(got.is_triangulated.cpu(), want.is_triangulated)


@pytest.mark.cuda
def test_entry_step_on_the_card(cuda):
    from gf_orb_slam_tpu_torch import entry

    fn, args = entry.entry()
    assert all(a.device == cuda for a in args)
    before = hamming.LAUNCHES_BY_SHAPE[(512, 512)]
    pose, n_inliers, logdet = fn(*args)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES_BY_SHAPE[(512, 512)] == before + 1
    assert torch.isfinite(pose).all() and torch.isfinite(logdet) and int(n_inliers) > 10


@pytest.mark.cuda
def test_compaction_reads_the_host_once(cuda):
    """A keyframe-slab compaction of the fixture's map (14 slots, 5 live, one
    more erased) with its BoW database reads the host once, for the live
    count (`int(n_valid)`): renumbering the map, permuting the database and
    the new track view make no host sync."""
    import warnings

    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    _, meta, m, _, _ = load_fixture(cuda)
    cam = CameraModel(**meta["camera"])
    system = SlamSystem(cam, SlamConfig(), device=cuda)
    k = torch.nonzero(m.kf_valid).flatten().tolist()[1]
    system.map = ms.erase_keyframe(m, k)
    system.set_vocabulary(voc_mod.load_default_vocabulary(cuda))
    system.n_kf = int(m.n_kf)
    m2, perm, n_valid = ms.compact_keyframes(system.map)  # caches device constants
    tv.compute_track_view(m2, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m2, perm, n_valid = ms.compact_keyframes(system.map)
        kdb.permute(system.bow_db, perm)
        tv.compute_track_view(m2, 3, view_size=system.cfg.view_size)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            system._compact_keyframes()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert sum("synchronizing CUDA operation" in str(w.message) for w in caught) == 1
    assert system.n_kf == 4 and system.compactions == [(0, 4)]
    assert bool(system.map.kf_valid[:4].all()) and bool(system.bow_db.valid[:4].all())


def _repeat_problem(cuda):
    """launch.dryrun_problem(4) (8 keyframes, 96 points, most points seen by
    every keyframe) with one keyframe holding a point three times, on the
    card: rows that take three or more addends in both BA solvers."""
    from gf_orb_slam_tpu_torch.parallel import launch
    from gf_orb_slam_tpu_torch.solvers.local_ba import BAProblem

    arrays = launch.dryrun_problem(4)
    for k in ("obs_point", "obs_uv", "obs_w"):
        arrays[k][3, 1:3] = arrays[k][3, 0]
    return BAProblem(**{k: torch.from_numpy(v).to(cuda) for k, v in arrays.items()})


def _random_graph(cuda, K=30):
    """A complete essential graph of K Sim3 vertices, moved ~0.01 off the
    measurements so that it takes steps: every vertex takes K − 1 edges."""
    from gf_orb_slam_tpu_torch.geometry import sim3 as s3
    from gf_orb_slam_tpu_torch.solvers import pose_graph

    g = torch.Generator().manual_seed(0)
    poses = s3.exp(0.3 * torch.randn(K, 7, generator=g))
    iu, ju = torch.triu_indices(K, K, 1)
    xi = 0.01 * torch.randn(K, 7, generator=g)
    xi[:, 6] = 0
    prob = pose_graph.PoseGraphProblem(
        poses=s3.compose(s3.exp(xi), poses), fixed=torch.arange(K) == 0, vertex_valid=torch.ones(K, dtype=torch.bool),
        edge_i=iu.int(), edge_j=ju.int(), edge_meas=pose_graph.relative_sim3(poses, iu, ju),
        edge_valid=torch.ones(iu.shape[0], dtype=torch.bool), edge_weight=torch.ones(iu.shape[0]))
    return pose_graph.PoseGraphProblem(*(x.to(cuda) for x in prob))


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [(), (3, 3), (30,)], ids=["flat", "block3x3", "row30"])
def test_index_sum_repeats_on_the_card(cuda, tail):
    """The fixed-order scatter-add gives equal bits on two calls (rows of
    0 to ~2,000 addends), within float32 rounding of a float64 sum, and
    the CPU's bits."""
    from gf_orb_slam_tpu_torch.ops import scatter

    def index_sum(index, src, n_rows):
        return scatter.planned_sum(scatter.sum_plan(index, n_rows), src)

    rng = np.random.default_rng(0)
    n, rows = 200_000, 100
    index = torch.from_numpy(rng.integers(0, rows - 1, n)).to(cuda)  # the last row takes none
    src = torch.from_numpy(rng.normal(size=(n,) + tail).astype(np.float32)).to(cuda)
    a = index_sum(index, src, rows)
    b = index_sum(index, src, rows)
    assert torch.equal(a, b)
    want = torch.zeros((rows,) + tail, dtype=torch.float64).index_add_(0, index.cpu(), src.cpu().double())
    torch.testing.assert_close(a.cpu().double(), want, rtol=0, atol=1e-3)
    assert (a[-1] == 0).all()
    # The CPU's index order, so the CPU's bits.
    assert torch.equal(a.cpu(), index_sum(index.cpu(), src.cpu(), rows))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["schur", "distributed", "pose_graph"])
def test_repaired_solvers_repeat_on_the_card(cuda, solver):
    """Each function whose float sums were made fixed-order, called twice on
    one input on the card, gives equal bits."""
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.parallel import global_ba, launch
    from gf_orb_slam_tpu_torch.solvers import local_ba, pose_graph

    if solver == "pose_graph":
        prob = _random_graph(cuda)
        a, b = (pose_graph.optimize_pose_graph(prob) for _ in range(2))
        assert not torch.equal(a, prob.poses)  # the graph took steps
        assert torch.equal(a, b)
        return
    prob = _repeat_problem(cuda)
    if solver == "schur":
        a, b = (local_ba.bundle_adjust(EUROC_CAM, prob) for _ in range(2))
    else:
        with launch.nccl_group() as group:
            a, b = (global_ba.distributed_bundle_adjust(EUROC_CAM, prob, group) for _ in range(2))
    for k in ("poses", "points", "obs_active", "cost"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.isfinite(a.cost) and not torch.equal(a.poses, prob.poses)
