"""The port's last modules against the JAX reference, on the same seeded
numpy inputs: the SE(3), camera, linalg, PWLS and pyramid helpers, the
single-level ORB functions, the patch-matmul descriptor path, BoxLOG, the
prior-pose initializer, the synthetic textures and revisit trajectory, the
viz exports, the point counters, the GF entry step, and the bench and the
budget sweep run on the CPU at a few frames.

Tolerances: the small helpers 1e-5 abs; ORB moments on 8-bit images exact
(integer sums); the patch path's angle bins and descriptors bit-equal,
angles 1e-5 rad; BoxLOG responses 1e-4 relative to the strongest response
(float32 convolution sums in another order), positions equal except where
two responses tie within that tolerance; the prior-pose initializer's
n_good and mask equal, points 5e-5 relative at the median and 2.5e-4 at
the worst (float32 normal equations: both implementations are 2e-4 from
the float64 solution on the farthest points); the homogeneous DLT 1e-4 rel;
annotate_frame bit-equal; the PLY's header, counts and point lines equal,
camera centres within 1e-4 (their last printed digit can round either
way); the entry step's pose 1e-3 (rad, units), inliers within max(3, 2%),
logdet 1e-4 rel, with the reference's lazier draws injected."""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_solvers
from gf_orb_slam_tpu.geometry import camera as jcam
from gf_orb_slam_tpu.geometry import linalg as jlinalg
from gf_orb_slam_tpu.geometry import pwls as jpwls
from gf_orb_slam_tpu.geometry import quat as jquat
from gf_orb_slam_tpu.geometry import se3 as jse3
from gf_orb_slam_tpu.io_utils import snapshot as jsnap
from gf_orb_slam_tpu.io_utils import synthetic as jsyn
from gf_orb_slam_tpu.io_utils import viz as jviz
from gf_orb_slam_tpu.ops import boxlog as jbox
from gf_orb_slam_tpu.ops import orb as jorb
from gf_orb_slam_tpu.ops import pyramid as jpyr
from gf_orb_slam_tpu.pipeline import tracking as jtrk
from gf_orb_slam_tpu.solvers import initializer as jinit
from gf_orb_slam_tpu_torch import batch_sweep, bench, entry, run_slam
from gf_orb_slam_tpu_torch.geometry import camera, linalg, pwls, se3
from gf_orb_slam_tpu_torch.gf import selection
from gf_orb_slam_tpu_torch.io_utils import snapshot, synthetic, viz
from gf_orb_slam_tpu_torch.ops import boxlog, orb, pyramid
from gf_orb_slam_tpu_torch.pipeline import tracking
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu_torch.solvers import initializer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
CPU = torch.device("cpu")
RENDER_CAM = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240, fps=20.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def image():
    """A uint8-valued 320×240 render of the bench's scene."""
    scene = jsyn.make_scene(seed=0)
    _, poses = jsyn.trajectory(8, fps=20.0)
    img = np.asarray(jsyn.render(scene, jcam.CameraModel(**RENDER_CAM), jnp.asarray(poses[3])))
    return np.clip(np.round(img), 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# Items 1-4: SE(3), camera, linalg, PWLS, pyramid
# ---------------------------------------------------------------------------


def random_poses(rng, n):
    w = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    tr = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    return np.asarray(jse3.make_pose(jquat.v2q(jnp.asarray(w)), jnp.asarray(tr)))


def test_se3_helpers(rng):
    p, q = random_poses(rng, 16), random_poses(rng, 16)
    T = np.asarray(jse3.pose_matrix(jnp.asarray(p)))
    close(se3.from_matrix(t(T)), jse3.from_matrix(jnp.asarray(T)))
    close(se3.relative(t(p), t(q)), jse3.relative(jnp.asarray(p), jnp.asarray(q)))
    w = np.concatenate([rng.normal(0, 1.0, (16, 3)), rng.normal(0, 1e-8, (4, 3)), np.zeros((1, 3))]).astype(np.float32)
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    close(se3.exp_so3(t(w)), R)
    close(se3.log_so3(t(R)), jse3.log_so3(jnp.asarray(R)))


def test_camera_helpers(rng):
    cam_j, cam_t = jcam.EUROC_CAM, camera.EUROC_CAM
    xn = rng.uniform(-0.8, 0.8, (64, 2)).astype(np.float32)
    close(camera.distort_normalized(cam_t, t(xn)), jcam.distort_normalized(cam_j, jnp.asarray(xn)))
    uv = rng.uniform(-30, 800, (200, 2)).astype(np.float32)
    for margin in (0.0, 12.5):
        np.testing.assert_array_equal(camera.in_image(cam_t, t(uv), margin).numpy(),
                                      np.asarray(jcam.in_image(cam_j, jnp.asarray(uv), margin)))
    d = rng.uniform(0.5, 20, 200).astype(np.float32)
    close(camera.backproject(cam_t, t(uv), t(d)), jcam.backproject(cam_j, jnp.asarray(uv), jnp.asarray(d)), atol=1e-5,
          rtol=1e-6)


def test_slogdet_general_and_kine_state(rng):
    A = rng.normal(size=(12, 7, 7)).astype(np.float32)
    M = np.concatenate([A @ A.transpose(0, 2, 1) + np.eye(7, dtype=np.float32),  # positive definite
                        A + A.transpose(0, 2, 1)])                               # indefinite
    want = np.asarray(jlinalg.slogdet_general(jnp.asarray(M)))
    assert (want == -1e30).any() and (want > -1e30).any()
    close(linalg.slogdet_general(t(M)), want, atol=1e-5, rtol=1e-5)
    assert pwls.KineState._fields == jpwls.KineState._fields
    Xv = rng.normal(size=13).astype(np.float32)
    ks = pwls.KineState(Xv=t(Xv), dt=torch.tensor(0.05))
    close(pwls.propagate(ks.Xv, ks.dt), jpwls.propagate(jnp.asarray(Xv), jnp.asarray(0.05, jnp.float32)))


def test_pyramid_helpers(image):
    for shape in ((200, 267), (100, 133)):
        close(pyramid.resize_matmul(t(image), shape), jpyr.resize_matmul(jnp.asarray(image), shape), atol=1e-3,
              rtol=1e-5)  # values up to 255: 1e-5 relative
    np.testing.assert_array_equal(pyramid.level_sigma2(8, 1.2), jpyr.level_sigma2(8, 1.2))


# ---------------------------------------------------------------------------
# Items 5-6: single-level ORB and the patch-matmul path
# ---------------------------------------------------------------------------


def level_and_points(rng, n=40, h=96, w=128, margin=20):
    lvl = rng.integers(0, 256, (h, w)).astype(np.float32)
    xy = np.stack([rng.integers(margin, w - margin, n), rng.integers(margin, h - margin, n)], 1).astype(np.float32)
    return lvl, xy


def test_single_level_orb(rng):
    lvl, xy = level_and_points(rng)
    np.testing.assert_array_equal(orb._moment_masks(), jorb._moment_masks())
    for name in ("moment_maps_circular", "moment_maps"):  # integer sums: exact
        np.testing.assert_array_equal(getattr(orb, name)(t(lvl)).numpy(), np.asarray(getattr(jorb, name)(jnp.asarray(lvl))))
    ang = np.asarray(jorb.ic_angles(jnp.asarray(lvl), jnp.asarray(xy)))
    close(orb.ic_angles(t(lvl), t(xy)), ang)
    want = np.asarray(jorb.brief_descriptors(jnp.asarray(lvl), jnp.asarray(xy), jnp.asarray(ang))).view(np.int32)
    np.testing.assert_array_equal(orb.brief_descriptors(t(lvl), t(xy), t(ang)).numpy(), want)


def test_patch_constants():
    assert orb._PATCH_R == jorb._PATCH_R and orb._PATCH_AREA == jorb._PATCH_AREA
    np.testing.assert_array_equal(orb._pair_diff_matrix(), jorb._pair_diff_matrix())
    np.testing.assert_array_equal(orb._patch_moment_masks_i8(), jorb._patch_moment_masks_i8())
    x = np.linspace(-20, 280, 301).astype(np.float32)
    np.testing.assert_array_equal(orb.center_i8(t(x)).numpy(), np.asarray(jorb.center_i8(jnp.asarray(x))))


def test_patch_orientation_brief(rng):
    """Two stacked levels in one flat buffer, keypoints up to the clip edges."""
    shapes = [(96, 128), (64, 80)]
    levels = [rng.integers(0, 256, s).astype(np.float32) for s in shapes]
    flat = np.concatenate([(lv - 128).astype(np.int8).reshape(-1) for lv in levels])
    xy, base, wl, hl = [], [], [], []
    off = 0
    for (h, w) in shapes:
        n = 30
        xy.append(np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1))
        base += [off] * n
        wl += [w] * n
        hl += [h] * n
        off += h * w
    xy = np.concatenate(xy).astype(np.float32)
    args = [np.asarray(a, np.int32) for a in (base, wl, hl)]
    ang_j, desc_j = jorb.patch_orientation_brief(jnp.asarray(flat), jnp.asarray(xy), *map(jnp.asarray, args))
    ang_t, desc_t = orb.patch_orientation_brief(t(flat), t(xy), *map(t, args))
    close(ang_t, ang_j)
    np.testing.assert_array_equal(orb.angle_bins(ang_t).numpy(), orb.angle_bins(t(np.asarray(ang_j))).numpy())
    np.testing.assert_array_equal(desc_t.numpy(), np.asarray(desc_j).view(np.int32))


def test_extract_orb_patch_desc(image):
    cfg = dict(n_features=300, patch_desc=True)
    kj = jorb.extract_orb(jnp.asarray(image), jorb.OrbConfig(**cfg))
    kt = orb.extract_orb(t(image), orb.OrbConfig(**cfg))
    same = (np.asarray(kj.uv) == kt.uv.numpy()).all(axis=1) & np.asarray(kj.valid) & kt.valid.numpy()
    assert same.sum() >= 0.98 * np.asarray(kj.valid).sum()
    close(kt.angle.numpy()[same], np.asarray(kj.angle)[same])
    np.testing.assert_array_equal(kt.desc.numpy()[same], np.asarray(kj.desc).view(np.int32)[same])


# ---------------------------------------------------------------------------
# Item 7: BoxLOG
# ---------------------------------------------------------------------------


def test_boxlog(image):
    want = np.asarray(jbox.boxlog_response(jnp.asarray(image)))
    got = boxlog.boxlog_response(t(image)).numpy()
    tol = 1e-4 * np.abs(want).max()
    close(got, want, atol=tol)
    xj, vj, okj = (np.asarray(a) for a in jbox.detect_blobs(jnp.asarray(image), n_keep=100))
    xt, vt, okt = (a.numpy() for a in boxlog.detect_blobs(t(image), n_keep=100))
    close(vt, vj, atol=tol)
    np.testing.assert_array_equal(okt, okj)
    differ = ~(xj == xt).all(axis=1)
    # A position may differ only where its response ties another kept one.
    for i in np.flatnonzero(differ):
        assert (np.abs(vj - vj[i]) <= 2 * tol).sum() >= 2, (i, vj[i])
    assert differ.mean() <= 0.05


def test_boxlog_blobs_found():
    """The reference test's scene: three Gaussian blobs found near their centres."""
    img = np.zeros((160, 200), np.float32)
    yy, xx = np.mgrid[0:160, 0:200]
    centers = [(40, 50), (100, 120), (70, 160)]
    for cy, cx in centers:
        img += 200.0 * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 5.0**2)))
    xy, _, valid = boxlog.detect_blobs(t(img), n_keep=10)
    xy = xy.numpy()[valid.numpy()]
    for cy, cx in centers:
        assert np.linalg.norm(xy - np.asarray([cx, cy]), axis=1).min() < 4.0
    assert not bool(boxlog.detect_blobs(torch.full((64, 64), 100.0), n_keep=5)[2].any())


# ---------------------------------------------------------------------------
# Item 8: the prior-pose initializer and the homogeneous DLT
# ---------------------------------------------------------------------------


def test_initialize_with_prior(rng):
    cam_j = jcam.EUROC_CAM
    uv1, uv2, ok, pose21, _ = test_solvers.TestTwoViewInit.make_pair(None, rng, cam_j, planar=False)
    want = jinit.initialize_with_prior(cam_j, uv1, uv2, ok, pose21)
    got = initializer.initialize_with_prior(camera.EUROC_CAM, *(t(np.asarray(a)) for a in (uv1, uv2, ok, pose21)))
    assert bool(got.success) == bool(want.success) and bool(got.success)
    assert int(got.n_good) == int(want.n_good)
    assert not bool(got.used_homography) and not bool(want.used_homography)
    tri = np.asarray(want.is_triangulated)
    np.testing.assert_array_equal(got.is_triangulated.numpy(), tri)
    X, Xw = got.points3d.numpy()[tri], np.asarray(want.points3d)[tri]
    rel = np.linalg.norm(X - Xw, axis=1) / np.linalg.norm(Xw, axis=1)
    # float32 normal equations: both sit up to 2e-4 from the float64
    # solution on the farthest points, so the worst point gets that slack.
    assert np.median(rel) <= 5e-5 and rel.max() <= 2.5e-4, (np.median(rel), rel.max())
    close(got.pose21, pose21, atol=0)


def test_triangulate_dlt_homogeneous(rng):
    X = rng.uniform([-3, -2, 4.0], [3, 2, 12.0], (200, 3)).astype(np.float32)
    p2 = jse3.make_pose(jquat.v2q(jnp.asarray([0.0, 0.02, 0.0])), jnp.asarray([-0.3, 0.0, 0.0]))
    uv1, _, _ = jcam.project(jcam.EUROC_CAM, jnp.asarray(X))
    uv2, _, _ = jcam.project(jcam.EUROC_CAM, jse3.transform_point(p2, jnp.asarray(X)))
    K = np.asarray(jcam.EUROC_CAM.K)
    P1 = K @ np.eye(4, dtype=np.float32)[:3]
    P2 = K @ np.asarray(jse3.pose_matrix(p2))[:3]
    want = np.asarray(jinit.triangulate_dlt_homogeneous(jnp.asarray(P1), jnp.asarray(P2), uv1, uv2))
    got = initializer.triangulate_dlt_homogeneous(t(P1), t(P2), t(np.asarray(uv1)), t(np.asarray(uv2)))
    close(got, want, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# Items 9-11: synthetic, viz, point counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("style", [*jsyn.TEXTURE_STYLES, None])
def test_varied_texture(style):
    assert synthetic.TEXTURE_STYLES == jsyn.TEXTURE_STYLES
    want = jsyn.varied_texture(np.random.default_rng(3), 256, style)
    np.testing.assert_array_equal(synthetic.varied_texture(np.random.default_rng(3), 256, style), want)


def test_revisit_trajectory():
    ts_j, poses_j = jsyn.revisit_trajectory(40)
    ts_t, poses_t = synthetic.revisit_trajectory(40)
    np.testing.assert_array_equal(ts_t, ts_j)
    close(poses_t, poses_j)


def test_annotate_frame(rng, image):
    uv = np.concatenate([rng.uniform(0, 320, (60, 2)), [[1.0, 1.0], [318.6, 238.2]]]).astype(np.float32)
    tracked = rng.random(62) < 0.6
    sel = rng.random(40) < 0.3  # shorter than the keypoints, as the reference allows
    for gf in (None, sel):
        np.testing.assert_array_equal(viz.annotate_frame(image, uv, tracked, gf), jviz.annotate_frame(image, uv, tracked, gf))


@pytest.fixture(scope="module")
def fixture_maps():
    """The map the reference saved (the track fixture), loaded by both."""
    return jsnap.load_map(FIXTURE)[0], snapshot.load_map(FIXTURE, CPU)[0]


def test_export_map_ply(tmp_path, fixture_maps):
    jm, m = fixture_maps
    jviz.export_map_ply(str(tmp_path / "ref.ply"), jm)
    viz.export_map_ply(str(tmp_path / "port.ply"), m)
    want = open(tmp_path / "ref.ply").read().splitlines()
    got = open(tmp_path / "port.ply").read().splitlines()
    assert len(got) == len(want)
    head = want.index("end_header") + 1
    assert got[:head] == want[:head]
    n_pts = int(np.asarray(jm.pt_valid).sum())
    n_kf = int(np.asarray(jm.kf_valid).sum())
    assert f"element vertex {n_pts + n_kf}" in want
    assert got[head : head + n_pts] == want[head : head + n_pts]
    centers = slice(head + n_pts, head + n_pts + n_kf)
    close([[float(v) for v in ln.split()] for ln in got[centers]], [[float(v) for v in ln.split()] for ln in want[centers]],
          atol=1.5e-4)
    assert got[head + n_pts + n_kf :] == want[head + n_pts + n_kf :]
    assert len(want) > head + n_pts + n_kf  # the fixture's map has covisibility edges


def test_update_point_counters(rng, fixture_maps):
    jm, m = fixture_maps
    P = m.pt_capacity
    vis, found = rng.random(P) < 0.3, rng.random(P) < 0.1
    want = jtrk.update_point_counters(jm, jnp.asarray(vis), jnp.asarray(found))
    got = tracking.update_point_counters(m, t(vis), t(found))
    np.testing.assert_array_equal(got.pt_visible.numpy(), np.asarray(want.pt_visible))
    np.testing.assert_array_equal(got.pt_found.numpy(), np.asarray(want.pt_found))


# ---------------------------------------------------------------------------
# Items 14-16: the entry step, the bench, the sweep
# ---------------------------------------------------------------------------


def test_entry_step():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    pose_j, n_j, logdet_j = jax.jit(fn)(*args)
    _, rounds, _ = selection.lazier_sizes(entry.N_POINTS, entry.GF_BUDGET)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (entry.N_POINTS,))) for k in jax.random.split(args[-1], rounds)])
    tfn, targs = entry.entry(device="cpu")
    for a, b in zip(args[:-1], targs[:-1]):
        a = np.asarray(a)
        np.testing.assert_array_equal(b.numpy(), a.view(np.int32) if a.dtype == np.uint32 else a)
    assert targs[-1].shape == gumbel.shape
    pose_t, n_t, logdet_t = tfn(*targs[:-1], t(gumbel))
    pose_j = np.asarray(pose_j)
    close(pose_t.numpy()[4:], pose_j[4:], atol=1e-3)
    assert abs(float(np.dot(pose_t.numpy()[:4], pose_j[:4]))) > np.cos(0.5e-3)
    assert abs(int(n_t) - int(n_j)) <= max(3, 0.02 * int(n_j)) and int(n_t) > 10
    close(float(logdet_t), float(logdet_j), atol=0, rtol=1e-4)
    assert entry.dryrun_multichip is not None


def reference_dict_keys(path: str, anchor: str) -> list[list[str]]:
    """Key lists of every dict literal in a reference script that has the
    key `anchor`, and of the dicts nested in it."""
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == anchor for k in node.keys):
            out += [[k.value for k in d.keys] for d in ast.walk(node) if isinstance(d, ast.Dict)]
    return out


@pytest.fixture(scope="module")
def voc_cpu():
    return voc_mod.load_default_vocabulary(CPU)


def test_bench_on_cpu(voc_cpu):
    """bench.run_bench on the CPU at 12 frames: the reference's JSON keys,
    finite rates, both window lists."""
    cam = run_slam.BENCH_CAMERA
    ts, _, frames = run_slam.render_sequence(cam, 12, 0, "cpu")
    line, on, off = bench.run_bench(cam, run_slam.bench_config(), ts, frames, voc_cpu, CPU, warmup=6, window=3,
                                    chain=2)
    json.dumps(line)
    ref_keys = reference_dict_keys(os.path.join(REPO, "bench.py"), "detail")
    assert list(line) == ref_keys[0] and list(line["detail"]) == ref_keys[1] and list(line["detail"]["gf"]) == ref_keys[2]
    d = line["detail"]
    assert len(d["window_fps_gf_on"]) == len(d["window_fps_gf_off"]) == 2
    assert all(np.isfinite(v) and v > 0 for v in (line["value"], d["gf_off_fps"], d["device_only_fps"]))
    assert d["device"] == "cpu" and d["frames_measured"] == 6 and d["frames_tracked"] == 6
    assert on.cfg.use_gf and not off.cfg.use_gf and on.state.name == off.state.name == "WORKING"


def test_batch_sweep_on_cpu(tmp_path):
    out = batch_sweep.main(["--synthetic", "8", "--budgets", "0", "100", "--rounds", "1", "--device", "cpu",
                            "--no-probe-stages", "--out-dir", str(tmp_path)])
    ref_cell_keys = reference_dict_keys(os.path.join(REPO, "batch_sweep.py"), "ate_rmse_mean_m")[0]
    assert [list(c) for c in out["cells"]] == [ref_cell_keys] * 2
    assert [(r["budget"], r["round"], r["frames"]) for r in out["runs"]] == [(0, 0, 8), (100, 0, 8)]
    assert all(r["tracked"] >= 3 for r in out["runs"])
    with open(tmp_path / "sweep_summary.json") as f:
        assert set(json.load(f)) == {"runs", "cells"}
    assert (tmp_path / "synthetic_gf100_r0_result.json").exists()
