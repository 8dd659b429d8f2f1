"""Parity of the PyTorch port's ORB front end (pyramid, FAST, ORB) with the
JAX reference on a 320×240 synthetic render with 300 features.

Tolerances: pyramid level 0 is an identity product and must be bit-exact;
levels ≥ 1 are float32 matmuls whose sum order differs between XLA and
torch, so rtol 1e-5. Those ulps can flip FAST thresholds, NMS ties or
round(8·I), so extraction is held to ≥ 98% identical keypoints, angles to
1e-4 rad, and descriptors bit-exact wherever the steering bin agrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.geometry.camera import CameraModel as JCam
from gf_orb_slam_tpu.io_utils import synthetic
from gf_orb_slam_tpu.mapping import frame as jframe
from gf_orb_slam_tpu.ops import fast as jfast
from gf_orb_slam_tpu.ops import orb as jorb
from gf_orb_slam_tpu.ops import pyramid as jpyr
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel as TCam
from gf_orb_slam_tpu_torch.mapping import frame as tframe
from gf_orb_slam_tpu_torch.ops import fast as tfast
from gf_orb_slam_tpu_torch.ops import orb as torb
from gf_orb_slam_tpu_torch.ops import pyramid as tpyr

H, W = 240, 320
N_FEATURES = 300
CAM = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=W, height=H, fps=20.0)


@pytest.fixture(scope="module")
def image():
    """A uint8-valued float32 render of the bench's scene (seed 0)."""
    scene = synthetic.make_scene(seed=0)
    _, poses = synthetic.trajectory(8, fps=20.0)
    img = np.asarray(synthetic.render(scene, JCam(**CAM), jnp.asarray(poses[3])))
    return np.clip(np.round(img), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def ref_levels(image):
    return [np.asarray(x) for x in jpyr.build_pyramid(jnp.asarray(image), 8, 1.2)]


CONSTANTS = {
    "brief_pattern": (lambda: jorb.make_brief_pattern(), lambda: torb.make_brief_pattern()),
    "rotated_patterns": (lambda: jorb.rotated_patterns(jorb.make_brief_pattern()),
                         lambda: torb.rotated_patterns(torb.make_brief_pattern())),
    "disc_halfwidths": (jorb._disc_halfwidths, torb._disc_halfwidths),
    "circle_offsets": (lambda: jfast.CIRCLE_OFFSETS, lambda: tfast.CIRCLE_OFFSETS),
    "resize_matrix": (lambda: jpyr._resize_matrix(200, 240), lambda: tpyr._resize_matrix(200, 240)),
    "resize_mats": (lambda: np.concatenate([a.ravel() for a in jpyr._resize_mats(200, 267, 240, 320)]),
                    lambda: np.concatenate([a.ravel() for a in tpyr._resize_mats(200, 267, 240, 320)])),
    "chain_resize_mats_480x752": (lambda: np.concatenate([a.ravel() for a in jpyr._chain_resize_mats(480, 752, 8, 1.2)]),
                                  lambda: np.concatenate([a.ravel() for a in tpyr._chain_resize_mats(480, 752, 8, 1.2)])),
    "pyramid_shapes": (lambda: np.asarray(jpyr.pyramid_shapes(480, 752, 8, 1.2)),
                       lambda: np.asarray(tpyr.pyramid_shapes(480, 752, 8, 1.2))),
    "features_per_level": (lambda: np.asarray(jpyr.features_per_level(800, 8, 1.2)),
                           lambda: np.asarray(tpyr.features_per_level(800, 8, 1.2))),
    "gaussian_kernel_1d": (lambda: jpyr._gaussian_kernel_1d(2.0, 7), lambda: tpyr._gaussian_kernel_1d(2.0, 7)),
    "scale_factors": (lambda: jpyr.scale_factors(8, 1.2), lambda: tpyr.scale_factors(8, 1.2)),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_numpy_constants_copied_exactly(name):
    ref, port = CONSTANTS[name]
    a, b = np.asarray(ref()), np.asarray(port())
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b, a)


def test_pyramid(image, ref_levels):
    got = [x.numpy() for x in tpyr.build_pyramid(torch.from_numpy(image), 8, 1.2)]
    assert [g.shape for g in got] == [r.shape for r in ref_levels]
    np.testing.assert_array_equal(got[0], ref_levels[0])
    np.testing.assert_array_equal(got[0], image)
    for g, r in zip(got[1:], ref_levels[1:]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lv", [0, 1, 4])
def test_blur_fast_nms(ref_levels, lv):
    lvl = ref_levels[lv]
    lj, lt = jnp.asarray(lvl), torch.from_numpy(lvl.copy())
    np.testing.assert_allclose(tpyr.gaussian_blur(lt).numpy(), np.asarray(jpyr.gaussian_blur(lj)),
                               rtol=1e-6, atol=1e-4)
    sj, st = jfast.fast_score(lj), tfast.fast_score(lt)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tfast.nms3(st).numpy(), np.asarray(jfast.nms3(sj)), atol=1e-3, rtol=0)


def test_detect_keypoints_level0_exact(ref_levels):
    # Level 0 is integer-valued, so scores tie often: the stable sort must
    # reproduce JAX top_k's lowest-index-first order exactly.
    lvl = ref_levels[0]
    xj, rj, vj = jfast.detect_keypoints(jnp.asarray(lvl), n_keep=120)
    xt, rt, vt = tfast.detect_keypoints(torch.from_numpy(lvl.copy()), n_keep=120)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)


def test_top_k_stable_matches_jax_ties():
    import jax

    x = np.asarray([1, 3, 3, 2, 3, 0, 3], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 3)
    vt, it = tfast.top_k_stable(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_extract_orb_and_make_frame(image):
    cfg_j = jorb.OrbConfig(n_features=N_FEATURES)
    cfg_t = torb.OrbConfig(n_features=N_FEATURES)
    fj = jframe.make_frame(jnp.asarray(image), JCam(**CAM), cfg_j)
    ft = tframe.make_frame(torch.from_numpy(image), TCam(**CAM), cfg_t)
    assert ft.capacity == fj.capacity == N_FEATURES
    np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))

    def keyed(f):
        uv, octv, valid = (np.asarray(x) for x in (f.uv_raw, f.octave, f.valid))
        return {(float(u), float(v), int(o)): i for i, ((u, v), o, ok) in enumerate(zip(uv, octv, valid)) if ok}

    kj, kt = keyed(fj), keyed(ft)
    common = kj.keys() & kt.keys()
    assert len(kj) > 150
    assert len(common) >= 0.98 * len(kj) and len(common) >= 0.98 * len(kt)
    ij = np.asarray([kj[k] for k in common])
    it = np.asarray([kt[k] for k in common])

    ang_j, ang_t = np.asarray(fj.angle)[ij], ft.angle.numpy()[it]
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-4, rtol=0)
    bins_j = np.asarray(torb.angle_bins(torch.from_numpy(ang_j)))
    bins_t = torb.angle_bins(torch.from_numpy(ang_t)).numpy()
    same_bin = bins_j == bins_t
    assert same_bin.mean() >= 0.98
    desc_j = np.asarray(fj.desc)[ij].view(np.int32)
    desc_t = ft.desc.numpy()[it]
    np.testing.assert_array_equal(desc_t[same_bin], desc_j[same_bin])
    np.testing.assert_array_equal(ft.uv.numpy()[it], np.asarray(fj.uv)[ij])


def test_patch_desc_path_refused(image):
    """The name is historical (the path was once refused): `patch_desc=True`
    runs, and the patch-matmul path meets its quality criterion. It keeps
    the gather path's keypoints, and its descriptors meet the reference's
    own quality criterion against them (tests/test_orb_frontend.py): most
    keypoints keep their steering bin, and where they do the descriptors
    differ in few bits (blurred against raw moments, 8-bit rounding)."""
    kp = torb.extract_orb(torch.from_numpy(image), torb.OrbConfig(n_features=200, patch_desc=True))
    kg = torb.extract_orb(torch.from_numpy(image), torb.OrbConfig(n_features=200))
    v = (kp.valid & kg.valid).numpy()
    assert v.sum() > 100
    np.testing.assert_array_equal(kp.uv.numpy()[v], kg.uv.numpy()[v])
    from gf_orb_slam_tpu_torch.ops import matching as tmatch

    dist = torch.diagonal(tmatch.hamming_matrix(kp.desc, kg.desc)).numpy()[v]
    same_bin = (torb.angle_bins(kp.angle) == torb.angle_bins(kg.angle)).numpy()[v]
    assert same_bin.mean() > 0.5
    assert np.median(dist[same_bin]) <= 12 and dist[same_bin].mean() < 32
