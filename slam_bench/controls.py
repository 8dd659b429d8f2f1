"""Hooks a run calls before its session starts (`run.py --prepare
slam_bench.controls:<name>`): the control that `correct` must refuse, the
planted faults of slam_bench/tests/test_bench_runs.py, and `tf32`, a
reading that `correct` does not refuse (PERF.md says why). The benchmark's
own runs call none. Each returns the function that undoes it, which the
run calls once the session has ended."""

from __future__ import annotations

import functools


def _patch(owner, name: str, new):
    """Set `owner.<name>` to `new`; returns the undo."""
    orig = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, orig)


def ham128():
    """The control: the configurations state exact 256-bit Hamming
    distances; this gives the matcher distances from the first 128 bits of
    each descriptor, doubled (the kernel reads the other four 32-bit words
    as zero)."""
    from gf_orb_slam_tpu_torch.ops import matching

    orig = matching.hamming_matrix

    def hamming(q, t):
        q2, t2 = q.clone(), t.clone()
        q2[:, 4:] = 0
        t2[:, 4:] = 0
        return orig(q2, t2) * 2

    return _patch(matching, "hamming_matrix", hamming)


def tf32():
    """Not refused, and so not the control: TF32 on for every float32 matmul
    and convolution (the program pins it off on import). On the card it
    moves no compared number beyond float32's own spread (PERF.md)."""
    import torch

    import gf_orb_slam_tpu_torch  # noqa: F401  (its import pins TF32 off; switch it on after)

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")

    def undo():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])

    return undo


def frozen_step():
    """Fault: the tracking step returns the pose it was given."""
    from gf_orb_slam_tpu_torch.pipeline import tracking

    orig = tracking.track_frame_fused

    def step(cam, orb_cfg, m, view, img, last_pose, *a, **kw):
        return orig(cam, orb_cfg, m, view, img, last_pose, *a, **kw)._replace(pose=last_pose)

    return _patch(tracking, "track_frame_fused", step)


def frozen_ba():
    """Fault: the local BA returns the poses and points it was given."""
    from gf_orb_slam_tpu_torch.solvers import local_ba

    orig = local_ba.bundle_adjust

    @functools.wraps(orig)  # keeps the signature the session's recorder binds
    def bundle_adjust(cam, prob, *a, **kw):
        return orig(cam, prob, *a, **kw)._replace(poses=prob.poses, points=prob.points)

    return _patch(local_ba, "bundle_adjust", bundle_adjust)


def _wrap_hamming(edit):
    from gf_orb_slam_tpu_torch.ops import matching

    orig = matching.hamming_matrix

    def hamming(q, t):
        return edit(orig(q, t))

    return _patch(matching, "hamming_matrix", hamming)


def half_batch():
    """Fault: the Hamming matrix leaves out the second half of its query
    rows (their distances read as the largest, 256)."""

    def edit(out):
        out[out.shape[0] // 2 :] = 256
        return out

    return _wrap_hamming(edit)


def altered_distance():
    """Fault: one distance of every Hamming matrix is off by one."""

    def edit(out):
        if out.numel():
            out[0, 0] += 1
        return out

    return _wrap_hamming(edit)


def altered_pose():
    """Fault: every fifth frame's reported pose is moved by 0.2 map units
    (about a metre: the map's unit is the first keyframes' median depth)
    along the camera's x axis where `process` produces it."""
    from gf_orb_slam_tpu_torch.pipeline import system

    orig = system.SlamSystem.process

    def process(self, img, timestamp):
        log = orig(self, img, timestamp)
        if log.pose_cw is not None and self.frame_id % 5 == 0:
            log.pose_cw = log.pose_cw.copy()
            log.pose_cw[4] -= 0.2
        return log

    return _patch(system.SlamSystem, "process", process)
