"""Process groups for the distributed global BA, and the multi-device dry
run (a port of `__graft_entry__.dryrun_multichip`).

- `run_gloo(fn, world_size, *args)` runs `fn(*args)` in `world_size`
  spawned CPU processes joined in one gloo group; `spawn_group` does the
  same with NCCL, one card per process. `fn` must be a module-level
  function (the children import it); tensors in its result come back as
  numpy arrays. The rendezvous is a file in a fresh temporary directory, so
  concurrent groups (parallel test workers) never share a port.
- `nccl_group()` is an in-process NCCL group of world size 1 on the current
  card; `gloo_group()` the same on the CPU.
- `dryrun_multichip(n_devices, device=None)` runs two LM steps of the
  keyframe-sharded global BA on n devices: n cards (NCCL; raises if the
  machine has fewer), or n gloo processes with `device="cpu"`.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 600.0


def _to_numpy(x):
    """Tensors → numpy arrays, through tuples, lists, dicts and NamedTuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def local_device() -> torch.device:
    """The device of this rank of the default group: its card under NCCL,
    else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _rank_main(fn, rank: int, world_size: int, backend: str, init_file: str, results, args):
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world_size)
        try:
            out = _to_numpy(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_group(fn, world_size: int, *args, backend: str = "gloo", timeout: float = JOIN_TIMEOUT_S) -> list:
    """fn(*args) on each rank of a `backend` group of `world_size` spawned
    processes; returns each rank's result, in rank order. Raises if a rank
    fails or the group does not finish within `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="gfslam_pg_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, init_file, results, args),
                             daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        try:
            # Drain the queue before joining (a child blocks until its result is read).
            for _ in range(world_size):
                rank, ok, out = results.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} of the {backend} group failed:\n{out}")
                got[rank] = out
        except queue.Empty:
            raise TimeoutError(f"the {backend} group of {world_size} did not finish within {timeout} s") from None
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]


def run_gloo(fn, world_size: int, *args, timeout: float = JOIN_TIMEOUT_S) -> list:
    """fn(*args) on each of `world_size` CPU processes of one gloo group."""
    return spawn_group(fn, world_size, *args, backend="gloo", timeout=timeout)


@contextlib.contextmanager
def _world1(backend: str):
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def nccl_group():
    """An in-process NCCL group of world size 1 on the current card. It
    fails where NCCL cannot start; nothing falls back to gloo."""
    return _world1("nccl")


def gloo_group():
    """An in-process gloo group of world size 1 on the CPU."""
    return _world1("gloo")


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def dryrun_problem(n_devices: int) -> dict:
    """The reference dry run's generated problem, as numpy arrays: C ≥ 4
    keyframes (at least two per device, C a multiple of n), 96 points, 64
    observation slots, the first two keyframes fixed."""
    from gf_orb_slam_tpu_torch.geometry import quat, se3
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM, project

    rng = np.random.default_rng(0)
    C = max(n_devices, 2) * 2
    while C % n_devices:
        C += 1
    N, P = 64, 96
    pts = rng.uniform([-4, -3, 6.0], [4, 3, 14.0], (P, 3)).astype(np.float32)
    poses, obs_uv, obs_pt, obs_w = [], [], [], []
    for c in range(C):
        t = np.asarray([0.3 * c - 0.15 * C, 0.0, 0.0], np.float32)
        w = (rng.normal(size=3) * 0.01).astype(np.float32)
        pose = se3.make_pose(quat.v2q(torch.from_numpy(w)), torch.from_numpy(t))
        poses.append(pose.numpy())
        uv, _, ok = project(EUROC_CAM, se3.transform_point(pose, torch.from_numpy(pts)))
        uvn = uv.numpy() + rng.normal(0, 0.5, (P, 2)).astype(np.float32)
        sel = np.flatnonzero(ok.numpy())[:N]
        row_uv = np.zeros((N, 2), np.float32)
        row_pt = np.full(N, -1, np.int32)
        row_w = np.zeros(N, np.float32)
        row_uv[: len(sel)] = uvn[sel]
        row_pt[: len(sel)] = sel
        row_w[: len(sel)] = 1.0
        obs_uv.append(row_uv)
        obs_pt.append(row_pt)
        obs_w.append(row_w)
    return {"poses": np.stack(poses), "points": pts, "fixed": np.asarray([True, True] + [False] * (C - 2)),
            "point_valid": np.ones(P, bool), "obs_uv": np.stack(obs_uv), "obs_point": np.stack(obs_pt),
            "obs_w": np.stack(obs_w)}


def solve_numpy(arrays: dict, n_lm_iters: int = 10, n_pcg_iters: int = 25, cam=None) -> dict:
    """distributed_bundle_adjust on the default group, on this rank's
    device, of a problem given as numpy arrays (BAProblem fields; the EuRoC
    camera unless `cam`); the gathered result as numpy arrays."""
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.parallel import global_ba
    from gf_orb_slam_tpu_torch.solvers.local_ba import BAProblem

    dev = local_device()
    prob = BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()})
    res = global_ba.distributed_bundle_adjust(cam or EUROC_CAM, prob, n_lm_iters=n_lm_iters,
                                              n_pcg_iters=n_pcg_iters)
    return _to_numpy(global_ba.gather_result(res, prob.poses.shape[0])._asdict())


def _dryrun_rank(n_devices: int) -> float:
    return float(solve_numpy(dryrun_problem(n_devices), n_lm_iters=2, n_pcg_iters=8)["cost"])


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Two LM steps (8 PCG iterations each) of the keyframe-sharded global
    BA on n_devices: CUDA cards by default (NCCL; raises if the machine has
    fewer), or n gloo processes with device="cpu". Returns the final cost,
    which must be finite."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices; this machine has "
                               f'{have} (device="cpu" runs gloo processes instead)')
        if n_devices == 1:
            with nccl_group():
                cost = _dryrun_rank(1)
        else:
            cost = spawn_group(_dryrun_rank, n_devices, n_devices, backend="nccl")[0]
    else:
        cost = run_gloo(_dryrun_rank, n_devices, n_devices)[0]
    if not np.isfinite(cost):
        raise RuntimeError(f"distributed BA produced a non-finite cost on {n_devices} devices")
    print(f"dryrun_multichip OK: {n_devices} devices ({dev.type}), keyframes sharded, cost={cost:.2f}")
    return cost
