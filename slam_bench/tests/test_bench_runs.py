"""Whole runs of the harness on the CPU at a test's size: the restore, a
sound run, and a run with each planted fault, which `correct` must refuse.
The card's runs are marked `cuda`."""

import numpy as np
import pytest
import torch

from slam_bench import run, scenes, session
from slam_bench.tests.conftest import tiny_spec


def test_a_restore_and_a_second_pass_give_equal_poses():
    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    spec = tiny_spec("room-gf100-rounds")
    cfg, traffic = spec["config"], dict(spec["traffic"], frames=12)
    torch.set_num_threads(2)
    ts, _, frames = scenes.make_sequence(traffic, cfg["camera"], 77, "cpu")
    system = SlamSystem(CameraModel(**cfg["camera"]), SlamConfig(**cfg["slam"]), device="cpu", seed=0)
    system.set_vocabulary(voc_mod.load_vocabulary(str(run.ROOT / cfg["vocabulary"]), "cpu"))
    for i in range(8):
        system.process(frames[i], float(ts[i]))
    snap = session.capture(system)
    first = [system.process(frames[i], float(ts[i])).pose_cw for i in range(8, 12)]
    n_kf, frame_id = system.n_kf, system.frame_id
    session.restore(system, snap)
    assert system.frame_id == frame_id - 4
    second = [system.process(frames[i], float(ts[i])).pose_cw for i in range(8, 12)]
    assert all(a is not None and np.array_equal(a, b) for a, b in zip(first, second))
    assert system.n_kf == n_kf


def _run(prepare=(), workload="room-gf100-rounds"):
    return run.run_cell(workload, 2**31 + 11, 20.0, False, device="cpu", prepare=prepare,
                        spec=tiny_spec(workload))


def test_a_sound_run_is_correct_and_loads_no_jax():
    line, info = _run()
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert info["forbidden_modules"] == []
    assert info["session"]["passes_repeat"]
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("fault", ["frozen_step", "frozen_ba", "half_batch", "altered_distance", "altered_pose"])
def test_a_planted_fault_is_not_correct(fault):
    line, info = _run([f"slam_bench.controls:{fault}"])
    assert not line["correct"], (fault, info["compared_all"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]])
def test_the_control_is_not_correct_on_the_card(card, workload):
    spec = run.cell_spec(workload)
    for seed in (101, 102, 103):
        line, _ = run.run_cell(workload, seed, 30.0, False, prepare=["slam_bench.controls:ham128"], spec=spec)
        assert not line["correct"], line["compared"]
