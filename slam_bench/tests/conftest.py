"""The benchmark's own tests (`python -m pytest slam_bench/tests -q`): on
the CPU at a size a test run holds; those marked `cuda` run on the card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slam_bench import run  # noqa: E402


def tiny_spec(workload: str) -> dict:
    """The cell's files with a CPU-sized traffic: 8 warm-up frames (the
    system initialises within them), an 8-frame pass (the room circuit
    inserts keyframes at frames 9 and 15, so the pass runs local BAs)."""
    spec = run.cell_spec(workload)
    spec["traffic"] = dict(spec["traffic"], frames=16, warmup=[0, 8])
    spec["traffic"]["pass"] = [8, 16]
    return spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
