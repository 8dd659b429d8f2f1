"""The port's distributed global BA scaling benchmark
(tools/torch_ba_scaling_bench.py) against the reference tool
(tools/ba_scaling_bench.py) at a small size, on the CPU:

* the generated problem, full-visibility and --fast-gen: obs_point, obs_w
  and fixed exact; poses, points and obs_uv within 1e-5, relative where
  the value exceeds 1 (obs_uv reaches ~700 px, where one float32 ulp is
  6.1e-5, and XLA's fused projection rounds a last bit apart);
* the converged cost at each world size within 1% of the reference's
  `cost=` line (the bound tests/test_torch_global_ba.py holds the solver
  to): the reference on conftest's virtual CPU devices, the port on 4 gloo
  processes (`--virtual 4`: world sizes 1, 2 and 4);
* the --projection payload column equal to the reference's at each d, and
  no TPU interconnect figure left in it.

The reference tool's source stays untouched: its `main` is run with its
module-level `bench_problem` wrapped, which hands over the problem.
"""

import contextlib
import io
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ba_scaling_bench  # noqa: E402
import torch_ba_scaling_bench  # noqa: E402

SMALL = ["--cams", "8", "--points", "256", "--obs-per-cam", "48", "--lm-iters", "2", "--pcg-iters", "5"]
COST = re.compile(r"devices=\s*(\d+)\s+ms/LM-iter=\s*\S+\s+cost=\s*(\S+)")
GENERATORS = {"full": [], "fast_gen": ["--fast-gen"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_reference(argv: list) -> tuple:
    """(the problem the reference's main built, its stdout)."""
    got = {}
    real = ba_scaling_bench.bench_problem

    def spy(args, cam, prob, C, P, N):
        got["prob"] = prob
        return real(args, cam, prob, C, P, N)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ba_scaling_bench, "bench_problem", spy)
        mp.setattr(sys, "argv", ["ba_scaling_bench.py", *argv])
        with contextlib.redirect_stdout(out):
            ba_scaling_bench.main()
    return got["prob"], out.getvalue()


@pytest.fixture(scope="module")
def runs():
    """Per generator: the reference's problem and costs by world size, and
    the port's problem and costs under --virtual 4."""
    out = {}
    for name, flag in GENERATORS.items():
        prob, text = run_reference(SMALL + flag)
        port = torch_ba_scaling_bench.main(SMALL + flag + ["--virtual", "4"])
        out[name] = {
            "ref_prob": {k: np.asarray(getattr(prob, k)) for k in prob._fields},
            "ref_cost": {int(d): float(c) for d, c in COST.findall(text)},
            "port_prob": torch_ba_scaling_bench.make_problem(8, 256, 48, fast_gen=bool(flag)),
            "port_cost": {r["d"]: r["cost"] for r in port["rows"]},
            "port_lines": port["lines"],
        }
    return out


@pytest.mark.parametrize("gen", list(GENERATORS))
def test_problem_matches_reference(runs, gen):
    want, got = runs[gen]["ref_prob"], runs[gen]["port_prob"]
    assert sorted(got) == sorted(want)
    for k in ("obs_point", "obs_w", "fixed", "point_valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("poses", "points", "obs_uv"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert (got["obs_point"] >= 0).sum() > 0.9 * got["obs_point"].size


@pytest.mark.parametrize("gen", list(GENERATORS))
def test_cost_per_world_size_matches_reference(runs, gen):
    ref, port = runs[gen]["ref_cost"], runs[gen]["port_cost"]
    assert sorted(port) == [1, 2, 4], runs[gen]["port_lines"]
    assert set(port) <= set(ref), (ref, port)
    for d, c in port.items():
        assert np.isfinite(c)
        assert abs(c - ref[d]) <= 0.01 * abs(ref[d]), (d, c, ref[d])
    # The reference's output format, line for line.
    for line in runs[gen]["port_lines"]:
        assert "shard-overhead=" in line and COST.search(line), line


def test_projection_payload_matches_reference(monkeypatch):
    """The payload column follows from P, d and the PCG count alone, so
    both tools' solves are stubbed here (each returns its problem)."""
    from gf_orb_slam_tpu.parallel import global_ba as ref_gba
    from gf_orb_slam_tpu_torch.parallel import global_ba as port_gba

    monkeypatch.setattr(ref_gba, "distributed_bundle_adjust",
                        lambda cam, prob, *a, **kw: types.SimpleNamespace(poses=prob.poses, cost=prob.points.sum()))
    monkeypatch.setattr(port_gba, "distributed_bundle_adjust",
                        lambda cam, prob, *a, **kw: types.SimpleNamespace(poses=prob.poses, cost=prob.points.sum()))
    argv = SMALL + ["--projection", "--no-virt"]
    _, text = run_reference(argv)
    want = json.loads(text.strip().splitlines()[-1])
    got = torch_ba_scaling_bench.main(argv + ["--virtual", "1"])
    port = json.loads(got["lines"][-1])
    assert [r["d"] for r in port["rows"]] == [r["d"] for r in want["rows"]] == [2, 4, 8]
    assert [r["payload_MB_dev"] for r in port["rows"]] == [r["payload_MB_dev"] for r in want["rows"]]
    assert port["latency_rounds"] == want["latency_rounds"]
    # No interconnect figure of the reference's (TPU ICI / DCN) remains, and every η is labelled.
    assert {n for n, _ in port["bands"]}.isdisjoint(n for n, _ in want["bands"])
    assert not any(re.search(r"ICI|DCN|TPU", n) for n, _ in port["bands"])
    assert port["eta_label"] == "projected, not measured"
    assert all(len(r["eta"]) == len(port["bands"]) and all(0 < e for e in r["eta"]) for r in port["rows"])


def test_card_is_the_default(monkeypatch):
    """Without --virtual the tool runs on the CUDA cards and refuses to
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--virtual"):
        torch_ba_scaling_bench.main(SMALL)
