"""The PyTorch port must run where JAX is not installed: importing every
module of gf_orb_slam_tpu_torch, in a fresh interpreter where importing JAX
or the JAX package fails, must succeed and leave neither loaded."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "gf_orb_slam_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[mod]
sys.meta_path.insert(0, Block())

import gf_orb_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gf_orb_slam_tpu_torch.__path__, "gf_orb_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
assert "jax" not in sys.modules
print(json.dumps(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) >= 55  # every subpackage and module was walked
    for mod in ("gf.active_matching", "gf.selection", "geometry.pwls", "pipeline.tracking", "parallel.global_ba",
                "parallel.launch", "io_utils.settings", "io_utils.datasets", "io_utils.images", "io_utils.prefetch",
                "io_utils.stage_probe", "io_utils.loop_eval", "io_utils.reloc_eval", "io_utils.viz", "ops.boxlog",
                "io_utils.map_delta", "ops.scatter",
                "entry", "bench", "batch_sweep"):
        assert f"gf_orb_slam_tpu_torch.{mod}" in names, mod


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/torch_loop_recall.py", "tools/torch_ba_scaling_bench.py",
                                    "tools/torch_repeat_probe.py", "tools/torch_repeat_cost.py"])
def test_port_scripts_never_import_jax(script):
    """The scripts that drive only the port name neither JAX nor the JAX
    package in any import statement, module-level or inside a function."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "gf_orb_slam_tpu")], names
