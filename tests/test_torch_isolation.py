"""The port imports neither JAX nor the JAX package, and keeps TF32 off.

The machine that holds the card has no JAX, so every module of
``cooper_mapper_torch`` and ``chip_smoke.py`` must import with ``jax`` and
``cooper_mapper_tpu`` made unimportable.
"""

import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = f"""
import sys
sys.path.insert(0, {ROOT!r})
sys.modules["jax"] = None
sys.modules["cooper_mapper_tpu"] = None
import importlib, pkgutil
import cooper_mapper_torch
names = [m.name for m in pkgutil.walk_packages(cooper_mapper_torch.__path__, "cooper_mapper_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "cooper_mapper_tpu")))
assert not [m for m in leaked if sys.modules[m] is not None], leaked
print(len(names))
"""


def _run(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)


def test_imports_without_jax():
    res = _run(_BLOCKED_IMPORTS)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 51


def test_tf32_off_after_import():
    res = _run(
        f"import sys; sys.path.insert(0, {ROOT!r})\n"
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "import cooper_mapper_torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
    )
    assert res.returncode == 0, res.stderr


def test_module_list_covers_the_slice():
    import cooper_mapper_torch

    names = {m.name for m in pkgutil.walk_packages(cooper_mapper_torch.__path__,
                                                   "cooper_mapper_torch.")}
    for mod in ("config", "bridge", "build", "utils.se3", "utils.twist",
                "utils.cloud", "io.sim", "ops.eig3", "ops.voxel", "ops.features",
                "ops.neighbors", "ops.races", "ops.residuals", "ops.gauss_newton",
                "ops.odometry", "ops.knn", "ops.scan_match", "models.laser_mapping",
                "models.laser_odometry", "models.fused", "maps.feature_map",
                # the pipeline slice
                "utils.profiling", "io.evaluation", "models.scan_registration",
                "maps.local_map", "ops.ukf", "fusion.pose_system", "fusion.ukf_estimator",
                "fusion.imu_queue", "fusion.extrinsics", "models.transform_maintenance",
                "models.pipeline",
                # the pose-graph backend and its persistence
                "ops.pose_graph", "ops.icp", "models.graph", "io.pcd", "io.map_io",
                # the out-of-core map, the converter and the host I/O
                "maps.dynamic_map", "io.feature_extracter", "io.rosbag", "io.native_binner",
                "io.native_pager", "fusion.utm", "fusion.fpd_receiver", "utils.frames",
                # the parallel layer
                "parallel.mesh", "parallel.distributed", "parallel.batch", "maps.sharded_map"):
        assert f"cooper_mapper_torch.{mod}" in names


@pytest.mark.parametrize("script", ["profile_torch_solve", "time_search_kernels"])
def test_card_scripts_import_without_jax(script):
    # the measurement scripts run on the card's machine too
    res = _run(f"import sys; sys.path.insert(0, {ROOT!r})\n"
               'sys.modules["jax"] = None\n'
               'sys.modules["cooper_mapper_tpu"] = None\n'
               f"import {script}\n")
    assert res.returncode == 0, res.stderr


def test_spawned_ranks_import_no_jax(tmp_path):
    # the parallel tests' ranks are spawned processes that import the port
    # and tests/torch_parallel_workers.py only; the runner fails a run whose
    # ranks loaded jax or the JAX package
    from tests import torch_parallel_workers as W

    res = W.run(W.group_facts, 2, tmp_path)
    assert [r["jax_modules"] for r in res] == [[], []]
    assert "jax" in sys.modules          # while this process has it
