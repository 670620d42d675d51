"""Shared code of the example-script parity tests (tests/test_torch_examples*.py,
tests/test_torch_demos.py; not a test file): the JAX package's scripts
loaded by path, unedited, the reduced presets both packages' scripts get,
and the simulated sweep files both read.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp

from cooper_mapper_tpu import config as jc
from cooper_mapper_tpu.io import sim as jsim
from cooper_mapper_torch import bridge
from cooper_mapper_torch import config as tc
from cooper_mapper_torch.examples import run_offline as trun
from tests import torch_pipeline_drives as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL = D.POSE_TOL
# sensor -> (rings, width, vertical fan): the presets' rings at a narrow width
SENSORS = {"vlp16": (16, 256, (-15.0, 15.0)), "hdl32": (32, 256, (-30.67, 10.67)),
           "hdl64": (64, 256, (-24.9, 2.0))}


def load_example(name):
    """A script of the JAX package's examples/, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_examples_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jrun = load_example("run_offline")


def reduced_preset(m, n_rings, width):
    """The sensor's preset (its rings, the default feature capacities) at
    ``width`` columns, with a small map and frames (config module ``m``)."""
    return m.PipelineConfig(
        registration=m.RegistrationConfig(n_rings=n_rings, max_points_per_ring=width),
        odometry=m.OdometryConfig(n_rings=n_rings),
        scan_match=m.ScanMatchConfig(score_threshold=50.0),
        feature_map=m.MapConfig(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=1024,
                                surf_cube_capacity=2048, surround_corner_capacity=4096,
                                surround_surf_capacity=8192, valid_distance=60.0),
        matcher=m.MatcherConfig(max_frame_corner=1024, max_frame_surf=2048))


def use_reduced_presets(monkeypatch, sensor):
    """Patch both run_offline scripts' SENSORS[sensor] with the reduced preset."""
    n_rings, width, _ = SENSORS[sensor]
    for mod, m in ((jrun, jc), (trun, tc)):
        monkeypatch.setitem(mod.SENSORS, sensor,
                            (lambda m=m: reduced_preset(m, n_rings, width),
                             mod.SENSORS[sensor][1]))


def simulate_files(d, sensor, n=4, step_m=0.35):
    """run_offline's selftest drive at the sensor's fan: n sweeps 0.35 m
    apart in a straight line, each an .npz of unordered points in the
    sensor's axis order.  Returns the sweeps' raw points."""
    n_rings, width, vfov = SENSORS[sensor]
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=31)
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = step_m
    os.makedirs(d, exist_ok=True)
    raw = []
    for i in range(n):
        p2 = p @ step
        sw = jsim.scan_sweep(world, jnp.asarray(p), jnp.asarray(p2), n_rings=n_rings,
                             width=width, vfov=vfov)
        xyz = np.asarray(sw.xyz)[np.asarray(sw.mask)][:, [2, 0, 1]]
        np.savez(os.path.join(d, f"sweep_{i:04d}.npz"), xyz=xyz)
        raw.append(xyz)
        p = p2
    return raw


def run_both(sweep_dir, out_root, sensor, **kw):
    """Both scripts' run() over the same files: (JAX pipeline, port's)."""
    with D.op_by_op_extraction():
        pj = jrun.run(sweep_dir, os.path.join(out_root, "out_jax"), sensor, **kw)
    pt = trun.run(sweep_dir, os.path.join(out_root, "out_torch"), sensor, device="cpu", **kw)
    return pj, pt


def assert_same_trajectory(tj, tt):
    tj, tt = np.stack(tj), np.stack(tt)
    assert np.isfinite(tt).all() and tt.shape == tj.shape
    np.testing.assert_allclose(tt[:, :3, 3], tj[:, :3, 3], atol=POSE_TOL)
    np.testing.assert_allclose(tt[:, :3, :3], tj[:, :3, :3], atol=POSE_TOL)


# ---------------------------------------------------------------------------
# the demos at a reduced size: the same narrowing patched into both scripts
# ---------------------------------------------------------------------------

class NarrowSim:
    """A script's ``sim`` module with every sweep cast at ``width`` columns.
    With ``jax_sweeps`` (for the port's script) each sweep is the JAX
    simulator's, bridged, in the JAX world of the same arguments: both
    pipelines then see the same bits (the two simulators part by ~1e-5,
    enough to move a curvature tie, tests/test_torch_sim.py)."""

    def __init__(self, sim, width, jax_sweeps=False):
        self._sim, self._width, self._jax_sweeps = sim, width, jax_sweeps
        self._worlds = {}

    def __getattr__(self, name):
        return getattr(self._sim, name)

    def make_room_world(self, *args, **kw):
        world = self._sim.make_room_world(*args, **kw)
        if self._jax_sweeps:
            kw.pop("device", None)
            self._worlds[id(world)] = (world, jsim.make_room_world(*args, **kw))
        return world

    def scan_sweep(self, world, pose_start, pose_end, *args, **kw):
        kw["width"] = self._width
        if not self._jax_sweeps:
            return self._sim.scan_sweep(world, pose_start, pose_end, *args, **kw)
        kw.pop("generator", None)
        if kw.pop("noise", 0.0):
            raise ValueError("the JAX sweeps are drawn without noise here")
        sw = jsim.scan_sweep(self._worlds[id(world)][1], jnp.asarray(pose_start.numpy()),
                             jnp.asarray(pose_end.numpy()), *args, **kw)
        return bridge.sweep(sw, world.origin.device)


# a 16-ring sweep at a narrow width holds fewer than these of each class
SMALL_FEATURES = dict(max_less_sharp=1024, max_flat=512, max_less_flat=4096)
SMALL_MAP = dict(corner_cube_capacity=512, surf_cube_capacity=1024,
                 surround_corner_capacity=2048, surround_surf_capacity=4096)
SMALL_FRAMES = dict(max_frame_corner=512, max_frame_surf=1024)


@contextlib.contextmanager
def reduced_demo(mod, m, width, pipelines):
    """Run a demo script ``mod`` (config module ``m``) at ``width`` columns
    with SMALL_FEATURES / SMALL_MAP / SMALL_FRAMES over its own settings,
    every SlamPipeline it builds appended to ``pipelines``; the port's
    scripts (``m`` is the port's config) are fed the JAX simulator's sweeps."""
    base = mod.SlamPipeline

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            pipelines.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "sim", NarrowSim(mod.sim, width, jax_sweeps=m is tc))
        mp.setattr(mod, "SlamPipeline", Recorded)
        mp.setattr(mod, "RegistrationConfig",
                   lambda **kw: m.RegistrationConfig(**{**kw, **SMALL_FEATURES,
                                                       "max_points_per_ring": width}))
        mp.setattr(mod, "MapConfig", lambda **kw: m.MapConfig(**{**kw, **SMALL_MAP}))
        mp.setattr(mod, "MatcherConfig", lambda **kw: m.MatcherConfig(**{**kw, **SMALL_FRAMES}))
        yield mp
