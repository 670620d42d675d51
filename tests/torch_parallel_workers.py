"""Rank workers of the parallel-layer tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_map.py, tests/test_torch_distributed.py) and the
runner that spawns them (not a test file).

``run(worker, world, tmp_path, *args)`` starts ``world`` spawned processes
(``Ranks`` starts them and lets the caller work until it asks for results),
each of which joins a gloo group through a ``file://`` rendezvous under
``tmp_path`` (no port to race for between pytest-xdist workers), runs
``worker(rank, world, *args)`` on one CPU thread, and pickles its result.
Every rank has ``TIMEOUT`` seconds in all; when they run out the children
are killed and the test fails, so a hung rendezvous or collective cannot
stall the suite.  A child's traceback becomes the test's failure message.

This module imports the port and numpy only: the children must not import
``jax`` (each result lists the ``jax`` modules its process loaded, and the
runner asserts there are none).  Inputs cross as numpy arrays and plain
values; results come back as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

TIMEOUT = 240.0          # seconds for all ranks of one run, spawn included
GROUP_TIMEOUT = 120.0    # seconds a collective may wait for the other ranks
CLOUD_FIELDS = ("xyz", "mask", "ring", "rel_time")


class Ranks:
    """``world`` spawned ranks running ``worker(rank, world, *args)``;
    ``results()`` waits for them (``timeout`` seconds from the start).  The
    group is gloo on the CPU unless ``device`` / ``backend`` say otherwise
    (the card tests)."""

    def __init__(self, worker, world: int, tmp_path, *args, timeout: float = TIMEOUT,
                 device="cpu", backend=None):
        ctx = mp.get_context("spawn")
        tag = f"{worker.__name__}_{world}_{time.monotonic_ns()}"
        init = f"file://{os.path.join(str(tmp_path), tag + '.store')}"
        self.name, self.timeout = worker.__name__, timeout
        self.outs = [os.path.join(str(tmp_path), f"{tag}.rank{r}") for r in range(world)]
        self.procs = [ctx.Process(target=_child, args=(worker.__name__, r, world, init,
                                                       self.outs[r], args, device, backend))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def results(self):
        procs = self.procs
        for p in procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise AssertionError(f"{self.name}: ranks {hung} of {len(procs)} still running "
                                 f"after {self.timeout} s; killed")
        results = []
        for r, (p, out) in enumerate(zip(procs, self.outs)):
            if p.exitcode != 0:
                err = open(out + ".err").read() if os.path.exists(out + ".err") else ""
                raise AssertionError(f"{self.name}: rank {r} exited {p.exitcode}\n{err}")
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        for r, res in enumerate(results):
            assert not res["jax_modules"], (r, res["jax_modules"])
        return results


def run(worker, world: int, tmp_path, *args, **kwargs):
    """Results of ``worker(rank, world, *args)`` on ranks 0..world-1
    (``kwargs``: ``Ranks``')."""
    return Ranks(worker, world, tmp_path, *args, **kwargs).results()


def _child(name, rank, world, init, out, args, device, backend):
    torch.set_num_threads(1)
    try:
        from cooper_mapper_torch.parallel import distributed

        distributed.initialize(init, world, rank, device=device, backend=backend,
                               timeout=GROUP_TIMEOUT)
        result = globals()[name](rank, world, *args)
        distributed.shutdown()
        result["jax_modules"] = sorted(m for m in sys.modules
                                       if m == "jax" or m.startswith(("jax.", "cooper_mapper_tpu")))
        with open(out, "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


# ---- conversions ----------------------------------------------------------

def cloud_arrays(c) -> dict:
    """A cloud of either package as a dict of numpy arrays."""
    return {f: np.array(getattr(c, f)) for f in CLOUD_FIELDS}


def port_cloud(d):
    from cooper_mapper_torch import bridge

    return bridge.cloud(SimpleNamespace(**d), "cpu")


def numpy_of(tree):
    """Every tensor of a dataclass / dict result as numpy, by field name."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    return {k: v.detach().cpu().numpy() for k, v in tree.items() if isinstance(v, torch.Tensor)}


def map_arrays(m) -> dict:
    """A single-device cube map (either package) as numpy arrays."""
    out = {"origin": np.array(m.origin)}
    for name in ("corner", "surf"):
        cc = getattr(m, name)
        for f in ("xyz", "mask", "count"):
            v = getattr(cc, f)
            out[f"{name}.{f}"] = v.numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)
    return out


def _mesh():
    from cooper_mapper_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh()


# ---- parallel/batch -------------------------------------------------------

def odometry(rank, world, clouds, x0, max_iterations):
    """``sharded_odometry_solve`` of the four clouds (dicts of arrays,
    batched) from x0; on one rank also the unsharded batch solve."""
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry as odo
    from cooper_mapper_torch.parallel import batch

    cfg = OdometryConfig(max_iterations=max_iterations)
    cl = [port_cloud(c) for c in clouds]
    x0 = torch.from_numpy(x0)
    x, st = batch.sharded_odometry_solve(*cl, x0, cfg, _mesh())
    out = {"x": x.numpy(), "n_matched": st.n_matched.numpy()}
    if world == 1:
        xs, sts = odo.batch_odometry_solve(*cl, x0, cfg)
        out.update(x_single=xs.numpy(), n_matched_single=sts.n_matched.numpy())
    return out


def scan_match(rank, world, clouds, x0, max_iterations):
    """``sharded_scan_match`` (frame clouds batched, the map shared); on one
    rank also the unsharded batch solve."""
    from cooper_mapper_torch.config import ScanMatchConfig
    from cooper_mapper_torch.ops import scan_match as sm
    from cooper_mapper_torch.parallel import batch

    cfg = ScanMatchConfig(max_iterations=max_iterations)
    cl = [port_cloud(c) for c in clouds]
    x0 = torch.from_numpy(x0)
    out = {"res": numpy_of(batch.sharded_scan_match(*cl, x0, cfg, _mesh()))}
    if world == 1:
        out["single"] = numpy_of(sm.batch_scan_match(*cl, x0, cfg))
    return out


def pose_graph(rank, world, graph, cfg_kwargs):
    """``sharded_pose_graph_optimize`` of a graph given as a dict of arrays
    (the JAX ``PoseGraph``'s fields); on one rank also ``optimize``."""
    from cooper_mapper_torch import bridge
    from cooper_mapper_torch.config import PoseGraphConfig
    from cooper_mapper_torch.ops import pose_graph as pg
    from cooper_mapper_torch.parallel import batch

    cfg = PoseGraphConfig(**cfg_kwargs)
    g = bridge.pose_graph(SimpleNamespace(**graph), "cpu")
    got, diag = batch.sharded_pose_graph_optimize(g, cfg, _mesh())
    out = {"poses": got.poses.numpy(), **numpy_of(diag)}
    if world == 1:
        want, wdiag = pg.optimize(g, cfg)
        out["single"] = {"poses": want.poses.numpy(), **numpy_of(wdiag)}
    return out


def suite(rank, world, jobs):
    """Several workers in one group: ``jobs`` maps a name to (worker name,
    args); the result maps the name to that worker's result."""
    return {name: globals()[fn](rank, world, *args) for name, (fn, args) in jobs.items()}


# ---- maps/sharded_map -----------------------------------------------------

def _insert_clouds(rng, cl, n_corner, n_surf, spread, shift=(0.0, 0.0, 0.0)):
    """tests/test_sharded_map.py::_clouds: uniform corner / surf clouds."""
    make = lambda n: cl.from_points(rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
                                    + np.asarray(shift, np.float32), device="cpu")
    return make(n_corner), make(n_surf)


def map_ops(rank, world, cfg_kwargs):
    """tests/test_sharded_map.py::TestShardedEquality's five operations on
    the striped map and on the port's single-device map, from the same
    seeded clouds: the de-striped map (``to_single``) and the single map
    after each, and the surround point sets."""
    from cooper_mapper_torch.config import MapConfig
    from cooper_mapper_torch.maps import feature_map as fm
    from cooper_mapper_torch.maps import sharded_map as smap
    from cooper_mapper_torch.utils import cloud as cl

    cfg = MapConfig(**cfg_kwargs)
    mesh = _mesh()
    out = {}

    rng = np.random.RandomState(0)
    c, s = _insert_clouds(rng, cl, 600, 1500, 25.0)
    single = fm.add_feature_cloud(fm.create(cfg, "cpu"), c, s, cfg)
    striped = smap.add_feature_cloud(smap.create_sharded(cfg, mesh), c, s, cfg, mesh)
    out["insert"] = (map_arrays(smap.to_single(striped, cfg, mesh)), map_arrays(single))
    out["stripe_cubes"] = striped.corner.count.shape[0]

    rng = np.random.RandomState(1)
    single, striped = fm.create(cfg, "cpu"), smap.create_sharded(cfg, mesh)
    pos = np.zeros(3, np.float32)
    steps = []
    for _ in range(4):
        c, s = _insert_clouds(rng, cl, 300, 800, 20.0, shift=pos)
        fm.add_feature_cloud(single, c, s, cfg)
        smap.add_feature_cloud(striped, c, s, cfg, mesh)
        pos = pos + np.array([12.0, 0.0, 8.0], np.float32)
        fm.recenter(single, torch.from_numpy(pos), cfg)
        smap.recenter(striped, pos, cfg, mesh)
        steps.append((map_arrays(smap.to_single(striped, cfg, mesh)), map_arrays(single)))
    out["recenter"] = steps

    rng = np.random.RandomState(2)
    c, s = _insert_clouds(rng, cl, 600, 1500, 25.0)
    single = fm.add_feature_cloud(fm.create(cfg, "cpu"), c, s, cfg)
    striped = smap.add_feature_cloud(smap.create_sharded(cfg, mesh), c, s, cfg, mesh)
    pos = torch.tensor([3.0, 1.0, -2.0])
    pts = lambda cloud: cloud.xyz[cloud.mask].numpy()
    got = smap.get_surround(striped, pos, cfg, mesh)
    want = fm.get_surround(single, pos, cfg)
    out["surround"] = {"got": [pts(x) for x in got], "want": [pts(x) for x in want],
                       "slots": [x.capacity for x in got]}

    rng = np.random.RandomState(3)
    c, s = _insert_clouds(rng, cl, 1200, 3000, 15.0)
    single = fm.add_feature_cloud(fm.create(cfg, "cpu"), c, s, cfg)
    striped = smap.add_feature_cloud(smap.create_sharded(cfg, mesh), c, s, cfg, mesh)
    fm.dedup_active(single, torch.zeros(3), cfg)
    smap.dedup_active(striped, np.zeros(3, np.float32), cfg, mesh)
    out["dedup"] = (map_arrays(smap.to_single(striped, cfg, mesh)), map_arrays(single))

    rng = np.random.RandomState(4)
    c, s = _insert_clouds(rng, cl, 600, 1500, 25.0)
    single = fm.add_feature_cloud(fm.create(cfg, "cpu"), c, s, cfg)
    out["from_single"] = (map_arrays(smap.to_single(smap.from_single(single, cfg, mesh), cfg,
                                                    mesh)), map_arrays(single))
    return out


def mesh_one(rank, world, cfg_kwargs):
    """tests/test_sharded_map.py::TestMeshOneBypass on a one-rank mesh: the
    stripe is the single map's layout and every operation equals the
    single-device one, bit for bit (guard rows included)."""
    from cooper_mapper_torch.config import MapConfig
    from cooper_mapper_torch.maps import feature_map as fm
    from cooper_mapper_torch.maps import sharded_map as smap
    from cooper_mapper_torch.utils import cloud as cl

    cfg = MapConfig(**cfg_kwargs)
    mesh = _mesh()
    rng = np.random.RandomState(5)
    c, s = _insert_clouds(rng, cl, 600, 1500, 25.0)
    single = fm.add_feature_cloud(fm.create(cfg, "cpu"), c, s, cfg)
    striped = smap.add_feature_cloud(smap.create_sharded(cfg, mesh), c, s, cfg, mesh)
    rows = lambda m: {f"{n}.{f}": getattr(getattr(m, n), f).numpy().copy()
                      for n in ("corner", "surf") for f in ("rows", "row_mask", "count")}
    out = {"insert": (rows(striped), rows(single))}
    pos = np.array([12.0, 0.0, -8.0], np.float32)
    fm.recenter(single, torch.from_numpy(pos), cfg)
    smap.recenter(striped, pos, cfg, mesh)
    out["recenter"] = (rows(striped), rows(single), striped.origin.numpy(), single.origin.numpy())
    got = smap.get_surround(striped, pos, cfg, mesh)
    want = fm.get_surround(single, torch.from_numpy(pos), cfg)
    out["surround"] = ([numpy_of(x) for x in got], [numpy_of(x) for x in want])
    fm.dedup_active(single, torch.from_numpy(pos), cfg)
    smap.dedup_active(striped, pos, cfg, mesh)
    out["dedup"] = (rows(striped), rows(single))
    view = smap.to_single(striped, cfg, mesh)
    out["to_single_is_view"] = view.surf.rows is striped.surf.rows
    return out


def _sweep_16x512(p0):
    """tests/test_sharded_map.py::TestShardedMappingStep's sweep in the
    port's simulator: the features of a static 16 x 512 sweep at ``p0``."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import features

    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=21, device="cpu")
    p = torch.from_numpy(p0)
    sw = sim.scan_sweep(world, p, p, n_rings=16, width=512)
    return features.extract_features(sw, RegistrationConfig(n_rings=16, max_points_per_ring=512))


def mapping_step(rank, world, map_kwargs):
    """TestShardedMappingStep: one mapping step against the striped map and
    against the port's single map, both seeded with the first frame."""
    from cooper_mapper_torch.config import MapConfig, MatcherConfig, ScanMatchConfig
    from cooper_mapper_torch.maps import feature_map as fm
    from cooper_mapper_torch.maps import sharded_map as smap
    from cooper_mapper_torch.models import laser_mapping as lm
    from cooper_mapper_torch.utils import se3

    mesh = _mesh()
    map_cfg = MapConfig(**map_kwargs)
    sm_cfg = ScanMatchConfig(score_threshold=50.0)
    m_cfg = MatcherConfig(max_frame_corner=2048, max_frame_surf=4096)
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    fc = _sweep_16x512(p0)
    T0 = torch.from_numpy(p0)
    world_cloud = lambda c: dataclasses.replace(c, xyz=se3.apply(T0, c.xyz))
    seed_c, seed_s = world_cloud(fc.less_sharp), world_cloud(fc.less_flat)
    single = fm.add_feature_cloud(fm.create(map_cfg, "cpu"), seed_c, seed_s, map_cfg)
    striped = smap.add_feature_cloud(smap.create_sharded(map_cfg, mesh), seed_c, seed_s,
                                     map_cfg, mesh)
    matcher = lm.MatcherState(L_last=torch.eye(4), W_last=T0)
    L_now = torch.eye(4)
    L_now[2, 3] = 0.05
    _, single, out1 = lm.mapping_step(matcher, single, fc.less_sharp, fc.less_flat, L_now,
                                      sm_cfg, m_cfg, map_cfg)
    _, striped, out2 = smap.mapping_step(matcher, striped, fc.less_sharp, fc.less_flat, L_now,
                                         sm_cfg, m_cfg, map_cfg, mesh)
    return {"W": (out2.W.numpy(), out1.W.numpy()), "x": (out2.result.x.numpy(),
                                                         out1.result.x.numpy()),
            "success": (bool(out2.result.success), bool(out1.result.success)),
            "converged": (bool(out2.result.converged), bool(out1.result.converged)),
            "map": (map_arrays(smap.to_single(striped, map_cfg, mesh)), map_arrays(single))}


def pipeline_sweeps(n_sweeps, width=512):
    """tests/test_sharded_map.py::TestShardedPipeline's drive in the port's
    simulator: 0.35 m steps along z from (0, 1.5, 0), sweeps of 16 x width."""
    from cooper_mapper_torch.io import sim

    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=21, device="cpu")
    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3] = 1.5
    for _ in range(n_sweeps):
        step = np.eye(4, dtype=np.float32)
        step[2, 3] = 0.35
        poses.append(poses[-1] @ step)
    return [sim.scan_sweep(world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                           n_rings=16, width=width) for i in range(n_sweeps)], poses


def pipeline_cfg():
    """TestShardedPipeline's configuration (tests/test_pipeline.py's _small_cfg)."""
    from cooper_mapper_torch.config import (MapConfig, MatcherConfig, PipelineConfig,
                                            RegistrationConfig, ScanMatchConfig)

    return PipelineConfig(
        registration=RegistrationConfig(n_rings=16, max_points_per_ring=512),
        scan_match=ScanMatchConfig(score_threshold=50.0),
        feature_map=MapConfig(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=1024,
                              surf_cube_capacity=2048, surround_corner_capacity=8192,
                              surround_surf_capacity=16384, valid_distance=60.0),
        matcher=MatcherConfig(max_frame_corner=2048, max_frame_surf=4096),
        mapping_stride=2)


def pipeline(rank, world, n_sweeps):
    """``SlamPipeline(map_mesh=...)`` over the drive: merged poses and the
    gathered map's point counts."""
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    sweeps, _ = pipeline_sweeps(n_sweeps)
    pipe = SlamPipeline(pipeline_cfg(), mode="mapping", map_mesh=_mesh())
    merged = np.stack([pipe.process(s).merged_pose for s in sweeps])
    single = pipe.single_map_state()
    return {"merged": merged, "points": {n: int(getattr(single, n).mask.sum())
                                         for n in ("corner", "surf")},
            "stats": pipe.stats()}


# ---- parallel/distributed -------------------------------------------------

def group_facts(rank, world):
    """What ``distributed`` and ``make_mesh`` report in this rank, and a
    mesh over the first two ranks."""
    from cooper_mapper_torch.parallel import distributed, mesh as mesh_lib

    m = mesh_lib.make_mesh()
    sub = mesh_lib.make_mesh(2)
    total = mesh_lib.all_reduce(torch.tensor([float(rank + 1)]), m)
    return {"multihost": distributed.is_multihost(), "slice": distributed.local_batch_slice(16),
            "mesh": (m.size, m.rank, str(m.device), m.axis_names),
            "sub": None if sub is None else (sub.size, sub.rank),
            "sum": float(total[0]),
            "gathered": mesh_lib.gather_batch(torch.tensor([rank, rank], dtype=torch.int32),
                                              m).tolist()}


def card_rank(rank, world):
    """On the card: a sum and a gather over the group (each rank's input
    back, on a mesh of one), and the sharded LM against ``optimize`` on a
    64-node ring."""
    from cooper_mapper_torch.config import PoseGraphConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import pose_graph as pg
    from cooper_mapper_torch.parallel import batch, mesh as mesh_lib

    m = mesh_lib.make_mesh(device="cuda")
    t = torch.arange(12.0, device=m.device).reshape(4, 3)
    total = mesh_lib.all_reduce(t.clone(), m)
    gathered = mesh_lib.all_gather(t, m)
    graph = pg.from_arrays(*sim.drifted_ring_graph(64, loop_every=16), max_nodes=64,
                           max_edges=128, device=m.device)
    cfg = PoseGraphConfig(max_nodes=64, max_edges=128, max_iterations=10)
    got, _ = batch.sharded_pose_graph_optimize(graph, cfg, m)
    want, _ = pg.optimize(graph, cfg)
    return {"device": str(total.device), "sum_same": torch.equal(total, t * world),
            "gather_same": gathered.is_cuda and torch.equal(gathered, t.repeat(world, 1)),
            "lm_same": torch.equal(got.poses, want.poses)}
