"""Port vs JAX package: the striped cube map (``maps/sharded_map``) and
``SlamPipeline(map_mesh=...)``.

The port runs in 2- and 4-rank gloo groups of spawned CPU processes
(``tests/torch_parallel_workers.py``); the JAX package runs on conftest's
8-device virtual mesh cut to the same number of devices.  The operations
and clouds are tests/test_sharded_map.py's.  Tolerances:

- insert, recenter, dedup and the ``from_single`` round trip: the
  de-striped map (``to_single``) equals the port's single-device map bit
  for bit, and the JAX package's ``to_single`` bit for bit (points compared
  where the mask is set, as the JAX test does);
- the surround gather: the same point set as the single-device gather;
- a mesh of one rank: every operation equals the single-device one bit for
  bit, guard rows included (TestMeshOneBypass);
- the mapping step: the pose within 5e-4 of the port's single-device step
  (the surround's order differs, and with it the normal equations' sums),
  the map's point counts within 2 (TestShardedMappingStep);
- the pipeline: merged positions within 2.5e-2 m of the single-device
  pipeline's (TestShardedPipeline; the map solves' f32 noise compounds
  through the chained guesses), and the gathered map's point counts within
  1% + 2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import MapConfig as JMapConfig  # noqa: E402
from cooper_mapper_tpu.maps import feature_map as jfm  # noqa: E402
from cooper_mapper_tpu.maps import sharded_map as jsmap  # noqa: E402
from cooper_mapper_tpu.parallel import mesh as jmesh  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from tests import torch_parallel_workers as W  # noqa: E402

CFG = dict(n_cubes=(7, 5, 7), cube_size=10.0, corner_cube_capacity=256,
           surf_cube_capacity=512, surround_corner_capacity=4096,
           surround_surf_capacity=8192, valid_distance=30.0)
STEP_MAP = dict(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=1024,
                surf_cube_capacity=2048, surround_corner_capacity=8192,
                surround_surf_capacity=16384, valid_distance=60.0)
STEP_TOL, PIPE_TOL = 5e-4, 2.5e-2


def _jax_clouds(rng, n_corner, n_surf, spread, shift=(0.0, 0.0, 0.0)):
    make = lambda n: jcloud.from_points(jnp.asarray(
        rng.uniform(-spread, spread, (n, 3)).astype(np.float32) + np.asarray(shift, np.float32)))
    return make(n_corner), make(n_surf)


def _jax_map_ops(n):
    """The JAX package's side of torch_parallel_workers.map_ops on n devices:
    ``to_single`` after each operation, and the surround's points."""
    cfg, mesh = JMapConfig(**CFG), jmesh.make_mesh(n)
    single = lambda st: W.map_arrays(jsmap.to_single(st, cfg, n))
    out = {}
    rng = np.random.RandomState(0)
    c, s = _jax_clouds(rng, 600, 1500, 25.0)
    out["insert"] = single(jsmap.add_feature_cloud(jsmap.create_sharded(cfg, mesh), c, s, cfg,
                                                   mesh))
    rng = np.random.RandomState(1)
    st, pos, steps = jsmap.create_sharded(cfg, mesh), np.zeros(3, np.float32), []
    for _ in range(4):
        c, s = _jax_clouds(rng, 300, 800, 20.0, shift=pos)
        st = jsmap.add_feature_cloud(st, c, s, cfg, mesh)
        pos = pos + np.array([12.0, 0.0, 8.0], np.float32)
        st = jsmap.recenter(st, pos, cfg, mesh)
        steps.append(single(st))
    out["recenter"] = steps
    rng = np.random.RandomState(2)
    c, s = _jax_clouds(rng, 600, 1500, 25.0)
    st = jsmap.add_feature_cloud(jsmap.create_sharded(cfg, mesh), c, s, cfg, mesh)
    got = jsmap.get_surround(st, jnp.asarray([3.0, 1.0, -2.0]), cfg, mesh)
    out["surround"] = [np.asarray(x.xyz)[np.asarray(x.mask)] for x in got]
    rng = np.random.RandomState(3)
    c, s = _jax_clouds(rng, 1200, 3000, 15.0)
    st = jsmap.add_feature_cloud(jsmap.create_sharded(cfg, mesh), c, s, cfg, mesh)
    out["dedup"] = single(jsmap.dedup_active(st, jnp.zeros(3), cfg, mesh))
    rng = np.random.RandomState(4)
    c, s = _jax_clouds(rng, 600, 1500, 25.0)
    out["from_single"] = single(jsmap.from_single(
        jfm.add_feature_cloud(jfm.create(cfg), c, s, cfg), cfg, mesh))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def runs(request, tmp_path_factory):
    n = request.param
    return n, W.run(W.map_ops, n, tmp_path_factory.mktemp(f"map{n}"), CFG), _jax_map_ops(n)


def _assert_maps(got, want, masked_points=False):
    """Two maps as ``map_arrays`` dicts equal bit for bit; with
    ``masked_points`` the points only where the mask is set."""
    for k in got:
        if masked_points and k.endswith(".xyz"):
            sel = want[k.replace(".xyz", ".mask")]
            np.testing.assert_array_equal(got[k][sel], want[k][sel], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _point_set(pts):
    return set(map(tuple, np.round(pts, 5)))


@pytest.mark.parametrize("op", ["insert", "dedup", "from_single"])
def test_op_matches_single_device_and_jax(runs, op):
    n, port, jax_out = runs
    for rank in port:
        got, single = rank[op]
        _assert_maps(got, single)
        _assert_maps(got, jax_out[op], masked_points=True)
    assert port[0]["stripe_cubes"] == -(-np.prod(CFG["n_cubes"]) // n)


def test_repeated_inserts_and_recenter(runs):
    n, port, jax_out = runs
    for rank in port:
        for (got, single), want in zip(rank["recenter"], jax_out["recenter"]):
            _assert_maps(got, single)
            _assert_maps(got, want, masked_points=True)


def test_surround_gather_same_point_set(runs):
    n, port, jax_out = runs
    cap = (CFG["surround_corner_capacity"], CFG["surround_surf_capacity"])
    for rank in port:
        sur = rank["surround"]
        assert sur["slots"] == [n * -(-c // n) for c in cap]
        for got, single, want in zip(sur["got"], sur["want"], jax_out["surround"]):
            assert len(got) == len(single) == len(want)
            assert _point_set(got) == _point_set(single) == _point_set(want)


def test_mesh_of_one_takes_the_single_device_path(tmp_path):
    (res,) = W.run(W.mesh_one, 1, tmp_path, CFG)
    for op in ("insert", "dedup"):
        got, want = res[op]
        _assert_maps(got, want)
    got, want, o_got, o_want = res["recenter"]
    _assert_maps(got, want)
    np.testing.assert_array_equal(o_got, o_want)
    for g, w in zip(*res["surround"]):
        _assert_maps(g, w)
    assert res["to_single_is_view"]


def test_mapping_step_matches_single_device(tmp_path):
    # the step's solve converges but misses the match-fraction gate in both
    # packages (0.148 in the JAX package), so the committed pose is the guess
    # in both: the solved twist is compared as well
    for rank in W.run(W.mapping_step, 2, tmp_path, STEP_MAP):
        (W2, W1), (ok2, ok1), (m2, m1) = rank["W"], rank["success"], rank["map"]
        assert ok1 == ok2 and rank["converged"] == (True, True)
        np.testing.assert_allclose(W2, W1, atol=STEP_TOL)
        np.testing.assert_allclose(*rank["x"], atol=STEP_TOL)
        for name in ("corner", "surf"):
            n2, n1 = int(m2[f"{name}.mask"].sum()), int(m1[f"{name}.mask"].sum())
            assert abs(n2 - n1) <= 2, (name, n2, n1)


PIPE_SWEEPS = 3


def _drive(n_sweeps, map_mesh=None):
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    sweeps, _ = W.pipeline_sweeps(n_sweeps)
    pipe = SlamPipeline(W.pipeline_cfg(), mode="mapping", map_mesh=map_mesh, device="cpu")
    merged = np.stack([pipe.process(s).merged_pose for s in sweeps])
    return merged, W.map_arrays(pipe.single_map_state())


def _drives(tmp_path, n_sweeps, with_mesh_of_one=False):
    """The pipeline over 2 ranks, and meanwhile in this process on one
    device and (optionally) on a mesh of one rank, which needs no group."""
    from cooper_mapper_torch.parallel.mesh import Mesh

    torch.set_num_threads(1)
    ranks = W.Ranks(W.pipeline, 2, tmp_path, n_sweeps)
    try:
        single = _drive(n_sweeps)
        one = (_drive(n_sweeps, Mesh(None, 1, 0, torch.device("cpu")))
               if with_mesh_of_one else None)
    finally:
        striped = ranks.results()
    return single, one, striped


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    return _drives(tmp_path_factory.mktemp("pipeline"), PIPE_SWEEPS, with_mesh_of_one=True)


def _check_striped(single, striped):
    merged, points = single
    for rank in striped:
        np.testing.assert_allclose(rank["merged"][:, :3, 3], merged[:, :3, 3], atol=PIPE_TOL)
        assert rank["stats"]["mapping_solves"] >= 2
        for name in ("corner", "surf"):
            n1, n2 = int(points[f"{name}.mask"].sum()), rank["points"][name]
            assert abs(n2 - n1) <= 0.01 * max(n1, n2) + 2, (name, n2, n1)


def test_pipeline_on_striped_map_matches_single_device(drives):
    single, _, striped = drives
    _check_striped(single, striped)


def test_mesh_of_one_pipeline_is_bit_identical(drives):
    """At one rank the pipeline takes the single-device path: every pose
    and map tensor is the same."""
    (merged, points), (merged1, points1), _ = drives
    np.testing.assert_array_equal(merged1, merged)
    _assert_maps(points1, points)


@pytest.mark.slow
def test_pipeline_on_striped_map_six_sweeps(tmp_path):
    single, _, striped = _drives(tmp_path, 6)
    _check_striped(single, striped)
