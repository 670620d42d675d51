"""The benchmark's input maker: deterministic per seed, and its frozen copy
of the simulator's features and voxel filter equal to the port's."""

import numpy as np
import pytest
import torch

from portbench.inputs import features, pool, sim
from portbench.tests.small import CELLS, small

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_pool_is_deterministic_per_seed(cell):
    wl, cfg = small(cell)
    a = _flat(pool.make_pool(cfg, wl["traffic"], 2**31 + 11, "cpu"))
    b = _flat(pool.make_pool(cfg, wl["traffic"], 2**31 + 11, "cpu"))
    c = _flat(pool.make_pool(cfg, wl["traffic"], 2**31 + 12, "cpu"))
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["truth"], c["truth"])
    # every cloud holds valid points, and no cloud is empty
    assert all(int(v.sum(-1).min()) > 0 for k, v in a.items() if k.endswith(".mask"))


def test_call_draws_are_deterministic():
    wl, cfg = small(CELLS[0])
    p = pool.make_pool(cfg, wl["traffic"], 7, "cpu")
    draws = []
    for _ in range(2):
        _, gen = pool.generators(7, 1, "cpu")
        draws.append(pool.draw_problems(p, 16, wl["traffic"]["prior"], gen))
    assert torch.equal(draws[0][0], draws[1][0]) and torch.equal(draws[0][1], draws[1][1])


def _port_sweep(xyz, mask, rel):
    from cooper_mapper_torch.ops.features import Sweep
    return Sweep(xyz=xyz, mask=mask, rel_time=rel)


def test_features_equal_the_ports():
    """Sweep by sweep, the batched copy extracts the port's features."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.ops.features import extract_features

    wl, cfg = small(CELLS[0])
    reg = cfg["registration"]
    rng = np.random.default_rng(3)
    world = sim.room_worlds(rng, 3, (30.0, 4.0, 40.0), 8, 0.4, "cpu")
    P0 = torch.from_numpy(sim.yaw_pose(np.zeros(3), np.full(3, 1.5), np.zeros(3),
                                       np.array([0.1, 1.0, -2.0])))
    P1 = P0 @ sim.euler6_to_mat(torch.tensor([[0.0, 0.02, 0.0, 0.1, 0.0, 0.0]] * 3))
    xyz, mask, rel = sim.scan_sweeps(world, P0, P1, 16, 360, noise=0.01,
                                     generator=torch.Generator().manual_seed(1))
    ours = features.extract_features(xyz, mask, rel, reg)
    for i in range(3):
        theirs = extract_features(_port_sweep(xyz[i], mask[i], rel[i]), RegistrationConfig(**reg))
        for kind in ("sharp", "less_sharp", "flat", "less_flat"):
            c = getattr(theirs, kind)
            for field in ("xyz", "mask", "ring", "rel_time"):
                assert torch.equal(ours[kind][field][i], getattr(c, field)), (i, kind, field)


def test_voxel_filter_equals_the_ports():
    from cooper_mapper_torch.ops.voxel import voxel_downsample
    from cooper_mapper_torch.utils.cloud import Cloud

    g = torch.Generator().manual_seed(5)
    xyz = torch.rand((3, 400, 3), generator=g) * 4.0
    mask = torch.rand((3, 400), generator=g) > 0.3
    xyz = torch.where(mask[..., None], xyz, torch.tensor(features.FAR))
    ring = torch.randint(0, 16, (3, 400), generator=g, dtype=torch.int32)
    rel = torch.rand((3, 400), generator=g)
    ours = features.voxel_downsample({"xyz": xyz, "mask": mask, "ring": ring, "rel_time": rel},
                                     0.4, 300)
    for i in range(3):
        theirs = voxel_downsample(Cloud(xyz[i], mask[i], ring[i], rel[i]), 0.4, 300)
        for field in ("xyz", "mask", "ring", "rel_time"):
            assert torch.equal(ours[field][i], getattr(theirs, field)), (i, field)


CAPACITY = {"sharp": "max_sharp", "flat": "max_flat", "less_sharp": "max_less_sharp",
            "less_flat": "max_less_flat", "corner": "max_frame_corner",
            "surf": "max_frame_surf", "ref_corner": "surround_corner_capacity",
            "ref_surf": "surround_surf_capacity"}


@pytest.mark.parametrize("cell", CELLS)
def test_pool_clouds_have_the_configured_capacities(cell):
    """Every cloud has its configuration's capacity, also a map of fewer
    sweeps than it holds (padded with invalid points)."""
    wl, cfg = small(cell)
    p = pool.make_pool(cfg, wl["traffic"], 3, "cpu")
    for name, cloud in p.items():
        if name == "truth":
            continue
        key = CAPACITY[name]
        cap = cfg["registration"][key] if key in cfg["registration"] else cfg[key]
        assert cloud["mask"].shape == (wl["traffic"]["pool_size"], cap), name
        assert bool((cloud["xyz"][~cloud["mask"]] == features.FAR).all())
