"""Port vs JAX package: feature extraction and the voxel filter.

Both packages get the SAME sweep (the JAX simulator's, through
``cooper_mapper_torch.bridge``).  The reference is the JAX function body
evaluated op by op (``features._extract_impl`` outside ``jit``): it performs
each f32 operation in the order the source states, as the port does.  Under
``jit`` XLA fuses and re-associates the curvature sums (up to 1.7e-3 on
this sweep), which reorders exact curvature ties on flat floors, so against
the jitted function only the sharp clouds are compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.config import RegistrationConfig as JReg  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat, voxel as jvoxel  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.config import RegistrationConfig as TReg  # noqa: E402
from cooper_mapper_torch.ops import features as tfeat, voxel as tvoxel  # noqa: E402

WIDTH = 512
CFG_J = JReg(n_rings=16, max_points_per_ring=WIDTH)
CFG_T = TReg(n_rings=16, max_points_per_ring=WIDTH)
CLOUDS = ("sharp", "less_sharp", "flat", "less_flat")


def _sweep(distorted):
    world = jsim.make_room_world(seed=42)
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    c, s = np.cos(0.02), np.sin(0.02)
    motion = np.array([[c, 0, s, 0.1], [0, 1, 0, 0], [-s, 0, c, 0.35], [0, 0, 0, 1]], np.float32)
    p1 = p0 @ motion if distorted else p0
    return jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p1), n_rings=16, width=WIDTH)


@pytest.fixture(scope="module", params=[False, True], ids=["static", "distorted"])
def sweeps(request):
    sj = _sweep(request.param)
    return sj, bridge.sweep(sj, "cpu")


def _assert_same_cloud(ct, cj, name):
    nj, nt = int(np.asarray(cj.mask).sum()), int(ct.mask.sum())
    assert nt == nj, f"{name}: {nt} points vs {nj}"
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    np.testing.assert_allclose(ct.xyz.numpy()[:nj], np.asarray(cj.xyz)[:nj], atol=1e-5,
                               err_msg=name)
    np.testing.assert_array_equal(ct.ring.numpy()[:nj], np.asarray(cj.ring)[:nj], err_msg=name)
    np.testing.assert_allclose(ct.rel_time.numpy()[:nj], np.asarray(cj.rel_time)[:nj],
                               atol=1e-7, err_msg=name)


def test_per_point_stages_match(sweeps):
    sj, st = sweeps
    np.testing.assert_array_equal(tfeat.curvature(st.xyz, 5).numpy(),
                                  np.asarray(jfeat.curvature(sj.xyz, 5)))
    np.testing.assert_array_equal(tfeat.scan_status(st.xyz, st.mask, CFG_T).numpy(),
                                  np.asarray(jfeat.scan_status(sj.xyz, sj.mask, CFG_J)))
    np.testing.assert_array_equal(tfeat.classify(st.xyz, st.mask, CFG_T).numpy(),
                                  np.asarray(jfeat.classify(sj.xyz, sj.mask, CFG_J)))
    np.testing.assert_array_equal(tfeat._region_ids(st.mask, CFG_T).numpy(),
                                  np.asarray(jfeat._region_ids(sj.mask, CFG_J)))


def test_feature_sets_match_op_by_op_reference(sweeps):
    sj, st = sweeps
    fj, _ = jfeat._extract_impl(sj, CFG_J)
    ft = tfeat.extract_features(st, CFG_T)
    for name in CLOUDS:
        _assert_same_cloud(getattr(ft, name), getattr(fj, name), name)


def test_sharp_sets_match_jitted_reference(sweeps):
    sj, st = sweeps
    fj = jfeat.extract_features(sj, CFG_J)
    ft = tfeat.extract_features(st, CFG_T)
    for name in ("sharp", "less_sharp"):
        _assert_same_cloud(getattr(ft, name), getattr(fj, name), name)


def test_voxel_keeps_the_same_points():
    # many points per voxel, invalid points scattered among them: the kept
    # point of each voxel (and so its ring and rel_time) is decided by the
    # stability of the lexicographic sort
    rng = np.random.RandomState(9)
    n = 600
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    mask = rng.rand(n) > 0.2
    xyz[~mask] = jcloud.FAR
    ring = rng.randint(0, 16, n).astype(np.int32)
    rel = rng.rand(n).astype(np.float32)
    cj = jcloud.make(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(ring), jnp.asarray(rel))
    vj = jvoxel.voxel_downsample(cj, 0.5, capacity=256)
    vt = tvoxel.voxel_downsample(bridge.cloud(cj, "cpu"), 0.5, capacity=256)
    _assert_same_cloud(vt, vj, "voxel")
    assert int(vt.mask.sum()) < int(mask.sum()) // 4   # real merging happened


def test_hdl64_capacity_cut_is_shared():
    # The feature capacities cut a 64-ring sweep down to its lowest rings in
    # both packages: sharp (256) and flat (1024) fill up, and the raw
    # less-flat pool is compacted to max_less_flat (8192) in ring-major
    # order BEFORE the voxel filter (features.py:428-431), so only the
    # lowest rings reach less_flat.  A JAX-package behaviour the port keeps:
    # every class holds the same points, bit for bit.
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=31)
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    p1 = p0.copy()
    p1[2, 3] += 0.35
    sj = jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p1), n_rings=64, width=512,
                         vfov=(-24.9, 2.0))          # the HDL-64E fan
    assert len(np.unique(np.nonzero(np.asarray(sj.mask))[0])) == 64
    fj, _ = jfeat._extract_impl(sj, JReg(n_rings=64, max_points_per_ring=512))
    ft = tfeat.extract_features(bridge.sweep(sj, "cpu"), TReg(n_rings=64, max_points_per_ring=512))
    rings = {}
    for name in CLOUDS:
        cj, ct = getattr(fj, name), getattr(ft, name)
        for f in ("xyz", "mask", "ring", "rel_time"):
            np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)),
                                          err_msg=f"{name}.{f}")
        rings[name] = sorted(set(ct.ring[ct.mask].tolist()))
        print(f"{name}: {int(ct.mask.sum())} of {ct.capacity}, rings {rings[name]}")
    assert int(ft.sharp.mask.sum()) == ft.sharp.capacity == 256
    assert int(ft.flat.mask.sum()) == ft.flat.capacity == 1024
    # less_flat keeps a prefix of the rings, far short of the 64
    lf = rings["less_flat"]
    assert lf == list(range(len(lf))) and len(lf) < 32
    assert lf == sorted(set(np.asarray(fj.less_flat.ring)[np.asarray(fj.less_flat.mask)].tolist()))


@pytest.mark.parametrize("width", [1024, 2048])
def test_less_flat_keeps_a_ring_prefix_at_16_rings(width):
    # the same cut at the VLP-16 fan: max_less_flat takes the raw less-flat
    # pool ring by ring from ring 0, so the cloud after the voxel filter
    # holds the lowest rings only, the same rings in both packages.  The
    # points are the same but for those a differing classify label moves
    # (an ulp of eig3's arccos / cos decides a threshold, ROADMAP.md Queue
    # 3: one label at 16 x 2048 here, none at 16 x 1024)
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=31)
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    p1 = p0.copy()
    p1[2, 3] += 0.35
    sj = jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p1), n_rings=16, width=width)
    st = bridge.sweep(sj, "cpu")
    cj, ct = JReg(n_rings=16, max_points_per_ring=width), TReg(n_rings=16, max_points_per_ring=width)
    fj, _ = jfeat._extract_impl(sj, cj)
    ft = tfeat.extract_features(st, ct)
    n_label = int((tfeat.classify(st.xyz, st.mask, ct).numpy()
                   != np.asarray(jfeat.classify(sj.xyz, sj.mask, cj))).sum())
    assert n_label <= 1
    lj, lt = fj.less_flat, ft.less_flat
    pts = lambda c, m: {tuple(x) for x in np.asarray(c.xyz)[np.asarray(m)].tolist()}
    differ = pts(lj, lj.mask) ^ pts(lt, lt.mask)
    if n_label == 0:
        for f in ("xyz", "mask", "ring", "rel_time"):
            np.testing.assert_array_equal(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)),
                                          err_msg=f)
    assert len(differ) <= 4 * n_label
    rings = sorted(set(lt.ring[lt.mask].tolist()))
    print(f"16 x {width}: less_flat {int(lt.mask.sum())} points, rings {rings}; labels "
          f"differing {n_label}, points differing {len(differ)}")
    assert rings == sorted(set(np.asarray(lj.ring)[np.asarray(lj.mask)].tolist()))
    assert rings == list(range(len(rings))) and len(rings) < 16
