"""Port vs JAX package: the offline map converter (``io/feature_extracter``).

``classify_map_points`` at the JAX test's k = 8 (tests/test_io.py's plane
and line) and at the converter's k = 10 on a jittered room cloud,
``extract_feature_map`` and ``convert_map_for_localization`` then
``load_feature_map``.

On the CPU the JAX converter searches with the dense ``neighbors.knn``
(``qn - 2 q.r + rn`` by a matmul, then ``lax.top_k``), the port with
``knn_plain`` (``(qn - 2 q.r) + rn``, the kernel's order); the two distances
may differ by an ulp, so a near tie at the k-th neighbour may pick another
point, and the eigenvalues (LAPACK's ``eigvalsh`` in both, from
covariances summed in different orders) differ in their last bits.  So the
labels must be equal except at points whose eigenvalue ratios sit within
1e-4 (relative) of a threshold (``feature_extracter.threshold_margin``);
the tests count those and print how many there are.  The cube counts
then differ by at most the number of such points.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.io import feature_extracter as jfe  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.io import feature_extracter as tfe  # noqa: E402
from cooper_mapper_torch.io import map_io as tmap_io  # noqa: E402
from cooper_mapper_torch.io import pcd as tpcd  # noqa: E402

MARGIN = 1e-4


def _plane_and_line():
    """tests/test_io.py::TestFeatureExtracter's cloud: a plane patch and a line."""
    rng = np.random.RandomState(0)
    uv = rng.uniform(-2, 2, (400, 2))
    plane = np.stack([uv[:, 0], np.zeros(400), uv[:, 1]], -1)
    t = rng.uniform(-2, 2, (100, 1))
    line = np.concatenate([t * 0 + 5.0, t * 3, t * 0], -1)
    return np.concatenate([plane, line]).astype(np.float32)


def _room_cloud(n_sweeps=2, width=256, jitter=0.003):
    """Two 16 x 256 sweeps of make_room_world(seed=3) placed in the world,
    jittered by ``jitter`` m (numpy-seeded): ~8k points."""
    world = jsim.make_room_world(seed=3)
    poses = jsim.figure_eight_trajectory(8)
    parts = []
    for i in range(n_sweeps):
        P = jnp.asarray(poses[3 * i])
        sw = jsim.scan_sweep(world, P, P, n_rings=16, width=width, distortion=False)
        pts = np.asarray(sw.xyz)[np.asarray(sw.mask)]
        parts.append(pts @ poses[3 * i][:3, :3].T + poses[3 * i][:3, 3])
    xyz = np.concatenate(parts)
    return (xyz + np.random.RandomState(1).normal(0, jitter, xyz.shape)).astype(np.float32)


def _evals_margin(xyz, k):
    pts = torch.from_numpy(xyz)
    return tfe.threshold_margin(tfe.eigenvalues(pts, tfe.neighbours(pts, k))).numpy()


def _compare_labels(xyz, k):
    """Port and JAX labels; returns the number of points whose labels
    differ, each of them within MARGIN of a threshold."""
    got = tfe.classify_map_points(xyz, k=k, device="cpu")
    want = [np.asarray(a) for a in jfe.classify_map_points(xyz, k=k)]
    differ = (got[0] != want[0]) | (got[1] != want[1])
    margin = _evals_margin(xyz, k)
    assert np.all(margin[differ] < MARGIN), margin[differ]
    print(f"k={k}: {int(differ.sum())} of {len(xyz)} labels differ, all within {MARGIN} "
          f"of a threshold ({int((margin < MARGIN).sum())} points are)")
    return got, int(differ.sum())


def test_classifies_plane_and_edge_as_jax():
    # TestFeatureExtracter::test_classifies_plane_and_edge, k = 8 (the card
    # runs it against the CPU in chip_smoke.py phase 41)
    (is_surf, is_corner), _ = _compare_labels(_plane_and_line(), 8)
    assert is_surf[:400].mean() > 0.8
    assert is_corner[400:].mean() > 0.6
    assert is_corner[:400].mean() < 0.2


def test_classify_room_cloud_at_k10_as_jax():
    xyz = _room_cloud()
    (is_surf, is_corner), n_differ = _compare_labels(xyz, 10)
    assert n_differ <= 1e-3 * len(xyz)
    assert is_surf.mean() > 0.5 and is_corner.sum() > 0 and not (is_surf & is_corner).any()


def test_neighbours_equal_jax_knn():
    """The k = 10 neighbour sets equal the JAX converter's except in rows
    where the two sets' last members are a near tie: their exact (float64)
    squared distances within the f32 rounding of the expanded form,
    16 ulps of |q|^2 + |r|^2.  The first neighbour is the point itself."""
    from cooper_mapper_tpu.ops import neighbors as jnb

    xyz = _room_cloud()
    got = np.sort(tfe.neighbours(torch.from_numpy(xyz), 10).numpy(), -1)
    want, _ = jnb.knn_chunked(jnp.asarray(xyz), jnp.asarray(xyz), jnp.ones(len(xyz), bool),
                              10, 1024)
    want = np.sort(np.asarray(want), -1)
    rows = np.nonzero(np.any(got != want, -1))[0]
    x64 = xyz.astype(np.float64)
    for i in rows:
        only = np.setxor1d(got[i], want[i])
        d = np.sum((x64[only] - x64[i]) ** 2, -1)
        n2 = np.sum(x64[i] ** 2) + np.sum(x64[only] ** 2, -1)
        assert d.max() - d.min() <= 16 * 2.0 ** -24 * n2.max(), (i, d)
    print(f"{len(rows)} of {len(xyz)} rows pick another 10th neighbour, each at a near tie")
    assert len(rows) <= 1e-2 * len(xyz)
    got_first = tfe.neighbours(torch.from_numpy(xyz), 10).numpy()[:, 0]
    np.testing.assert_array_equal(got_first, np.arange(len(xyz)))


def _map_cfg(m):
    return m.MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, corner_cube_capacity=1024,
                       surf_cube_capacity=2048, surround_corner_capacity=8192,
                       surround_surf_capacity=16384, valid_distance=25.0)


def test_extract_feature_map_cube_counts_match_jax():
    xyz = _room_cloud()
    _, n_differ = _compare_labels(xyz, 10)
    got = tfe.extract_feature_map(xyz, _map_cfg(tc), batch_insert=2048, device="cpu")
    want = jfe.extract_feature_map(xyz, _map_cfg(jc), batch_insert=2048)
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    for cg, cw in ((got.corner, want.corner), (got.surf, want.surf)):
        diff = np.abs(cg.count.numpy() - np.asarray(cw.count))
        assert diff.sum() <= n_differ, diff.sum()
        assert int(cg.count.sum()) > 0


def test_convert_then_load_round_trip(tmp_path):
    """convert_map_for_localization writes the cube files of the map that
    extract_feature_map builds; load_feature_map reads them back: saved
    again, the same files with the same points; and the JAX converter on
    the same PCD writes the same cube files."""
    xyz = _room_cloud()
    src = str(tmp_path / "map.pcd")
    tpcd.write_pcd(src, xyz)
    cfg = _map_cfg(tc)
    n = tfe.convert_map_for_localization(src, str(tmp_path / "port"), cfg, device="cpu")
    assert n == len(os.listdir(tmp_path / "port")) - 1 > 0          # + index.txt
    loaded = tmap_io.load_feature_map(str(tmp_path / "port"), cfg, device="cpu")
    assert tmap_io.save_feature_map(loaded, cfg, str(tmp_path / "again")) == n

    def rows(d):
        with open(os.path.join(d, "index.txt")) as f:
            return sorted(f.read().splitlines())

    assert rows(tmp_path / "port") == rows(tmp_path / "again")
    for name in os.listdir(tmp_path / "port"):
        if name.endswith(".pcd"):
            np.testing.assert_array_equal(tpcd.read_pcd(str(tmp_path / "port" / name))[0],
                                          tpcd.read_pcd(str(tmp_path / "again" / name))[0])
    assert jfe.convert_map_for_localization(src, str(tmp_path / "jax"), _map_cfg(jc)) == n
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
