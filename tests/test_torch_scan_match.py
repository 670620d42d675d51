"""Port vs JAX package: the scan-to-map solve and its parts.

Every case feeds the same numpy-seeded inputs, or the same clouds built by
the JAX package and bridged as numpy, to the JAX function and its port.

Tolerances, with their reasons:

* residuals and fits: 1e-4 absolute on metre-scale outputs (library sin /
  cos / arccos and sum orders differ by ulps); ``valid`` equal except where
  an eigenvalue ratio or an inlier distance lies within 1e-3 relative of its
  threshold, where an ulp decides (counted, and bounded at 2%);
* solved twists: 2e-3, the tolerance tests/test_odometry.py uses between
  equivalent nearest-neighbour paths (the JAX package forms the k-NN cross
  term with a matrix product, the port elementwise, so a near-tied 5th
  neighbour can differ); ``converged`` and ``success`` equal;
* score and match fraction: 1e-3 relative.

The solves run on clouds compacted to their valid counts (``bench.snug``),
in both packages: compaction keeps the valid points' order, so it changes no
selection, and it keeps the CPU searches short.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from benchmarks import bench_scan_match  # noqa: E402
from cooper_mapper_tpu.config import (  # noqa: E402
    RegistrationConfig as JReg, ScanMatchConfig as JSM)
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.models import laser_mapping as jlm  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_tpu.ops import odometry as jodo  # noqa: E402
from cooper_mapper_tpu.ops import residuals as jres  # noqa: E402
from cooper_mapper_tpu.ops import scan_match as jsm  # noqa: E402
from cooper_mapper_tpu.utils import cloud as jcloud  # noqa: E402
from cooper_mapper_tpu.utils import se3 as jse3, twist as jtwist  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.config import ScanMatchConfig as TSM  # noqa: E402
from cooper_mapper_torch.ops import odometry as todo  # noqa: E402
from cooper_mapper_torch.ops import residuals as tres  # noqa: E402
from cooper_mapper_torch.ops import scan_match as tsm  # noqa: E402
from cooper_mapper_torch.utils import twist as ttwist  # noqa: E402

TWIST_TOL, REL_TOL, NEAR = 2e-3, 1e-3, 1e-3
CFG_SM = dict(score_threshold=50.0)   # tests/test_scan_match.py: sparser synthetic scenes


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(c):
    return bridge.cloud(c, "cpu")


# ---------------------------------------------------------------------------
# residuals, map half
# ---------------------------------------------------------------------------


def _neighbourhoods(seed, n=240, k=5):
    """[3n, k, 3] 5-point sets: noisy lines, noisy planes and blobs, with noise
    levels that put some sets on either side of the fits' thresholds."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-10, 10, (3 * n, 1, 3))
    sig = rng.choice([0.002, 0.02, 0.06, 0.15], (3 * n, 1, 1))
    u = rng.randn(3 * n, 1, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(u, rng.randn(3 * n, 1, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    a, b = rng.uniform(-0.5, 0.5, (2, 3 * n, k, 1))
    pts = c + a * u + sig * rng.randn(3 * n, k, 3)           # lines
    pts[n:2 * n] += (b * v)[n:2 * n]                           # planes
    pts[2 * n:] = c[2 * n:] + 0.3 * rng.randn(n, k, 3)         # blobs
    X = c[:, 0] + rng.uniform(-0.4, 0.4, (3 * n, 3))
    mask = rng.rand(3 * n) > 0.1
    return pts.astype(np.float32), X.astype(np.float32), mask


def _cov_eigs(pts):
    a = pts.astype(np.float64) - pts.mean(1, keepdims=True)
    return np.linalg.eigvalsh(np.einsum("nki,nkj->nij", a, a))


def _planes(pts, lib):
    return tuple([lib(pts[:, j, ax]) for j in range(pts.shape[1])] for ax in range(3))


def _valid_equal(got, want, near, what):
    """valid flags equal except at ``near`` (the threshold cases)."""
    got, want = np.asarray(got), np.asarray(want)
    assert near.mean() < 0.02, f"{what}: {near.sum()} threshold cases"
    np.testing.assert_array_equal(got[~near], want[~near], err_msg=what)
    return int(near.sum())


def test_line_fit_and_corner_coefficients_match_jax():
    pts, X, mask = _neighbourhoods(0)
    jA, jB, jv = jres.fit_line_planes(*_planes(pts, jnp.asarray), jnp.asarray(mask), 5.0)
    tA, tB, tv = tres.fit_line_planes(*_planes(pts, _t), _t(mask), 5.0)
    lam = _cov_eigs(pts)
    # threshold cases excluded: 0 of the 720 sets here (and 0 for the weight)
    near = np.abs(lam[:, 2] - 5.0 * lam[:, 1]) <= NEAR * lam[:, 2]
    _valid_equal(tv, jv, near, "line valid")
    both = np.asarray(jv) & tv.numpy()
    assert 0.2 < both.mean() < 0.8
    np.testing.assert_allclose(tA.numpy()[both], np.asarray(jA)[both], atol=1e-4)
    np.testing.assert_allclose(tB.numpy()[both], np.asarray(jB)[both], atol=1e-4)
    jd, jr, jok = jres.corner_coeff_map(jA, jB, jnp.asarray(X))
    td, tr, tok = tres.corner_coeff_map(_t(jA), _t(jB), _t(X))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    w = 1.0 - 0.9 * np.abs(np.asarray(jres.line_point_distance(jA, jB, jnp.asarray(X))[0]))
    _valid_equal(tok, jok, np.abs(w - 0.1) <= NEAR * 0.1, "corner weight valid")


def test_plane_fit_and_surf_coefficients_match_jax():
    pts, X, mask = _neighbourhoods(1)
    jp, jv = jres.fit_plane_planes(*_planes(pts, jnp.asarray), jnp.asarray(mask), 0.2)
    tp, tv = tres.fit_plane_planes(*_planes(pts, _t), _t(mask), 0.2)
    lam = _cov_eigs(pts)
    # threshold cases excluded: 3 of the 720 sets here (1 planar ratio, 2
    # inlier distances)
    near = np.abs(lam[:, 1] - 0.05 * lam[:, 2]) <= NEAR * lam[:, 2]
    # an inlier distance on the 0.2 m test
    p64 = np.asarray(jp, np.float64)
    dist = np.abs(np.einsum("nki,ni->nk", pts.astype(np.float64), p64[:, :3]) + p64[:, 3:])
    near |= (np.abs(dist - 0.2) <= NEAR * 0.2).any(-1)
    _valid_equal(tv, jv, near, "plane valid")
    both = np.asarray(jv) & tv.numpy()
    assert 0.2 < both.mean() < 0.8
    np.testing.assert_allclose(tp.numpy()[both], np.asarray(jp)[both], atol=1e-4)
    jd, jr, jok = jres.surf_coeff_map(jp, jnp.asarray(X))
    td, tr, tok = tres.surf_coeff_map(_t(jp), _t(X))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_array_line_fit_matches_jax():
    # fit_line on [..., K, 3]: eigh in both packages; the principal
    # direction's sign is each eigensolver's, so {A, B} is compared as a pair
    pts, _, mask = _neighbourhoods(2)
    collinear = np.linspace(0, 1, 5, dtype=np.float32)[:, None] * np.float32([1, 2, 3]) \
        + np.float32([0.5, 0, -1])
    pts = np.concatenate([pts, collinear[None]])
    mask = np.concatenate([mask, [True]])
    jA, jB, jv = jres.fit_line(jnp.asarray(pts), jnp.asarray(mask))
    tA, tB, tv = tres.fit_line(_t(pts), _t(mask))
    lam = _cov_eigs(pts)
    near = np.abs(lam[:, 2] - 5.0 * lam[:, 1]) <= NEAR * lam[:, 2]
    _valid_equal(tv, jv, near, "line valid")
    assert bool(tv[-1]) and not tv.numpy()[:-1][~mask[:-1]].any()
    both = np.asarray(jv) & tv.numpy()
    assert 0.2 < both.mean() < 0.8
    same = np.maximum(np.abs(tA.numpy() - np.asarray(jA)), np.abs(tB.numpy() - np.asarray(jB)))
    swap = np.maximum(np.abs(tA.numpy() - np.asarray(jB)), np.abs(tB.numpy() - np.asarray(jA)))
    np.testing.assert_array_less(np.minimum(same, swap).max(-1)[both], 1e-4)
    # the collinear set's line passes through its points
    d, _ = tres.line_point_distance(tA[-1], tB[-1], _t(collinear[2]))
    assert float(d) < 1e-5


def test_array_plane_fit_matches_jax():
    # fit_plane on [..., K, 3]: the inlier and collinear gates and the mask
    # on noisy lines, planes and blobs 10 m out
    pts, _, mask = _neighbourhoods(3)
    jp, jv = jres.fit_plane(jnp.asarray(pts), jnp.asarray(mask), 0.2)
    tp, tv = tres.fit_plane(_t(pts), _t(mask), 0.2)
    lam = _cov_eigs(pts)
    near = np.abs(lam[:, 1] - 0.05 * lam[:, 2]) <= NEAR * lam[:, 2]
    p64 = np.asarray(jp, np.float64)
    dist = np.abs(np.einsum("nki,ni->nk", pts.astype(np.float64), p64[:, :3]) + p64[:, 3:])
    near |= (np.abs(dist - 0.2) <= NEAR * 0.2).any(-1)
    _valid_equal(tv, jv, near, "plane valid")
    assert not tv.numpy()[~mask].any()
    assert 0.2 < (np.asarray(jv) & tv.numpy()).mean() < 0.8
    # the parameters on clean planes 3 m out (the JAX package's
    # test_fit_plane_planes_params_on_clean_planes): n . p = -1 is solved
    # uncentred in f32, so the two LU solves part by up to ~1e-3 in d
    rng = np.random.RandomState(5)
    base = rng.randn(256, 1, 3) * 3
    pn = rng.randn(256, 1, 3)
    pn /= np.linalg.norm(pn, axis=-1, keepdims=True)
    u = np.cross(pn, np.array([1.0, 0.3, -0.5]))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(pn, u)
    clean = (base + rng.randn(256, 5, 1) * u + rng.randn(256, 5, 1) * v
             + 0.01 * rng.randn(256, 5, 3)).astype(np.float32)
    jp, jv = jres.fit_plane(jnp.asarray(clean))
    tp, tv = tres.fit_plane(_t(clean))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().mean() > 0.8
    np.testing.assert_allclose(tp.numpy()[tv.numpy()], np.asarray(jp)[tv.numpy()], atol=2e-3)
    # exactly collinear points: the planar-ratio gate rejects them in both
    # (without it the plane through a line is underdetermined, and the two
    # LU solves pick different ones)
    line = (np.linspace(0, 1, 5)[:, None] * np.array([1.0, 2.0, 3.0]) + [0.5, 0.0, -1.0])
    line = line[None].astype(np.float32)
    assert not bool(tres.fit_plane(_t(line))[1][0])
    assert not bool(jres.fit_plane(jnp.asarray(line))[1][0])


def test_reference_jacobian_rows_match_jax_and_autograd():
    rng = np.random.RandomState(2)
    x = np.array([[0.05, -0.1, 0.2, 1.0, -2.0, 0.5], [0.3, 0.02, -0.25, 0.0, 1.0, 3.0]],
                 np.float32)
    pts = (rng.randn(2, 32, 3) * 10).astype(np.float32)
    coeff = rng.randn(2, 32, 3).astype(np.float32)
    J = todo._reference_jacobian_rows(_t(x), _t(pts), _t(coeff))
    assert J.shape == (2, 32, 6)
    for b in range(2):
        want = jodo._reference_jacobian_rows(jnp.asarray(x[b]), jnp.asarray(pts[b]),
                                             jnp.asarray(coeff[b]))
        np.testing.assert_allclose(J[b].numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
        # d(coeff . (Rz Ry Rx p + t))/dx by autograd, as test_scan_match.py checks JAX's
        f = lambda xx: (_t(coeff[b]) * ttwist.point_to_map(xx, _t(pts[b]))).sum(-1)
        J_ad = torch.autograd.functional.jacobian(f, _t(x[b]))
        np.testing.assert_allclose(J[b].numpy(), J_ad.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# solves on tests/test_scan_match.py's scenes (width 512)
# ---------------------------------------------------------------------------


def _pose_mat(x=0.0, y=1.5, z=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return jnp.array([[c, 0, s, x], [0, 1, 0, y], [-s, 0, c, z], [0, 0, 0, 1]], jnp.float32)


def _world_features(pose, world):
    sweep = jsim.scan_sweep(world, pose, pose, n_rings=16, width=512, distortion=False)
    return jfeat.extract_features(sweep, JReg(n_rings=16, max_points_per_ring=512))


@pytest.fixture(scope="module")
def pose_offset_scene():
    """test_recovers_pose_offset's map, frame, true pose and initial guess
    (JAX clouds, snug), plus the first map pose's features."""
    world = jsim.make_room_world(seed=11)
    refs = []
    for pose in [_pose_mat(), _pose_mat(x=1.0, z=0.7), _pose_mat(x=-0.8, z=1.2, yaw=0.3)]:
        fc = _world_features(pose, world)
        refs.append((jlm._to_world(fc.less_sharp, pose), jlm._to_world(fc.less_flat, pose)))
        if not len(refs) - 1:
            fc0 = fc
    ref_c = jcloud.concat(jcloud.concat(refs[0][0], refs[1][0]), refs[2][0])
    ref_s = jcloud.concat(jcloud.concat(refs[0][1], refs[1][1]), refs[2][1])
    true_pose = _pose_mat(x=0.4, z=-0.3, yaw=0.04)
    fc_cur = _world_features(true_pose, world)
    x0 = jtwist.from_mat(true_pose @ jse3.euler6_to_mat(
        jnp.array([0.01, 0.02, -0.01, 0.15, -0.1, 0.1])))
    clouds = [bench.snug(c) for c in (fc_cur.less_sharp, fc_cur.less_flat, ref_c, ref_s)]
    return clouds, np.asarray(x0), true_pose, fc0


def _compare(res_t, res_j, batched=False):
    t, j = bridge.to_numpy(res_t), bridge.to_numpy(res_j)
    assert np.isfinite(t["x"]).all()
    np.testing.assert_allclose(t["x"], j["x"], atol=TWIST_TOL)
    for f in ("converged", "success", "enough_ref", "is_degenerate"):
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    for f in ("score", "match_fraction"):
        np.testing.assert_allclose(t[f], j[f], rtol=REL_TOL, err_msg=f)
    return t


def test_scan_match_recovers_pose_offset_like_jax(pose_offset_scene):
    clouds, x0, true_pose, _ = pose_offset_scene
    res_j = jsm.scan_match(*clouds, jnp.asarray(x0), JSM(**CFG_SM))
    res_t = tsm.scan_match(*map(_cloud, clouds), _t(x0), TSM(**CFG_SM))
    t = _compare(res_t, res_j)
    assert t["converged"] and t["match_fraction"] > 0.3
    # and the port recovers the pose as well as tests/test_scan_match.py asks of JAX
    err = np.asarray(jse3.se3_log(jse3.inverse(true_pose) @ jtwist.to_mat(jnp.asarray(t["x"]))))
    assert np.linalg.norm(err[:3]) < 0.1 and np.linalg.norm(err[3:]) < 0.01


def test_gate_rejects_garbage_like_jax(pose_offset_scene):
    *_, fc0 = pose_offset_scene
    junk_xyz = (100.0 + 5.0 * np.random.RandomState(0).randn(512, 3)).astype(np.float32)
    junk = jcloud.from_points(jnp.asarray(junk_xyz), capacity=512)
    res_j = jsm.scan_match(fc0.sharp, fc0.flat, junk, junk, jnp.zeros(6), JSM(**CFG_SM))
    res_t = tsm.scan_match(_cloud(fc0.sharp), _cloud(fc0.flat), _cloud(junk), _cloud(junk),
                           torch.zeros(6), TSM(**CFG_SM))
    t = _compare(res_t, res_j)
    assert not t["success"] and not bool(res_j.success)


@pytest.mark.parametrize("backend", ["pallas"], ids=["kernel_backend"])
def test_kernel_backend_matches_jax(pose_offset_scene, backend):
    # the JAX package's dispatch knob names the same search (the tensors'
    # device picks the path): the port at a non-default value against the
    # JAX package at the same value (on the CPU its dense path) within the
    # file's tolerances; a name the JAX package does not know raises
    clouds, x0, _, _ = pose_offset_scene
    res_j = jsm.scan_match(*clouds, jnp.asarray(x0), JSM(kernel_backend=backend, **CFG_SM))
    res_t = tsm.scan_match(*map(_cloud, clouds), _t(x0), TSM(kernel_backend=backend, **CFG_SM))
    _compare(res_t, res_j)
    with pytest.raises(ValueError, match="kernel_backend"):
        tsm.scan_match(*map(_cloud, clouds), _t(x0), TSM(kernel_backend="cuda", **CFG_SM))


def test_parity_mode_matches_jax(pose_offset_scene):
    """The parity solve equals the JAX package's and differs from the
    native one (tests/test_torch_parity_golden.py holds it to the C++
    oracle)."""
    clouds, x0, _, _ = pose_offset_scene
    res_j = jsm.scan_match(*clouds, jnp.asarray(x0), JSM(**CFG_SM), parity_mode=True)
    res_t = tsm.scan_match(*map(_cloud, clouds), _t(x0), TSM(**CFG_SM), parity_mode=True)
    t = _compare(res_t, res_j)
    native = bridge.to_numpy(tsm.scan_match(*map(_cloud, clouds), _t(x0), TSM(**CFG_SM)))
    assert t["converged"] and np.abs(t["x"] - native["x"]).max() > 0


# ---------------------------------------------------------------------------
# the slice: benchmarks/bench_scan_match.py's problem, B = 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_problem():
    return bench_scan_match.build_problem()


def test_scan_match_local_matches_jax(bench_problem):
    x0 = (0.02 * np.random.RandomState(1).randn(6)).astype(np.float32)
    res_j = jsm.scan_match_local(*bench_problem, jnp.asarray(x0), JSM())
    res_t = tsm.scan_match_local(*map(_cloud, bench_problem), _t(x0), TSM())
    t = _compare(res_t, res_j)
    assert t["converged"]


def test_shared_reference_equals_its_broadcast(bench_problem):
    # 3 iterations: the layouts must agree step by step, convergence is not
    # the point here
    corner, surf, ref_c, ref_s = map(_cloud, bench_problem)
    cfg = TSM(max_iterations=3)
    B = 2
    xb = _t((0.02 * np.random.RandomState(2).randn(B, 6)).astype(np.float32))
    tile = lambda c: chip_smoke.tile(c, B)
    shared = tsm.batch_scan_match(tile(corner), tile(surf), ref_c, ref_s, xb, cfg)
    bcast = tsm.batch_scan_match(tile(corner), tile(surf), tile(ref_c), tile(ref_s), xb, cfg)
    for f in dataclasses.fields(tsm.ScanMatchResult):
        a, b = getattr(shared, f.name), getattr(bcast, f.name)
        assert a.shape[0] == B and torch.equal(a, b), f.name
    # lane 0 is scan_match from its prior (within 1e-5: the batched normal
    # equation products may block differently at another batch size)
    single = tsm.scan_match(corner, surf, ref_c, ref_s, xb[0], cfg)
    np.testing.assert_allclose(single.x.numpy(), shared.x[0].numpy(), atol=1e-5)
    assert bool(single.converged) == bool(shared.converged[0])


def test_problem_builder_matches_jax(bench_problem):
    # chip_smoke's builder (port: _to_world, concatenation, voxel filter,
    # prepare_frame, snug) on the JAX package's own feature clouds, against
    # bench_scan_match.build_problem
    p0, p1, poses = chip_smoke.scan_match_poses()
    world = jsim.make_room_world(seed=chip_smoke.SM_WORLD_SEED)
    cfg = JReg(n_rings=16, max_points_per_ring=1024)
    feats = lambda a, b: jfeat.extract_features(
        jsim.scan_sweep(world, jnp.asarray(a), jnp.asarray(b), n_rings=16, width=1024), cfg)
    bridged = lambda f: bridge.feature_clouds(f, "cpu")
    got = chip_smoke.scan_match_clouds([bridged(feats(p, p)) for p in poses],
                                       [_t(p) for p in poses], bridged(feats(p0, p1)))
    for name, g, w in zip(("corner", "surf", "ref_corner", "ref_surf"), got, bench_problem):
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask), err_msg=name)
        np.testing.assert_allclose(g.xyz.numpy(), np.asarray(w.xyz), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_bench_problem_batch_solve_matches_jax(bench_problem):
    B = 4
    x0 = (0.02 * np.random.RandomState(0).randn(B, 6)).astype(np.float32)
    tile_j = lambda c: jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), c)
    corner, surf, ref_c, ref_s = bench_problem
    res_j = jsm.batch_scan_match(tile_j(corner), tile_j(surf), ref_c, ref_s,
                                 jnp.asarray(x0), JSM())
    res_t = tsm.batch_scan_match(chip_smoke.tile(_cloud(corner), B),
                                 chip_smoke.tile(_cloud(surf), B), _cloud(ref_c),
                                 _cloud(ref_s), _t(x0), TSM())
    t = _compare(res_t, res_j)
    assert t["success"].all() and np.asarray(res_j.success).all()
    assert t["x"].shape == (B, 6)


def test_bench_problem_batch_solve_at_knn8_matches_jax(bench_problem):
    # ScanMatchConfig(knn=8): tests/test_io.py's k, a neighbourhood the card
    # serves from its register lists like 5 and 10
    B = 2
    x0 = (0.02 * np.random.RandomState(8).randn(B, 6)).astype(np.float32)
    tile_j = lambda c: jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), c)
    corner, surf, ref_c, ref_s = bench_problem
    res_j = jsm.batch_scan_match(tile_j(corner), tile_j(surf), ref_c, ref_s,
                                 jnp.asarray(x0), JSM(knn=8))
    res_t = tsm.batch_scan_match(chip_smoke.tile(_cloud(corner), B),
                                 chip_smoke.tile(_cloud(surf), B), _cloud(ref_c),
                                 _cloud(ref_s), _t(x0), TSM(knn=8))
    t = _compare(res_t, res_j)
    assert t["success"].all() and t["x"].shape == (B, 6)
