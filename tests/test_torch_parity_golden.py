"""Port vs the literal C++ transcription: the parity modes of the odometry
and scan-to-map solves against ``tests/ref_oracle.py`` (float64 numpy,
LaserOdometry.cpp:328-647 and ScanMatch.cpp:51-347), iteration by iteration.

Every test of tests/test_parity_golden.py (TestGoldenTrace, TestKernelParity,
TestScanMatchGolden) and of tests/test_odometry.py::TestParityMode, with the
port in place of the JAX package, on the same scenes (built with the JAX
simulator and extractor, bridged) and at the same tolerances: the odometry
trace within 3e-4, the scan-to-map trace within 2e-3.  The teeth tests
(a wrong residual scale, a wrong weight slope) must diverge as they do for
the JAX package.  The degenerate scan-to-map scene exercises the
row-zeroing projector, whose answer depends on the eigenvector signs; on
the CPU torch's eigh returns numpy's signs there (ROADMAP Queue 3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tests import ref_oracle  # noqa: E402
from cooper_mapper_tpu.config import RegistrationConfig as JReg  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_tpu.ops.voxel import voxel_downsample as jvoxel  # noqa: E402
from cooper_mapper_tpu.utils import twist as jtwist  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.config import OdometryConfig, ScanMatchConfig  # noqa: E402
from cooper_mapper_torch.ops import gauss_newton as gn  # noqa: E402
from cooper_mapper_torch.ops import odometry as odo_ops  # noqa: E402
from cooper_mapper_torch.ops import residuals  # noqa: E402
from cooper_mapper_torch.ops import scan_match as sm_ops  # noqa: E402
from cooper_mapper_torch.utils import cloud as cloud_lib, se3, twist  # noqa: E402

ODO_TOL = 3e-4      # tests/test_parity_golden.py::TestGoldenTrace
SM_TOL = 2e-3       # tests/test_parity_golden.py::TestScanMatchGolden


def _ring_major_dense(c):
    """Valid points of a JAX Cloud, ring-major sorted (ring asc, azimuth
    asc), the layout the reference's index walks assume."""
    m = np.asarray(c.mask)
    xyz, ring, rel = np.asarray(c.xyz)[m], np.asarray(c.ring)[m], np.asarray(c.rel_time)[m]
    order = np.lexsort((rel, ring))
    return xyz[order], ring[order], rel[order]


def _cloud(xyz, cap, ring=None, rel=None):
    return cloud_lib.from_points(np.asarray(xyz, np.float32), capacity=cap, ring=ring,
                                 rel_time=rel, device="cpu")


def _step_pose():
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = 0.3
    c, s = np.cos(0.02), np.sin(0.02)
    step[0, 0], step[0, 2], step[2, 0], step[2, 2] = c, s, -s, c
    return p0, step


# ---------------------------------------------------------------------------
# odometry: LaserOdometry::scanMatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweep_pair():
    """tests/test_parity_golden.py::sweep_pair: sweep 1 solved against
    sweep 0's less-sharp / less-flat clouds, 8 x 256."""
    world = jsim.make_room_world(size=(24.0, 4.0, 30.0), n_pillars=6, seed=5)
    cfg_r = JReg(n_rings=8, max_points_per_ring=256, max_sharp=64, max_less_sharp=512,
                 max_flat=128, max_less_flat=2048)
    p0, step = _step_pose()
    p1 = p0 @ step
    p2 = p1 @ step
    fc0 = jfeat.extract_features(jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p1),
                                                 n_rings=8, width=256), cfg_r)
    fc1 = jfeat.extract_features(jsim.scan_sweep(world, jnp.asarray(p1), jnp.asarray(p2),
                                                 n_rings=8, width=256), cfg_r)
    refc = _ring_major_dense(fc0.less_sharp)
    refs = _ring_major_dense(fc0.less_flat)
    sharp = _ring_major_dense(fc1.sharp)
    flat = _ring_major_dense(fc1.flat)
    clouds = (_cloud(sharp[0], 128, sharp[1], sharp[2]), _cloud(flat[0], 512, flat[1], flat[2]),
              _cloud(refc[0], 512, refc[1], refc[2]), _cloud(refs[0], 2048, refs[1], refs[2]))
    return dict(refc=refc, refs=refs, sharp=sharp, flat=flat, clouds=clouds)


@pytest.fixture(scope="module")
def golden_trace(sweep_pair):
    sp = sweep_pair
    f64 = lambda a: a.astype(np.float64)
    return ref_oracle.odometry_scan_match(
        f64(sp["sharp"][0]), f64(sp["sharp"][2]), f64(sp["flat"][0]), f64(sp["flat"][2]),
        f64(sp["refc"][0]), sp["refc"][1], f64(sp["refs"][0]), sp["refs"][1])


def _solve_parity(sweep_pair, k, **changes):
    cfg = OdometryConfig(max_iterations=k, n_rings=8, **changes)
    x, st = odo_ops.odometry_solve(*sweep_pair["clouds"], torch.zeros(6), cfg, parity_mode=True)
    return x.numpy(), st


class TestGoldenTrace:
    def test_oracle_is_meaningful(self, golden_trace):
        """The oracle converges toward the simulated motion on this scene
        (z ~ 0.3 m forward, yaw ~ 0.02)."""
        x_final = golden_trace[-1].x
        assert len(golden_trace) >= 5 and golden_trace[0].n_selected > 50
        assert x_final[5] > 0.05, f"no forward progress: {x_final}"
        assert abs(x_final[3]) < 0.2 and abs(x_final[4]) < 0.2

    @pytest.mark.parametrize("k", [1, 2, 5, 7, 10, 25])
    def test_iteration_trace_matches(self, sweep_pair, golden_trace, k):
        """The port's parity solve after k iterations equals the oracle's
        trace: the -0.05 dynamics, the refresh schedule, the weight rule
        after iteration 5 and the arz quirk all show here."""
        x, _ = _solve_parity(sweep_pair, k)
        rec = golden_trace[min(k, len(golden_trace)) - 1]
        err = np.abs(x - rec.x)
        assert np.all(err < ODO_TOL), f"iter {k}: port {x} vs oracle {rec.x} (|err| {err})"

    def test_matched_count_matches(self, sweep_pair, golden_trace):
        _, st = _solve_parity(sweep_pair, 25)
        n = int(st.n_matched[0])
        counts = {r.iteration: r.n_selected for r in golden_trace}
        assert any(abs(n - c) <= 2 for c in counts.values()), (n, counts)

    def test_refresh_schedule_divergence_detected(self, sweep_pair, golden_trace):
        """Teeth: a wrong residual scale (0.10 for 0.05) visibly diverges."""
        x_bad, _ = _solve_parity(sweep_pair, 10, residual_scale=0.10)
        rec = golden_trace[min(10, len(golden_trace)) - 1]
        assert np.max(np.abs(x_bad - rec.x)) > 1e-3


class TestKernelParity:
    def test_arz_typo_row(self):
        """_reference_jacobian_rows(port_typo=True) equals the literal C++
        rows, the missing-parenthesis arz term included."""
        rng = np.random.RandomState(0)
        x = rng.randn(6).astype(np.float32) * 0.3
        pts = rng.randn(32, 3).astype(np.float32)
        dirs = rng.randn(32, 3).astype(np.float32)
        J = odo_ops._reference_jacobian_rows(torch.from_numpy(x)[None], torch.from_numpy(pts)[None],
                                             torch.from_numpy(dirs)[None], port_typo=True)[0]
        for i in range(32):
            row = ref_oracle.jacobian_row(x.astype(np.float64), pts[i].astype(np.float64),
                                          dirs[i].astype(np.float64))
            np.testing.assert_allclose(J[i].numpy(), row, rtol=1e-4, atol=1e-5)

    def test_typo_differs_from_exact(self):
        """At nonzero pitch the typo'd row differs from the derivative."""
        x = torch.tensor([[0.05, 0.2, 0.1, 0, 0, 0]])
        pts = torch.tensor([[[1.0, 2.0, 3.0]]])
        dirs = torch.tensor([[[0.0, 1.0, 0.0]]])
        J_typo = odo_ops._reference_jacobian_rows(x, pts, dirs, port_typo=True)
        J_fix = odo_ops._reference_jacobian_rows(x, pts, dirs)
        assert abs(float(J_typo[0, 0, 2] - J_fix[0, 0, 2])) > 1e-3

    def test_projector_row_zeroing(self, monkeypatch):
        """The reference-mode projector equals the oracle's
        inv(V) @ rows-zeroed(V) on the JAX test's matrix (well separated
        eigenvalues).  P depends on each eigenvector's sign, and torch's
        LAPACK (MKL) returns another sign than numpy's on one column of this
        matrix, so the oracle is given the port's eigenvectors, aligned in
        sign, in place of its own (ROADMAP Queue 3); the port's P must then
        equal it, and must differ from the oracle's own exactly where a sign
        differs."""
        rng = np.random.RandomState(1)
        Q, _ = np.linalg.qr(rng.randn(6, 6))
        evals = np.array([0.5, 3.0, 20.0, 40.0, 80.0, 200.0])
        A = (Q @ np.diag(evals) @ Q.T).astype(np.float32)
        P, deg = gn.degeneracy_projector(torch.from_numpy(A), 10.0, reference_mode=True)
        P_own, deg_np = ref_oracle.degeneracy_projector(A, 10.0)
        assert bool(deg) and deg_np
        _, Vt = torch.linalg.eigh(torch.from_numpy(A))
        np_eigh = np.linalg.eigh

        def eigh_with_torch_signs(M):
            w, V = np_eigh(M)
            return w, V * np.sign((V * Vt.numpy()).sum(0))
        monkeypatch.setattr(ref_oracle.np.linalg, "eigh", eigh_with_torch_signs)
        P_np, _ = ref_oracle.degeneracy_projector(A, 10.0)
        np.testing.assert_allclose(P.numpy(), P_np, atol=5e-3)
        same = (np_eigh(A)[1] * Vt.numpy()).sum(0) > 0
        if same.all():
            np.testing.assert_allclose(P.numpy(), P_own, atol=5e-3)
        else:
            assert np.abs(P.numpy() - P_own).max() > 5e-3

    def test_coefficients_match(self):
        rng = np.random.RandomState(2)
        A, B, C = (rng.randn(16, 3).astype(np.float32) for _ in range(3))
        X = rng.randn(16, 3).astype(np.float32) + 3.0
        t = torch.from_numpy
        f64 = lambda a: a.astype(np.float64)
        for it in (0, 6):
            d_c, r_c, ok_c = residuals.corner_coeff_odometry(t(A), t(B), t(X), it)
            d_s, r_s, ok_s = residuals.surf_coeff_odometry(t(A), t(B), t(C), t(X), it)
            for i in range(16):
                c_np, in_np, ok_np = ref_oracle.corner_coefficients(f64(A[i]), f64(B[i]),
                                                                    f64(X[i]), it)
                np.testing.assert_allclose(d_c[i].numpy(), c_np, rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(float(r_c[i]), in_np, rtol=1e-4, atol=1e-4)
                assert bool(ok_c[i]) == ok_np
                c_np, in_np, ok_np = ref_oracle.surf_coefficients(f64(A[i]), f64(B[i]),
                                                                  f64(C[i]), f64(X[i]), it)
                np.testing.assert_allclose(d_s[i].numpy(), c_np, rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(float(r_s[i]), in_np, rtol=1e-4, atol=1e-4)
                assert bool(ok_s[i]) == ok_np


# ---------------------------------------------------------------------------
# scan-to-map: ScanMatch::scanMatchScan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def map_scene():
    """tests/test_parity_golden.py::map_scene: sweep 0's voxel-filtered
    features at ground truth form the map (jittered 1 cm so every 5-NN plane
    fit is well posed); sweep 1's are solved from a perturbed guess."""
    world = jsim.make_room_world(size=(24.0, 4.0, 30.0), n_pillars=6, seed=5)
    cfg_r = JReg(n_rings=16, max_points_per_ring=512, max_sharp=128, max_less_sharp=1024,
                 max_flat=256, max_less_flat=4096)
    p0, step = _step_pose()
    p1 = p0 @ step
    fc0 = jfeat.extract_features(jsim.scan_sweep(world, jnp.asarray(p0), jnp.asarray(p0),
                                                 n_rings=16, width=512), cfg_r)
    fc1 = jfeat.extract_features(jsim.scan_sweep(world, jnp.asarray(p1), jnp.asarray(p1),
                                                 n_rings=16, width=512), cfg_r)

    def valid(c, leaf):
        d = jvoxel(c, leaf)
        return np.asarray(d.xyz)[np.asarray(d.mask)]

    world_frame = lambda xyz, T: (T[:3, :3] @ xyz.T).T + T[:3, 3]
    rng = np.random.RandomState(7)
    ref_c = world_frame(valid(fc0.less_sharp, 0.2), p0)
    ref_s = world_frame(valid(fc0.less_flat, 0.4), p0)
    ref_c = ref_c + 0.01 * rng.randn(*ref_c.shape).astype(np.float32)
    ref_s = ref_s + 0.01 * rng.randn(*ref_s.shape).astype(np.float32)
    x_true = np.asarray(jtwist.from_mat(jnp.asarray(p1)), np.float64)
    x0 = x_true + np.array([0.01, -0.008, 0.012, 0.05, -0.04, 0.06])
    return dict(name="map", ref_c=ref_c, ref_s=ref_s, q_c=valid(fc1.less_sharp, 0.2),
                q_s=valid(fc1.flat, 0.4), x0=x0, x_true=x_true)


SM_CFG = ScanMatchConfig(score_threshold=50.0)   # the JAX test's, scaled to ~300 queries


_ORACLE_RUNS = {}


def _run_oracle(scene, iters, eig_threshold=100.0):
    f64 = lambda a: a.astype(np.float64)
    return ref_oracle.scan_match_scan(
        f64(scene["ref_c"]), f64(scene["ref_s"]), f64(scene["q_c"]), f64(scene["q_s"]),
        scene["x0"], max_iterations=iters, score_threshold=SM_CFG.score_threshold,
        eig_threshold=eig_threshold)


def _oracle_sm(scene, iters, eig_threshold=100.0):
    """ref_oracle.scan_match_scan on ``scene``, each run once per module."""
    key = (scene["name"], iters, eig_threshold)
    if key not in _ORACLE_RUNS:
        _ORACLE_RUNS[key] = _run_oracle(scene, iters, eig_threshold)
    return _ORACLE_RUNS[key]


def _port_sm(scene, iters, cfg=None):
    cfg = dataclasses.replace(cfg or SM_CFG, max_iterations=iters)
    return sm_ops.scan_match(_cloud(scene["q_c"], 256), _cloud(scene["q_s"], 512),
                             _cloud(scene["ref_c"], 1024), _cloud(scene["ref_s"], 4096),
                             torch.from_numpy(scene["x0"].astype(np.float32)), cfg,
                             parity_mode=True)


@pytest.fixture(scope="module")
def decimated_scene(map_scene):
    return dict(map_scene, name="decimated", ref_c=map_scene["ref_c"][::8],
                ref_s=map_scene["ref_s"][::8])


class TestScanMatchGolden:
    def test_oracle_is_meaningful(self, map_scene):
        """The oracle converges and accepts; the scene is degenerate at the
        eigen-100 threshold, so the projector path is exercised."""
        out = _oracle_sm(map_scene, 10)
        assert out.converged and out.accepted
        err0 = np.linalg.norm(map_scene["x0"] - map_scene["x_true"])
        assert np.linalg.norm(out.x - map_scene["x_true"]) <= err0 * 1.05
        assert out.trace[0].n_selected >= 50 and out.trace[0].is_degenerate

    def test_nondegenerate_solves_to_truth(self, map_scene):
        """At the odometry's threshold (10) the scene is non-degenerate: the
        port follows the oracle's full-update dynamics to the pose."""
        golden = _oracle_sm(map_scene, 10, eig_threshold=10.0)
        assert golden.converged or np.abs(golden.trace[-1].dx).max() < 0.02
        err = np.abs(golden.x - map_scene["x_true"])
        assert np.all(err[:3] < 6e-3) and np.all(err[3:5] < 3e-2), err
        res = _port_sm(map_scene, 10, dataclasses.replace(SM_CFG, eig_threshold=10.0))
        d = np.abs(res.x.numpy().astype(np.float64) - golden.trace[-1].x)
        assert np.all(d < SM_TOL), (res.x.numpy(), golden.trace[-1].x)

    @pytest.mark.parametrize("k", [1, 3, 10])
    def test_iteration_trace_matches(self, map_scene, k):
        """The port's parity scan match equals the oracle's trace: the 5-NN
        gate, the line and plane fits, the map-variant weights and the
        eigen-100 row-zeroing projector."""
        golden = _oracle_sm(map_scene, 10)
        res = _port_sm(map_scene, k)
        rec = golden.trace[min(k, len(golden.trace)) - 1]
        err = np.abs(res.x.numpy().astype(np.float64) - rec.x)
        assert np.all(err < SM_TOL), f"iter {k}: port {res.x.numpy()} vs oracle {rec.x} ({err})"

    def test_matched_count_and_score_match(self, map_scene):
        golden = _oracle_sm(map_scene, 10)
        res = _port_sm(map_scene, 10)
        counts = [r.n_selected for r in golden.trace]
        assert any(abs(int(res.n_matched) - n) <= 3 for n in counts), (int(res.n_matched), counts)
        # the port scores at the post-update pose, the oracle at the break
        # iteration's pre-update pose: equal within the sub-threshold step
        assert abs(float(res.score) - golden.score) / golden.score < 0.02
        assert abs(float(res.match_fraction) - golden.percent) < 0.02

    def test_gate_accepts_good_scene(self, map_scene):
        assert _oracle_sm(map_scene, 10).accepted and bool(_port_sm(map_scene, 10).success)

    def test_gate_rejects_decimated_reference(self, decimated_scene):
        """An 8x-decimated map starves the 5-NN gate: both reject, on the
        match percentage."""
        golden = _oracle_sm(decimated_scene, 10)
        res = _port_sm(decimated_scene, 10)
        assert not golden.accepted and not bool(res.success)
        assert golden.percent < 0.4 and float(res.match_fraction) < 0.4

    def test_wrong_weight_slope_diverges(self, map_scene):
        """Teeth: a wrong robust-weight slope diverges from the trace."""
        golden = _oracle_sm(map_scene, 5)
        res = _port_sm(map_scene, 5, dataclasses.replace(SM_CFG, weight_slope=0.3))
        rec = golden.trace[min(5, len(golden.trace)) - 1]
        assert np.max(np.abs(res.x.numpy().astype(np.float64) - rec.x)) > 5e-4


def test_eigenvector_signs_move_the_degenerate_solve(map_scene, monkeypatch):
    """The row-zeroing projector's hazard on the degenerate scene: the
    oracle fed numpy's eigenvectors with random column signs ends far
    outside the trace tolerance, while torch's own signs (MKL on the CPU)
    leave it where numpy's do."""
    own = _oracle_sm(map_scene, 10).x
    np_eigh = np.linalg.eigh
    rng = np.random.RandomState(0)

    def signed(sign_of):
        def eigh(M):
            w, V = np_eigh(M)
            return (w, V * sign_of(M, V)) if M.shape == (6, 6) else (w, V)
        monkeypatch.setattr(np.linalg, "eigh", eigh)
        return np.abs(_run_oracle(map_scene, 10).x - own).max()

    flips = [signed(lambda M, V: rng.choice([-1.0, 1.0], 6)) for _ in range(8)]
    torch_v = lambda M: torch.linalg.eigh(torch.from_numpy(M.astype(np.float32)))[1].double()
    by_torch = signed(lambda M, V: np.sign((V * torch_v(M).numpy()).sum(0)))
    print(f"final pose moved by random sign flips {np.round(flips, 6).tolist()}, by torch's "
          f"signs {by_torch:.3g}")
    assert max(flips) > SM_TOL and by_torch < 1e-6


# ---------------------------------------------------------------------------
# tests/test_odometry.py::TestParityMode
# ---------------------------------------------------------------------------


def test_parity_mode_converges():
    """The reference-dynamics mode reaches the optimum of a 0.3 m forward,
    0.2 m lateral motion from a cold start in 100 iterations
    (LaserOdometry.cpp:512-575)."""
    world = jsim.make_room_world(seed=7)
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    motion = np.eye(4, dtype=np.float32)
    motion[0, 3], motion[2, 3] = 0.2, 0.3
    cfg_r = JReg(n_rings=16, max_points_per_ring=512)
    feats = [jfeat.extract_features(jsim.scan_sweep(world, jnp.asarray(a), jnp.asarray(b),
                                                    n_rings=16, width=512), cfg_r)
             for a, b in ((p0, p0), (p0, p0 @ motion))]
    prev, cur = (bridge.feature_clouds(f, "cpu") for f in feats)
    x, st = odo_ops.odometry_solve(cur.sharp, cur.flat, prev.less_sharp, prev.less_flat,
                                   torch.zeros(6), OdometryConfig(max_iterations=100),
                                   parity_mode=True)
    err = se3.se3_log(se3.inverse(torch.from_numpy(motion)) @ twist.to_relative_motion(x))
    assert float(err[:3].norm()) < 0.08, f"trans err {err}"
    assert bool(st.converged[0]) and bool(torch.isfinite(x).all())
