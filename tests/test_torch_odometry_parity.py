"""Port vs JAX package: the odometry parity mode through its entry points.

``batch_odometry_solve(parity_mode=True)`` at B = 4 against the per-lane
``odometry_solve`` (the same arithmetic lane by lane: within 1e-6) and
against the JAX package's vmapped solve; and ``models/laser_odometry.step``
in parity mode over a three-sweep drive against the JAX package's, sweep by
sweep.  Both packages get the same feature clouds (the JAX extractor's,
bridged).  Twists within 2e-3, the tolerance between equivalent
nearest-neighbour paths (tests/test_odometry.py).  The C++ oracle holds the
same mode in tests/test_torch_parity_golden.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.models import laser_odometry as jlo  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat, odometry as jodo  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.models import laser_odometry as tlo  # noqa: E402
from cooper_mapper_torch.ops import odometry as todo  # noqa: E402
from cooper_mapper_torch.utils.cloud import Cloud  # noqa: E402

SOLVE_ATOL, LANE_ATOL = 2e-3, 1e-6
REG = dict(n_rings=16, max_points_per_ring=256, max_sharp=128, max_less_sharp=512,
           max_flat=256, max_less_flat=2048)


def _drive(n, yaw=0.0):
    """n sweeps of a drive in make_room_world(seed=31), 0.35 m and ``yaw``
    rad per sweep, 16 x 256, and their JAX features."""
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=31)
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    c, s = np.cos(yaw), np.sin(yaw)
    step = np.array([[c, 0, s, 0.1], [0, 1, 0, 0], [-s, 0, c, 0.35], [0, 0, 0, 1]], np.float32)
    feats = []
    for _ in range(n):
        sw = jsim.scan_sweep(world, jnp.asarray(p), jnp.asarray(p @ step), n_rings=16,
                             width=REG["max_points_per_ring"])
        feats.append(jfeat.extract_features(sw, jc.RegistrationConfig(**REG)))
        p = p @ step
    return feats


def test_batch_parity_equals_per_lane_and_jax_vmap():
    B = 4
    prev, cur = _drive(2, yaw=0.03)
    x0 = (0.02 * np.random.RandomState(0).randn(B, 6)).astype(np.float32)
    tile_j = lambda c: jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), c)
    xj, stj = jodo.batch_odometry_solve(tile_j(cur.sharp), tile_j(cur.flat), prev.less_sharp,
                                        prev.less_flat, jnp.asarray(x0), jc.OdometryConfig(),
                                        parity_mode=True)
    t = lambda c: bridge.cloud(c, "cpu")
    tile_t = lambda c: Cloud(*(a[None].expand((B,) + tuple(a.shape)).contiguous()
                               for a in (c.xyz, c.mask, c.ring, c.rel_time)))
    cfg = tc.OdometryConfig()
    xt, stt = todo.batch_odometry_solve(tile_t(t(cur.sharp)), tile_t(t(cur.flat)),
                                        t(prev.less_sharp), t(prev.less_flat),
                                        torch.from_numpy(x0), cfg, parity_mode=True)
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=SOLVE_ATOL)
    np.testing.assert_array_equal(stt.converged.numpy(), np.asarray(stj.converged))
    for b in range(B):
        xb, _ = todo.odometry_solve(t(cur.sharp), t(cur.flat), t(prev.less_sharp),
                                    t(prev.less_flat), torch.from_numpy(x0[b]), cfg,
                                    parity_mode=True)
        np.testing.assert_allclose(xb.numpy(), xt[b].numpy(), atol=LANE_ATOL)
    # the parity dynamics are not the native ones
    xn, _ = todo.batch_odometry_solve(tile_t(t(cur.sharp)), tile_t(t(cur.flat)),
                                      t(prev.less_sharp), t(prev.less_flat),
                                      torch.from_numpy(x0), cfg)
    assert float((xn - xt).abs().max()) > 1e-4


@pytest.fixture
def jax_eigh(monkeypatch):
    """Route the port's ``torch.linalg.eigh`` through JAX's.  The drive's
    first solve is degenerate at iteration 0, and the row-zeroing projector
    follows each eigenvector's sign, which torch's LAPACK and jaxlib's
    choose differently there (ROADMAP Queue 3): with JAX's eigenvectors the
    rest of the port is held to the JAX package."""
    def eigh(A):
        w, V = jnp.linalg.eigh(jnp.asarray(A.numpy()))
        return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(V))
    monkeypatch.setattr(torch.linalg, "eigh", eigh)


def test_laser_odometry_parity_drive_matches_jax(jax_eigh):
    feats = _drive(4, yaw=0.02)
    cfg_j, cfg_t = jc.OdometryConfig(), tc.OdometryConfig()
    sj = jlo.init_step(jlo.create(REG["max_less_sharp"], REG["max_less_flat"]), feats[0], cfg_j,
                       parity_mode=True)
    st = tlo.init_step(tlo.create(REG["max_less_sharp"], REG["max_less_flat"], "cpu"),
                       bridge.feature_clouds(feats[0], "cpu"), cfg_t, parity_mode=True)
    for fc in feats[1:]:
        sj, oj = jlo.step(sj, fc, cfg_j, parity_mode=True)
        st, ot = tlo.step(st, bridge.feature_clouds(fc, "cpu"), cfg_t, parity_mode=True)
        np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), atol=SOLVE_ATOL)
        np.testing.assert_allclose(ot.T_sum.numpy(), np.asarray(oj.T_sum), atol=SOLVE_ATOL)
        assert bool(ot.converged) == bool(oj.converged)
        assert abs(float(ot.n_matched) - float(oj.n_matched)) <= 2
    # three sweeps of 0.35 m forward (the sensor's +z)
    assert abs(float(st.T_sum[2, 3]) - 1.05) < 0.15, st.T_sum


def test_parity_drive_sinks_as_the_jax_packages_does(jax_eigh):
    """benchmarks/bench_realtime.py's straight drive (0.35 m per sweep, level)
    at 16 x 512, laser_odometry in parity mode: the reference's s-scaled warp
    without a de-warp couples each solve to the previous sweep's projection
    error (OdometryConfig.cv_dewarp), and the height runs away, in the JAX
    package as in the port.  The port follows it sweep by sweep.

    The first solve is degenerate at iteration 0 with its two small
    eigenvalues' eigenvectors signed differently by the jitted solve than by
    an eager ``jnp.linalg.eigh`` of the same system, so the JAX package runs
    op by op here (``jax.disable_jit``), with the eigensolver the port is
    given."""
    from benchmarks.bench_realtime import build_sweeps

    reg = dict(REG, max_points_per_ring=512)
    feats = [jfeat.extract_features(sw, jc.RegistrationConfig(**reg))
             for sw in build_sweeps(8, width=512)]
    cfg_j, cfg_t = jc.OdometryConfig(), tc.OdometryConfig()
    sj = jlo.init_step(jlo.create(reg["max_less_sharp"], reg["max_less_flat"]), feats[0], cfg_j)
    st = tlo.init_step(tlo.create(reg["max_less_sharp"], reg["max_less_flat"], "cpu"),
                       bridge.feature_clouds(feats[0], "cpu"), cfg_t)
    for fc in feats[1:]:
        with jax.disable_jit():
            sj, oj = jlo.step(sj, fc, cfg_j, parity_mode=True)
        st, ot = tlo.step(st, bridge.feature_clouds(fc, "cpu"), cfg_t, parity_mode=True)
        np.testing.assert_allclose(ot.T_sum.numpy(), np.asarray(oj.T_sum), atol=SOLVE_ATOL)
    height = float(st.T_sum[1, 3])
    print(f"parity drive: height after 7 sweeps {height:.4f} m (JAX {float(oj.T_sum[1, 3]):.4f})")
    assert height < -0.1          # 2.45 m of level drive
