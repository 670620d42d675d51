"""Port vs JAX package: the whole single-stream sweep
(``models/fused``: ``init_sweep`` -> ``odometry_sweep`` / ``mapping_sweep``)
over the drive of tests/test_pipeline.py::TestFusedSteps: 16 x 512 sweeps,
0.35 m per sweep in make_room_world(seed=31), mapping on every second sweep,
on a 7 x 3 x 7 map of 20 m cubes.

Both packages get the same sweeps (the JAX simulator's, bridged).  The port
runs its fused steps, its own feature extraction included.  The JAX side
runs the same composition as ``models/fused.py`` (extract -> odometry step
-> merged pose or mapping step) with two differences that keep it the
reference and keep the test inside its time: extraction runs op by op
(``features._extract_impl`` outside ``jit``), because under ``jit`` XLA
re-associates the curvature sums and reorders exact curvature ties on the
flat floor (ROADMAP Queue 3), which moves the poses by up to ~1e-3; and the
stages stay jitted, because the whole sweep under ``jax.disable_jit()``
takes ~120 s on one CPU thread.

Tolerances: poses within 2e-3 (the tolerance between NN paths in
tests/test_odometry.py; they agree to ~2e-6 here), map points within 1e-4 m,
and the final position within TestFusedSteps' own 0.3 m of the simulator's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_tpu.models import fused as jfused  # noqa: E402
from cooper_mapper_tpu.models import laser_mapping as jlm  # noqa: E402
from cooper_mapper_tpu.models import laser_odometry as jlo  # noqa: E402
from cooper_mapper_tpu.ops import features as jfeat  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.models import fused as tfused  # noqa: E402

POSE_TOL, POINT_TOL, GT_TOL = 2e-3, 1e-4, 0.3
N_SWEEPS, STEP_M = 6, 0.35


def _cfg(m):
    """TestFusedSteps' configuration (tests/test_pipeline.py:252-263)."""
    return m.PipelineConfig(
        registration=m.RegistrationConfig(n_rings=16, max_points_per_ring=512),
        scan_match=m.ScanMatchConfig(score_threshold=50.0),
        feature_map=m.MapConfig(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=1024,
                                surf_cube_capacity=2048, surround_corner_capacity=8192,
                                surround_surf_capacity=16384, valid_distance=60.0),
        matcher=m.MatcherConfig(max_frame_corner=2048, max_frame_surf=4096))


def _jax_sweep(st, sw, cfg, i):
    """models/fused.py's step i with op-by-op extraction: (state', pose, ok)."""
    fc, _ = jfeat._extract_impl(sw, cfg.registration)
    if i == 0:
        return jfused.FusedState(jlo.init_step(st.odo, fc, cfg.odometry), st.matcher, st.map), \
            None, None
    odo, out = jlo.step(st.odo, fc, cfg.odometry)
    if i % 2 == 0:
        matcher, map_state, mo = jlm.mapping_step(
            st.matcher, st.map, out.corner_for_map, out.surf_for_map, out.T_sum,
            cfg.scan_match, cfg.matcher, cfg.feature_map)
        return jfused.FusedState(odo, matcher, map_state), mo.W, mo.result.success
    return (jfused.FusedState(odo, st.matcher, st.map),
            jlm.merged_pose(st.matcher, out.T_sum), None)


def _port_sweep(st, sw, cfg, i):
    if i == 0:
        return tfused.init_sweep(st, sw, cfg), None, None
    if i % 2 == 0:
        return tfused.mapping_sweep(st, sw, cfg)
    st, W, _ = tfused.odometry_sweep(st, sw, cfg)
    return st, W, None


@pytest.fixture(scope="module")
def drives():
    world = jsim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=31)
    p = np.eye(4, dtype=np.float32)
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = STEP_M
    sweeps = []
    for _ in range(N_SWEEPS):
        sweeps.append(jsim.scan_sweep(world, jnp.asarray(p), jnp.asarray(p @ step), n_rings=16,
                                      width=512))
        p = p @ step
    out = {}
    for name, make, run, cfg, to_port in (
            ("jax", jfused.create, _jax_sweep, _cfg(jc), lambda s: s),
            ("port", lambda c: tfused.create(c, device="cpu"), _port_sweep, _cfg(tc),
             lambda s: bridge.sweep(s, "cpu"))):
        st, poses, oks = make(cfg), [], []
        for i, sw in enumerate(sweeps):
            st, W, ok = run(st, to_port(sw), cfg, i)
            if W is not None:
                poses.append(np.asarray(W))
            if ok is not None:
                oks.append(bool(ok))
        out[name] = dict(state=st, poses=poses, oks=oks)
    return out


def test_sweep_poses_match_jax(drives):
    jax_poses, port_poses = drives["jax"]["poses"], drives["port"]["poses"]
    assert len(port_poses) == N_SWEEPS - 1
    for k, (got, want) in enumerate(zip(port_poses, jax_poses)):
        np.testing.assert_allclose(got, want, atol=POSE_TOL, err_msg=f"sweep {k + 1}")
    # the first mapping sweep finds an empty map, the second solves
    assert drives["port"]["oks"] == drives["jax"]["oks"] == [False, True]


def test_sweep_tracks_the_ground_truth(drives):
    # TestFusedSteps' bound: 5 sweeps of 0.35 m forward (the sensor's +z)
    pos = drives["port"]["poses"][-1][:3, 3]
    gt = np.array([0.0, 0.0, STEP_M * (N_SWEEPS - 1)])
    assert np.linalg.norm(pos - gt) < GT_TOL, (pos, gt)
    assert int(drives["port"]["state"].map.surf.count.sum()) > 0


def test_sweep_state_matches_jax(drives):
    sj, st = drives["jax"]["state"], drives["port"]["state"]
    np.testing.assert_allclose(st.odo.T_sum.numpy(), np.asarray(sj.odo.T_sum), atol=POSE_TOL)
    np.testing.assert_allclose(st.matcher.W_last.numpy(), np.asarray(sj.matcher.W_last),
                               atol=POSE_TOL)
    np.testing.assert_array_equal(st.map.origin.numpy(), np.asarray(sj.map.origin))
    for ct, cj in ((st.map.corner, sj.map.corner), (st.map.surf, sj.map.surf)):
        np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        np.testing.assert_allclose(ct.xyz.numpy(), np.asarray(cj.xyz), atol=POINT_TOL)
