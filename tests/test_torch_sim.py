"""Port vs JAX package: the ray-cast room world and the simulated sweep."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.io import sim as jsim  # noqa: E402
from cooper_mapper_torch.io import sim as tsim  # noqa: E402

WIDTH = 512


def _bench_poses():
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    c, s = np.cos(0.02), np.sin(0.02)
    motion = np.array([[c, 0, s, 0.1], [0, 1, 0, 0], [-s, 0, c, 0.35], [0, 0, 0, 1]], np.float32)
    return p0, p0 @ motion


@pytest.mark.parametrize("seed", [0, 42])
def test_room_world_is_identical(seed):
    wj = jsim.make_room_world(seed=seed)
    wt = tsim.make_room_world(seed=seed, device="cpu")
    for f in ("origin", "u", "v"):
        np.testing.assert_array_equal(getattr(wt, f).numpy(), np.asarray(getattr(wj, f)))


def _sweeps(p_start, p_end):
    wj = jsim.make_room_world(seed=42)
    wt = tsim.make_room_world(seed=42, device="cpu")
    sj = jsim.scan_sweep(wj, jnp.asarray(p_start), jnp.asarray(p_end), n_rings=16, width=WIDTH)
    st = tsim.scan_sweep(wt, torch.from_numpy(p_start), torch.from_numpy(p_end), 16, WIDTH)
    return sj, st


def test_static_sweep_matches():
    p0, _ = _bench_poses()
    sj, st = _sweeps(p0, p0)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.xyz.numpy(), np.asarray(sj.xyz), atol=1e-5)
    np.testing.assert_allclose(st.rel_time.numpy(), np.asarray(sj.rel_time), atol=1e-7)


def test_distorted_sweep_matches():
    # The per-column poses come from se3_log of the sweep motion.  Its
    # (1 - A/(2B)) / theta^2 term cancels about four digits in f32 at the
    # bench's theta = 0.02 rad, so one ulp of difference between the two
    # libraries' cos moves the interpolated translation by ~3e-5 and points
    # at ~20 m range by up to ~3e-4 m (measured 2.9e-4 at 512 columns).
    # Hence atol 1e-3 m here against 1e-5 for the static sweep above.
    p0, p1 = _bench_poses()
    sj, st = _sweeps(p0, p1)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_allclose(st.xyz.numpy(), np.asarray(sj.xyz), atol=1e-3)
