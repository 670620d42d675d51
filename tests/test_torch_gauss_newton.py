"""Port vs JAX package: normal equations, the unrolled 6x6 Cholesky solve,
the degeneracy projector and the guarded GN step.  Tolerance atol 1e-5 on
well-conditioned 6x6 systems (sums run in another order than XLA's)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.ops import gauss_newton as jgn  # noqa: E402
from cooper_mapper_torch.ops import gauss_newton as tgn  # noqa: E402

ATOL = 1e-5


def _spd(rng, B, small=None):
    """Random SPD 6x6 matrices with eigenvalues in [20, 100]; ``small``
    lanes get two eigenvalues below the degeneracy threshold (10)."""
    A = np.empty((B, 6, 6), np.float32)
    for b in range(B):
        V, _ = np.linalg.qr(rng.randn(6, 6))
        lam = rng.uniform(20, 100, 6)
        if small is not None and small[b]:
            lam[:2] = [0.5, 3.0]
        A[b] = (V * lam) @ V.T
    return A


def test_assemble_hard_zeroes_masked_nan_rows():
    rng = np.random.RandomState(0)
    B, N = 3, 64
    J = rng.randn(B, N, 6).astype(np.float32)
    b = rng.randn(B, N).astype(np.float32)
    valid = rng.rand(B, N) > 0.3
    J[~valid] = np.nan            # FAR-sentinel geometry: NaN/Inf in masked rows
    b[~valid] = np.inf
    jt = tgn.assemble_normal_eqs(torch.from_numpy(J), torch.from_numpy(b), torch.from_numpy(valid))
    jj = jgn.assemble_normal_eqs(jnp.asarray(J), jnp.asarray(b), jnp.asarray(valid))
    for got, want in zip(jt, jj):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)


def test_cholesky6_solve_matches():
    rng = np.random.RandomState(1)
    A = _spd(rng, 8)
    b = rng.randn(8, 6).astype(np.float32)
    got = tgn._cholesky6_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgn._cholesky6_solve(jnp.asarray(A), jnp.asarray(b))),
                               atol=ATOL)
    np.testing.assert_allclose(got, np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0],
                               atol=ATOL)


def test_solve_6x6_rank_deficient_stays_finite():
    rng = np.random.RandomState(2)
    Jr = rng.randn(4, 20, 6).astype(np.float32)
    Jr[..., 5] = 0.0                              # one unconstrained direction
    JtJ = np.einsum("bni,bnj->bij", Jr, Jr)
    Jtb = rng.randn(4, 6).astype(np.float32)
    got = tgn.solve_6x6(torch.from_numpy(JtJ), torch.from_numpy(Jtb))
    want = np.asarray(jgn.solve_6x6(jnp.asarray(JtJ), jnp.asarray(Jtb)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[..., :5], want[..., :5], rtol=1e-3, atol=1e-4)


def test_degeneracy_projector_matches():
    rng = np.random.RandomState(3)
    small = np.array([True, False, True, False])
    A = _spd(rng, 4, small)
    P, deg = tgn.degeneracy_projector(torch.from_numpy(A), 10.0)
    Pj, degj = jgn.degeneracy_projector(jnp.asarray(A), 10.0)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(degj))
    np.testing.assert_array_equal(deg.numpy(), small)
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), atol=ATOL)


@pytest.mark.parametrize("lm_damping", [0.0, 0.5])
def test_gn_step_matches(lm_damping):
    rng = np.random.RandomState(4)
    B = 6
    small = np.array([False, True, False, False, True, False])
    JtJ = _spd(rng, B, small)
    # large right-hand sides so the trust region clamps some lanes
    Jtb = (rng.randn(B, 6) * np.array([[1], [1], [50], [1], [1], [200]])).astype(np.float32)
    x = (0.01 * rng.randn(B, 6)).astype(np.float32)
    n_valid = np.array([50, 50, 50, 5, 50, 50], np.float32)    # lane 3: too few matches
    converged = np.array([False, False, False, False, False, True])
    kw = dict(eig_threshold=10.0, delta_r_abort=0.1, delta_t_abort=0.1, min_matched=10,
              trust_region_t=0.3, trust_region_r=0.05, min_converge_iter=0,
              compute_projector=True, lm_damping=lm_damping)

    st_t = tgn.gn_init(torch.from_numpy(x))
    st_t.converged = torch.from_numpy(converged)
    st_j = jgn.gn_init(jnp.asarray(x))
    st_j = jgn.GNState(st_j.x, st_j.P, st_j.is_degenerate, jnp.asarray(converged),
                       st_j.n_matched, st_j.iter_used)
    out_t = tgn.gn_step(st_t, torch.from_numpy(JtJ), torch.from_numpy(Jtb),
                        torch.from_numpy(n_valid), 1, **kw)
    out_j = jgn.gn_step(st_j, jnp.asarray(JtJ), jnp.asarray(Jtb), jnp.asarray(n_valid), 1, **kw)
    np.testing.assert_allclose(out_t.x.numpy(), np.asarray(out_j.x), atol=ATOL)
    np.testing.assert_allclose(out_t.P.numpy(), np.asarray(out_j.P), atol=ATOL)
    for f in ("is_degenerate", "converged", "iter_used"):
        np.testing.assert_array_equal(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)))
    assert out_t.converged.numpy().any() and not out_t.converged.numpy().all()
    # a second step reuses the stored projector
    out_t2 = tgn.gn_step(out_t, torch.from_numpy(JtJ), torch.from_numpy(Jtb),
                         torch.from_numpy(n_valid), 2, **{**kw, "compute_projector": False})
    out_j2 = jgn.gn_step(out_j, jnp.asarray(JtJ), jnp.asarray(Jtb), jnp.asarray(n_valid), 2,
                         **{**kw, "compute_projector": False})
    np.testing.assert_allclose(out_t2.x.numpy(), np.asarray(out_j2.x), atol=ATOL)
