"""Port vs JAX package: the reference mode of the Gauss-Newton machinery.

The LU solve ``solve_6x6(spd=False)`` (over one and two batch axes), the
Eigen port's row-zeroing projector ``degeneracy_projector(reference_mode=
True)`` and ``gn_step(reference_mode=True)``; and the native branch held
bit for bit to a frozen copy of its code before the reference mode joined
it.

The row-zeroing projector P = V^T Vz depends on the sign of each
eigenvector, and torch's and jaxlib's LAPACK need not return the same
signs.  So the formula is tested given the SAME eigenvectors (JAX's, fed to
the port through ``torch.linalg.eigh``), and directly only on matrices
where the two libraries' signs agree.  Tolerance atol 1e-5, as
tests/test_torch_gauss_newton.py: the LU and the products run in another
order than XLA's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.ops import gauss_newton as jgn  # noqa: E402
from cooper_mapper_torch.ops import gauss_newton as tgn  # noqa: E402

ATOL = 1e-5
KW = dict(eig_threshold=10.0, delta_r_abort=0.1, delta_t_abort=0.1, min_matched=10)


def _spd(rng, B, small=None):
    """SPD 6x6 matrices with eigenvalues in [20, 100]; ``small`` lanes get
    two well separated eigenvalues below the threshold (10)."""
    A = np.empty((B, 6, 6), np.float32)
    for b in range(B):
        V, _ = np.linalg.qr(rng.randn(6, 6))
        lam = rng.uniform(20, 100, 6)
        if small is not None and small[b]:
            lam[:2] = [0.5, 3.0]
        A[b] = (V * lam) @ V.T
    return A


def _systems(kind, batch):
    """(JtJ [*batch, 6, 6], Jtb [*batch, 6]) of one kind: SPD, rank deficient
    (one unconstrained direction) or all rows masked (zeros)."""
    rng = np.random.RandomState({"spd": 0, "rank_deficient": 1, "all_masked": 2}[kind])
    Jtb = rng.randn(4, 6).astype(np.float32)
    if kind == "spd":
        JtJ = _spd(rng, 4)
    elif kind == "rank_deficient":
        Jr = rng.randn(4, 20, 6).astype(np.float32)
        Jr[..., 5] = 0.0
        JtJ = np.einsum("bni,bnj->bij", Jr, Jr)
    else:
        JtJ, Jtb = np.zeros((4, 6, 6), np.float32), np.zeros((4, 6), np.float32)
    return JtJ.reshape(batch + (6, 6)), Jtb.reshape(batch + (6,))


@pytest.fixture
def jax_eigh(monkeypatch):
    """Route the port's ``torch.linalg.eigh`` through JAX's, so both
    packages' projectors see the same eigenvectors."""
    def eigh(A):
        w, V = jnp.linalg.eigh(jnp.asarray(A.numpy()))
        return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(V))
    monkeypatch.setattr(torch.linalg, "eigh", eigh)


@pytest.mark.parametrize("batch", [(4,), (2, 2)], ids=["B4", "B2x2"])
@pytest.mark.parametrize("kind", ["spd", "rank_deficient", "all_masked"])
def test_lu_solve_matches_jax(kind, batch):
    JtJ, Jtb = _systems(kind, batch)
    got = tgn.solve_6x6(torch.from_numpy(JtJ), torch.from_numpy(Jtb), spd=False)
    want = np.asarray(jgn.solve_6x6(jnp.asarray(JtJ), jnp.asarray(Jtb), spd=False))
    assert torch.isfinite(got).all()
    # the rank-deficient lanes' free component is b5 / 1e-12 in both
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=ATOL)
    if kind == "all_masked":
        assert not got.any()


def test_lu_solve_of_a_singular_system_is_nonfinite_as_jax():
    # rank one at 1e6: the 1e-12 floor is lost to rounding, so the LU meets
    # an exact zero pivot; neither package raises, both return inf/NaN
    v = np.arange(1, 7, dtype=np.float32)
    JtJ = (np.outer(v, v) * 1e6).astype(np.float32)[None]
    Jtb = np.ones((1, 6), np.float32)
    got = tgn.solve_6x6(torch.from_numpy(JtJ), torch.from_numpy(Jtb), spd=False)
    want = np.asarray(jgn.solve_6x6(jnp.asarray(JtJ), jnp.asarray(Jtb), spd=False))
    np.testing.assert_array_equal(torch.isfinite(got).numpy(), np.isfinite(want))
    assert not torch.isfinite(got).all()
    # and the step scrubs it: x stays finite
    st = tgn.gn_step(tgn.gn_init(torch.zeros(1, 6)), torch.from_numpy(JtJ),
                     torch.from_numpy(Jtb), torch.full((1,), 50.0), 1, **KW,
                     reference_mode=True)
    assert torch.isfinite(st.x).all()


def test_reference_projector_given_the_same_eigenvectors(jax_eigh):
    rng = np.random.RandomState(3)
    small = np.array([True, False, True, False])
    A = _spd(rng, 4, small)
    P, deg = tgn.degeneracy_projector(torch.from_numpy(A), 10.0, reference_mode=True)
    Pj, degj = jgn.degeneracy_projector(jnp.asarray(A), 10.0, reference_mode=True)
    np.testing.assert_array_equal(deg.numpy(), small)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(degj))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), atol=ATOL)
    # non-degenerate lanes keep every row: V^T V = I
    np.testing.assert_allclose(P.numpy()[~small], np.broadcast_to(np.eye(6), (2, 6, 6)),
                               atol=ATOL)


def test_reference_projector_directly_where_the_signs_agree():
    rng = np.random.RandomState(4)
    A = _spd(rng, 40, np.ones(40, bool))
    _, Vt = torch.linalg.eigh(torch.from_numpy(A))
    _, Vj = jnp.linalg.eigh(jnp.asarray(A))
    agree = ((Vt.numpy() * np.asarray(Vj)).sum(-2) > 0).all(-1)
    P, _ = tgn.degeneracy_projector(torch.from_numpy(A), 10.0, reference_mode=True)
    Pj, _ = jgn.degeneracy_projector(jnp.asarray(A), 10.0, reference_mode=True)
    print(f"torch and jaxlib agree in sign on every column of {int(agree.sum())} of 40 systems")
    assert 0 < agree.sum() < len(agree), agree.sum()
    np.testing.assert_allclose(P.numpy()[agree], np.asarray(Pj)[agree], atol=ATOL)
    # where a sign differs, so does P: the property ROADMAP Queue 3 records
    assert np.abs(P.numpy()[~agree] - np.asarray(Pj)[~agree]).max(axis=(1, 2)).min() > 1e-2


@pytest.mark.parametrize("lm_damping", [0.0, 0.5])
def test_gn_step_reference_mode_matches(jax_eigh, lm_damping):
    rng = np.random.RandomState(5)
    B = 6
    small = np.array([False, True, False, False, True, False])
    JtJ = _spd(rng, B, small)
    Jtb = (rng.randn(B, 6) * 5).astype(np.float32)
    x = (0.01 * rng.randn(B, 6)).astype(np.float32)
    n_valid = np.array([50, 50, 50, 5, 50, 50], np.float32)    # lane 3: too few matches
    converged = np.array([False, False, False, False, False, True])
    kw = dict(KW, reference_mode=True, compute_projector=True, lm_damping=lm_damping)
    st_t = tgn.gn_init(torch.from_numpy(x))
    st_t.converged = torch.from_numpy(converged)
    st_j = jgn.gn_init(jnp.asarray(x))
    st_j = jgn.GNState(st_j.x, st_j.P, st_j.is_degenerate, jnp.asarray(converged),
                       st_j.n_matched, st_j.iter_used)
    for it in (0, 1):
        st_t = tgn.gn_step(st_t, torch.from_numpy(JtJ), torch.from_numpy(Jtb),
                           torch.from_numpy(n_valid), it, **kw)
        st_j = jgn.gn_step(st_j, jnp.asarray(JtJ), jnp.asarray(Jtb), jnp.asarray(n_valid), it,
                           **kw)
        np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x), atol=ATOL)
        np.testing.assert_allclose(st_t.P.numpy(), np.asarray(st_j.P), atol=ATOL)
        for f in ("is_degenerate", "converged", "iter_used"):
            np.testing.assert_array_equal(getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f)))
        kw["compute_projector"] = False
    # the full-system solve, then P: the degenerate lanes moved, lane 3 and 5 did not
    moved = (st_t.x.numpy() != x).any(-1)
    np.testing.assert_array_equal(moved, [True, True, True, False, True, False])


# -- the native branch, bit for bit against its code before the reference
# -- mode joined it (a frozen copy)


def _solve_before(JtJ, Jtb):
    tr = torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    A = JtJ + (1e-7 / 6.0 * tr + 1e-12) * torch.eye(6)
    return tgn._cholesky6_solve(A, Jtb)


def _projector_before(JtJ, thr):
    evals, V = torch.linalg.eigh(JtJ)
    keep = evals >= thr
    return (V * keep.to(JtJ.dtype)[..., None, :]) @ V.transpose(-1, -2), torch.any(~keep, dim=-1)


def _step_dx_before(JtJ, Jtb, P, deg, lm_damping):
    if lm_damping > 0.0:
        JtJ = JtJ + lm_damping * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1))
    eye = torch.eye(6)
    A_eff = torch.where(deg[..., None, None], P @ JtJ @ P + (eye - P), JtJ)
    b_eff = torch.where(deg[..., None], (P @ Jtb[..., None])[..., 0], Jtb)
    return tgn.nan_guard(_solve_before(A_eff, b_eff))


@pytest.mark.parametrize("lm_damping", [0.0, 0.5])
def test_native_branch_is_bit_identical_to_before(lm_damping):
    rng = np.random.RandomState(6)
    small = np.array([False, True, False, True])
    JtJ = torch.from_numpy(_spd(rng, 4, small))
    Jtb = torch.from_numpy((rng.randn(4, 6) * 5).astype(np.float32))
    assert torch.equal(tgn.solve_6x6(JtJ, Jtb), _solve_before(JtJ, Jtb))
    P, deg = tgn.degeneracy_projector(JtJ, 10.0)
    P0, deg0 = _projector_before(JtJ, 10.0)
    assert torch.equal(P, P0) and torch.equal(deg, deg0)
    st = tgn.gn_step(tgn.gn_init(torch.zeros(4, 6)), JtJ, Jtb, torch.full((4,), 50.0), 1,
                     **KW, compute_projector=True, lm_damping=lm_damping)
    assert torch.equal(st.x, _step_dx_before(JtJ, Jtb, P0, deg0, lm_damping))
