"""Port vs JAX package where the port reaches as far as the JAX package does:
the k-NN at every k (the TPU kernel's k is static, any 1 <= k <= M), every
search at more than 65,535 problems (CUDA's cap on grid y, the kernels'
problem axis; the JAX package's vmap runs any batch), and the config knobs.

On the CPU the port runs the plain versions, held here to the JAX package's
dense searches and to ``knn_pallas`` in interpret mode; the card holds its
kernels to these plain versions bit for bit (tests/test_torch_kernels_cuda.py,
chip_smoke.py phase 41).

Tolerances: indices equal wherever the JAX package's answer is not a near-tie
(the two packages form q.r differently: JAX by a matrix product, the port by
elementwise f32 products), distances within rtol 1e-5 / atol 1e-4, as in
tests/test_torch_knn.py; exactly equal on integer-grid points, whose
distances both packages compute exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.ops import neighbors as jnb  # noqa: E402
from cooper_mapper_tpu.ops.pallas.knn_stream import knn_pallas  # noqa: E402
from cooper_mapper_tpu.utils.cloud import Cloud as JCloud  # noqa: E402
from cooper_mapper_torch.ops import knn as tknn  # noqa: E402
from cooper_mapper_torch.ops import neighbors as tnb  # noqa: E402
from cooper_mapper_torch.ops import races  # noqa: E402
from cooper_mapper_torch.utils.cloud import Cloud as TCloud  # noqa: E402

GATE, SPAN, R = 25.0, 2.5, 16
WIDE_B = 65537          # one problem past CUDA's grid-y cap


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _float_problem(seed, Q, M, mask_frac=0.15, span=5.0, lead=()):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-span, span, lead + (Q, 3)).astype(np.float32)
    r = rng.uniform(-span, span, lead + (M, 3)).astype(np.float32)
    return q, r, rng.rand(*(lead + (M,))) > mask_frac


def _grid_problem(seed, Q, M, mask_frac=0.15):
    """Integer-grid points, seven values per axis: distances repeat, and both
    packages compute each exactly."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, (Q, 3)).astype(np.float32)
    r = rng.randint(-3, 4, (M, 3)).astype(np.float32)
    return q, r, rng.rand(M) > mask_frac


def _port_knn(q, r, mask, k):
    idx, d = tknn.knn_plain(_t(q[None]), _t(r), _t(mask), k)
    return idx[0].numpy(), d[0].numpy()


def _near_tie_free(d, k):
    """Rows whose first k + 1 distances (float64) are at least 1e-4 apart:
    ten times the atol the packages' f32 distances are held to, so that no
    rounding of either package can reorder them."""
    s = np.sort(d, axis=-1)[:, :k + 1]
    return (np.diff(s, axis=-1) > 1e-4).all(-1)


@pytest.mark.parametrize("k", [1, 3, 8, 16, 33, 64, 100])
def test_knn_plain_matches_jax_dense_at_every_k(k):
    # random floats: equal indices away from near-ties; integer grid: equal
    # indices and distances, ties listed by index in both
    q, r, mask = _float_problem(k, 128, 512)
    gi, gd = _port_knn(q, r, mask, k)
    wi, wd = (np.asarray(a) for a in jnb.knn(jnp.asarray(q), jnp.asarray(r),
                                             jnp.asarray(mask), k))
    dense = np.where(mask[None], ((q[:, None] - r[None]).astype(np.float64) ** 2).sum(-1), 1e12)
    clean = _near_tie_free(dense, k)
    assert clean.mean() > 0.5
    np.testing.assert_array_equal(gi[clean], wi[clean])
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)

    q, r, mask = _grid_problem(100 + k, 96, 400)
    gi, gd = _port_knn(q, r, mask, k)
    wi, wd = jnb.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), k)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gd, np.asarray(wd))


def test_knn_plain_at_k_equal_m_and_fewer_valid_points_than_k():
    # k = M lists every point: the valid ones by (distance, index), then the
    # masked ones at |r|^2 = BIG (about 1e12), as the JAX package does
    q, r, mask = _grid_problem(7, 40, 150, mask_frac=0.6)
    gi, gd = _port_knn(q, r, mask, 150)
    wi, wd = jnb.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), 150)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gd, np.asarray(wd))
    assert sorted(gi[0].tolist()) == list(range(150))
    n_valid = int(mask.sum())
    assert (gd[:, n_valid:] >= 1e11).all() and (gd[:, :n_valid] < 1e3).all()


@pytest.mark.parametrize("k", [8, 40])
def test_knn_plain_matches_pallas_interpret(k):
    # knn_pallas at a small and a large static k, as tests/test_torch_knn.py
    # runs it at k = 5
    q, r, mask = _float_problem(50 + k, 128, 256)
    want = knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), k,
                      tile_q=128, tile_m=128, interpret=True)
    gi, gd = _port_knn(q, r, mask, k)
    wi, wd = (np.asarray(a) for a in want)
    dense = np.where(mask[None], ((q[:, None] - r[None]).astype(np.float64) ** 2).sum(-1), 1e12)
    clean = _near_tie_free(dense, k)
    assert clean.mean() > 0.5
    np.testing.assert_array_equal(gi[clean], wi[clean])
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# More than 65,535 problems: the plain versions against the JAX searches
# vmapped over the batch (tiny Q and M, so the whole batch is quick)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_problem():
    """WIDE_B problems of 4 integer-grid queries against per-problem
    references of 24 points on R rings (exact distances: no package-specific
    near-tie), the port's race A and the JAX package's dense searches,
    vmapped."""
    rng = np.random.RandomState(65537)
    q = rng.randint(-4, 5, (WIDE_B, 4, 3)).astype(np.float32)
    xyz = rng.randint(-4, 5, (WIDE_B, 24, 3)).astype(np.float32)
    ring = rng.randint(0, R, (WIDE_B, 24)).astype(np.int32)
    mask = rng.rand(WIDE_B, 24) > 0.1
    ref = JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(ring),
                 jnp.zeros((WIDE_B, 24), jnp.float32))
    corner = jax.jit(jax.vmap(lambda qq, rr: jnb.corner_pairs(qq, rr, GATE, SPAN, R)))
    surf = jax.jit(jax.vmap(lambda qq, rr: jnb.surf_triples(qq, rr, GATE, SPAN, R)))
    jq = jnp.asarray(q)
    port = tuple(map(_t, (q, xyz, ring, mask)))
    ia, da = races.nn1_plain(port[0], port[1], port[3])
    return dict(q=q, xyz=xyz, ring=ring, mask=mask, port=port, ia=ia, da=da,
                corner=[np.asarray(a) for a in corner(jq, ref)],
                surf=[np.asarray(a) for a in surf(jq, ref)])


def _a_ring(p):
    q, xyz, ring, mask = p["port"]
    return torch.gather(ring, 1, p["ia"].long())


def test_races_plain_beyond_65535_problems_match_jax(wide_problem):
    p = wide_problem
    q, xyz, ring, mask = p["port"]
    ia, da = p["ia"], p["da"]
    ring_a = _a_ring(p)
    jia_c, jib_c, jok_c = p["corner"]
    jia_s, jib_s, jic_s, jok_s = p["surf"]
    assert ia.shape == (WIDE_B, 4)
    # race A: the first index of the smallest distance, as jnp.argmin
    np.testing.assert_array_equal(ia.numpy(), jia_c)
    np.testing.assert_array_equal(ia.numpy(), jia_s)
    adj = races.nn1_masked_plain(q, ring_a, ia, xyz, ring, mask, "adj", SPAN)
    same = races.nn1_masked_plain(q, ring_a, ia, xyz, ring, mask, "same", SPAN)
    ib, db, ic, dc = races.bc_races_plain(q, ring_a, ia, xyz, ring, mask, SPAN)
    np.testing.assert_array_equal(adj[0].numpy(), jib_c)
    np.testing.assert_array_equal(same[0].numpy(), jib_s)
    np.testing.assert_array_equal(ib.numpy(), jib_s)
    np.testing.assert_array_equal(ic.numpy(), jic_s)
    np.testing.assert_array_equal(((da < GATE) & (adj[1] < GATE)).numpy(), jok_c)
    np.testing.assert_array_equal(((da < GATE) & (db < GATE) & (dc < GATE)).numpy(), jok_s)
    assert torch.equal(ib, same[0]) and torch.equal(ic, adj[0])


def test_fused_and_knn_plain_beyond_65535_problems_match_jax(wide_problem):
    p = wide_problem
    q, xyz, ring, mask = p["port"]
    jia_c, jib_c, _ = p["corner"]
    jia_s, jib_s, jic_s, _ = p["surf"]
    a_valid = torch.gather(mask, 1, p["ia"].long()).numpy()
    fia, _, fib, _, fic, _ = races.fused_races_plain(q, xyz, ring, mask, True, SPAN)
    cia, _, cic, _ = races.fused_races_plain(q, xyz, ring, mask, False, SPAN)
    # where A is a valid point the fused search gives the split searches'
    # selections (where it is invalid its ring is 1e9, as in the TPU kernel)
    for got, want in ((fia, jia_s), (fib, jib_s), (fic, jic_s), (cia, jia_c), (cic, jib_c)):
        np.testing.assert_array_equal(got.numpy()[a_valid], want[a_valid])
    knn_j = jax.jit(jax.vmap(lambda qq, rr, mm: jnb.knn(qq, rr, mm, 3)))
    wi, wd = knn_j(jnp.asarray(p["q"]), jnp.asarray(p["xyz"]), jnp.asarray(p["mask"]))
    gi, gd = tknn.knn_plain(q, xyz, mask, 3)
    assert gi.shape == (WIDE_B, 4, 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_shared_reference_beyond_65535_problems_equals_per_problem():
    # the shared-reference layout (batch stride 0) at WIDE_B gives each
    # problem's answer against its own copy of the reference
    rng = np.random.RandomState(3)
    q = _t(rng.randint(-4, 5, (WIDE_B, 2, 3)).astype(np.float32))
    xyz = _t(rng.randint(-4, 5, (20, 3)).astype(np.float32))
    ring = _t(rng.randint(0, R, 20).astype(np.int32))
    mask = _t(rng.rand(20) > 0.1)
    tiled = [t[None].expand((WIDE_B,) + tuple(t.shape)).contiguous() for t in (xyz, ring, mask)]
    shared = races.nn1_plain(q, xyz, mask)
    assert all(torch.equal(a, b) for a, b in zip(shared, races.nn1_plain(q, tiled[0],
                                                                           tiled[2])))
    ring_a = ring[shared[0].long()]
    got = races.bc_races_plain(q, ring_a, shared[0], xyz, ring, mask, SPAN)
    want = races.bc_races_plain(q, ring_a, shared[0], *tiled, SPAN)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(tknn.knn_plain(q, xyz, mask, 4),
                                                 tknn.knn_plain(q, tiled[0], tiled[2], 4)))


# ---------------------------------------------------------------------------
# OdometryConfig.nn_query_chunk: the plain searches in query chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [64, 100])
def test_query_chunks_give_the_unchunked_searches(chunk):
    # a chunk that divides Q and one that leaves a padded last chunk: the
    # same selections, bit for bit, as one search over all the queries
    q, xyz, mask = _float_problem(9, 300, 700, lead=(2,))
    ring = np.random.RandomState(9).randint(0, R, (2, 700)).astype(np.int32)
    ref = TCloud(_t(xyz), _t(mask), _t(ring), torch.zeros(2, 700))
    tq = _t(q)
    for fn in (tnb.corner_pairs, tnb.surf_triples):
        whole = fn(tq, ref, GATE, SPAN)
        parts = fn(tq, ref, GATE, SPAN, query_chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(whole, parts))
