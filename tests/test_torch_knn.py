"""Port vs JAX package: the streaming k-NN of the scan-to-map solve.

``knn_plain`` (the CPU path, and the version the CUDA kernel is held to bit
for bit on the card) against the JAX package's dense ``neighbors.knn``
(``jax.lax.top_k``) and against ``knn_pallas`` in interpret mode.

Contract (tests/test_knn_stream.py's): equal indices for the queries whose
5th neighbour lies inside the scan-to-map gate (5 m^2), distances within
rtol 1e-5 / atol 1e-4 (the JAX package forms the cross term with a matrix
product, the port with elementwise f32 products).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.ops import neighbors as jnb  # noqa: E402
from cooper_mapper_tpu.ops.pallas.knn_stream import knn_pallas  # noqa: E402
from cooper_mapper_torch.ops import knn as tknn  # noqa: E402
from cooper_mapper_torch.ops import neighbors as tnb  # noqa: E402

K, GATE = 5, 5.0


def _problem(seed, Q, M, mask_frac=0.15, span=5.0, B=None):
    rng = np.random.RandomState(seed)
    lead = () if B is None else (B,)
    q = rng.uniform(-span, span, lead + (Q, 3)).astype(np.float32)
    r = rng.uniform(-span, span, lead + (M, 3)).astype(np.float32)
    mask = rng.rand(*(lead + (M,))) > mask_frac
    return q, r, mask


def _port(q, r, mask):
    """knn_plain on one problem (q [Q, 3]) -> numpy (idx [Q, k], d [Q, k])."""
    idx, d = tknn.knn_plain(torch.from_numpy(q)[None], torch.from_numpy(r),
                            torch.from_numpy(mask), K)
    return idx[0].numpy(), d[0].numpy()


def _assert_contract(got, want):
    (gi, gd), (wi, wd) = got, [np.asarray(a) for a in want]
    gated = wd[:, -1] < GATE
    assert gated.mean() > 0.5
    np.testing.assert_array_equal(gi[gated], wi[gated])
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M", [512, 1000, 130], ids=["tile-multiple", "ragged", "just-over-k-tile"])
def test_plain_matches_jax_dense_knn(M):
    q, r, mask = _problem(M, 256, M, span=5.0 * (M / 512) ** (1 / 3))
    _assert_contract(_port(q, r, mask), jnb.knn(jnp.asarray(q), jnp.asarray(r),
                                                jnp.asarray(mask), K))


def test_plain_matches_pallas_interpret():
    q, r, mask = _problem(0, 256, 512)
    want = knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), K,
                      tile_q=128, tile_m=128, interpret=True)
    _assert_contract(_port(q, r, mask), want)


def test_duplicates_across_tiles():
    # the same point repeated across several 128-point tiles: each duplicate
    # listed once, the smaller index first
    q = np.tile([[1.0, 2.0, 3.0]], (128, 1)).astype(np.float32)
    r = np.tile([[1.0, 2.0, 3.0]], (384, 1)).astype(np.float32)
    mask = np.ones(384, bool)
    idx, d = _port(q, r, mask)
    np.testing.assert_array_equal(idx, np.tile(np.arange(K), (128, 1)))
    assert np.abs(d).max() < 1e-5
    ji, _ = knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), K,
                       tile_q=128, tile_m=128, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(ji))


def test_masked_points_never_selected():
    q, r, mask = _problem(5, 128, 256, mask_frac=0.5, span=3.0)
    idx, d = _port(q, r, mask)
    in_gate = d < 25.0
    assert in_gate.mean() > 0.9 and mask[idx[in_gate]].all()
    wi, _ = jnb.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), K)
    np.testing.assert_array_equal(idx[in_gate], np.asarray(wi)[in_gate])


def test_ascending_order():
    q, r, mask = _problem(2, 128, 384)
    idx, d = _port(q, r, mask)
    assert (np.diff(d, axis=-1) >= 0).all()
    # equal distances (exact duplicates planted) keep index order
    r[[40, 41, 300]] = r[17]
    idx, d = _port(q, r, np.ones(384, bool))
    ties = d[:, :-1] == d[:, 1:]
    assert ties.any() and (idx[:, 1:][ties] > idx[:, :-1][ties]).all()


def test_shared_and_per_problem_references():
    # a per-problem reference [B, M, 3]: each problem equals a search of its
    # own reference; the shared [M, 3] one equals its broadcast, bit for bit
    q, r, mask = _problem(7, 100, 300, B=3)
    tq, tr, tm = map(torch.from_numpy, (q, r, mask))
    idx, d = tknn.knn_plain(tq, tr, tm, K)
    for b in range(3):
        wi, wd = jnb.knn(jnp.asarray(q[b]), jnp.asarray(r[b]), jnp.asarray(mask[b]), K)
        _assert_contract((idx[b].numpy(), d[b].numpy()), (wi, wd))
    shared = tknn.knn_plain(tq, tr[0], tm[0], K)
    bcast = tknn.knn_plain(tq, tr[:1].expand(3, -1, -1).contiguous(),
                           tm[:1].expand(3, -1).contiguous(), K)
    assert all(torch.equal(a, b) for a, b in zip(shared, bcast))


def test_plain_chunks_change_nothing(monkeypatch):
    # the plain version's query and batch chunking is a memory bound only
    q, r, mask = _problem(9, 300, 700, B=2)
    tq, tr, tm = map(torch.from_numpy, (q, r, mask))
    whole = tknn.knn_plain(tq, tr[0], tm[0], K)
    per = tknn.knn_plain(tq, tr, tm, K)
    monkeypatch.setattr(tknn, "_PLAIN_CHUNK_ELEMS", {"cpu": 700 * 37, "cuda": 700 * 37})
    assert all(torch.equal(a, b) for a, b in zip(whole, tknn.knn_plain(tq, tr[0], tm[0], K)))
    assert all(torch.equal(a, b) for a, b in zip(per, tknn.knn_plain(tq, tr, tm, K)))


def test_fewer_valid_points_than_k():
    # 3 valid points: they lead, the rest are BIG-distance fillers whose
    # indices still lie in [0, M) (torch faults on an out-of-range gather)
    q, r, _ = _problem(4, 64, 200)
    mask = np.zeros(200, bool)
    mask[[3, 50, 199]] = True
    r[~mask] = 1e6
    idx, d = _port(q, r, mask)
    assert set(np.sort(idx[:, :3], axis=1).ravel()) == {3, 50, 199}
    assert (d[:, :3] < 1e3).all() and (d[:, 3:] > 1e11).all()
    assert idx.min() >= 0 and idx.max() < 200
    wi, _ = jnb.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), K)
    np.testing.assert_array_equal(idx[:, :3], np.asarray(wi)[:, :3])


def test_m_below_k_raises():
    q, r, mask = _problem(1, 8, 4)
    with pytest.raises(ValueError):
        _port(q, r, mask)


def test_cpu_tensors_run_the_plain_version():
    # knn_search dispatches on the device: on the CPU it is knn_plain and the
    # kernel's launch counter does not move
    q, r, mask = _problem(3, 64, 256)
    tq, tr, tm = torch.from_numpy(q)[None], torch.from_numpy(r), torch.from_numpy(mask)
    before = tknn.knn.launches
    got = tnb.knn_search(tq, tr, tm, K)
    assert tknn.knn.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, tknn.knn_plain(tq, tr, tm, K)))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32


@pytest.mark.parametrize("n_vals", [3, 9])
def test_first_k_under_ties_of_special_values(n_vals):
    # negative values, -0.0 beside +0.0, infinities, NaN and heavy ties
    # (3 values: the k-th value shared by a third of the columns): every row
    # equals the first k columns of a stable sort
    rng = np.random.RandomState(7)
    vals = np.array([np.nan, 1e12, -1e12, -3.5, -0.0, 0.0, 2.0, np.inf, -np.inf],
                    np.float32)[:n_vals]
    d = torch.from_numpy(vals[rng.randint(0, n_vals, (64, 50))])
    sv, si = torch.sort(d, dim=-1, stable=True)
    idx, v = tknn._first_k(d.clone(), K)
    assert torch.equal(idx, si[:, :K].to(torch.int32))
    assert torch.equal(v.isnan(), sv[:, :K].isnan())
    assert torch.equal(v.nan_to_num(), sv[:, :K].nan_to_num())


def test_first_k_equals_the_stable_sort_under_ties():
    # heavy ties (integer distances): the rows topk cannot answer go to
    # _first_k_tied, and every row equals the first k columns of a stable sort
    rng = np.random.RandomState(6)
    d = torch.from_numpy(rng.randint(0, 8, (64, 40)).astype(np.float32))
    d[:8] = torch.arange(40, dtype=torch.float32)     # tie-free rows
    idx, v = tknn._first_k(d.clone(), K)
    sv, si = torch.sort(d, dim=-1, stable=True)
    assert torch.equal(v, sv[:, :K]) and torch.equal(idx, si[:, :K].to(torch.int32))
