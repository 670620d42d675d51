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


# ---------------------------------------------------------------------------
# The split of M across blocks (csrc/split.cuh): the plan and the merge law
# ---------------------------------------------------------------------------

H100_SMS, KNN_BLOCK_QUERIES = 132, 256     # the card's SMs; 128 threads x 2 queries


@pytest.mark.parametrize("B,Q,M,split", [
    (64, 2048, 5888, False),    # scan-to-map batch, surf
    (1, 8192, 65536, True),     # mapping sweep, surf
    (1, 2048, 32768, True),     # mapping sweep, corner
    (64, 256, 512, True),       # scan-to-map batch, corner: 64 blocks
    (1, 100, 7, True),          # M smaller than a chunk: one chunk
    (3, 333, 1000, True),
    (1, 5, 5, False),
])
def test_split_plan_covers_m_in_nonempty_chunks(B, Q, M, split):
    S, L = tknn._split_plan(B, Q, M, H100_SMS, KNN_BLOCK_QUERIES)
    chunks = [(z * L, min(M, (z + 1) * L)) for z in range(S)]
    assert chunks[0][0] == 0 and chunks[-1][1] == M
    assert all(a < b for a, b in chunks)                        # non-empty
    assert all(chunks[z][1] == chunks[z + 1][0] for z in range(S - 1))
    blocks = B * -(-Q // KNN_BLOCK_QUERIES)
    if blocks >= H100_SMS:
        assert (S, L) == (1, M)                                 # no scratch, no merge
    elif split and M > S:
        # the split grid fills the card as far as the smallest chunk allows
        assert S > 1 or M <= tknn.races.SPLIT_MIN_CHUNK
        assert blocks * S >= H100_SMS or L <= 2 * tknn.races.SPLIT_MIN_CHUNK
    assert S == 1 or split


def _merge_first_k(parts, k):
    """csrc/split.cuh's merge_first_k in Python: per query, the chunks'
    ascending lists in chunk order, inserted with a strict "<" and moved up
    past strictly larger entries only, from (+inf, 0..k-1)."""
    n = parts[0][0].reshape(-1, k).shape[0]
    out_d = np.full((n, k), np.inf, np.float32)
    out_i = np.tile(np.arange(k, dtype=np.int32), (n, 1))
    for t in range(n):
        bd, bi = list(out_d[t]), list(out_i[t])
        for pi, pd in parts:
            for d, j in zip(pd.reshape(n, k)[t], pi.reshape(n, k)[t]):
                if not d < bd[-1]:
                    break
                bd[-1], bi[-1] = d, j
                for s in range(k - 1, 0, -1):
                    if bd[s] < bd[s - 1]:
                        bd[s], bd[s - 1] = bd[s - 1], bd[s]
                        bi[s], bi[s - 1] = bi[s - 1], bi[s]
        out_d[t], out_i[t] = bd, bi
    return out_i, out_d


def _chunk_first_k(q, r, m, c0, c1, k):
    """knn_plain over the chunk [c0, c1), indices offset by c0, padded to k
    entries with (+inf, slot) as the kernel's list starts."""
    shared = r.dim() == 2
    rc = (r[c0:c1] if shared else r[:, c0:c1]).contiguous()
    mc = (m[c0:c1] if shared else m[:, c0:c1]).contiguous()
    kk = min(k, c1 - c0)
    idx, d = tknn.knn_plain(q, rc, mc, kk)
    pad = k - kk
    if pad:
        lead = idx.shape[:-1]
        idx = torch.cat([idx, torch.arange(kk, k, dtype=torch.int32).expand(*lead, pad)], -1)
        d = torch.cat([d, torch.full((*lead, pad), np.inf)], -1)
    return (idx + c0 * (idx < kk if pad else 1)).numpy(), d.numpy()


def _random_chunkings(rng, M, n):
    """n chunkings of [0, M): random cuts (chunks as short as 1) and even splits."""
    out = []
    for i in range(n):
        if i % 2:
            S = rng.randint(2, min(M, 40))
            L = -(-M // S)
            cuts = list(range(L, M, L))
        else:
            cuts = sorted(rng.choice(np.arange(1, M), rng.randint(1, min(M - 1, 30)), replace=False))
        out.append([0, *cuts, M])
    return out


def _tied_problem(seed, B, Q, M, per_problem, k_edge=()):
    """Integer-grid points (heavy distance ties) with exact duplicates planted
    on both sides of every position in ``k_edge``."""
    rng = np.random.RandomState(seed)
    lead = (B,) if per_problem else ()
    q = rng.randint(-3, 4, (B, Q, 3)).astype(np.float32)
    r = rng.randint(-3, 4, lead + (M, 3)).astype(np.float32)
    for e in k_edge:
        r[..., e - 2:e + 2, :] = r[..., e - 2:e - 1, :]
    mask = rng.rand(*(lead + (M,))) > 0.1
    return rng, torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(mask)


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
@pytest.mark.parametrize("k", [5, 10])
def test_first_k_is_the_ordered_merge_of_chunks(per_problem, k):
    # the identity the split k-NN kernel rests on: the first k of the whole
    # equals the (d, j)-ordered merge of the chunks' first k, under heavy
    # ties, ties straddling chunk edges and chunks shorter than k
    M = 97
    rng, q, r, m = _tied_problem(31 + k, 2, 40, M, per_problem, k_edge=(24, 50, 75))
    want_i, want_d = (t.numpy().reshape(-1, k) for t in tknn.knn_plain(q, r, m, k))
    for cuts in _random_chunkings(rng, M, 6) + [[0, 24, 50, 75, M], [0, 3, 6, 9, M]]:
        parts = [_chunk_first_k(q, r, m, a, b, k) for a, b in zip(cuts[:-1], cuts[1:])]
        got_i, got_d = _merge_first_k(parts, k)
        np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(got_i, want_i)


def test_merge_of_a_nan_query_is_inf_and_the_first_slots():
    # a NaN distance never enters a list (a NaN compare is false): a NaN
    # query merges to (+inf, 0..k-1), what one scan of the kernel gives
    _, q, r, m = _tied_problem(4, 1, 6, 60, False)
    q[0, 2] = float("nan")
    parts = [_chunk_first_k(q, r, m, a, b, K) for a, b in ((0, 20), (20, 23), (23, 60))]
    got_i, got_d = _merge_first_k(parts, K)
    assert np.isinf(got_d[2]).all() and (got_i[2] == np.arange(K)).all()
    want_i, want_d = (t.numpy().reshape(-1, K) for t in tknn.knn_plain(q, r, m, K))
    finite = np.arange(6) != 2
    np.testing.assert_array_equal(got_i[finite], want_i[finite])
    np.testing.assert_array_equal(got_d[finite], want_d[finite])
