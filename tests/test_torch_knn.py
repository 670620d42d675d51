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
from cooper_mapper_torch.utils.profiling import COUNTS  # noqa: E402

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
    before = COUNTS["knn.knn.launches"]
    got = tnb.knn_search(tq, tr, tm, K)
    assert COUNTS["knn.knn.launches"] == before
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


# ---------------------------------------------------------------------------
# The card's merge of chunk lists and its select route, modelled step for
# step in numpy (tests/torch_knn_models.py) and held to the plain versions
# ---------------------------------------------------------------------------

from tests import torch_knn_models as KM  # noqa: E402


def _chunk_lists(rng, S, n, K, L, nan_rows=()):
    """Chunk lists [S, n, K] as the split k-NN kernel writes them: chunk z
    holds 1..L points with indices from z * L, integer distances (heavy ties
    within and across chunks) and some BIG; its list is the first K finite
    entries by (d, j), then (+inf, 0), (+inf, 1), ... where it has fewer
    (chunks shorter than K, and every chunk of a NaN query's rows)."""
    pd = np.full((S, n, K), np.inf, np.float32)
    pi = np.zeros((S, n, K), np.int32)
    for z in range(S):
        Lz = rng.randint(1, L + 1)
        d = rng.randint(0, 5, (n, Lz)).astype(np.float32)
        d[rng.rand(n, Lz) < 0.1] = tknn.races.BIG
        d[list(nan_rows)] = np.nan
        j = z * L + np.arange(Lz)
        for t in range(n):
            fin = ~np.isnan(d[t])
            o = np.lexsort((j[fin], d[t][fin]))[:K]
            F = len(o)
            pd[z, t, :F], pi[z, t, :F] = d[t][fin][o], j[fin][o]
            pi[z, t, F:] = np.arange(K - F)
    return pd, pi


@pytest.mark.parametrize("S", [1, 2, 5, 17, 31, 66, 130])
@pytest.mark.parametrize("K", [1, 5, 10, 19, 32])
def test_merge_first_k_model_equals_the_chunk_order_scan(K, S):
    # merge_first_k's grouping (threads per query over strided chunks, the
    # pairwise merges of sorted key lists, the fillers kept out) against the
    # chunk-order scan, literally and as merge_first_k_plain; under ties, a
    # NaN query (every chunk all fillers) and chunks of fewer than K points
    rng = np.random.RandomState(K * 1000 + S)
    pd, pi = _chunk_lists(rng, S, 24, K, 8 if K < 10 else 3 * K // 2, nan_rows=(5,))
    want_i, want_d = _merge_first_k([(pi[z], pd[z]) for z in range(S)], K)
    plain_i, plain_d = tknn.merge_first_k_plain(torch.from_numpy(pd), torch.from_numpy(pi))
    np.testing.assert_array_equal(plain_i.numpy(), want_i)
    np.testing.assert_array_equal(plain_d.numpy(), want_d)
    got_i, got_d = KM.merge_first_k_model(pd, pi)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert np.isinf(got_d[5]).all() and (got_i[5] == np.arange(K)).all()
    # the CPU entry is the plain version
    got = tknn.merge_first_k(torch.from_numpy(pd), torch.from_numpy(pi))
    assert torch.equal(got[0], plain_i) and torch.equal(got[1], plain_d)


@pytest.mark.parametrize("W", [1, 2, 8, 32])
def test_merge_first_k_model_at_other_shapes(W):
    # the result does not depend on the grouping: the shapes timed against
    # the one built give the same lists, on chunk lists of a real search
    _, q, r, m = _tied_problem(12, 1, 30, 400, False, k_edge=(40, 120))
    k, L = 10, 25
    parts = [_chunk_first_k(q, r, m, a, min(400, a + L), k) for a in range(0, 400, L)]
    pd = np.stack([p[1].reshape(-1, k) for p in parts])
    pi = np.stack([np.where(np.isinf(p[1]), np.arange(k) - np.isfinite(p[1]).sum(-1, keepdims=True),
                            p[0]).reshape(-1, k) for p in parts]).astype(np.int32)
    want_i, want_d = (t.numpy().reshape(-1, k) for t in tknn.knn_plain(q, r, m, k))
    got_i, got_d = KM.merge_first_k_model(pd, pi, W)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def _select_problem(seed, Q, M, n_valid=None):
    """Queries near reference points (distances a little below 0 from f32
    rounding), exact duplicates (ties), a NaN query; ``n_valid`` valid points
    if given, else 90%."""
    rng = np.random.RandomState(seed)
    r = rng.uniform(5.0, 10.0, (M, 3)).astype(np.float32)
    r[[30, 31, 200]] = r[7]
    mask = rng.rand(M) > 0.1
    if n_valid is not None:
        mask[:] = False
        mask[rng.choice(M, n_valid, replace=False)] = True
    mask[[7, 30, 31, 200]] = True
    q = rng.uniform(5.0, 10.0, (Q, 3)).astype(np.float32)
    near = rng.choice(np.flatnonzero(mask), Q // 2)
    q[:Q // 2] = r[near] + rng.normal(0, 1e-5, (Q // 2, 3)).astype(np.float32)
    q[3] = r[7]
    q[Q - 1, 1] = np.nan
    return q, r, mask


@pytest.mark.parametrize("k", [33, 64, 257])
@pytest.mark.parametrize("n_valid", [None, 20], ids=["most-valid", "fewer-valid-than-k"])
def test_select_model_equals_knn_plain_and_jax(k, n_valid):
    # the select route's warp (the lanes' own lists, their sorted union and
    # its check; keys, the fill rule) against knn_plain bit for bit, and
    # against the JAX package's dense k-NN by the contract; a NaN query as
    # the register lists give it, (+inf, 0..k-1)
    q, r, mask = _select_problem(k, 16, 700, n_valid)
    tq, tr, tm = torch.from_numpy(q)[None], torch.from_numpy(r), torch.from_numpy(mask)
    want_i, want_d = (t[0].numpy() for t in tknn.knn_plain(tq, tr, tm, k))
    assert (want_d[:-1] < 0).any() and (want_d[:-1] == 0).any()
    D = tknn.races.pairwise_sq_dist(tq, tr, tknn.races._ref_norms(tr, tm))[0].numpy()
    for t in range(16):
        got_i, got_d = KM.knn_select_model(D[t], k)
        if t == 15:
            assert np.isinf(got_d).all() and (got_i == np.arange(k)).all()
            continue
        np.testing.assert_array_equal(got_i, want_i[t])
        np.testing.assert_array_equal(got_d.view(np.uint32), want_d[t].view(np.uint32))
    # the JAX package masks invalid points by its own rule: compare the
    # valid neighbours; indices where no other distance lies within 1e-3
    # (the JAX matrix-product rounding cannot swap them)
    n = min(k, n_valid or k)
    ji, jd = (np.asarray(a)[:, :n] for a in
              jnb.knn(jnp.asarray(q[:-1]), jnp.asarray(r), jnp.asarray(mask), k))
    np.testing.assert_allclose(want_d[:-1, :n], jd, rtol=1e-5, atol=1e-4)
    full = np.sort(D[:-1], axis=1)
    lo = np.concatenate([np.full((15, 1), -np.inf), full[:, :n - 1]], 1)
    sure = (want_d[:-1, :n] - lo > 1e-3) & (full[:, 1:n + 1] - want_d[:-1, :n] > 1e-3)
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(want_i[:-1, :n][sure], ji[sure])


@pytest.mark.parametrize("k", [33, 257, 600])
def test_select_model_falls_back_to_the_warp_select(k):
    # one lane's points (indices 5 mod 32) hold the nearest ones, more than
    # its own list keeps: pass 1's check fails and the warp select over the
    # points under tau gives the list; above 32 L (k = 600) pass 1 is
    # skipped and the warp select runs unbounded; bit for bit with knn_plain
    rng = np.random.RandomState(k)
    M = 700
    r = rng.uniform(-8.0, 8.0, (M, 3)).astype(np.float32)
    near = np.arange(5, M, 32)
    r[near] = rng.uniform(-0.5, 0.5, (len(near), 3)).astype(np.float32)
    q = rng.uniform(-0.3, 0.3, (1, 6, 3)).astype(np.float32)
    tq, tr, tm = torch.from_numpy(q), torch.from_numpy(r), torch.ones(M, dtype=torch.bool)
    want_i, want_d = (t[0].numpy() for t in tknn.knn_plain(tq, tr, tm, k))
    D = tknn.races.pairwise_sq_dist(tq, tr, tknn.races._ref_norms(tr, tm))[0].numpy()
    for t in range(6):
        trace = {}
        got_i, got_d = KM.knn_select_model(D[t], k, trace)
        assert not trace["exact"] and trace["merges"] > 0
        np.testing.assert_array_equal(got_i, want_i[t])
        np.testing.assert_array_equal(got_d.view(np.uint32), want_d[t].view(np.uint32))


def test_select_route_key_order_is_the_distance_index_order():
    # the 64-bit keys order as (d, j): negative, -0-free zero, positive,
    # BIG; equal d by index; NO_KEY above every finite d
    d = np.array([-3.5, -1e-7, 0.0, 1e-7, 2.0, 2.0, 1e12, 3e38], np.float32)
    j = np.array([9, 4, 7, 1, 3, 8, 0, 2])
    keys = KM.make_key(d, j)
    assert (np.diff(keys.astype(object)) > 0).all() and (keys < KM.NO_KEY).all()
    assert (KM.key_dist(keys).view(np.uint32) == d.view(np.uint32)).all()
    assert KM.make_key(np.float32(np.inf), 0) < KM.NO_KEY   # +inf is kept out by the compare


@pytest.mark.parametrize("B,Q,k,want", [
    (64, 2048, 33, 8),      # the scan-to-map surf search
    (64, 2048, 1024, 8),
    (64, 2048, 1025, 8),    # the radix route above 1024 ignores it
    (8, 2048, 257, 8),      # the per-problem map
    (1, 8192, 64, 8),       # mapping sweep 4's surf search, B = 1
    (2, 300, 100, 4),       # the tie-heavy grid: 75 blocks of 8 leave SMs idle
    (1, 500, 40, 2),        # classify_map_points(k=40) on tests/test_io.py's scene
    (65537, 128, 40, 8),    # B = 65,537
    (1, 5, 33, 1),
])
def test_select_plan_at_the_coverage_shapes(B, Q, k, want):
    # k picks the route in the library, not the plan
    assert tknn.races._select_plan(B, Q, H100_SMS) == want
    assert B * -(-Q // want) >= H100_SMS or want == 1
