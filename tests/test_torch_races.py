"""The race kernels' plain versions (cooper_mapper_torch/ops/races.py) vs the
JAX package's dense races and its Pallas kernels in interpret mode.

Contract (the JAX package's own, tests/test_nn1_pallas.py): equal indices
for every query inside the 25 m^2 gate, ties toward the smaller index,
distances within rtol 1e-5 / atol 1e-4 (the JAX side forms q.r with a
matrix product, the port with three products and two sums).
The CUDA kernels themselves are held to the plain versions on a card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.ops import neighbors as jnb  # noqa: E402
from cooper_mapper_tpu.ops.pallas import nn1 as jpallas  # noqa: E402
from cooper_mapper_tpu.utils.cloud import Cloud as JCloud  # noqa: E402
from cooper_mapper_torch.ops import races  # noqa: E402

GATE = 25.0
Q, M, R, SPAN = 128, 256, 16, 2.5


def _ring_problem(seed, mask_frac=0.1):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-8, 8, (Q, 3)).astype(np.float32)
    xyz = rng.uniform(-8, 8, (M, 3)).astype(np.float32)
    ring = rng.randint(0, R, M).astype(np.int32)
    mask = rng.rand(M) > mask_frac
    return q, xyz, ring, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas(fn, *args, **kw):
    return fn(*args, tile_q=128, tile_m=128, interpret=True, **kw)


def _assert_race(got, want, gated):
    (ig, dg), (iw, dw) = got, want
    ig, dg = ig.numpy()[0], dg.numpy()[0]
    iw, dw = np.asarray(iw), np.asarray(dw)
    np.testing.assert_array_equal(ig[gated], iw[gated])
    np.testing.assert_allclose(dg[gated], dw[gated], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_nn1_plain_matches_jax(seed):
    q, xyz, ring, mask = _ring_problem(seed)
    got = races.nn1_plain(_t(q[None]), _t(xyz), _t(mask))
    dense = jnb.nn1(jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask))
    kern = _pallas(jpallas.nn1_pallas, jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask))
    gated = np.asarray(dense[1]) < GATE
    assert gated.mean() > 0.9
    _assert_race(got, dense, gated)
    _assert_race(got, kern, gated)


@pytest.mark.parametrize("mode", ["adj", "same"])
def test_nn1_masked_plain_matches_jax(mode):
    q, xyz, ring, mask = _ring_problem(3)
    ia, da = races.nn1_plain(_t(q[None]), _t(xyz), _t(mask))
    ring_a = _t(ring)[ia.long()]
    got = races.nn1_masked_plain(_t(q[None]), ring_a, ia, _t(xyz), _t(ring), _t(mask), mode, SPAN)
    jq, jref = jnp.asarray(q), JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(ring),
                                      jnp.zeros(M, jnp.float32))
    jia = jnp.asarray(ia.numpy()[0])
    kern = _pallas(jpallas.nn1_masked_pallas, jq, jref.ring[jia], jia, jref.xyz, jref.ring,
                   jref.mask, mode, SPAN)
    # the dense searches: corner race B is "adj"; surf races B / C are "same" / "adj"
    if mode == "adj":
        _, jib, _ = jnb.corner_pairs(jq, jref, GATE, ring_span=SPAN, n_rings=R)
    else:
        _, jib, _, _ = jnb.surf_triples(jq, jref, GATE, ring_span=SPAN, n_rings=R)
    gated = (np.asarray(kern[1]) < GATE) & (da.numpy()[0] < GATE)
    assert gated.mean() > 0.5
    _assert_race(got, kern, gated)
    np.testing.assert_array_equal(got[0].numpy()[0][gated], np.asarray(jib)[gated])


def test_bc_races_plain_matches_jax():
    q, xyz, ring, mask = _ring_problem(5)
    ia, da = races.nn1_plain(_t(q[None]), _t(xyz), _t(mask))
    ring_a = _t(ring)[ia.long()]
    ib, db, ic, dc = races.bc_races_plain(_t(q[None]), ring_a, ia, _t(xyz), _t(ring), _t(mask), SPAN)
    jia = jnp.asarray(ia.numpy()[0])
    jring = jnp.asarray(ring)
    kb, kdb, kc, kdc = _pallas(jpallas.bc_races_pallas, jnp.asarray(q), jring[jia], jia,
                               jnp.asarray(xyz), jring, jnp.asarray(mask), SPAN)
    jref = JCloud(jnp.asarray(xyz), jnp.asarray(mask), jring, jnp.zeros(M, jnp.float32))
    jia_d, jib_d, jic_d, jok = jnb.surf_triples(jnp.asarray(q), jref, GATE, ring_span=SPAN, n_rings=R)
    ok = (da.numpy()[0] < GATE) & (db.numpy()[0] < GATE) & (dc.numpy()[0] < GATE)
    np.testing.assert_array_equal(ok, np.asarray(jok))
    gb = np.asarray(kdb) < GATE
    gc = np.asarray(kdc) < GATE
    _assert_race((ib, db), (kb, kdb), gb)
    _assert_race((ic, dc), (kc, kdc), gc)
    for got, want in ((ia, jia_d), (ib, jib_d), (ic, jic_d)):
        np.testing.assert_array_equal(got.numpy()[0][ok], np.asarray(want)[ok])


def test_bc_races_equal_two_masked_races():
    q, xyz, ring, mask = _ring_problem(6)
    args = (_t(q[None]),)
    ia, _ = races.nn1_plain(args[0], _t(xyz), _t(mask))
    rest = (_t(ring)[ia.long()], ia, _t(xyz), _t(ring), _t(mask))
    ib, db, ic, dc = races.bc_races_plain(args[0], *rest, SPAN)
    sb = races.nn1_masked_plain(args[0], *rest, "same", SPAN)
    sc = races.nn1_masked_plain(args[0], *rest, "adj", SPAN)
    for a, b in ((ib, sb[0]), (db, sb[1]), (ic, sc[0]), (dc, sc[1])):
        assert torch.equal(a, b)


def test_tie_breaks_toward_smaller_index():
    # duplicate reference points: the winner is the smaller index, as in
    # jnp.argmin over the full tile and the Pallas kernel across tiles
    q = np.asarray([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]] * 64, np.float32)
    r = np.tile(np.asarray([[1.0, 2.0, 3.0]], np.float32), (256, 1))
    mask = np.ones(256, bool)
    ia, _ = races.nn1_plain(_t(q[None]), _t(r), _t(mask))
    kern, _ = _pallas(jpallas.nn1_pallas, jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask))
    assert int(ia[0, 0]) == 0 and int(kern[0]) == 0
    np.testing.assert_array_equal(ia.numpy()[0], np.asarray(kern))


def test_masked_race_excludes_a_itself():
    # "same" never returns A, even when A is duplicated in the reference
    q = np.tile([[1.0, 0.0, 0.0]], (128, 1)).astype(np.float32)
    xyz = np.zeros((128, 3), np.float32)
    xyz[0] = [1.0, 0.0, 0.0]
    xyz[1] = [1.0, 0.0, 0.0]
    xyz[2:] = np.random.RandomState(0).uniform(2, 9, (126, 3))
    ring = np.zeros(128, np.int32)
    mask = np.ones(128, bool)
    ia, _ = races.nn1_plain(_t(q[None]), _t(xyz), _t(mask))
    ring_a = _t(ring)[ia.long()]
    ib, db = races.nn1_masked_plain(_t(q[None]), ring_a, ia, _t(xyz), _t(ring), _t(mask), "same")
    assert int(ia[0, 0]) == 0
    assert int(ib[0, 0]) == 1 and float(db[0, 0]) < 1e-6
    bb, bdb, _, _ = races.bc_races_plain(_t(q[None]), ring_a, ia, _t(xyz), _t(ring), _t(mask))
    assert int(bb[0, 0]) == 1 and float(bdb[0, 0]) < 1e-6


def test_shared_and_per_problem_references_agree():
    B = 3
    rng = np.random.RandomState(7)
    q = rng.uniform(-8, 8, (B, Q, 3)).astype(np.float32)
    _, xyz, ring, mask = _ring_problem(8)
    shared = (_t(xyz), _t(ring), _t(mask))
    tiled = tuple(torch.stack([t] * B) for t in shared)
    ia, da = races.nn1_plain(_t(q), shared[0], shared[2])
    ia2, da2 = races.nn1_plain(_t(q), tiled[0], tiled[2])
    assert torch.equal(ia, ia2) and torch.equal(da, da2)
    ring_a = shared[1][ia.long()]
    out = races.bc_races_plain(_t(q), ring_a, ia, *shared)
    out2 = races.bc_races_plain(_t(q), ring_a, ia, *tiled)
    assert all(torch.equal(a, b) for a, b in zip(out, out2))


def test_wrappers_reject_bad_inputs():
    q, xyz, ring, mask = _ring_problem(0)
    tq, tx, tm = _t(q[None]), _t(xyz), _t(mask)
    with pytest.raises(ValueError):
        races.nn1(tq.double(), tx, tm)                       # dtype
    with pytest.raises(ValueError):
        races.nn1(tq[0], tx, tm)                             # shape
    with pytest.raises(ValueError):
        races.nn1(tq.transpose(1, 2).contiguous().transpose(1, 2), tx, tm)  # contiguity
    with pytest.raises(ValueError):
        races.nn1(tq, tx, tm[:-1])                           # mask length
    ia, _ = races.nn1(tq, tx, tm)
    with pytest.raises(ValueError):
        races.nn1_masked(tq, _t(ring)[ia.long()], ia, tx, _t(ring), tm, "near")


# ---------------------------------------------------------------------------
# The split of M across blocks (csrc/split.cuh): the plan and the merge law
# ---------------------------------------------------------------------------

# The card's SMs; the plan's query block: 128 threads, 1 query each, for
# bc_races and for a split nn1 / nn1_masked launch (a whole one serves 2
# queries per thread, csrc/races.cu)
H100_SMS, BC_BLOCK_QUERIES = 132, 128


@pytest.mark.parametrize("B,Q,M,S_min", [
    (512, 768, 3840, 1),     # odometry batch: already 3072 blocks, no split
    (512, 256, 256, 1),      # odometry batch corner: 1024 blocks, no split
    (8, 768, 3840, 1),       # 48 blocks: split
    (1, 1024, 8192, 66),     # single-stream surf: 8 query blocks
    (1, 256, 2048, 32),      # single-stream corner shapes: 2 query blocks
])
def test_split_plan_at_the_race_shapes(B, Q, M, S_min):
    S, L = races._split_plan(B, Q, M, H100_SMS, BC_BLOCK_QUERIES)
    races._check_plan(S, L, M)
    blocks = B * -(-Q // BC_BLOCK_QUERIES)
    assert S >= S_min
    if blocks >= H100_SMS:
        assert (S, L) == (1, M)
    else:
        # every SM gets a block, or each chunk is already the smallest one
        assert blocks * S >= H100_SMS or L < 2 * races.SPLIT_MIN_CHUNK
        assert L >= races.SPLIT_MIN_CHUNK or S == 1


@pytest.mark.parametrize("S,L,M", [(0, 10, 5), (2, 10, 10), (3, 4, 13), (1, 9, 10)])
def test_check_plan_rejects_plans_that_miss_m(S, L, M):
    # an empty last chunk, a gap at the end, or S < 1
    with pytest.raises(ValueError):
        races._check_plan(S, L, M)


def _merge_min(parts, design=None):
    """csrc/split.cuh's merge_min in Python: the chunks' (min, argmin) pairs
    merged to what the chunk-order scan with strict "<" from (+inf, 0) gives.
    ``design`` = (QB, WARPS) takes the kernel's order instead: W = WARPS *
    32 / QB threads per query, thread c scanning chunks c, c + W, ... with
    "<" from (+inf, z = -1), then the lexicographic (d, z) minimum by the
    shuffle butterfly inside each warp, then across the warps in order."""
    if design is None:
        best = np.full(parts[0][1].shape, np.inf, np.float32)
        bidx = np.zeros(parts[0][0].shape, np.int32)
        for i, d in parts:
            take = d < best
            best[take], bidx[take] = d[take], i[take]
        return bidx, best
    qb, warps = design
    per_warp = 32 // qb
    W = per_warp * warps
    shape = parts[0][1].shape
    # per thread: (d, z, j)
    th = [[np.full(shape, np.inf, np.float32), np.full(shape, -1), np.zeros(shape, np.int32)]
          for _ in range(W)]
    for z, (i, d) in enumerate(parts):
        t = th[z % W]
        take = d < t[0]
        t[0][take], t[1][take], t[2][take] = d[take], z, i[take]

    def join(a, b):
        take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
        return [np.where(take, y, x) for x, y in zip(a, b)]

    off = 1
    while off < per_warp:            # __shfl_xor_sync over the lane bits above QB
        th = [join(th[c], th[c ^ off]) if (c % per_warp) ^ off < per_warp else th[c]
              for c in range(W)]
        off *= 2
    out = th[0]
    for w in range(1, warps):        # warp 0 reads the others' results in order
        out = join(out, th[w * per_warp])
    return out[2], out[0]


MERGE_SIZES = [1, 2, 3, 5, 31, 32, 33, 66, 100, 130]
# merge_min<QB, WARPS>: the built shape (csrc/split.cuh MERGE_QB, MERGE_WARPS)
# and the two it was measured against
MERGE_SHAPES = [(8, 4), (32, 4), (1, 1)]


def _chunk_partials(S, n=70, L=9, seed=0):
    """S chunks' (argmin, min) pairs of n queries, as the split races write
    them: integer distances (ties across chunks), an index in the chunk's
    range [z*L, (z+1)*L), and (+inf, 0) where a chunk had no candidate."""
    rng = np.random.RandomState(seed + S)
    parts = []
    for z in range(S):
        d = rng.randint(0, 4, n).astype(np.float32)
        d[rng.rand(n) < 0.2] = races.BIG
        i = (z * L + rng.randint(0, L, n)).astype(np.int32)
        none = rng.rand(n) < 0.3
        d[none], i[none] = np.inf, 0
        parts.append((i, d))
    return parts


@pytest.mark.parametrize("S", MERGE_SIZES)
@pytest.mark.parametrize("design", MERGE_SHAPES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_merge_min_grouping_equals_the_chunk_order_scan(design, S):
    # the kernel's strided threads, warp butterfly and cross-warp join give
    # the sequential merge's bits, ties across chunks included, for the
    # shape the kernel is built with and two others of its template
    parts = _chunk_partials(S)
    want_i, want_d = _merge_min(parts)
    got_i, got_d = _merge_min(parts, design)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)
    assert (want_d == np.inf).any() or S > 3


@pytest.mark.parametrize("S", MERGE_SIZES)
def test_merge_min_plain_equals_the_chunk_order_scan(S):
    # the plain version (the CPU path of races.merge_min), two searches
    parts = [_chunk_partials(S, seed=s) for s in (0, 1)]
    pd = torch.from_numpy(np.stack([np.stack([d for _, d in p]) for p in parts]))
    pi = torch.from_numpy(np.stack([np.stack([i for i, _ in p]) for p in parts]))
    got_i, got_d = races.merge_min(pd, pi)
    for k, p in enumerate(parts):
        want_i, want_d = _merge_min(p)
        np.testing.assert_array_equal(got_d[k].numpy(), want_d)
        np.testing.assert_array_equal(got_i[k].numpy(), want_i)


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
def test_bc_races_are_the_ordered_merge_of_chunks(per_problem):
    # races B and C over the whole equal the chunk-order merge of the races
    # over each chunk (indices offset, ia taken relative to the chunk), under
    # heavy ties, duplicates straddling chunk edges and chunks of one point
    B_, Q_, M_ = 2, 60, 90
    rng = np.random.RandomState(21)
    lead = (B_,) if per_problem else ()
    q = rng.randint(-3, 4, (B_, Q_, 3)).astype(np.float32)
    xyz = rng.randint(-3, 4, lead + (M_, 3)).astype(np.float32)
    for e in (30, 61):
        xyz[..., e - 2:e + 2, :] = xyz[..., e - 2:e - 1, :]
    ring = rng.randint(0, 4, lead + (M_,)).astype(np.int32)
    mask = rng.rand(*(lead + (M_,))) > 0.1
    tq, tx, tr, tm = _t(q), _t(xyz), _t(ring), _t(mask)
    ia, _ = races.nn1_plain(tq, tx, tm)
    ring_a = tr[ia.long()] if not per_problem else torch.gather(tr, 1, ia.long())
    ring_a[:, ::7] = torch.from_numpy(rng.randint(0, 4, ring_a[:, ::7].shape).astype(np.int32))
    want = [t.numpy() for t in races.bc_races_plain(tq, ring_a, ia, tx, tr, tm, SPAN)]
    cut_sets = [[0, 30, 61, M_], [0, 1, 2, 29, 30, 31, M_], [0, 45, M_]]
    cut_sets += [[0, *sorted(rng.choice(np.arange(1, M_), 12, replace=False)), M_]
                 for _ in range(3)]
    for cuts in cut_sets:
        parts_b, parts_c = [], []
        for a, b in zip(cuts[:-1], cuts[1:]):
            sl = (lambda t: t[a:b]) if not per_problem else (lambda t: t[:, a:b])
            ib, db, ic, dc = races.bc_races_plain(
                tq, ring_a, ia - a, sl(tx).contiguous(), sl(tr).contiguous(),
                sl(tm).contiguous(), SPAN)
            parts_b.append(((ib + a).numpy(), db.numpy()))
            parts_c.append(((ic + a).numpy(), dc.numpy()))
        for got, w_i, w_d in ((_merge_min(parts_b), want[0], want[1]),
                              (_merge_min(parts_c), want[2], want[3])):
            np.testing.assert_array_equal(got[1], w_d)
            np.testing.assert_array_equal(got[0], w_i)


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
@pytest.mark.parametrize("race", ["nn1", "adj", "same"])
def test_nn1_and_masked_are_the_ordered_merge_of_chunks(race, per_problem):
    # race A and each ring race over the whole equal the chunk-order merge of
    # the race over each chunk (indices offset, ia taken relative to the
    # chunk), under heavy ties, duplicates straddling chunk edges and chunks
    # of one point
    B_, Q_, M_ = 2, 60, 90
    rng = np.random.RandomState(22)
    lead = (B_,) if per_problem else ()
    q = rng.randint(-3, 4, (B_, Q_, 3)).astype(np.float32)
    xyz = rng.randint(-3, 4, lead + (M_, 3)).astype(np.float32)
    for e in (30, 61):
        xyz[..., e - 2:e + 2, :] = xyz[..., e - 2:e - 1, :]
    ring = rng.randint(0, 4, lead + (M_,)).astype(np.int32)
    mask = rng.rand(*(lead + (M_,))) > 0.1
    tq, tx, tr, tm = _t(q), _t(xyz), _t(ring), _t(mask)
    ia, _ = races.nn1_plain(tq, tx, tm)
    ring_a = tr[ia.long()] if not per_problem else torch.gather(tr, 1, ia.long())
    ring_a[:, ::7] = torch.from_numpy(rng.randint(0, 4, ring_a[:, ::7].shape).astype(np.int32))

    def run(a, b):
        sl = (lambda t: t[a:b]) if not per_problem else (lambda t: t[:, a:b])
        x, r, m = (sl(t).contiguous() for t in (tx, tr, tm))
        if race == "nn1":
            return races.nn1_plain(tq, x, m)
        return races.nn1_masked_plain(tq, ring_a, ia - a, x, r, m, race, SPAN)

    w_i, w_d = (t.numpy() for t in run(0, M_))
    big_chunks = 0   # chunk results at BIG (ring races: a winner that failed its ring test)
    cut_sets = [[0, 30, 61, M_], [0, 1, 2, 29, 30, 31, M_], [0, 45, M_], [0, 89, M_]]
    cut_sets += [[0, *sorted(rng.choice(np.arange(1, M_), 12, replace=False)), M_]
                 for _ in range(3)]
    for cuts in cut_sets:
        parts = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            i, d = run(a, b)
            parts.append(((i + a).numpy(), d.numpy()))
            big_chunks += int((d == races.BIG).sum())
        got_i, got_d = _merge_min(parts)
        np.testing.assert_array_equal(got_d, w_d)
        np.testing.assert_array_equal(got_i, w_i)
    assert big_chunks > 0 or race == "nn1"


# ---------------------------------------------------------------------------
# The listed walks: valid_list, the plain versions' query mask, and the
# card's walk over list positions (csrc/races.cu RefWalk) emulated here
# ---------------------------------------------------------------------------


def _masks(seed):
    rng = np.random.RandomState(seed)
    return {"scattered": rng.rand(4, 90) < 0.4, "none": np.zeros((4, 90), bool),
            "all": np.ones((4, 90), bool), "mixed": rng.rand(4, 90) < rng.rand(4, 1)}


@pytest.mark.parametrize("kind", ["scattered", "none", "all", "mixed"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-problem"])
def test_valid_list_is_a_stable_partition(kind, shared):
    mask = _t(_masks(40)[kind])
    if shared:
        mask = mask[0].contiguous()
    order, count = races.valid_list(mask)
    assert order.dtype == torch.int32 and count.dtype == torch.int32
    assert order.shape == mask.shape and count.shape == mask.shape[:-1]
    for m, o, c in zip(mask.reshape(-1, 90), order.reshape(-1, 90), count.reshape(-1)):
        slots = torch.arange(90)
        want = torch.cat([slots[m], slots[~m]]).to(torch.int32)   # valid first, index order
        assert torch.equal(o, want) and int(c) == int(m.sum())
        if not m.any():
            assert torch.equal(o, slots.to(torch.int32))          # nothing valid: identity
    assert torch.equal(races.list_mask((order, count)), mask)


def _take_ring(values, idx, per_problem):
    return torch.gather(values, 1, idx.long()) if per_problem else values[idx.long()]


def _query_case(seed, B=3, Q_=70, M_=90, per_problem=True):
    rng = np.random.RandomState(seed)
    lead = (B,) if per_problem else ()
    q = rng.randint(-3, 4, (B, Q_, 3)).astype(np.float32)
    xyz = rng.randint(-3, 4, lead + (M_, 3)).astype(np.float32)
    ring = rng.randint(0, 4, lead + (M_,)).astype(np.int32)
    mask = rng.rand(*(lead + (M_,))) > 0.5
    q_mask = rng.rand(B, Q_) < 0.6
    q[~q_mask] = 1e6
    return _t(q), _t(xyz), _t(ring), _t(mask), _t(q_mask)


@pytest.mark.parametrize("race", ["nn1", "adj", "same", "bc"])
@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
def test_plain_versions_answer_invalid_queries_big_and_0(race, per_problem):
    # on a valid query the masked call is the unmasked one bit for bit; on
    # an invalid one it is (BIG, 0), in every output of the race; the
    # wrappers given a query list give the same on the CPU
    q, xyz, ring, mask, q_mask = _query_case(41, per_problem=per_problem)
    ia, _ = races.nn1_plain(q, xyz, mask)
    ring_a = _take_ring(ring, ia, per_problem)
    q_list, r_list = races.valid_list(q_mask), races.valid_list(mask)
    if race == "nn1":
        call = lambda **kw: races.nn1_plain(q, xyz, mask, **kw)
        wrapped = races.nn1(q, xyz, mask, q_list, r_list)
    elif race == "bc":
        call = lambda **kw: races.bc_races_plain(q, ring_a, ia, xyz, ring, mask, SPAN, **kw)
        wrapped = races.bc_races(q, ring_a, ia, xyz, ring, mask, SPAN, q_list, r_list)
    else:
        call = lambda **kw: races.nn1_masked_plain(q, ring_a, ia, xyz, ring, mask, race, SPAN,
                                                   **kw)
        wrapped = races.nn1_masked(q, ring_a, ia, xyz, ring, mask, race, SPAN, q_list, r_list)
    whole, masked = call(), call(q_mask=q_mask)
    assert 0 < int(q_mask.sum()) < q_mask.numel()
    for w, m, c in zip(whole, masked, wrapped):
        assert torch.equal(m[q_mask], w[q_mask]) and torch.equal(c, m)
        fixed = 0 if m.dtype == torch.int32 else np.float32(races.BIG)
        assert (m[~q_mask] == fixed).all()


def _listed_walk(race, q, xyz, ring, mask, ring_a, ia, L):
    """One problem's race as the card walks its list (csrc/races.cu):
    chunks of L list positions over [0, n) (n the valid count; all M, in
    slot order, where it is 0 or M), each chunk's argmin turned from a
    position to a slot, a ring race's chunk answer joined with (BIG, first
    invalid slot) (ring_answer), a chunk past n answering (+inf, 0) before
    that, and the chunks merged in order with a strict "<"."""
    M_ = mask.shape[0]
    order, count = races.valid_list(mask)
    n = int(count)
    first_invalid = int(order[n]) if 0 < n < M_ else -1
    if first_invalid < 0:
        n, order = M_, torch.arange(M_, dtype=torch.int32)
    at = {int(s): p for p, s in enumerate(order[:n].tolist())}
    pa = torch.tensor([[at.get(int(j), -1) for j in row] for row in ia], dtype=torch.int32)
    big = np.float32(races.BIG)
    parts = []
    for a in range(0, -(-M_ // L) * L, L):
        a_, b_ = min(a, n), min(a + L, n)
        if a_ >= b_:
            i, d = torch.zeros(ia.shape, dtype=torch.int32), torch.full(ia.shape, np.inf)
        else:
            s = order[a_:b_].long()
            if race == "nn1":
                i, d = races.nn1_plain(q, xyz[s].contiguous(), mask[s].contiguous())
            else:
                i, d = races.nn1_masked_plain(q, ring_a, pa - a_, xyz[s].contiguous(),
                                              ring[s].contiguous(), mask[s].contiguous(), race,
                                              SPAN)
            i = order[a_ + i.long()]
        d = d.to(torch.float32)
        if race != "nn1" and first_invalid >= 0:
            take = (big < d) | ((d == big) & (first_invalid < i))
            d, i = torch.where(take, big, d), torch.where(take, first_invalid, i)
        parts.append((i.numpy(), d.numpy()))
    return _merge_min(parts)


@pytest.mark.parametrize("L", [90, 31, 7, 1], ids=lambda v: f"L{v}")
@pytest.mark.parametrize("case", ["scattered", "first-invalid", "none", "all", "no-candidate"])
@pytest.mark.parametrize("race", ["nn1", "adj", "same"])
def test_listed_walk_equals_the_whole_walk(race, case, L):
    # the card's listed walk, whole (L = M) and split into chunks of list
    # positions (chunks past the count walk nothing), gives the whole
    # walk's bits on every query: integer-grid points (ties), a first slot
    # that is invalid, no valid point (the identity walk), every point
    # valid, and a ring no candidate is near (then (BIG, 0))
    _, xyz, ring, mask, _ = _query_case(42, B=1, Q_=60, per_problem=False)
    q = _t(np.random.RandomState(45).randint(-3, 4, (1, 60, 3)).astype(np.float32))
    mask = {"scattered": mask, "first-invalid": mask & (torch.arange(90) > 4),
            "none": torch.zeros_like(mask), "all": torch.ones_like(mask),
            "no-candidate": mask}[case]
    ia, _ = races.nn1_plain(q, xyz, mask)
    ring_a = ring[ia.long()]
    ring_a[:, ::7] = torch.from_numpy(np.random.RandomState(43).randint(0, 4, (1, 9)))
    if case == "no-candidate":
        ring_a[:] = 40
    want = (races.nn1_plain(q, xyz, mask) if race == "nn1" else
            races.nn1_masked_plain(q, ring_a, ia, xyz, ring, mask, race, SPAN))
    got_i, got_d = _listed_walk(race, q, xyz, ring, mask, ring_a, ia, L)
    np.testing.assert_array_equal(got_d, want[1].numpy())
    np.testing.assert_array_equal(got_i, want[0].numpy())
    if case == "no-candidate" and race != "nn1":
        assert (got_i == 0).all()


@pytest.mark.parametrize("block", [1, 32, 64])
@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
def test_pair_counters_count_whole_query_blocks(block, per_problem):
    # walked: each problem's valid queries rounded up to whole blocks
    # (capped at Q) x its listed reference points (M where none is valid)
    from cooper_mapper_torch.utils import profiling

    q, xyz, _, mask, q_mask = _query_case(45, per_problem=per_problem)
    q_mask[1] = False
    if per_problem:
        mask[2] = False
    q_list, r_list = races.valid_list(q_mask), races.valid_list(mask)
    with profiling.tracing() as tr:
        with profiling.span("race"):
            races._count_pairs(q, xyz, q_list, r_list, block)
            races._count_pairs(q, xyz, None, None, block)
    B, Q_, M_ = q.shape[0], q.shape[1], xyz.shape[-2]
    nq = [min(Q_, -(-int(n) // block) * block) for n in q_mask.sum(-1)]
    nr = [int(n) or M_ for n in (mask.sum(-1) if per_problem else [mask.sum()] * B)]
    walked = sum(a * b for a, b in zip(nq, nr))
    assert nq[1] == 0 and (not per_problem or nr[2] == M_)
    assert tr.counters() == {"race": {"race_pairs_walked": walked + B * Q_ * M_,
                                      "race_pairs_padded": 2 * B * Q_ * M_}}


def test_wrappers_reject_bad_lists():
    q, xyz, ring, mask, q_mask = _query_case(44)
    q_list, r_list = races.valid_list(q_mask), races.valid_list(mask)
    with pytest.raises(ValueError):
        races.nn1(q, xyz, mask, (q_list[0].long(), q_list[1]), r_list)          # dtype
    with pytest.raises(ValueError):
        races.nn1(q, xyz, mask, q_list, races.valid_list(mask[0]))              # shape
    ia, _ = races.nn1(q, xyz, mask, q_list, r_list)
    with pytest.raises(ValueError):
        races.bc_races(q, _take_ring(ring, ia, True), ia, xyz, ring, mask, SPAN, q_list,
                       (r_list[0], r_list[1][:1]))                              # count shape
