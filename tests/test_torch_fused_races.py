"""The fused race search (``races.fused_races_plain`` and its dispatch in
``ops/neighbors``) vs the JAX package's ``fused_races_pallas`` in interpret
mode and its dense searches.

Contract (the JAX package's own, tests/test_nn1_pallas.py:134 and :200):
equal indices and acceptance for every query inside the 25 m^2 gate, ties
toward the smaller index, distances within rtol 1e-5 / atol 1e-4 (the JAX
side forms q.r with a matrix product, the port with three products and two
sums).  Against the port's split races the plain version is bit-identical
on every query whose race-A winner is a valid point.  The CUDA kernel is
held to the plain version on a card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.ops import neighbors as jnb  # noqa: E402
from cooper_mapper_tpu.ops.pallas import nn1 as jpallas  # noqa: E402
from cooper_mapper_tpu.utils.cloud import Cloud as JCloud  # noqa: E402
from cooper_mapper_torch.ops import neighbors as tnb  # noqa: E402
from cooper_mapper_torch.ops import races  # noqa: E402
from cooper_mapper_torch.utils.cloud import Cloud  # noqa: E402

GATE, R, SPAN = 25.0, 16, 2.5


def _problem(seed, Q, M, mask_frac=0.1):
    """tests/test_nn1_pallas.py's _ring_cloud problem: queries and a masked
    ringed reference, uniform in [-8, 8]^3."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-8, 8, (Q, 3)).astype(np.float32)
    xyz = rng.uniform(-8, 8, (M, 3)).astype(np.float32)
    ring = rng.randint(0, R, M).astype(np.int32)
    mask = rng.rand(M) > mask_frac
    return q, xyz, ring, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_fused(q, xyz, ring, mask, with_same):
    """fused_races_pallas in interpret mode, the reference padded to a
    multiple of 128 with invalid points as the JAX package's dispatch pads
    it (neighbors._pad_ref_arrays)."""
    pad = (-xyz.shape[0]) % 128
    xyz = np.concatenate([xyz, np.zeros((pad, 3), np.float32)])
    ring = np.concatenate([ring, np.zeros(pad, np.int32)])
    mask = np.concatenate([mask, np.zeros(pad, bool)])
    out = jpallas.fused_races_pallas(jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(ring),
                                     jnp.asarray(mask), with_same=with_same, ring_span=SPAN,
                                     tile_q=128, interpret=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("with_same", [True, False])
@pytest.mark.parametrize("seed,M", [(11, 256), (12, 1000)])
def test_fused_plain_matches_jax(seed, M, with_same):
    # the case of test_fused_races_match_dense_searches (seed 11, M = 256)
    # and a ragged M that the JAX side pads and the port does not
    q, xyz, ring, mask = _problem(seed, 128, M)
    got = [o.numpy()[0] for o in races.fused_races_plain(_t(q[None]), _t(xyz), _t(ring),
                                                         _t(mask), with_same, SPAN)]
    kern = _jax_fused(q, xyz, ring, mask, with_same)
    jref = JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(ring),
                  jnp.zeros(M, jnp.float32))
    if with_same:
        dense = jnb.surf_triples(jnp.asarray(q), jref, GATE, ring_span=SPAN, n_rings=R)
    else:
        dense = jnb.corner_pairs(jnp.asarray(q), jref, GATE, ring_span=SPAN, n_rings=R)
    ok = np.all([d < GATE for d in got[1::2]], axis=0)
    np.testing.assert_array_equal(ok, np.asarray(dense[-1]))
    assert ok.mean() > 0.3
    for k in range(0, len(got), 2):
        np.testing.assert_array_equal(got[k][ok], kern[k][ok])
        np.testing.assert_array_equal(got[k][ok], np.asarray(dense[k // 2])[ok])
        gated = kern[k + 1] < GATE
        np.testing.assert_array_equal(got[k][gated], kern[k][gated])
        np.testing.assert_allclose(got[k + 1][gated], kern[k + 1][gated], rtol=1e-5, atol=1e-4)


def test_fused_excludes_a_itself():
    # test_fused_races_exclude_a_itself: A duplicated, race B never returns A
    q = np.tile([[1.0, 0.0, 0.0]], (128, 1)).astype(np.float32)
    xyz = np.zeros((128, 3), np.float32)
    xyz[:2] = [1.0, 0.0, 0.0]
    xyz[2:] = np.random.RandomState(0).uniform(2, 9, (126, 3))
    ring, mask = np.zeros(128, np.int32), np.ones(128, bool)
    ia, _, ib, db, _, _ = races.fused_races_plain(_t(q[None]), _t(xyz), _t(ring), _t(mask), True)
    kern = _jax_fused(q, xyz, ring, mask, True)
    assert int(ia[0, 0]) == 0 and int(ib[0, 0]) == 1 and float(db[0, 0]) < 1e-6
    np.testing.assert_array_equal(ib.numpy()[0], kern[2])


@pytest.mark.parametrize("per_problem", [False, True])
def test_fused_equals_split_races_where_a_is_valid(per_problem):
    # bit for bit against nn1 -> bc_races / nn1_masked("adj") on every query
    # whose A is valid; ragged Q and M, half the reference invalid so some
    # far queries pick an invalid A
    B = 3
    rng = np.random.RandomState(4)
    q = rng.uniform(-8, 8, (B, 100, 3)).astype(np.float32)
    q[:, :10] = 1e6                               # FAR queries (invalid points)
    lead = (B,) if per_problem else ()
    xyz = rng.uniform(-8, 8, lead + (333, 3)).astype(np.float32)
    ring = rng.randint(0, R, lead + (333,)).astype(np.int32)
    mask = rng.rand(*(lead + (333,))) > 0.5
    xyz[~mask] = 1e6
    tq, tx, tr, tm = map(_t, (q, xyz, ring, mask))
    surf = races.fused_races_plain(tq, tx, tr, tm, True, SPAN)
    corner = races.fused_races_plain(tq, tx, tr, tm, False, SPAN)
    ia, da = races.nn1_plain(tq, tx, tm)
    ring_a = tnb.take_ref(tr, ia, not per_problem)
    split_surf = (ia, da) + races.bc_races_plain(tq, ring_a, ia, tx, tr, tm, SPAN)
    split_corner = (ia, da) + races.nn1_masked_plain(tq, ring_a, ia, tx, tr, tm, "adj", SPAN)
    a_valid = tnb.take_ref(tm, ia, not per_problem)
    assert 0 < int((~a_valid).sum()) < a_valid.numel()
    for got, want in ((surf, split_surf), (corner, split_corner)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):
            assert torch.equal(g[a_valid], w[a_valid])


def _clouds(seed, Q, M):
    q, xyz, ring, mask = _problem(seed, Q, M)
    ref = Cloud(_t(xyz), _t(mask), _t(ring), torch.zeros(M))
    jref = JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(ring), jnp.zeros(M, jnp.float32))
    return q, ref, jref


@pytest.mark.parametrize("fused_env", ["0", "1"])
@pytest.mark.parametrize("Q,M,routed", [(128, 256, True), (256, 8190, True), (128, 8193, False),
                                        (100, 256, False)])
def test_dispatch_gate(monkeypatch, fused_env, Q, M, routed):
    # COOPER_PALLAS_FUSED=1 takes the fused kernel exactly where the JAX
    # package's _fused_tile_q does (M rounded up to 128 at most 8192, Q a
    # multiple of 128).  With COOPER_PALLAS_INTERPRET=1 the JAX dispatch runs
    # its Pallas kernels in interpret mode, so both packages take the same
    # route, and the selections agree on every gated-in query.
    monkeypatch.setenv("COOPER_PALLAS_FUSED", fused_env)
    monkeypatch.setenv("COOPER_PALLAS_INTERPRET", "1")
    assert tnb.fused_route(Q, M) == (routed and fused_env == "1")
    pad = -(-M // 128) * 128
    assert bool(jnb._fused_tile_q(Q, pad)) == (routed if fused_env == "1" else False)
    if M > 1000:
        return    # the gate alone at the large shapes; the searches below are small
    q, ref, jref = _clouds(21, Q, M)
    calls, plain = [], races.fused_races_plain
    monkeypatch.setattr(races, "fused_races_plain", lambda *a: calls.append(1) or plain(*a))
    surf = tnb.surf_triples(_t(q[None]), ref, GATE, SPAN)
    corner = tnb.corner_pairs(_t(q[None]), ref, GATE, SPAN)
    assert len(calls) == (2 if tnb.fused_route(Q, M) else 0)
    jsurf = jnb.surf_triples(jnp.asarray(q), jref, GATE, ring_span=SPAN, n_rings=R)
    jcorner = jnb.corner_pairs(jnp.asarray(q), jref, GATE, ring_span=SPAN, n_rings=R)
    for got, want in ((surf, jsurf), (corner, jcorner)):
        ok = np.asarray(want[-1])
        np.testing.assert_array_equal(got[-1].numpy()[0], ok)
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(g.numpy()[0][ok], np.asarray(w)[ok])



# ---------------------------------------------------------------------------
# The card kernel's partition (csrc/races.cu fused_races_kernel) in numpy
# ---------------------------------------------------------------------------

TILE_M, RACE_GROUP = 512, 32     # csrc/races.cu
H100_SMS = 132


def _lane_group(G):
    """Points per lane per group: the G lanes cover a divisor of TILE_M."""
    return RACE_GROUP if RACE_GROUP * G <= TILE_M else TILE_M // G


def _scan(v):
    """One strict-"<" scan in index order from (+inf, 0) over v [Q, M]:
    (first argmin, min); a NaN never enters."""
    w = np.where(np.isnan(v), np.inf, v)
    m = w.min(-1)
    i = np.argmax(w == m[:, None], -1)
    return np.where(m < np.inf, i, 0), m


def _lane_race(v, G):
    """The kernel's race over values v [Q, M] (f32): lane l of G scans the
    points j % G == l in groups of _lane_group(G) in its own order (fminf
    minimum per group, a group recorded where it is strictly below the
    running minimum, then the first point of the recorded group equal to
    it), and the lanes combine by the lexicographic (d, j) minimum."""
    Q, M = v.shape
    N = _lane_group(G)
    best, bi = np.full(Q, np.inf, np.float32), np.zeros(Q, np.int64)
    rows = np.arange(Q)
    for lane in range(G):
        cols = np.arange(lane, M, G)
        lv = v[:, cols]
        run, grp = np.full(Q, np.inf, np.float32), np.full(Q, -1)
        for g0 in range(0, len(cols), N):
            m = np.fmin.reduce(lv[:, g0:g0 + N], axis=1, initial=np.inf)
            take = m < run
            run[take], grp[take] = m[take], g0
        ld, lj = np.full(Q, np.inf, np.float32), np.zeros(Q, np.int64)
        for qi in rows[grp >= 0]:
            seg = lv[qi, grp[qi]:grp[qi] + N]
            ld[qi], lj[qi] = run[qi], cols[grp[qi] + int(np.argmax(seg == run[qi]))]
        take = (ld < best) | ((ld == best) & (lj < bi))
        best[take], bi[take] = ld[take], lj[take]
    return bi, best


def _fused_model(q, xyz, ring, mask, with_same, race):
    """Every race of one search (B = 1, shared reference) with ``race``
    (_scan or a G-lane _lane_race): (ia, da, ib, db, ic, dc) or (ia, da, ic,
    dc) as numpy arrays."""
    d = races.pairwise_sq_dist(_t(q[None]), _t(xyz), races._ref_norms(_t(xyz), _t(mask)))
    d = d.numpy()[0]
    ringf = races._ref_rings(_t(ring), _t(mask)).numpy()
    ia, da = race(d)
    ra = ringf[ia][:, None]
    cols = np.arange(len(xyz))
    out = [ia, da]
    if with_same:
        out += race(np.where((ringf == ra) & (cols != ia[:, None]), d, np.float32(races.BIG)))
    rd = np.abs(ringf - ra)
    out += race(np.where((rd > 0) & (rd <= SPAN), d, np.float32(races.BIG)))
    return out


def _partition_case(case):
    """(q, xyz, ring, mask) for the partition test: integer-grid points
    (heavy ties) with duplicates across lanes and tiles, NaN queries, FAR
    queries whose A is an invalid point, an all-invalid reference, M < G."""
    rng = np.random.RandomState({"ties": 31, "far": 32, "all-invalid": 33, "tiny": 34}[case])
    M = 5 if case == "tiny" else 1100          # 1100: two full tiles and a ragged one
    q = rng.randint(-3, 4, (40, 3)).astype(np.float32)
    xyz = rng.randint(-3, 4, (M, 3)).astype(np.float32)
    ring = rng.randint(0, 4, M).astype(np.int32)
    mask = rng.rand(M) > 0.1
    q[[3, 17]] = np.nan
    if M > 1000:
        xyz[600:640] = xyz[5]                  # one point on every lane, in three tiles
        xyz[1090:] = xyz[5]
    if case == "far":
        mask = rng.rand(M) > 0.5
        xyz[~mask] = 1e6
        q[:8] = 1e6
    if case == "all-invalid":
        mask[:] = False
    return q, xyz, ring, mask


@pytest.mark.parametrize("with_same", [True, False], ids=["surf", "corner"])
@pytest.mark.parametrize("case", ["ties", "far", "all-invalid", "tiny"])
@pytest.mark.parametrize("G", [1, 4, 32])
def test_lane_partition_equals_one_scan(G, case, with_same):
    # G lanes per query, each over its strided subset of every tile by group
    # minima, combined by the lexicographic (d, j) minimum: the bits of one
    # strict-"<" scan on every query, and of fused_races_plain on every
    # query that is not NaN (on a NaN query torch.argmin takes the NaN)
    q, xyz, ring, mask = _partition_case(case)
    got = _fused_model(q, xyz, ring, mask, with_same, lambda v: _lane_race(v, G))
    scan = _fused_model(q, xyz, ring, mask, with_same, _scan)
    plain = [t.numpy()[0] for t in races.fused_races_plain(
        _t(q[None]), _t(xyz), _t(ring), _t(mask), with_same, SPAN)]
    for g, s in zip(got, scan):
        np.testing.assert_array_equal(g, s)
    finite = ~np.isnan(q).any(-1)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g[finite], p[finite])
    nan = ~finite
    assert (got[0][nan] == 0).all() and np.isinf(got[1][nan]).all()
    if case == "far":
        assert (~mask[got[0][finite]]).any()  # some A is an invalid point


@pytest.mark.parametrize("B,Q,plan", [
    (512, 768, (1, 2)),      # odometry batch surf: 1536 blocks at G = 1
    (512, 256, (1, 2)),      # odometry batch corner: 512 blocks
    (1, 1024, (32, 1)),      # single-stream surf: 4 blocks at G = 1
    (1, 256, (32, 1)),       # single-stream corner: 1 block at G = 1
    (1, 1, (32, 1)),
    (264, 256, (1, 2)),      # exactly 2 blocks per SM at G = 1
    (263, 256, (32, 1)),     # one block short
])
def test_fused_plan_at_the_fused_shapes(B, Q, plan):
    # G = 1 (2 queries per thread) exactly where its blocks give every SM
    # FUSED_BLOCKS_PER_SM, else a warp per query
    assert races._fused_plan(B, Q, H100_SMS) == plan
    assert plan in races.FUSED_PLANS
    fills = B * -(-Q // (races.FUSED_THREADS * 2)) >= races.FUSED_BLOCKS_PER_SM * H100_SMS
    assert (plan == (1, 2)) == fills
