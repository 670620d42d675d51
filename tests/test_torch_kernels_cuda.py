"""The CUDA kernels (races, fused races, k-NN) against their plain PyTorch
versions, and the cube map on the card against the CPU.

These tests need an NVIDIA card and skip without one.  The file imports no
JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which imports JAX.)  Kernel and
plain version perform the same f32 operations in the same order, so
indices and distances must be bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cooper_mapper_torch.ops import knn, races  # noqa: E402
from cooper_mapper_torch.ops.neighbors import take_ref  # noqa: E402
from cooper_mapper_torch.utils.profiling import COUNTS  # noqa: E402

R, SPAN = 16, 2.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA race kernels have no CPU mode")
    return torch.device("cuda")


def _problem(seed, B, Q, M, per_problem, device):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.uniform(-8, 8, (B, Q, 3)).astype(np.float32)).to(device)
    lead = (B,) if per_problem else ()
    xyz = torch.from_numpy(rng.uniform(-8, 8, lead + (M, 3)).astype(np.float32)).to(device)
    ring = torch.from_numpy(rng.randint(0, R, lead + (M,)).astype(np.int32)).to(device)
    mask = torch.from_numpy(rng.rand(*(lead + (M,))) > 0.1).to(device)
    return q, xyz, ring, mask


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("B,Q,M", [(4, 256, 256), (4, 100, 1000), (4, 768, 3840),
                                   (1, 1024, 8192), (1, 256, 2048), (1, 1000, 8191),
                                   (1, 333, 65536)])
def test_kernels_equal_plain_versions(cuda, per_problem, B, Q, M):
    # ragged shapes included: Q not a multiple of the query block, M not a
    # multiple of the 512-point reference tile; the B = 1 shapes of the
    # single-stream sweep, where bc_races splits M across blocks
    q, xyz, ring, mask = _problem(11, B, Q, M, per_problem, cuda)
    before = [COUNTS[f"races.{k.__name__}.launches"] for k in races.KERNELS]
    ia, da = races.nn1(q, xyz, mask)
    pia, pda = races.nn1_plain(q, xyz, mask)
    assert torch.equal(ia, pia) and torch.equal(da, pda)
    ring_a = take_ref(ring, ia, not per_problem)
    for mode in ("adj", "same"):
        args = (q, ring_a, ia, xyz, ring, mask, mode, SPAN)
        assert all(torch.equal(a, b) for a, b in
                   zip(races.nn1_masked(*args), races.nn1_masked_plain(*args)))
    args = (q, ring_a, ia, xyz, ring, mask, SPAN)
    assert all(torch.equal(a, b) for a, b in
               zip(races.bc_races(*args), races.bc_races_plain(*args)))
    torch.cuda.synchronize()
    after = [COUNTS[f"races.{k.__name__}.launches"] for k in races.KERNELS]
    assert [a - b for a, b in zip(after, before)] == [1, 2, 1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("Q,M", [(256, 2048), (1024, 8192), (100, 1000)])
def test_fused_kernel_equals_plain_and_split_kernels(cuda, per_problem, Q, M):
    # the single-stream shapes, a ragged one; bit for bit against the plain
    # version everywhere, and against nn1 -> bc_races / nn1_masked("adj")
    # on every query whose A is a valid point
    q, xyz, ring, mask = _problem(13, 2, Q, M, per_problem, cuda)
    q[:, :7] = 1e6                                  # FAR queries, as invalid points sit
    before = COUNTS["races.fused_races.launches"]
    for with_same in (True, False):
        got = races.fused_races(q, xyz, ring, mask, with_same, SPAN)
        want = races.fused_races_plain(q, xyz, ring, mask, with_same, SPAN)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        ia, da = races.nn1(q, xyz, mask)
        ring_a = take_ref(ring, ia, not per_problem)
        split = (ia, da) + (races.bc_races(q, ring_a, ia, xyz, ring, mask, SPAN) if with_same
                            else races.nn1_masked(q, ring_a, ia, xyz, ring, mask, "adj", SPAN))
        a_valid = take_ref(mask, ia, not per_problem)
        assert all(torch.equal(a[a_valid], b[a_valid]) for a, b in zip(got, split))
    torch.cuda.synchronize()
    assert COUNTS["races.fused_races.launches"] == before + 2


@pytest.mark.cuda
def test_feature_map_round_trip_on_card(cuda):
    # insert, recentre and surround gather of the cube map on the card equal
    # the CPU run (the same stable sorts and in-range scatters)
    from cooper_mapper_torch.config import MapConfig
    from cooper_mapper_torch.maps import feature_map as fm
    from cooper_mapper_torch.utils import cloud

    cfg = MapConfig(n_cubes=(7, 3, 7), cube_size=10.0, margin_cubes=1, corner_cube_capacity=64,
                    surf_cube_capacity=128, surround_corner_capacity=2048,
                    surround_surf_capacity=4096, valid_distance=20.0, vfov_up_deg=10.0,
                    vfov_down_deg=15.0)
    rng = np.random.RandomState(3)
    maps = {d: fm.create(cfg, d) for d in ("cpu", cuda)}
    for pos in ([0.0, 0.0, 0.0], [24.0, 3.0, -17.0], [41.0, -2.0, -30.0]):
        xyz = rng.uniform(-40, 60, (4000, 3)).astype(np.float32)
        mask = rng.rand(4000) > 0.05
        outs = {}
        for d, m in maps.items():
            c = cloud.make(torch.from_numpy(xyz).to(d), torch.from_numpy(mask).to(d))
            p = torch.tensor(pos, device=d)
            fm.recenter(m, p, cfg)
            fm.add_feature_cloud(m, c, c, cfg)
            outs[d] = fm.get_surround(m, p, cfg)
        gpu, cpu = maps[cuda], maps["cpu"]
        for cc_g, cc_c in ((gpu.corner, cpu.corner), (gpu.surf, cpu.surf)):
            # the slots; the guard row's xyz is whichever dropped point won
            assert torch.equal(cc_g.xyz.cpu(), cc_c.xyz) and torch.equal(cc_g.mask.cpu(), cc_c.mask)
            assert torch.equal(cc_g.count.cpu(), cc_c.count)
        assert torch.equal(gpu.origin.cpu(), cpu.origin)
        for g, c in zip(outs[cuda], outs["cpu"]):
            assert torch.equal(g.xyz.cpu(), c.xyz) and torch.equal(g.mask.cpu(), c.mask)


@pytest.mark.cuda
def test_ties_and_self_exclusion_on_card(cuda):
    # tests/test_nn1_pallas.py's tie and exclude-A cases, on the kernels
    q = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]] * 64, device=cuda)[None]
    r = torch.tensor([[1.0, 2.0, 3.0]], device=cuda).repeat(600, 1)
    ia, _ = races.nn1(q, r, torch.ones(600, dtype=torch.bool, device=cuda))
    assert int(ia[0, 0]) == 0 and int(ia[0, 1]) == 0
    q = torch.tensor([[1.0, 0.0, 0.0]], device=cuda).repeat(128, 1)[None].contiguous()
    xyz = torch.from_numpy(np.random.RandomState(0).uniform(2, 9, (128, 3)).astype(np.float32))
    xyz[:2] = torch.tensor([1.0, 0.0, 0.0])
    xyz = xyz.to(cuda)
    ring = torch.zeros(128, dtype=torch.int32, device=cuda)
    mask = torch.ones(128, dtype=torch.bool, device=cuda)
    ia, _ = races.nn1(q, xyz, mask)
    ib, db = races.nn1_masked(q, ring[ia.long()], ia, xyz, ring, mask, "same")
    assert int(ia[0, 0]) == 0 and int(ib[0, 0]) == 1 and float(db[0, 0]) < 1e-6
    bb, bdb, _, _ = races.bc_races(q, ring[ia.long()], ia, xyz, ring, mask)
    assert int(bb[0, 0]) == 1 and float(bdb[0, 0]) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("B,Q,M", [(3, 256, 512), (3, 100, 1000), (3, 333, 5), (3, 2048, 5888),
                                   (1, 8192, 65536), (1, 2048, 32768), (1, 1000, 7777)])
def test_knn_kernel_equals_plain_version(cuda, per_problem, B, Q, M):
    # ragged Q (not a multiple of the query block) and M (not a multiple of
    # the 512-point tile), M == k, the scan-to-map surf shape and the
    # mapping sweep's B = 1 shapes, where the kernel splits M across blocks
    q, xyz, _, mask = _problem(12, B, Q, M, per_problem, cuda)
    before = COUNTS["knn.knn.launches"]
    got = knn.knn(q, xyz, mask)
    want = knn.knn_plain(q, xyz, mask)
    torch.cuda.synchronize()
    assert COUNTS["knn.knn.launches"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].min()) >= 0 and int(got[0].max()) < M


@pytest.mark.cuda
def test_knn_ties_and_sparse_reference_on_card(cuda):
    # tests/test_knn_stream.py's duplicates across tiles: equal distances
    # list the smaller index first
    q = torch.tensor([[1.0, 2.0, 3.0]], device=cuda).repeat(130, 1)[None].contiguous()
    r = torch.tensor([[1.0, 2.0, 3.0]], device=cuda).repeat(1300, 1)
    idx, d = knn.knn(q, r, torch.ones(1300, dtype=torch.bool, device=cuda))
    assert (idx == torch.arange(5, device=cuda, dtype=torch.int32)).all()
    assert float(d.abs().max()) < 1e-5
    # fewer valid points than k: the valid ones first, every index in range
    mask = torch.zeros(1300, dtype=torch.bool, device=cuda)
    mask[[7, 700]] = True
    r2 = r.clone()
    r2[700] += 1.0
    idx, d = knn.knn(q, r2, mask)
    assert idx[0, 0, :2].tolist() == [7, 700] and float(d[..., 2:].min()) >= 1e11
    assert int(idx.min()) >= 0 and int(idx.max()) < 1300
    assert all(torch.equal(a, b) for a, b in zip((idx, d), knn.knn_plain(q, r2, mask)))
    with pytest.raises(ValueError):
        knn.knn(q, r[:4].contiguous(), mask[:4].contiguous())


@pytest.mark.cuda
def test_voxel_filter_on_card_is_deterministic(cuda):
    # the centroid sums add each voxel's points in index order, so two card
    # runs agree bit for bit, and with the CPU's ordered f32 sums
    from cooper_mapper_torch.ops.voxel import voxel_downsample
    from cooper_mapper_torch.utils import cloud

    rng = np.random.RandomState(9)
    xyz = torch.from_numpy((rng.randn(20000, 3) * 3).astype(np.float32))
    xyz[:5000] = xyz[:5000] * 0.01 + 25.0          # dense voxels: long sums
    mask = torch.from_numpy(rng.rand(20000) > 0.1)
    cpu = voxel_downsample(cloud.make(xyz, mask), 0.4)
    runs = [voxel_downsample(cloud.make(xyz.to(cuda), mask.to(cuda)), 0.4) for _ in range(2)]
    assert torch.equal(runs[0].xyz, runs[1].xyz) and torch.equal(runs[0].mask, runs[1].mask)
    assert torch.equal(runs[0].mask.cpu(), cpu.mask)
    assert torch.equal(runs[0].xyz.cpu(), cpu.xyz)


# ---------------------------------------------------------------------------
# The split of M across blocks: forced chunkings against the plain versions
# ---------------------------------------------------------------------------


def _plan(M, S):
    """A valid (S, L) with about S non-empty chunks of M."""
    L = -(-M // S)
    return -(-M // L), L


def _tied(seed, B, Q, M, device, edges=()):
    """Integer-grid points (heavy ties), duplicates on both sides of each edge."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, (B, Q, 3)).astype(np.float32)
    xyz = rng.randint(-3, 4, (M, 3)).astype(np.float32)
    for e in edges:
        xyz[e - 2:e + 2] = xyz[e - 2]
    ring = rng.randint(0, 4, M).astype(np.int32)
    mask = rng.rand(M) > 0.1
    return tuple(torch.from_numpy(a).to(device) for a in (q, xyz, ring, mask))


@pytest.mark.cuda
def test_split_plan_fills_the_card_at_the_single_stream_shapes(cuda):
    n_sm = races.sm_count(cuda)
    assert n_sm == torch.cuda.get_device_properties(cuda).multi_processor_count
    lib = __import__("cooper_mapper_torch.build", fromlist=["library"]).library()
    for Q, M, bq in ((8192, 65536, lib.cooper_knn_block_queries(5)),
                     (2048, 32768, lib.cooper_knn_block_queries(5)),
                     (1024, 8192, lib.cooper_bc_races_block_queries()),
                     (1024, 8192, lib.cooper_nn1_block_queries())):
        S, L = races._split_plan(1, Q, M, n_sm, bq)
        assert S > 1 and -(-Q // bq) * S >= n_sm
    # nn1 / nn1_masked corner, 2 query blocks: the chunks are already the shortest
    S, L = races._split_plan(1, 256, 2048, n_sm, lib.cooper_nn1_block_queries())
    assert S > 1 and L < 2 * races.SPLIT_MIN_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("M,S", [(600, 4), (600, 6), (41, 8), (51, 10), (41, 41), (1300, 13)])
def test_knn_split_equals_plain_under_ties_at_chunk_edges(cuda, k, M, S):
    # duplicates straddling the chunk edges, M just above k x S, chunks
    # shorter than k (one point each at S = M), several chunks per tile
    plan = _plan(M, S)
    q, xyz, _, mask = _tied(5, 2, 300, M, cuda, edges=range(plan[1], M, plan[1]))
    before = COUNTS["knn.knn.launches"]
    got = knn._knn_cuda(q, xyz, mask, k, plan=plan)
    want = knn.knn_plain(q, xyz, mask, k)
    torch.cuda.synchronize()
    assert COUNTS["knn.knn.launches"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 13, 130])
def test_knn_duplicates_spread_over_chunks(cuda, S):
    # one point repeated over many chunks: the first k indices, in order
    q = torch.tensor([[1.0, 2.0, 3.0]], device=cuda).repeat(700, 1)[None].contiguous()
    r = torch.tensor([[1.0, 2.0, 3.0]], device=cuda).repeat(1300, 1)
    mask = torch.ones(1300, dtype=torch.bool, device=cuda)
    for k in (5, 10):
        idx, d = knn._knn_cuda(q, r, mask, k, plan=_plan(1300, S))
        assert (idx == torch.arange(k, device=cuda, dtype=torch.int32)).all()
        assert float(d.abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 7])
def test_nan_query_comes_back_inf_and_first_slots(cuda, S):
    # a NaN distance never enters (ROADMAP: the kernels differ from the
    # plain versions here); the split keeps that: k-NN (+inf, 0..k-1),
    # bc_races B / C the first candidate whose ring test fails (distance
    # BIG), else (+inf, 0)
    q, xyz, ring, mask = _tied(6, 1, 200, 900, cuda)
    q[0, 17] = float("nan")
    keep = torch.arange(200, device=cuda) != 17
    for k in (5, 10):
        idx, d = knn._knn_cuda(q, xyz, mask, k, plan=_plan(900, S))
        assert torch.isinf(d[0, 17]).all() and idx[0, 17].tolist() == list(range(k))
        want = knn.knn_plain(q, xyz, mask, k)
        assert torch.equal(idx[0, keep], want[0][0, keep])
        assert torch.equal(d[0, keep], want[1][0, keep])
    ia, _ = races.nn1(q, xyz, mask)
    ia[0, 17] = 3
    ring_a = take_ref(ring, ia, True)
    ib, db, ic, dc = races._bc_races_cuda(q, ring_a, ia, xyz, ring, mask, SPAN, plan=_plan(900, S))
    ringf = torch.where(mask, ring.float(), torch.tensor(races.RING_INVALID, device=cuda))
    rd = (ringf - ring_a[0, 17].float()).abs()
    cols = torch.arange(900, device=cuda)
    for (i, dist), ok in (((ib, db), (rd == 0) & (cols != 3)), ((ic, dc), (rd > 0) & (rd <= SPAN))):
        fails = (~ok).nonzero()
        want = (float(np.float32(races.BIG)), int(fails[0])) if len(fails) else (float("inf"), 0)
        assert (float(dist[0, 17]), int(i[0, 17])) == want
    plain = races.bc_races_plain(q, ring_a, ia, xyz, ring, mask, SPAN)
    assert all(torch.equal(a[0, keep], b[0, keep]) for a, b in zip((ib, db, ic, dc), plain))
    # nn1 (+inf, 0); nn1_masked as bc_races' B ("same") and C ("adj")
    i, dist = races._nn1_cuda(q, xyz, mask, plan=_plan(900, S))
    assert (float(dist[0, 17]), int(i[0, 17])) == (float("inf"), 0)
    assert all(torch.equal(a[0, keep], b[0, keep])
               for a, b in zip((i, dist), races.nn1_plain(q, xyz, mask)))
    for mode, (wi, wd) in (("same", (ib, db)), ("adj", (ic, dc))):
        args = (q, ring_a, ia, xyz, ring, mask, mode, SPAN)
        i, dist = races._nn1_masked_cuda(*args, plan=_plan(900, S))
        assert (float(dist[0, 17]), int(i[0, 17])) == (float(wd[0, 17]), int(wi[0, 17]))
        assert all(torch.equal(a[0, keep], b[0, keep])
                   for a, b in zip((i, dist), races.nn1_masked_plain(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("M,S", [(600, 4), (41, 8), (41, 41), (8192, 128)])
def test_bc_races_split_equals_plain_under_ties_at_chunk_edges(cuda, M, S):
    plan = _plan(M, S)
    q, xyz, ring, mask = _tied(7, 2, 300, M, cuda, edges=range(plan[1], M, plan[1]))
    ia, _ = races.nn1(q, xyz, mask)
    ring_a = take_ref(ring, ia, True)
    before = COUNTS["races.bc_races.launches"]
    got = races._bc_races_cuda(q, ring_a, ia, xyz, ring, mask, SPAN, plan=plan)
    want = races.bc_races_plain(q, ring_a, ia, xyz, ring, mask, SPAN)
    torch.cuda.synchronize()
    assert COUNTS["races.bc_races.launches"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _race_cuda(race, q, xyz, ring, mask, plan=None):
    """nn1 ("nn1") or nn1_masked ("adj", "same", with A's ring and index
    from nn1_plain) through the card wrappers, and the plain version."""
    if race == "nn1":
        return races._nn1_cuda(q, xyz, mask, plan=plan), races.nn1_plain(q, xyz, mask)
    ia, _ = races.nn1_plain(q, xyz, mask)
    args = (q, take_ref(ring, ia, xyz.dim() == 2), ia, xyz, ring, mask, race, SPAN)
    return races._nn1_masked_cuda(*args, plan=plan), races.nn1_masked_plain(*args)


def _race_counters(race):
    k = "nn1" if race == "nn1" else "nn1_masked"
    return COUNTS[f"races.{k}.launches"], COUNTS[f"races.{k}.merges"]


@pytest.mark.cuda
@pytest.mark.parametrize("race", ["nn1", "adj", "same"])
@pytest.mark.parametrize("M,S", [(600, 4), (41, 8), (41, 41), (8192, 128)])
def test_nn1_and_masked_split_equal_plain_under_ties_at_chunk_edges(cuda, race, M, S):
    # duplicates straddling the chunk edges, one-point chunks (S = M), a
    # chunk per 64 points at the single-stream surf size; the launch and
    # merge counters move by one call and by one merge where S > 1
    plan = _plan(M, S)
    q, xyz, ring, mask = _tied(8, 2, 300, M, cuda, edges=range(plan[1], M, plan[1]))
    before = _race_counters(race)
    got, want = _race_cuda(race, q, xyz, ring, mask, plan)
    torch.cuda.synchronize()
    assert _race_counters(race) == (before[0] + 1, before[1] + (plan[0] > 1))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("race", ["nn1", "adj", "same"])
@pytest.mark.parametrize("B,Q,M", [(1, 1024, 8192), (1, 256, 2048), (512, 256, 256),
                                   (3, 700, 5000)])
def test_nn1_and_masked_counters_follow_the_split_plan(cuda, race, B, Q, M):
    # the default plan at the single-stream and odometry batch shapes: a
    # merge exactly where _split_plan splits M
    lib = __import__("cooper_mapper_torch.build", fromlist=["library"]).library()
    S, _ = races._split_plan(B, Q, M, races.sm_count(cuda), lib.cooper_nn1_block_queries())
    q, xyz, ring, mask = _problem(16, B, Q, M, False, cuda)
    before = _race_counters(race)
    if race == "nn1":
        got, want = races.nn1(q, xyz, mask), races.nn1_plain(q, xyz, mask)
    else:
        ia, _ = races.nn1_plain(q, xyz, mask)
        args = (q, take_ref(ring, ia, True), ia, xyz, ring, mask, race, SPAN)
        got, want = races.nn1_masked(*args), races.nn1_masked_plain(*args)
    torch.cuda.synchronize()
    assert _race_counters(race) == (before[0] + 1, before[1] + (S > 1))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_all_invalid_reference_gives_the_plain_answer(cuda, per_problem, S):
    # nn1 and nn1_masked form |r|^2 = BIG and the ring 1e9 of an invalid
    # point in the kernel.  With every point invalid, race A's distances
    # (|q|^2 - 2 q.r) + BIG all round to BIG here (|q|, |r| <= 14 m), so the
    # first point wins; every ring race fails everywhere: (BIG, 0) too
    q, xyz, ring, mask = _problem(17, 2, 300, 700, per_problem, cuda)
    mask = torch.zeros_like(mask)
    for race in ("nn1", "adj", "same"):
        got, want = _race_cuda(race, q, xyz, ring, mask, _plan(700, S))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (got[0] == 0).all() and (got[1] == np.float32(races.BIG)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,M", [(1, 4096, 16384), (2, 333, 1000), (1, 100, 10)])
def test_knn_kernel_at_k10_equals_plain_version(cuda, B, Q, M):
    # the feature classifier's k (io/feature_extracter.py): split and unsplit
    q, xyz, _, mask = _problem(14, B, Q, M, False, cuda)
    got = knn.knn(q, xyz, mask, 10)
    want = knn.knn_plain(q, xyz, mask, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].min()) >= 0 and int(got[0].max()) < M
    # any other k <= M runs as well (the register lists up to 32); k > M raises
    assert all(torch.equal(a, b) for a, b in zip(knn.knn(q, xyz, mask, 7),
                                                 knn.knn_plain(q, xyz, mask, 7)))
    with pytest.raises(ValueError):
        knn.knn(q, xyz, mask, M + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("B,Q,M", [(1, 4096, 65536), (4, 1000, 5000)])
def test_knn_on_a_spatially_sorted_reference(cuda, k, B, Q, M):
    # a reference stored in spatial order (as the cube map's surround and the
    # voxel filter's output are), with exact duplicates: the kernel's sampled
    # bound on each chunk's k-th distance must leave the result unchanged
    rng = np.random.RandomState(15)
    xyz = np.round(rng.uniform(-20, 20, (M, 3)), 1).astype(np.float32)
    xyz = xyz[np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))]
    xyz[M // 2:M // 2 + 40] = xyz[M // 2]
    q = np.round(rng.uniform(-20, 20, (B, Q, 3)), 1).astype(np.float32)
    q[0, :5] = xyz[M // 2]
    q = torch.from_numpy(q).to(cuda)
    xyz = torch.from_numpy(xyz).to(cuda)
    mask = torch.from_numpy(rng.rand(M) > 0.05).to(cuda)
    got = knn.knn(q, xyz, mask, k)
    want = knn.knn_plain(q, xyz, mask, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The fused kernel's plans (G lanes per query) and merge_min
# ---------------------------------------------------------------------------


def _fused_case(seed, B, Q, M, per_problem, device):
    """Integer-grid points (heavy ties) with duplicates across lanes and
    tiles, 10% invalid points, a NaN query and FAR queries whose nearest
    point is an invalid one (invalid points parked at 1e6, as the port
    parks them)."""
    rng = np.random.RandomState(seed)
    lead = (B,) if per_problem else ()
    q = rng.randint(-3, 4, (B, Q, 3)).astype(np.float32)
    xyz = rng.randint(-3, 4, lead + (M, 3)).astype(np.float32)
    if M > 700:
        xyz[..., 600:640, :] = xyz[..., 5:6, :]
    ring = rng.randint(0, 4, lead + (M,)).astype(np.int32)
    mask = rng.rand(*(lead + (M,))) > 0.1
    xyz[~mask] = 1e6
    if Q > 2:
        q[:, 1] = 1e6
        q[:, 2] = np.nan
    return tuple(torch.from_numpy(a).to(device) for a in (q, xyz, ring, mask))


def _nan_rows_as_a_scan(got, q, ring, mask, with_same):
    """On a NaN query the kernel is a strict-"<" scan that nothing enters but
    the BIG of a failed ring test: A (+inf, 0); B / C the first candidate
    that fails its ring test at BIG, else (+inf, 0).  Checks that and
    returns the finite rows."""
    nan = torch.isnan(q).any(-1)
    ringf = torch.where(mask, ring.float(), torch.tensor(races.RING_INVALID, device=q.device))
    for b, qi in nan.nonzero().tolist():
        rf = ringf if ringf.dim() == 1 else ringf[b]
        assert (float(got[1][b, qi]), int(got[0][b, qi])) == (float("inf"), 0)
        rd = (rf - rf[0]).abs()
        cols = torch.arange(rf.numel(), device=q.device)
        oks = ([(rd == 0) & (cols != 0)] if with_same else []) + [(rd > 0) & (rd <= SPAN)]
        for k, ok in enumerate(oks, 1):
            fails = (~ok).nonzero()
            want = (float(np.float32(races.BIG)), int(fails[0])) if len(fails) else (
                float("inf"), 0)
            assert (float(got[2 * k + 1][b, qi]), int(got[2 * k][b, qi])) == want
    return ~nan


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("Q", [1, 128, 1024])
@pytest.mark.parametrize("M", [1, 127, 2048, 8191, 8192])
@pytest.mark.parametrize("plan", races.FUSED_PLANS, ids=lambda p: f"G{p[0]}x{p[1]}")
def test_fused_kernel_at_every_plan_equals_plain(cuda, plan, M, Q, per_problem):
    # every plan the launcher can pick, forced: bit for bit against the
    # plain version on every finite query, the scan's answer on a NaN one
    q, xyz, ring, mask = _fused_case(18, 2, Q, M, per_problem, cuda)
    for with_same in (True, False):
        before = COUNTS["races.fused_races.launches"]
        got = races._fused_races_cuda(q, xyz, ring, mask, with_same, SPAN, plan=plan)
        want = races.fused_races_plain(q, xyz, ring, mask, with_same, SPAN)
        torch.cuda.synchronize()
        assert COUNTS["races.fused_races.launches"] == before + 1
        keep = _nan_rows_as_a_scan(got, q, ring, mask, with_same)
        for a, b in zip(got, want):
            assert torch.equal(a[keep], b[keep])
        if Q > 2:
            # the FAR query's A is an invalid point, where the reference has one
            valid_a = take_ref(mask, got[0], not per_problem)[:, 1]
            assert not bool(valid_a[(~mask).any(-1).expand(2)].any())


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("plan", races.FUSED_PLANS, ids=lambda p: f"G{p[0]}x{p[1]}")
def test_fused_kernel_on_an_all_invalid_reference(cuda, plan, per_problem):
    # |r|^2 = BIG and the ring 1e9 formed in the kernel: every distance
    # rounds to BIG (|q|, |r| <= 14 m), so A is the first point, A's ring
    # 1e9 matches every point's, and C fails everywhere: (BIG, 0)
    q, xyz, ring, mask = _problem(19, 2, 300, 1000, per_problem, cuda)
    mask = torch.zeros_like(mask)
    for with_same in (True, False):
        got = races._fused_races_cuda(q, xyz, ring, mask, with_same, SPAN, plan=plan)
        want = races.fused_races_plain(q, xyz, ring, mask, with_same, SPAN)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (got[0] == 0).all() and (got[-2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,M", [(1, 1024, 8192), (1, 256, 2048), (512, 768, 3840),
                                   (512, 256, 256)])
def test_fused_races_launches_one_kernel(cuda, B, Q, M):
    # the wrapper validates, allocates and launches the kernel: nothing else
    # runs on the card (the profiler counts every kernel of the calls)
    q, xyz, ring, mask = _problem(20, B, Q, M, False, cuda)
    for with_same in (True, False):
        races.fused_races(q, xyz, ring, mask, with_same, SPAN)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                races.fused_races(q, xyz, ring, mask, with_same, SPAN)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 3 and all("fused_races_kernel" in k for k in kernels), kernels


@pytest.mark.cuda
def test_fused_plan_unit_matches_the_library(cuda):
    lib = __import__("cooper_mapper_torch.build", fromlist=["library"]).library()
    assert lib.cooper_fused_block_threads() == races.FUSED_THREADS
    q, xyz, ring, mask = _problem(21, 1, 128, 256, False, cuda)
    with pytest.raises(ValueError):
        races._fused_races_cuda(q, xyz, ring, mask, True, SPAN, plan=(2, 1))


def _merge_partials(searches, S, n, L, device, seed=0):
    """S chunks' (min, argmin) pairs per query and search, as a split race
    writes them: integer distances (ties across chunks), BIG, and (+inf, 0)
    where a chunk had no candidate."""
    rng = np.random.RandomState(seed + S)
    d = rng.randint(0, 4, (searches, S, n)).astype(np.float32)
    d[rng.rand(searches, S, n) < 0.2] = races.BIG
    i = (np.arange(S)[None, :, None] * L + rng.randint(0, L, (searches, S, n))).astype(np.int32)
    none = rng.rand(searches, S, n) < 0.3
    d[none], i[none] = np.inf, 0
    return torch.from_numpy(d).to(device), torch.from_numpy(i).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 3, 31, 32, 33, 66, 130])
def test_merge_min_equals_the_one_scan(cuda, S):
    # up to four searches in one launch, ragged n, ties across
    # chunks: the chunk-order merge's bits (merge_min_plain, held to the
    # sequential merge on the CPU by tests/test_torch_races.py)
    for searches, n in ((1, 1024), (2, 1000), (4, 37)):
        pd, pi = _merge_partials(searches, S, n, 64, cuda)
        before = COUNTS["races.merge_min.launches"]
        got = races._merge_min_cuda(pd, pi)
        torch.cuda.synchronize()
        assert COUNTS["races.merge_min.launches"] == before + 1
        want = races.merge_min_plain(pd, pi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("race", ["nn1", "adj", "same", "bc"])
def test_merge_min_counts_the_split_races_merges(cuda, race):
    # a split race launches merge_min once per call (bc_races: both searches
    # in one launch); an unsplit one does not
    q, xyz, ring, mask = _problem(22, 1, 300, 2000, False, cuda)
    ia, _ = races.nn1_plain(q, xyz, mask)
    ring_a = take_ref(ring, ia, True)
    for S in (1, 9):
        before = COUNTS["races.merge_min.launches"]
        if race == "nn1":
            races._nn1_cuda(q, xyz, mask, plan=_plan(2000, S))
        elif race == "bc":
            races._bc_races_cuda(q, ring_a, ia, xyz, ring, mask, SPAN, plan=_plan(2000, S))
        else:
            races._nn1_masked_cuda(q, ring_a, ia, xyz, ring, mask, race, SPAN,
                                   plan=_plan(2000, S))
        assert COUNTS["races.merge_min.launches"] == before + (S > 1)


# ---------------------------------------------------------------------------
# The listed walks: nn1, nn1_masked and bc_races given valid_list's lists
# ---------------------------------------------------------------------------


def _listed_case(seed, B, Q, M, q_frac, r_frac, per_problem, device, tied=False, empty=(),
                 pairs=False):
    """Queries and a reference as a feature cloud holds them: a share
    ``q_frac`` / ``r_frac`` of the slots valid, scattered, the others at
    the FAR sentinel; ``tied`` puts the points on an integer grid (heavy
    ties), ``pairs`` repeats each even slot in the odd one after it (M
    even), ``empty`` lists problems whose reference has no valid point."""
    rng = np.random.RandomState(seed)
    lead = (B,) if per_problem else ()
    pts = ((lambda *s: rng.randint(-3, 4, s).astype(np.float32)) if tied
           else (lambda *s: rng.uniform(-30, 30, s).astype(np.float32)))
    q, xyz = pts(B, Q, 3), pts(*lead, M, 3)
    ring = rng.randint(0, 4 if tied else R, lead + (M,)).astype(np.int32)
    q_mask = rng.rand(B, Q) < q_frac
    r_mask = rng.rand(*(lead + (M,))) < r_frac
    if pairs:
        xyz[..., 1::2, :] = xyz[..., 0::2, :]
        ring[..., 1::2] = ring[..., 0::2]
        r_mask[..., 1::2] = r_mask[..., 0::2]
    for b in empty:
        r_mask[b] = False
    q[~q_mask], xyz[~r_mask] = 1e6, 1e6
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (q, xyz, ring, q_mask, r_mask))


def _listed_against_plain(q, xyz, ring, q_mask, r_mask, plan=None, miss_every=0):
    """Every listed race on the card against its plain version given the
    query mask, bit for bit on every slot; returns the answers."""
    shared = xyz.dim() == 2
    lists = dict(q_list=races.valid_list(q_mask), r_list=races.valid_list(r_mask))
    ia, da = races._nn1_cuda(q, xyz, r_mask, plan=plan, **lists)
    want = races.nn1_plain(q, xyz, r_mask, q_mask)
    assert torch.equal(ia, want[0]) and torch.equal(da, want[1])
    ring_a = take_ref(ring, ia, shared)
    if miss_every:   # rings no candidate is near: no ring candidate passes
        ring_a[:, ::miss_every] = 40
    for mode in ("adj", "same"):
        args = (q, ring_a, ia, xyz, ring, r_mask, mode, SPAN)
        got = races._nn1_masked_cuda(*args, plan=plan, **lists)
        want = races.nn1_masked_plain(*args, q_mask=q_mask)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), mode
    args = (q, ring_a, ia, xyz, ring, r_mask, SPAN)
    got = races._bc_races_cuda(*args, plan=plan, **lists)
    want = races.bc_races_plain(*args, q_mask=q_mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return ia, ring_a, got


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
@pytest.mark.parametrize("B,Q,M,q_frac,r_frac", [(8, 1024, 8192, 0.59, 0.5),
                                                 (8, 256, 2048, 0.48, 0.06),
                                                 (3, 1000, 8191, 0.5, 0.3),
                                                 (4, 256, 256, 1.0, 1.0),
                                                 (4, 300, 700, 0.0, 0.5)],
                         ids=["surf", "corner", "ragged", "all-valid", "no-valid-query"])
def test_listed_races_equal_plain(cuda, per_problem, B, Q, M, q_frac, r_frac):
    # the odometry cell's shapes and shares of valid slots (surf 8 x 1024 vs
    # 8192 at ~50%, corner 8 x 256 vs 2048 at ~6%), ragged, every slot valid
    # (identity lists, today's walk) and no valid query (every block exits)
    q, xyz, ring, q_mask, r_mask = _listed_case(31, B, Q, M, q_frac, r_frac, per_problem, cuda)
    ia, _, _ = _listed_against_plain(q, xyz, ring, q_mask, r_mask, miss_every=5)
    assert (ia[~q_mask] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
def test_listed_races_without_a_valid_reference_point(cuda, per_problem):
    # a problem with no valid reference point walks all M slots: the FAR
    # sentinel's answer, as the parent's whole walk gives it
    B, Q, M = 4, 256, 2048
    q, xyz, ring, q_mask, r_mask = _listed_case(32, B, Q, M, 0.5, 0.06, per_problem, cuda,
                                                empty=(1, 3) if per_problem else ())
    if not per_problem:
        r_mask = torch.zeros_like(r_mask)
    _listed_against_plain(q, xyz, ring, q_mask, r_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("race_plan", [(8192, 128), (8192, 3), (8192, 2), (600, 4), (41, 41)],
                         ids=lambda p: f"M{p[0]}-S{p[1]}")
def test_listed_races_at_pinned_split_plans(cuda, race_plan):
    # B = 1, as the single stream splits M: chunks cover list positions,
    # so with ~45% valid the count falls inside one chunk and every later
    # chunk walks nothing; integer-grid points (ties at the chunk edges)
    M, S = race_plan
    q, xyz, ring, q_mask, r_mask = _listed_case(33, 1, 700, M, 0.6, 0.45, False, cuda,
                                                tied=True)
    plan = _plan(M, S)
    count = int(r_mask.sum())
    assert 0 < count < M and (plan[0] == 1 or count < (plan[0] - 1) * plan[1])
    _listed_against_plain(q, xyz, ring, q_mask, r_mask, plan=plan, miss_every=7)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 5])
def test_listed_races_duplicates_keep_the_smaller_index(cuda, S):
    # every valid point repeated in the next slot: the smaller index wins
    # each tie, whole and split, per problem and shared
    q, xyz, ring, q_mask, r_mask = _listed_case(34, 3, 512, 4096, 0.7, 0.5, True, cuda, tied=True,
                                                pairs=True)
    ia, _, _ = _listed_against_plain(q, xyz, ring, q_mask, r_mask, plan=_plan(4096, S))
    assert (ia[q_mask] % 2 == 0).all()    # the first of each pair
    _listed_against_plain(q, xyz[0].contiguous(), ring[0].contiguous(), q_mask,
                          r_mask[0].contiguous(), plan=_plan(4096, S))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4])
def test_listed_ring_race_with_no_candidate(cuda, S):
    # no candidate passes the ring test anywhere: (BIG, 0), the parent's
    # first failing slot, never the first listed one (problem 1's first
    # valid slot is 3)
    q, xyz, ring, q_mask, r_mask = _listed_case(35, 2, 300, 900, 0.8, 0.4, True, cuda,
                                                tied=True)
    r_mask[1, :3] = False
    xyz[~r_mask] = 1e6
    _, _, (ib, db, ic, dc) = _listed_against_plain(q, xyz, ring, q_mask, r_mask,
                                                   plan=_plan(900, S), miss_every=1)
    big = np.float32(races.BIG)
    assert (db[q_mask] == big).all() and (dc[q_mask] == big).all()
    assert (ib[q_mask] == 0).all() and (ic[q_mask] == 0).all()


@pytest.mark.cuda
def test_listed_races_beyond_65535_problems(cuda):
    # the slabs move the lists and counts with the problems
    B, Q, M = 65537, 3, 40
    q, xyz, ring, q_mask, r_mask = _listed_case(36, B, Q, M, 0.6, 0.5, True, cuda)
    _listed_against_plain(q, xyz, ring, q_mask, r_mask)
    _listed_against_plain(q, xyz, ring, q_mask, r_mask, plan=_plan(M, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4])
def test_listed_pair_counters_count_the_launch_blocks(cuda, S):
    # race_pairs_walked counts the query slots of the blocks that scan: each
    # problem's valid queries rounded up to the launch's block (capped at Q)
    from cooper_mapper_torch.build import library
    from cooper_mapper_torch.utils import profiling

    B, Q, M = 6, 700, 900
    q, xyz, ring, q_mask, r_mask = _listed_case(37, B, Q, M, 0.3, 0.5, True, cuda)
    lists = dict(q_list=races.valid_list(q_mask), r_list=races.valid_list(r_mask))
    lib = library()
    plan = _plan(M, S)
    nr = r_mask.sum(-1).long().cpu()
    nv = q_mask.sum(-1).long().cpu()
    walked = lambda block: int((torch.clamp(-(-nv // block) * block, max=Q) * nr).sum())
    with profiling.tracing() as tr:
        with profiling.span("nn1"):
            ia, _ = races._nn1_cuda(q, xyz, r_mask, plan=plan, **lists)
        ring_a = take_ref(ring, ia, False)
        with profiling.span("bc"):
            races._bc_races_cuda(q, ring_a, ia, xyz, ring, r_mask, SPAN, plan=plan, **lists)
    got = tr.counters()   # the spans also hold the launch tallies
    nn1_block = lib.cooper_nn1_block_queries() if S > 1 else lib.cooper_nn1_whole_block_queries()
    for span, block in (("nn1", nn1_block), ("bc", lib.cooper_bc_races_block_queries())):
        pairs = {k: got[span].get(k) for k in ("race_pairs_walked", "race_pairs_padded")}
        assert pairs == {"race_pairs_walked": walked(block),
                         "race_pairs_padded": B * Q * M}, (span, pairs)


# ---------------------------------------------------------------------------
# The pipeline slice on the card: the cube map's dedup, the UKF, the entry point
# ---------------------------------------------------------------------------


def _dedup_map(device, policy):
    """A small cube map after four inserts of lattice clouds (many points per
    voxel, cubes straddled), built the same way on ``device``."""
    from cooper_mapper_torch.config import MapConfig
    from cooper_mapper_torch.maps import feature_map as fm
    from cooper_mapper_torch.utils import cloud

    cfg = MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, valid_distance=20.0,
                    corner_cube_capacity=256, surf_cube_capacity=512, margin_cubes=1,
                    dedup_policy=policy)
    rng = np.random.RandomState(1)
    st = fm.create(cfg, device)
    for _ in range(4):
        clouds = []
        for n in (700, 1400):
            xyz = np.round(rng.uniform(-12, 12, (n, 3)) / 0.15) * 0.15
            clouds.append(cloud.make(torch.from_numpy(xyz.astype(np.float32)).to(device),
                                     torch.from_numpy(rng.rand(n) < 0.9).to(device)))
        fm.add_feature_cloud(st, clouds[0], clouds[1], cfg)
    return st, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["centroid", "anchor"])
def test_dedup_active_on_card_equals_cpu_and_repeats(cuda, policy):
    from cooper_mapper_torch.maps import feature_map as fm

    pos = torch.tensor([3.0, 1.0, -2.0])
    st_cpu, cfg = _dedup_map("cpu", policy)
    fm.dedup_active(st_cpu, pos, cfg)
    runs = []
    for _ in range(2):
        st, _ = _dedup_map(cuda, policy)
        runs.append(fm.dedup_active(st, pos.to(cuda), cfg))
    for st in runs:
        for cc, ref in ((st.corner, st_cpu.corner), (st.surf, st_cpu.surf)):
            assert torch.equal(cc.count.cpu(), ref.count)
            assert torch.equal(cc.row_mask.cpu()[:-1], ref.row_mask[:-1])
            assert torch.equal(cc.xyz.cpu(), ref.xyz)


@pytest.mark.cuda
def test_ukf_on_card_equals_cpu(cuda):
    from cooper_mapper_torch.config import UKFConfig
    from cooper_mapper_torch.fusion import imu_queue, ukf_estimator
    from cooper_mapper_torch.ops import ukf

    cfg = UKFConfig(cool_time_duration=0.0)
    rng = np.random.RandomState(2)
    # _safe_cholesky on a matrix that is not positive definite takes the
    # 1e-4 jitter on both devices
    Q, _ = np.linalg.qr(rng.randn(16, 16))
    bad = torch.from_numpy((Q @ np.diag(np.r_[np.linspace(0.01, 1, 15), -1e-5]) @ Q.T)
                           .astype(np.float32))
    L_cpu, L_card = ukf._safe_cholesky(bad), ukf._safe_cholesky(bad.to(cuda)).cpu()
    assert torch.isfinite(L_card).all()
    assert torch.allclose(L_card, L_cpu, rtol=0, atol=1e-5)

    stamps = torch.arange(1, 11, dtype=torch.float32) * 0.01
    acc = torch.from_numpy(rng.randn(10, 3).astype(np.float32))
    gyro = torch.from_numpy(rng.randn(10, 3).astype(np.float32) * 0.5)
    out = {}
    for dev in ("cpu", cuda):
        st = ukf_estimator.create(cfg, pos=torch.tensor([1.0, 2.0, 3.0]), device=dev)
        batch = imu_queue.ImuBatch(stamps.to(dev), acc.to(dev), gyro.to(dev),
                                   torch.ones(10, dtype=torch.bool, device=dev))
        st = imu_queue.replay_predict(st, batch, 0.0, 0.1, cfg)
        T = torch.eye(4, device=dev)
        T[:3, 3] = torch.tensor([1.1, 2.0, 3.05], device=dev)
        st = imu_queue.correct_from_lidar(st, T, torch.tensor([0.5, 0.0, 0.0], device=dev),
                                          torch.eye(4, device=dev), cfg)
        out[str(dev)] = st
    c, g = out["cpu"], out[str(cuda)]
    assert torch.allclose(g.ukf.mean.cpu(), c.ukf.mean, rtol=0, atol=1e-5)
    assert torch.allclose(g.ukf.cov.cpu(), c.ukf.cov, rtol=0,
                          atol=1e-5 * float(c.ukf.cov.abs().max()))


@pytest.mark.cuda
def test_slam_pipeline_builds_its_state_on_the_card(cuda):
    from cooper_mapper_torch.config import MapConfig, PipelineConfig
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    cfg = PipelineConfig(feature_map=MapConfig(n_cubes=(5, 3, 5)))
    for mode in ("mapping", "local"):
        pipe = SlamPipeline(cfg, mode)                      # the default device
        assert pipe.device.type == "cuda"
        tensors = [pipe.odo.T_sum, pipe.matcher.W_last, pipe.ukf.ukf.mean, pipe.T_li]
        tensors += ([pipe.map_state.surf.rows, pipe.map_state.origin] if mode == "mapping"
                    else [pipe.map_state.surf_xyz, pipe.map_state.head])
        assert all(t.is_cuda for t in tensors)


@pytest.mark.cuda
def test_voxel_and_cube_cells_on_card_equal_cpu_on_cell_boundaries(cuda):
    # lattice points sit exactly on voxel and cube boundaries (4.2 m on a
    # 0.2 m leaf, 15 m on 10 m cubes); the card must floor them into the
    # CPU's cells, so the division cannot be a product with a reciprocal
    from cooper_mapper_torch.config import MapConfig
    from cooper_mapper_torch.maps.feature_map import world_to_cube
    from cooper_mapper_torch.ops.voxel import voxel_coords

    rng = np.random.RandomState(3)
    xyz = torch.from_numpy((np.round(rng.uniform(-30, 30, (200000, 3)) / 0.15) * 0.15)
                           .astype(np.float32))
    for leaf in (0.2, 0.4):
        assert torch.equal(voxel_coords(xyz.to(cuda), leaf).cpu(), voxel_coords(xyz, leaf))
    cfg = MapConfig(cube_size=10.0)
    assert torch.equal(world_to_cube(xyz.to(cuda), cfg).cpu(), world_to_cube(xyz, cfg))


# ---- the pose-graph backend on the card ------------------------------------

def _ring_graph(device, solver, **changes):
    """sim.drifted_ring_graph(64, loop_every=16) on ``device`` and its
    PoseGraphConfig (64 nodes, 128 edges)."""
    from cooper_mapper_torch.config import PoseGraphConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import pose_graph as pg

    g = pg.from_arrays(*sim.drifted_ring_graph(64, loop_every=16), max_nodes=64,
                       max_edges=128, device=device)
    return g, PoseGraphConfig(max_nodes=64, max_edges=128, solver=solver, **changes)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_lm_on_card_repeats_and_equals_cpu(cuda, solver):
    # the scatter-adds are ordered segment sums, so a repeat gives the same
    # bits; the card and the CPU agree within the pipeline's 2e-3
    from cooper_mapper_torch.ops import pose_graph as pg

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        g, cfg = _ring_graph(dev, solver)
        runs[dev.type] = (g, pg.optimize(g, cfg), pg.optimize(g, cfg))
    g, (a, da), (b, _) = runs["cuda"]
    _, (c, dc), _ = runs["cpu"]
    assert torch.equal(a.poses, b.poses)
    assert torch.equal(a.poses[0], g.poses[0])
    assert float((a.poses.cpu() - c.poses).abs().max()) <= 2e-3
    assert float(da["lambda"]) == float(dc["lambda"])
    assert float(da["final_cost"]) < 0.2 * float(da["initial_cost"])


@pytest.mark.cuda
def test_pose_graph_nan_edge_on_card_keeps_the_poses(cuda):
    # cholesky_ex reports the failed factorization on the device: no raise,
    # the step is zero, lambda climbs to its clip
    from cooper_mapper_torch.ops import pose_graph as pg

    g, cfg = _ring_graph(cuda, "dense", max_iterations=12)
    g.edge_T[3, 0, 3] = float("nan")
    out, diag = pg.optimize(g, cfg)
    assert torch.equal(out.poses, g.poses)
    assert float(diag["lambda"]) == 1e6


@pytest.mark.cuda
def test_icp_on_card_equals_cpu(cuda):
    from cooper_mapper_torch.ops import icp
    from cooper_mapper_torch.utils import cloud as cloud_lib
    from cooper_mapper_torch.utils import se3

    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (4000, 3)).astype(np.float32)
    pts[:2000, 1] = 0.0
    pts[2000:, 0] = 3.0
    T_true = se3.se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.02, 0.05, -0.03]))
    src = ((torch.from_numpy(pts) - T_true[:3, 3]) @ T_true[:3, :3]).numpy()
    pts = pts + 0.01 * rng.randn(*pts.shape).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        target = cloud_lib.from_points(pts, capacity=4100, device=dev)
        source = cloud_lib.from_points(src, capacity=4096, device=dev)
        out[dev.type] = icp.icp(source, target, torch.eye(4, device=dev), max_iterations=8)
    (T, rmse, n), (Tc, rmse_c, n_c) = out["cuda"], out["cpu"]
    assert float((T.cpu() - Tc).abs().max()) <= 1e-4
    assert int(n) == int(n_c)
    assert abs(float(rmse) - float(rmse_c)) <= 1e-5


def _spd_batch(rng, B, n_small=0):
    """B SPD 6x6 systems, eigenvalues in [20, 100]; the first ``n_small``
    get two well separated eigenvalues below the threshold 10."""
    A = np.empty((B, 6, 6), np.float32)
    for b in range(B):
        V, _ = np.linalg.qr(rng.randn(6, 6))
        lam = rng.uniform(20, 100, 6)
        if b < n_small:
            lam[:2] = [0.5, 3.0]
        A[b] = (V * lam) @ V.T
    return torch.from_numpy(A), torch.from_numpy((5 * rng.randn(B, 6)).astype(np.float32))


def _without_host_sync(fn):
    """``fn()`` with PyTorch's synchronising calls turned into errors."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_lu_solve_on_card_equals_cpu_without_a_host_sync(cuda):
    # the parity modes' LU solve: lu_factor_ex leaves its info unread, so the
    # card is not waited for; an exactly singular system comes back inf/NaN
    from cooper_mapper_torch.ops import gauss_newton as gn

    A, b = _spd_batch(np.random.RandomState(21), 64)
    v = torch.arange(1.0, 7.0)
    A[-1] = torch.outer(v, v) * 1e6                  # rank one: an exact zero pivot
    A_c, b_c = A.to(cuda), b.to(cuda)
    got = _without_host_sync(lambda: gn.solve_6x6(A_c, b_c, spd=False))
    want = gn.solve_6x6(A, b, spd=False)
    torch.testing.assert_close(got[:-1].cpu(), want[:-1], rtol=1e-4, atol=1e-5)
    assert torch.equal(torch.isfinite(got[-1]).cpu(), torch.isfinite(want[-1]))
    assert not torch.isfinite(got[-1]).all()


@pytest.mark.cuda
def test_reference_projector_on_card(cuda):
    # P = V^T Vz follows each eigenvector's sign: with D = diag(sign(v_card .
    # v_cpu)), V_card = V_cpu D, and zeroing rows commutes with scaling
    # columns, so P_card = D P_cpu D on every system whatever signs
    # cuSOLVER returns.  Between the two eigensolvers the f32 eigenvectors
    # of the small eigenvalues (0.5 and 3.0: a gap of 2.5 against a norm of
    # ~100) differ by ~eps * 100 / 2.5 ~ 5e-6 per entry, so P by ~1e-5:
    # compared at 1e-4
    from cooper_mapper_torch.ops import gauss_newton as gn

    A, _ = _spd_batch(np.random.RandomState(22), 64, n_small=48)
    P, deg = gn.degeneracy_projector(A.to(cuda), 10.0, reference_mode=True)
    P_cpu, deg_cpu = gn.degeneracy_projector(A, 10.0, reference_mode=True)
    assert torch.equal(deg.cpu(), deg_cpu), (deg.cpu(), deg_cpu)
    assert int(deg_cpu.sum()) == 48
    V = torch.linalg.eigh(A.to(cuda))[1].cpu()
    D = torch.sign((V * torch.linalg.eigh(A)[1]).sum(-2))
    assert bool((D != 0).all())
    agree = (D > 0).all(-1)
    want = D[..., :, None] * P_cpu * D[..., None, :]
    print(f"card eigenvectors with LAPACK's signs in {int(agree.sum())} of 64 systems; "
          f"card P vs D P_cpu D: {float((P.cpu() - want).abs().max())}; card vs CPU P "
          f"where the signs agree: "
          f"{float((P.cpu() - P_cpu)[agree].abs().max()) if agree.any() else None}")
    torch.testing.assert_close(P.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("reference_mode", [True, False])
def test_gn_steps_on_card_make_no_host_sync(cuda, reference_mode):
    # the GN loop's steps after iteration 0 (whose eigh is the one host
    # read), in both modes, equal to the CPU's from the same projector
    from cooper_mapper_torch.ops import gauss_newton as gn

    A, b = _spd_batch(np.random.RandomState(23), 32, n_small=8)
    P, deg = gn.degeneracy_projector(A, 10.0, reference_mode)
    kw = dict(eig_threshold=10.0, delta_r_abort=0.1, delta_t_abort=0.1, min_matched=10,
              reference_mode=reference_mode)

    def steps(P, deg, A, b):
        st = gn.gn_init(torch.zeros_like(b))
        st = gn.GNState(st.x, P, deg, st.converged, st.n_matched, st.iter_used)
        for it in (1, 2, 3):
            st = gn.gn_step(st, A, b, torch.full_like(b[:, 0], 50.0), it, **kw)
        return st.x
    on_card = [t.to(cuda) for t in (P, deg, A, b)]          # the copies wait for the host
    got = _without_host_sync(lambda: steps(*on_card))
    torch.testing.assert_close(got.cpu(), steps(P, deg, A, b), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_knn_at_k10_at_the_converters_shape(cuda):
    """The offline converter's search (io/feature_extracter.neighbours): a
    map cloud against itself at k = 10, B = 1 and Q = M, under the plan
    ``_split_plan`` picks, against knn_plain on a query subset."""
    from cooper_mapper_torch.io import feature_extracter

    rng = np.random.RandomState(16)
    pts = torch.from_numpy(rng.uniform(-30, 30, (60000, 3)).astype(np.float32)).to(cuda)
    pts[:, 1] = torch.round(pts[:, 1])                  # planes, so near ties occur
    before = COUNTS["knn.knn.launches"]
    idx = feature_extracter.neighbours(pts, 10)
    assert COUNTS["knn.knn.launches"] == before + 1
    sub = torch.from_numpy(rng.choice(60000, 2048, replace=False)).to(cuda)
    mask = torch.ones(60000, dtype=torch.bool, device=cuda)
    got = knn.knn(pts[sub][None], pts, mask, 10)
    want = knn.knn_plain(pts[sub][None], pts, mask, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(idx[sub], want[0][0].long())
    # more neighbourhoods than one eigvalsh call takes: labels as the CPU's
    # from the same neighbours, but on a threshold's ulp
    big = torch.cat([pts, pts[:feature_extracter.EIG_BATCH] + 0.05])
    nb = feature_extracter.neighbours(big, 10)
    ev_card = feature_extracter.eigenvalues(big, nb)
    ev_cpu = feature_extracter.eigenvalues(big.cpu(), nb.cpu())
    differ = torch.zeros(len(big), dtype=torch.bool)
    for a, b in zip(feature_extracter.labels(ev_card), feature_extracter.labels(ev_cpu)):
        differ |= a.cpu() != b
    margin = torch.minimum(feature_extracter.threshold_margin(ev_card).cpu(),
                           feature_extracter.threshold_margin(ev_cpu))
    assert len(big) > feature_extracter.EIG_BATCH and bool(torch.isfinite(ev_card).all())
    assert int(differ.sum()) <= 1e-3 * len(big) and bool((margin[differ] < 1e-4).all())


@pytest.mark.cuda
@pytest.mark.parametrize("use_native", [False, True])
def test_dynamic_map_flush_and_reload_on_card_equal_cpu(cuda, tmp_path, use_native):
    """The out-of-core map on the card pages the same cubes as on the CPU:
    the same ledger, counts, files and surround after an out-and-back
    wander (the window shift and the slots come from the same code on both)."""
    from cooper_mapper_torch.config import MapConfig
    from cooper_mapper_torch.maps import dynamic_map
    from cooper_mapper_torch.utils import cloud

    cfg = MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, corner_cube_capacity=256,
                    surf_cube_capacity=512, surround_corner_capacity=2048,
                    surround_surf_capacity=4096, valid_distance=25.0)
    pts = np.random.RandomState(3).uniform(-12, 12, (400, 3)).astype(np.float32)
    pts[:40] = np.round(pts[:40] / 10.0 - 0.5) * 10.0 + 5.0    # on cube boundaries
    maps = {}
    for dev in ("cpu", "cuda"):
        d = dynamic_map.DynamicFeatureMap.create(cfg, str(tmp_path / dev),
                                                 use_native_pager=use_native, device=dev)
        c = cloud.from_points(pts, device=dev)
        d.add_feature_cloud(c, c)
        for pos in ([60.0, 0, 0], [120.0, 0, 5.0], [0.0, 0, 0], [35.0, 0, -35.0], [0.0, 0, 0]):
            d.page(torch.tensor(pos, device=dev))
        d.save()
        maps[dev] = d
    a, b = maps["cpu"], maps["cuda"]
    assert a.on_disk == b.on_disk and (a.n_flushed, a.n_loaded) == (b.n_flushed, b.n_loaded)
    assert b.n_loaded > 0
    for ca, cb in ((a.state.corner, b.state.corner), (a.state.surf, b.state.surf)):
        assert torch.equal(ca.count, cb.count.cpu())
        assert torch.equal(ca.xyz, cb.xyz.cpu()) and torch.equal(ca.mask, cb.mask.cpu())
    assert sorted(p.name for p in (tmp_path / "cpu").iterdir()) == \
        sorted(p.name for p in (tmp_path / "cuda").iterdir())


# ---------------------------------------------------------------------------
# The k-NN at every k (register lists k <= 32, the select route above) and
# every search kernel beyond 65,535 problems
# ---------------------------------------------------------------------------

EVERY_K = tuple(range(1, 33)) + (33, 64, 100, 257)


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("B,Q,M", [(3, 333, 1000), (1, 2048, 8192)])
def test_knn_every_k_equals_plain_version(cuda, per_problem, B, Q, M):
    # both routes and (at B = 1) the split of the register lists, every k
    q, xyz, _, mask = _problem(21, B, Q, M, per_problem, cuda)
    before = (COUNTS["knn.knn.launches"], COUNTS["knn.knn_select.launches"])
    for k in EVERY_K:
        got, want = knn.knn(q, xyz, mask, k), knn.knn_plain(q, xyz, mask, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k
    torch.cuda.synchronize()
    assert (COUNTS["knn.knn.launches"] - before[0],
            COUNTS["knn.knn_select.launches"] - before[1]) == (32, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 16, 17, 24, 25, 32])
@pytest.mark.parametrize("M,S", [(600, 4), (41, 8), (1300, 13)])
def test_knn_every_k_split_under_ties_at_chunk_edges(cuda, k, M, S):
    # chunks shorter than k included: the merge of each instantiation's
    # lists in chunk order keeps the one-scan bits
    if k > M:
        pytest.skip("k > M is rejected")
    plan = _plan(M, S)
    q, xyz, _, mask = _tied(5, 2, 300, M, cuda, edges=range(plan[1], M, plan[1]))
    got = knn._knn_cuda(q, xyz, mask, k, plan=plan)
    want = knn.knn_plain(q, xyz, mask, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 100, 1300])
def test_knn_select_route_ties_nan_and_k_equal_m(cuda, k):
    # ties listed by index, a NaN query as the register lists give it
    # (+inf, 0..k-1), and k = M; one point repeated: the first k indices
    q, xyz, _, mask = _tied(6, 2, 200, 1300, cuda)
    q[1, 17] = float("nan")
    idx, d = knn.knn(q, xyz, mask, k)
    assert torch.isinf(d[1, 17]).all() and idx[1, 17].tolist() == list(range(k))
    want = knn.knn_plain(q, xyz, mask, k)
    keep = torch.ones(2, 200, dtype=torch.bool, device=cuda)
    keep[1, 17] = False
    assert torch.equal(idx[keep], want[0][keep]) and torch.equal(d[keep], want[1][keep])
    r = torch.tensor([[1.0, 2.0, 3.0]], device=cuda).repeat(1300, 1)
    idx, d = knn.knn_select(q[:, :5].contiguous(), r, torch.ones(1300, dtype=torch.bool,
                                                                 device=cuda), k)
    assert (idx[0, :3] == torch.arange(k, device=cuda, dtype=torch.int32)).all()


@pytest.mark.cuda
def test_knn_select_route_in_scratch_slabs(cuda, monkeypatch):
    # keys beyond shared memory, the queries launched a few rows at a time
    monkeypatch.setattr(knn, "_SELECT_SCRATCH_BYTES", 3 * 8 * 8192)
    q, xyz, _, mask = _problem(22, 2, 50, 5000, True, cuda)
    for k in (4097, 5000):
        got, want = knn.knn(q, xyz, mask, k), knn.knn_plain(q, xyz, mask, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        knn._knn_cuda(q, xyz, mask, 33)      # the register lists stop at 32


def _chunk_lists(S, n, K, device, seed=0):
    """Chunk lists [S, n, K] as the split k-NN kernel writes them: chunk z
    holds 1..L points with indices from z * L, integer distances (ties within
    and across chunks) and some BIG, listed by (d, j), then (+inf, 0), (+inf,
    1), ... where the chunk has fewer than K points, and all fillers on the
    rows of NaN queries (every 37th)."""
    g = torch.Generator().manual_seed(seed + 100 * S + K)
    L = max(4, K + K // 2)
    pd = torch.full((S, n, K), float("inf"))
    pi = torch.zeros((S, n, K), dtype=torch.int32)
    nan_rows = torch.arange(n) % 37 == 5
    for z in range(S):
        Lz = int(torch.randint(1, L + 1, (1,), generator=g))
        d = torch.randint(0, 5, (n, Lz), generator=g).float()
        d[torch.rand(n, Lz, generator=g) < 0.1] = races.BIG
        v, o = torch.sort(d, dim=1, stable=True)
        F = min(K, Lz)
        pd[z, :, :F], pi[z, :, :F] = v[:, :F], (o[:, :F] + z * L).int()
        pi[z, :, F:] = torch.arange(K - F, dtype=torch.int32)
        pd[z, nan_rows], pi[z, nan_rows] = float("inf"), torch.arange(K, dtype=torch.int32)
    return pd.to(device), pi.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 3, 17, 31, 33, 66, 130])
def test_merge_first_k_equals_the_chunk_order_merge(cuda, S):
    # every K of the register lists: the card's merge (threads per query,
    # pairwise merges of key lists) against the chunk-order merge, under
    # ties, fillers and ragged n
    for K in range(1, 33):
        for n in (1000, 37):
            pd, pi = _chunk_lists(S, n, K, cuda)
            got = knn.merge_first_k(pd, pi)
            torch.cuda.synchronize()
            assert got[0].is_cuda and got[1].is_cuda
            want = knn.merge_first_k_plain(pd, pi)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (K, n)
    with pytest.raises(ValueError):
        knn.merge_first_k(*_chunk_lists(S, 8, 33, cuda))


def _spatially_ordered(xyz, mask):
    """The reference sorted along a Morton-like key of its cells (as the cube
    map and the voxel filter store points), each problem on its own."""
    cell = ((xyz + 8.0) / 2.0).floor().long().clamp(0, 7)
    key = (cell[..., 0] * 64 + cell[..., 1] * 8 + cell[..., 2]).float() + \
        xyz[..., 0].remainder(2.0) * 1e-3
    order = torch.argsort(key, dim=-1)
    take = lambda t: torch.gather(t, -1, order) if t.dim() == order.dim() else \
        torch.gather(t, -2, order[..., None].expand(*order.shape, 3))
    return take(xyz).contiguous(), take(mask).contiguous()


SELECT_EDGE_KS = (33, 63, 64, 65, 127, 128, 1000, 1024, 1025)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["shuffled", "spatial"])
@pytest.mark.parametrize("per_problem", [False, True])
def test_knn_select_route_at_the_list_edges(cuda, per_problem, order):
    # the warp select at every list length's edges (64 to 1024 keys), the
    # radix select above and at k = M, on shared and per-problem references,
    # in random and in spatial order; every k launched once
    q, xyz, _, mask = _problem(25, 2, 150, 1300, per_problem, cuda)
    if order == "spatial":
        xyz, mask = _spatially_ordered(xyz, mask)
    before = COUNTS["knn.knn_select.launches"]
    for k in SELECT_EDGE_KS + (1300,):
        got, want = knn.knn(q, xyz, mask, k), knn.knn_plain(q, xyz, mask, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k
    torch.cuda.synchronize()
    assert COUNTS["knn.knn_select.launches"] == before + len(SELECT_EDGE_KS) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
def test_knn_select_route_when_one_lane_holds_the_nearest(cuda, per_problem):
    # the nearest points at indices 3 mod 32, all seen by one lane of the
    # first pass: its check fails and the warp select gives the list; k = 600
    # (above 32 keys x 16 per lane) skips the first pass
    rng = np.random.RandomState(27)
    M = 1300
    lead = (2,) if per_problem else ()
    xyz = rng.uniform(-8.0, 8.0, lead + (M, 3)).astype(np.float32)
    near = np.arange(3, M, 32)
    xyz[..., near, :] = rng.uniform(-0.5, 0.5, lead + (len(near), 3)).astype(np.float32)
    q = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 40, 3)).astype(np.float32)).to(cuda)
    xyz = torch.from_numpy(xyz).to(cuda)
    mask = torch.ones(lead + (M,), dtype=torch.bool, device=cuda)
    for k in (33, 64, 257, 600):
        got, want = knn.knn(q, xyz, mask, k), knn.knn_plain(q, xyz, mask, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k


@pytest.mark.cuda
def test_select_plan_matches_the_library_and_every_qb_agrees(cuda):
    # the library's route edge is the one SELECT_EDGE_KS straddles; every
    # block shape gives the same lists, small Q included; a block shape the
    # kernel lacks raises
    lib = __import__("cooper_mapper_torch.build", fromlist=["library"]).library()
    assert lib.cooper_knn_select_warp_max_k() == 1024
    assert lib.cooper_knn_register_max_k() < 33
    q, xyz, _, mask = _problem(26, 3, 45, 900, True, cuda)
    for k in (33, 100, 600):
        want = knn.knn_plain(q, xyz, mask, k)
        for qb in (1, 2, 4, 8):
            got = knn._knn_select_cuda(q, xyz, mask, k, plan=qb)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (k, qb)
    with pytest.raises(RuntimeError):
        knn._knn_select_cuda(q, xyz, mask, 33, plan=races.SELECT_MAX_QB + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_kernels_beyond_65535_problems(cuda, per_problem, split):
    # B = 65,537: launched in slabs of at most 65,535 problems, each slab's
    # pointers (queries, per-problem references, outputs) moved to its first
    # problem and the split's scratch reused; bit for bit with the plain
    # versions, whole and with M forced into chunks
    B, Q, M = 65537, 3, 40
    q, xyz, ring, mask = _problem(23, B, Q, M, per_problem, cuda)
    plan = _plan(M, 3) if split else None
    i, d = races._nn1_cuda(q, xyz, mask, plan=plan)
    want = races.nn1_plain(q, xyz, mask)
    assert torch.equal(i, want[0]) and torch.equal(d, want[1])
    ring_a = take_ref(ring, i, not per_problem)
    for mode in ("adj", "same"):
        args = (q, ring_a, i, xyz, ring, mask, mode, SPAN)
        assert all(torch.equal(a, b) for a, b in
                   zip(races._nn1_masked_cuda(*args, plan=plan), races.nn1_masked_plain(*args)))
    args = (q, ring_a, i, xyz, ring, mask, SPAN)
    assert all(torch.equal(a, b) for a, b in
               zip(races._bc_races_cuda(*args, plan=plan), races.bc_races_plain(*args)))
    for with_same in (True, False):
        assert all(torch.equal(a, b) for a, b in
                   zip(races.fused_races(q, xyz, ring, mask, with_same, SPAN),
                       races.fused_races_plain(q, xyz, ring, mask, with_same, SPAN)))
    for k in (5, 33):
        got = (knn._knn_cuda(q, xyz, mask, k, plan=plan) if k <= 32
               else knn.knn(q, xyz, mask, k))
        want = knn.knn_plain(q, xyz, mask, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_degeneracy_projector_beyond_cusolver_batch(cuda):
    # cuSOLVER's batched eigh rejects 32768 or more matrices in one call:
    # the projector solves them in pieces, each as a call of its own would
    from cooper_mapper_torch.ops import gauss_newton as gn

    rng = np.random.RandomState(24)
    A = rng.randn(40000, 6, 6).astype(np.float32)
    JtJ = torch.from_numpy(A @ A.transpose(0, 2, 1) * 50.0).to(cuda)
    n = gn.EIGH_BATCH
    evals, V = gn.eigh(JtJ)
    for s in (slice(0, n), slice(2 * n, 40000)):
        e1, V1 = torch.linalg.eigh(JtJ[s])
        assert torch.equal(evals[s], e1) and torch.equal(V[s], V1)
    P, deg = gn.degeneracy_projector(JtJ, 100.0)
    P1, deg1 = gn.degeneracy_projector(JtJ[:n], 100.0)
    assert P.shape == (40000, 6, 6) and torch.isfinite(P).all() and torch.equal(deg[:n], deg1)
    # the projector's batched product may take another cuBLAS plan at
    # another batch size: equal to f32 rounding, not bit for bit
    torch.testing.assert_close(P[:n], P1, rtol=0, atol=1e-5)
