"""The nearest-neighbour races of the odometry correspondence search
(port of ``cooper_mapper_tpu/ops/pallas/nn1.py``).

Four searches, each with a wrapper, a launch counter and a plain PyTorch
version:

* ``nn1``         — race A: for each query, ``(argmin, min)`` of
  ``|q|^2 - 2 q.r + |r|^2`` over the reference (``_nn1_kernel``).
* ``nn1_masked``  — one ring-constrained race: ``"adj"`` keeps candidates
  with ``0 < |ring - ring_a| <= ring_span``, ``"same"`` those with
  ``ring == ring_a`` and index ``!= ia`` (``_nn1_masked_kernel``).
* ``bc_races``    — surf races B (``"same"``) and C (``"adj"``) from one
  distance per pair (``_bc_races_kernel``).
* ``fused_races`` — every race of one correspondence search in one launch:
  A, then A's ring read from the reference, then C (and B with
  ``with_same``) (``_fused_races_kernel``).  On every query whose A is a
  valid reference point it equals ``nn1`` followed by ``bc_races`` or
  ``nn1_masked("adj")``; where A is invalid its ring is ``1e9``, as in the
  TPU kernel, not the invalid point's stored ring.

Shapes: queries ``[B, Q, 3]``; the reference is shared ``[M, 3]`` (mask and
ring ``[M]``) or per problem ``[B, M, 3]`` (``[B, M]``).  Outputs are
``[B, Q]``: int32 indices and f32 squared distances.  Any B: the kernels
launch more than 65,535 problems (CUDA's cap on grid y, their problem axis)
in slabs of at most that many (``csrc/split.cuh`` ``over_slabs``).

Dispatch follows the device: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel (``csrc/races.cu``) or raises.  Where the query
blocks of an ``nn1``, ``nn1_masked`` or ``bc_races`` call would not give
every SM of the card one, the kernel splits M across blocks and
``merge_min`` joins their results (``_split_plan``, ``csrc/split.cuh``):
the same bits as one scan over M.  The fused kernel never splits M: where
its query blocks would not fill the card, G lanes of a warp share each
query, each scanning every G-th point, and combine by shuffles
(``_fused_plan``).  The ``nn1``, ``nn1_masked`` and ``fused_races`` kernels
read the mask and the int32 rings as they are and form ``|r|^2``, ``BIG``
and the f32 rings themselves, so those wrappers launch their kernel (and,
for the first two, the merge) and nothing else.  An invalid reference point
carries ``|r|^2 = BIG`` and ring ``1e9``; a candidate that fails a ring
test has distance exactly ``BIG``.  Ties go to the smaller index.  Kernel
and plain version evaluate the distance with the same f32 operations in the
same order, so they agree bit for bit.

``nn1``, ``nn1_masked`` and ``bc_races`` take optional walk lists
(``valid_list``): ``q_list`` of the query mask, ``r_list`` of the reference
mask, each ``(order, count)``.  With ``r_list`` the kernel scans only each
problem's valid reference points (all M where it has none, as without a
list); with ``q_list`` it searches only the valid queries and answers every
other query slot ``(BIG, 0)``, as the plain versions do given the query mask
(``q_mask``).  On every valid query the answers equal the call without lists
bit for bit: an invalid reference point loses race A to every valid one (for
a finite query) and fails every ring test (``csrc/races.cu``, ``RefWalk``).
Without lists each race walks every slot.  With tracing on, each of the
three counts ``race_pairs_walked`` (the pairs its launch scans, whole query
blocks included: ``_count_pairs``) and ``race_pairs_padded`` (B x Q x M) in
the innermost open span.

Each wrapper counts its launches in ``utils/profiling.COUNTS``:
``races.<kernel>.launches`` and, for a call that split M and so launched
the merge too, ``races.<kernel>.merges``; ``races.merge_min.launches``
counts the merge's launches inside those calls and through its own entry.
"""

from __future__ import annotations

import functools

import torch

from ..utils import profiling

BIG = 1.0e12
RING_INVALID = 1.0e9

# Queries per chunk of the plain versions: bounds their [chunk, Q, M]
# temporaries to ~2^26 elements per problem chunk.
_PLAIN_CHUNK_ELEMS = 1 << 26

# The split of M across blocks (csrc/split.cuh).  A grid of fewer query
# blocks than the card has SMs is split into up to SPLIT_BLOCKS_PER_SM blocks
# per SM (4 blocks of 4 warps: 4 warps per scheduler), each scanning at
# least SPLIT_MIN_CHUNK reference points.
SPLIT_BLOCKS_PER_SM = 4
SPLIT_MIN_CHUNK = 64

# The fused kernel's plans (G lanes per query, QPT queries per thread) that
# csrc/races.cu builds, and its threads per block.  _fused_plan takes G = 1,
# 2 queries per thread, where those blocks give every SM FUSED_BLOCKS_PER_SM;
# else a warp per query, G = 32 (the other G and G = 1 with one query per
# thread lost at every shape measured: PERF.md).
FUSED_PLANS = ((1, 2), (32, 1))
FUSED_THREADS = 128
FUSED_BLOCKS_PER_SM = 2


def _split_plan(B, Q, M, n_sm, block_queries):
    """(S, L): the chunks of M a search kernel's blocks scan.  Block z scans
    ``[z*L, min(M, (z+1)*L))``; the S chunks are non-empty and cover
    ``[0, M)``.  S = 1 (the whole of M, no merge) when the ``B x
    ceil(Q / block_queries)`` query blocks already give every SM one."""
    blocks = B * -(-Q // block_queries)
    if blocks >= n_sm:
        return 1, M
    S = max(1, min(-(-SPLIT_BLOCKS_PER_SM * n_sm // blocks), -(-M // SPLIT_MIN_CHUNK)))
    L = -(-M // S)
    return -(-M // L), L


# The k-NN's warp select (csrc/knn_select.cu): a warp per query, at most
# SELECT_MAX_QB queries of one problem per block, sharing the block's tiles
# of the reference.  Which k it serves is the library's
# (cooper_knn_select_warp_max_k); the radix select above takes no plan.
SELECT_MAX_QB = 8


def _select_plan(B, Q, n_sm):
    """QB, the queries per block of a warp-select k-NN of B problems of Q
    queries on a card of ``n_sm`` SMs: the most (up to SELECT_MAX_QB) whose
    ``B x ceil(Q / QB)`` blocks still give every SM one, so that a small Q
    still spreads over the card."""
    qb = SELECT_MAX_QB
    while qb > 1 and B * -(-Q // qb) < n_sm:
        qb //= 2
    return qb


def _fused_plan(B, Q, n_sm):
    """(G, QPT): the lanes per query and queries per thread of a fused
    search of B problems of Q queries on a card of ``n_sm`` SMs."""
    if B * -(-Q // (FUSED_THREADS * 2)) >= FUSED_BLOCKS_PER_SM * n_sm:
        return 1, 2
    return 32, 1


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """Streaming multiprocessors of the CUDA ``device``."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_race(q, r_xyz, r_mask, r_ring=None, ring_a=None, ia=None):
    """Validate one race's inputs; returns (B, Q, M, shared_reference)."""
    if q.dim() != 3 or q.shape[-1] != 3:
        raise ValueError(f"queries must be [B, Q, 3], got {tuple(q.shape)}")
    B, Q, _ = q.shape
    if r_xyz.dim() not in (2, 3):
        raise ValueError(f"reference must be [M, 3] or [B, M, 3], got {tuple(r_xyz.shape)}")
    shared = r_xyz.dim() == 2
    M = r_xyz.shape[-2]
    if B < 1 or Q < 1 or M < 1:
        raise ValueError(f"unsupported race shape B={B}, Q={Q}, M={M}")
    dev = q.device
    lead = () if shared else (B,)
    _check("q", q, torch.float32, (B, Q, 3), dev)
    _check("r_xyz", r_xyz, torch.float32, lead + (M, 3), dev)
    _check("r_mask", r_mask, torch.bool, lead + (M,), dev)
    if r_ring is not None:
        _check("r_ring", r_ring, torch.int32, lead + (M,), dev)
        _check("ring_a", ring_a, torch.int32, (B, Q), dev)
        _check("ia", ia, torch.int32, (B, Q), dev)
    return B, Q, M, shared


def _sq_norm(p):
    """(x*x + y*y) + z*z over the trailing axis — the kernels' order."""
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def _ref_norms(r_xyz, r_mask):
    """|r|^2 with BIG at invalid reference points: [*, M]."""
    return torch.where(r_mask, _sq_norm(r_xyz), torch.full_like(r_mask, BIG, dtype=torch.float32))


def _ref_rings(r_ring, r_mask):
    """Ring as f32 with RING_INVALID at invalid reference points: [*, M]."""
    return torch.where(r_mask, r_ring.to(torch.float32),
                       torch.full_like(r_mask, RING_INVALID, dtype=torch.float32))


def _check_fused(q, r_xyz, r_ring, r_mask):
    """Validate the fused search's inputs; returns (B, Q, M, shared_reference)."""
    B, Q, M, shared = _check_race(q, r_xyz, r_mask)
    _check("r_ring", r_ring, torch.int32, tuple(r_mask.shape), q.device)
    return B, Q, M, shared


def _check_ring_race(q, ring_a, ia, r_xyz, r_ring, r_mask, mode):
    """Validate a ring race's inputs; returns (B, Q, M, shared_reference)."""
    if mode not in ("same", "adj"):
        raise ValueError(f"mode must be 'same' or 'adj', got {mode!r}")
    return _check_race(q, r_xyz, r_mask, r_ring, ring_a, ia)


def _ring_race_inputs(q, ring_a, ia, r_xyz, r_ring, r_mask, mode="adj"):
    """Validate a ring race's inputs and derive what the plain versions and
    the bc_races kernel read: (B, Q, M, shared, |r|^2 [*, M], ring [*, M]
    f32, ring_a [B, Q] f32)."""
    B, Q, M, shared = _check_ring_race(q, ring_a, ia, r_xyz, r_ring, r_mask, mode)
    return (B, Q, M, shared, _ref_norms(r_xyz, r_mask), _ref_rings(r_ring, r_mask),
            ring_a.to(torch.float32))


def valid_list(mask):
    """The walk of a masked axis: (order [*, N] int32, count [*] int32).
    ``order`` is a stable partition of the slot indices 0..N-1, the valid
    slots first and then the invalid ones, each group in index order;
    ``count`` is the number of valid slots.  Where nothing is valid the
    order is the identity (the races then walk every slot).  Device ops only
    (a cumsum, a where and a scatter): no sort, no host sync."""
    n = mask.shape[-1]
    c = torch.cumsum(mask, -1, dtype=torch.int64)      # valid slots up to and at j
    count = c[..., -1:]
    slot = torch.arange(n, dtype=torch.int64, device=mask.device)
    # valid slot j goes to position c - 1; invalid slot j to count + (j - c)
    pos = torch.where(mask, c - 1, (slot - c) + count)
    order = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    order.scatter_(-1, pos, slot.to(torch.int32).expand(mask.shape))
    return order, count[..., 0].to(torch.int32)


def list_mask(lst):
    """The mask a walk list was built from: True at the slots of its first
    ``count`` positions.  None for no list."""
    if lst is None:
        return None
    order, count = lst
    listed = torch.arange(order.shape[-1], device=order.device) < count[..., None]
    return torch.zeros(order.shape, dtype=torch.bool, device=order.device).scatter_(
        -1, order.long(), listed)


def _check_lists(q_list, r_list, B, Q, M, shared, device):
    """Validate the walk lists of a race of B problems of Q queries against
    a reference of M points (shared: one list and a 0-d count)."""
    lead = () if shared else (B,)
    for name, lst, shape in (("q_list", q_list, (B, Q)), ("r_list", r_list, lead + (M,))):
        if lst is None:
            continue
        order, count = lst
        _check(f"{name} order", order, torch.int32, shape, device)
        _check(f"{name} count", count, torch.int32, shape[:-1], device)


def _check_listed(q, r_xyz, r_mask, q_list, r_list):
    """The CPU path's check of a race's lists (the card's checks its own)."""
    if q_list is not None or r_list is not None:
        _check_lists(q_list, r_list, *_check_race(q, r_xyz, r_mask), q.device)


def _list_ptrs(q_list, r_list):
    """The data pointers of (q_list, r_list): order and count each, None
    for no list."""
    ptrs = []
    for lst in (q_list, r_list):
        ptrs += [None, None] if lst is None else [t.data_ptr() for t in lst]
    return ptrs


def _count_pairs(q, r_xyz, q_list, r_list, block):
    """With tracing on: counters ``race_pairs_walked`` and
    ``race_pairs_padded`` (B x Q x M) of one race.  Walked: over the
    problems, the query slots of the blocks that serve a listed query,
    min(Q, ceil(n_q / block) * block), times the listed reference points;
    ``block`` is the launch's query positions per block (every lane of such
    a block scans), 1 on the CPU, whose plain versions have no blocks.  With
    tracing off nothing is formed."""
    if not profiling.enabled():
        return
    B, Q, M = q.shape[0], q.shape[1], r_xyz.shape[-2]
    nq = Q if q_list is None else torch.clamp(
        -(-q_list[1].to(torch.int64) // block) * block, max=Q)
    nr = M if r_list is None else torch.where(r_list[1] > 0, r_list[1], M).to(torch.int64)
    walked = nq * nr
    if not isinstance(walked, torch.Tensor) or walked.dim() == 0:
        walked = walked * B                # the same for every problem
    profiling.count("race_pairs_walked", walked)
    profiling.count("race_pairs_padded", B * Q * M)


def _fixed_answers(q_mask, i, d):
    """(BIG, 0) at the query slots where ``q_mask`` is False (None: none)."""
    if q_mask is None:
        return i, d
    return torch.where(q_mask, i, 0), torch.where(q_mask, d, BIG)


def pairwise_sq_dist(q, r, rn):
    """[B, Q, 3] x [*, M, 3] (+ |r|^2 [*, M]) -> [B, Q, M] squared distances,
    ``(|q|^2 - 2*cross) + |r|^2`` with ``cross = (qx*rx + qy*ry) + qz*rz``.

    Written elementwise, so every product and sum is one IEEE f32 operation
    in a fixed order (no TF32, no FMA contraction): the CUDA kernels repeat
    exactly these operations.  The tile is updated in place to save memory
    passes; ``(-2*cross) + |q|^2`` is ``|q|^2 - 2*cross`` bit for bit.
    """
    if r.dim() == 2:
        r, rn = r[None], rn[None]
    qx, qy, qz = (q[..., i, None] for i in range(3))
    rx, ry, rz = (r[..., None, :, i] for i in range(3))
    d = qx * rx
    d += qy * ry
    d += qz * rz
    return d.mul_(-2.0).add_(_sq_norm(q)[..., None]).add_(rn[..., None, :])


def _batch_chunks(B, Q, M):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, Q * M))
    return [(s, min(B, s + step)) for s in range(0, B, step)]


def _take(t, shared, s, e):
    return t if shared else t[s:e]


def _argmin_rows(d):
    """(first index of the row minimum as int32, the minimum)."""
    i = torch.argmin(d, dim=-1)
    return i.to(torch.int32), torch.gather(d, -1, i[..., None])[..., 0]


def _ring_ok(ring, ra, ia, mode, ring_span, M):
    """Candidate mask of a ring race: ring [*, M], ra/ia [b, Q] -> [b, Q, M]."""
    if ring.dim() == 1:
        ring = ring[None]
    ring = ring[..., None, :]
    if mode == "same":
        cols = torch.arange(M, device=ring.device, dtype=torch.int32)
        return (ring == ra[..., None]) & (cols != ia[..., None])
    rd = torch.abs(ring - ra[..., None])
    return (rd > 0.0) & (rd <= ring_span)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle the kernels are held to)
# ---------------------------------------------------------------------------


def nn1_plain(q, r_xyz, r_mask, q_mask=None):
    """Race A, plain PyTorch: (idx [B, Q] int32, sq_dist [B, Q] f32).
    ``q_mask`` [B, Q]: (BIG, 0) at the query slots where it is False."""
    B, Q, M, shared = _check_race(q, r_xyz, r_mask)
    rn = _ref_norms(r_xyz, r_mask)
    idx, dist = [], []
    for s, e in _batch_chunks(B, Q, M):
        d = pairwise_sq_dist(q[s:e], _take(r_xyz, shared, s, e), _take(rn, shared, s, e))
        i, m = _argmin_rows(d)
        idx.append(i)
        dist.append(m)
    return _fixed_answers(q_mask, torch.cat(idx), torch.cat(dist))


def nn1_masked_plain(q, ring_a, ia, r_xyz, r_ring, r_mask, mode: str,
                     ring_span: float = 2.5, q_mask=None):
    """One ring-constrained race, plain PyTorch: (idx, sq_dist) [B, Q];
    (BIG, 0) where ``q_mask`` is False."""
    B, Q, M, shared, rn, ring, ra = _ring_race_inputs(q, ring_a, ia, r_xyz, r_ring,
                                                      r_mask, mode)
    idx, dist = [], []
    for s, e in _batch_chunks(B, Q, M):
        d = pairwise_sq_dist(q[s:e], _take(r_xyz, shared, s, e), _take(rn, shared, s, e))
        ok = _ring_ok(_take(ring, shared, s, e), ra[s:e], ia[s:e], mode, ring_span, M)
        i, m = _argmin_rows(torch.where(ok, d, BIG))
        idx.append(i)
        dist.append(m)
    return _fixed_answers(q_mask, torch.cat(idx), torch.cat(dist))


def bc_races_plain(q, ring_a, ia, r_xyz, r_ring, r_mask, ring_span: float = 2.5,
                   q_mask=None):
    """Surf races B ("same") and C ("adj") from one distance per pair, plain
    PyTorch: (ib, db, ic, dc), each [B, Q]; (BIG, 0) where ``q_mask`` is
    False."""
    B, Q, M, shared, rn, ring, ra = _ring_race_inputs(q, ring_a, ia, r_xyz, r_ring, r_mask)
    outs = [[], [], [], []]
    for s, e in _batch_chunks(B, Q, M):
        d = pairwise_sq_dist(q[s:e], _take(r_xyz, shared, s, e), _take(rn, shared, s, e))
        rg = _take(ring, shared, s, e)
        ok_b = _ring_ok(rg, ra[s:e], ia[s:e], "same", ring_span, M)
        ok_c = _ring_ok(rg, ra[s:e], ia[s:e], "adj", ring_span, M)
        for k, res in enumerate(_argmin_rows(torch.where(ok_b, d, BIG))
                                + _argmin_rows(torch.where(ok_c, d, BIG))):
            outs[k].append(res)
    ib, db, ic, dc = (torch.cat(o) for o in outs)
    return _fixed_answers(q_mask, ib, db) + _fixed_answers(q_mask, ic, dc)


def fused_races_plain(q, r_xyz, r_ring, r_mask, with_same: bool, ring_span: float = 2.5):
    """Every race of one search, plain PyTorch: (ia, da, ib, db, ic, dc) with
    ``with_same`` (surf), else (ia, da, ic, dc) (corner), each [B, Q].
    A's ring is read from the f32 ring array, so it is RING_INVALID where
    A is an invalid point."""
    B, Q, M, shared = _check_fused(q, r_xyz, r_ring, r_mask)
    rn, ring = _ref_norms(r_xyz, r_mask), _ref_rings(r_ring, r_mask)
    n_out = 6 if with_same else 4
    outs = [[] for _ in range(n_out)]
    for s, e in _batch_chunks(B, Q, M):
        d = pairwise_sq_dist(q[s:e], _take(r_xyz, shared, s, e), _take(rn, shared, s, e))
        ia, da = _argmin_rows(d)
        rg = _take(ring, shared, s, e)
        ra = rg[ia.long()] if shared else torch.gather(rg, 1, ia.long())
        res = [ia, da]
        if with_same:
            ok_b = _ring_ok(rg, ra, ia, "same", ring_span, M)
            res += _argmin_rows(torch.where(ok_b, d, BIG))
        ok_c = _ring_ok(rg, ra, ia, "adj", ring_span, M)
        res += _argmin_rows(d.masked_fill_(~ok_c, BIG))
        for k, r in enumerate(res):
            outs[k].append(r)
    return tuple(torch.cat(o) for o in outs)


def merge_min_plain(part_d, part_i):
    """The chunks' (min, argmin) pairs [..., S, n] merged in chunk order with
    a strict "<" from (+inf, 0), plain PyTorch: (idx, dist) [..., n].  The
    first chunk holding the minimum wins a tie; nothing below +inf: (+inf, 0)."""
    d = torch.where(torch.isnan(part_d), torch.inf, part_d)
    z = torch.argmin(d, dim=-2, keepdim=True)
    best = torch.gather(d, -2, z)[..., 0, :]
    idx = torch.gather(part_i, -2, z)[..., 0, :]
    return torch.where(best < torch.inf, idx, 0), best


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on the card
# ---------------------------------------------------------------------------


def _launch(name: str, q, fn, *args):
    """Call C launcher ``fn`` on q's device and current stream; raise on the
    ``cudaGetLastError()`` code it returns."""
    with torch.cuda.device(q.device):
        status = fn(*args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def _require_device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"races run on cpu or cuda tensors, got {q.device}")
    return q.device.type == "cuda"


def nn1(q, r_xyz, r_mask, q_list=None, r_list=None):
    """Race A: (idx [B, Q] int32, sq_dist [B, Q] f32).  ``q_list`` /
    ``r_list``: the walks' lists (``valid_list`` of the query / reference
    mask), or None."""
    if not _require_device(q):
        _check_listed(q, r_xyz, r_mask, q_list, r_list)
        _count_pairs(q, r_xyz, q_list, r_list, 1)
        return nn1_plain(q, r_xyz, r_mask, list_mask(q_list))
    return _nn1_cuda(q, r_xyz, r_mask, q_list=q_list, r_list=r_list)


def _nn1_cuda(q, r_xyz, r_mask, plan=None, q_list=None, r_list=None):
    """The nn1 kernel on CUDA tensors; ``plan`` = (S, L) overrides
    ``_split_plan`` (the card tests pin chunk edges with it)."""
    from ..build import library

    lib = library()
    B, Q, M, shared = _check_race(q, r_xyz, r_mask)
    _check_lists(q_list, r_list, B, Q, M, shared, q.device)
    S, L = plan or _split_plan(B, Q, M, sm_count(q.device), lib.cooper_nn1_block_queries())
    _check_plan(S, L, M)
    _count_pairs(q, r_xyz, q_list, r_list, _nn1_block(lib, S))
    d, i, part_d, part_i = _race_outputs(q.device, B, Q, S)
    _launch("nn1", q, lib.cooper_nn1,
            q.data_ptr(), r_xyz.data_ptr(), r_mask.data_ptr(), *_list_ptrs(q_list, r_list),
            d.data_ptr(), i.data_ptr(), _ptr(part_d), _ptr(part_i), B, Q, M,
            0 if shared else M, S, L)
    profiling.tally("races.nn1.launches")
    profiling.tally("races.nn1.merges", S > 1)
    profiling.tally("races.merge_min.launches", S > 1)
    return i, d


def nn1_masked(q, ring_a, ia, r_xyz, r_ring, r_mask, mode: str,
               ring_span: float = 2.5, q_list=None, r_list=None):
    """One ring-constrained race ("adj" or "same"): (idx, sq_dist) [B, Q].
    ``q_list`` / ``r_list`` as for ``nn1``."""
    if not _require_device(q):
        _check_listed(q, r_xyz, r_mask, q_list, r_list)
        _count_pairs(q, r_xyz, q_list, r_list, 1)
        return nn1_masked_plain(q, ring_a, ia, r_xyz, r_ring, r_mask, mode, ring_span,
                                list_mask(q_list))
    return _nn1_masked_cuda(q, ring_a, ia, r_xyz, r_ring, r_mask, mode, ring_span,
                            q_list=q_list, r_list=r_list)


def _nn1_masked_cuda(q, ring_a, ia, r_xyz, r_ring, r_mask, mode, ring_span=2.5, plan=None,
                     q_list=None, r_list=None):
    """The nn1_masked kernel on CUDA tensors; ``plan`` = (S, L) overrides
    ``_split_plan``."""
    from ..build import library

    lib = library()
    B, Q, M, shared = _check_ring_race(q, ring_a, ia, r_xyz, r_ring, r_mask, mode)
    _check_lists(q_list, r_list, B, Q, M, shared, q.device)
    S, L = plan or _split_plan(B, Q, M, sm_count(q.device), lib.cooper_nn1_block_queries())
    _check_plan(S, L, M)
    _count_pairs(q, r_xyz, q_list, r_list, _nn1_block(lib, S))
    d, i, part_d, part_i = _race_outputs(q.device, B, Q, S)
    _launch("nn1_masked", q, lib.cooper_nn1_masked,
            q.data_ptr(), ring_a.data_ptr(), ia.data_ptr(), r_xyz.data_ptr(),
            r_mask.data_ptr(), r_ring.data_ptr(), *_list_ptrs(q_list, r_list), d.data_ptr(),
            i.data_ptr(), _ptr(part_d), _ptr(part_i), B, Q, M, 0 if shared else M,
            int(mode == "same"), float(ring_span), S, L)
    profiling.tally("races.nn1_masked.launches")
    profiling.tally("races.nn1_masked.merges", S > 1)
    profiling.tally("races.merge_min.launches", S > 1)
    return i, d


def _nn1_block(lib, S):
    """Query positions per block of an nn1 / nn1_masked launch split S ways."""
    return lib.cooper_nn1_block_queries() if S > 1 else lib.cooper_nn1_whole_block_queries()


def _race_outputs(device, B, Q, S):
    """(dist, idx) [B, Q] of one race and, where S > 1, the chunks' scratch
    (dist, idx) [S, B, Q]."""
    d = torch.empty((B, Q), dtype=torch.float32, device=device)
    i = torch.empty((B, Q), dtype=torch.int32, device=device)
    if S == 1:
        return d, i, None, None
    return (d, i, torch.empty((S, B, Q), dtype=torch.float32, device=device),
            torch.empty((S, B, Q), dtype=torch.int32, device=device))


def bc_races(q, ring_a, ia, r_xyz, r_ring, r_mask, ring_span: float = 2.5, q_list=None,
             r_list=None):
    """Surf races B and C: (ib, db, ic, dc), each [B, Q].  ``q_list`` /
    ``r_list`` as for ``nn1``."""
    if not _require_device(q):
        _check_listed(q, r_xyz, r_mask, q_list, r_list)
        _count_pairs(q, r_xyz, q_list, r_list, 1)
        return bc_races_plain(q, ring_a, ia, r_xyz, r_ring, r_mask, ring_span,
                              list_mask(q_list))
    return _bc_races_cuda(q, ring_a, ia, r_xyz, r_ring, r_mask, ring_span, q_list=q_list,
                          r_list=r_list)


def _bc_races_cuda(q, ring_a, ia, r_xyz, r_ring, r_mask, ring_span=2.5, plan=None,
                   q_list=None, r_list=None):
    """The bc_races kernel on CUDA tensors; ``plan`` = (S, L) overrides
    ``_split_plan`` (the card tests pin chunk edges with it)."""
    from ..build import library

    lib = library()
    B, Q, M, shared, rn, ring, ra = _ring_race_inputs(q, ring_a, ia, r_xyz, r_ring, r_mask)
    _check_lists(q_list, r_list, B, Q, M, shared, q.device)
    S, L = plan or _split_plan(B, Q, M, sm_count(q.device), lib.cooper_bc_races_block_queries())
    _check_plan(S, L, M)
    _count_pairs(q, r_xyz, q_list, r_list, lib.cooper_bc_races_block_queries())
    out = lambda dt, *lead: torch.empty(lead + (B, Q), dtype=dt, device=q.device)
    db, ib, dc, ic = out(torch.float32), out(torch.int32), out(torch.float32), out(torch.int32)
    part_d, part_i = ((out(torch.float32, 2, S), out(torch.int32, 2, S)) if S > 1
                      else (None, None))
    _launch("bc_races", q, lib.cooper_bc_races,
            q.data_ptr(), ra.data_ptr(), ia.data_ptr(), r_xyz.data_ptr(),
            rn.data_ptr(), ring.data_ptr(), *_list_ptrs(q_list, r_list), db.data_ptr(),
            ib.data_ptr(), dc.data_ptr(), ic.data_ptr(), _ptr(part_d), _ptr(part_i), B, Q, M,
            0 if shared else M, float(ring_span), S, L)
    profiling.tally("races.bc_races.launches")
    profiling.tally("races.bc_races.merges", S > 1)
    profiling.tally("races.merge_min.launches", S > 1)
    return ib, db, ic, dc


def _check_plan(S, L, M):
    if not (S >= 1 and L >= 1 and (S - 1) * L < M <= S * L and S <= 65535):
        raise ValueError(f"split plan S={S}, L={L} does not cover M={M} in non-empty chunks")


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_races(q, r_xyz, r_ring, r_mask, with_same: bool, ring_span: float = 2.5):
    """Every race of one search in one launch: (ia, da, ib, db, ic, dc) with
    ``with_same``, else (ia, da, ic, dc), each [B, Q]."""
    if not _require_device(q):
        return fused_races_plain(q, r_xyz, r_ring, r_mask, with_same, ring_span)
    return _fused_races_cuda(q, r_xyz, r_ring, r_mask, with_same, ring_span)


def _fused_races_cuda(q, r_xyz, r_ring, r_mask, with_same, ring_span=2.5, plan=None):
    """The fused kernel on CUDA tensors: validation, the outputs and one
    launch.  ``plan`` = (G, QPT) overrides ``_fused_plan`` (the card tests
    run every plan in ``FUSED_PLANS`` with it)."""
    from ..build import library

    B, Q, M, shared = _check_fused(q, r_xyz, r_ring, r_mask)
    G, qpt = plan or _fused_plan(B, Q, sm_count(q.device))
    if (G, qpt) not in FUSED_PLANS:
        raise ValueError(f"fused plan G={G}, QPT={qpt} is not built; one of {FUSED_PLANS}")
    idx = lambda: torch.empty((B, Q), dtype=torch.int32, device=q.device)
    dist = lambda: torch.empty((B, Q), dtype=torch.float32, device=q.device)
    ia, da, ic, dc = idx(), dist(), idx(), dist()
    ib, db = (idx(), dist()) if with_same else (None, None)
    _launch("fused_races", q, library().cooper_fused_races,
            q.data_ptr(), r_xyz.data_ptr(), r_mask.data_ptr(), r_ring.data_ptr(),
            da.data_ptr(), ia.data_ptr(), _ptr(db), _ptr(ib), dc.data_ptr(), ic.data_ptr(),
            B, Q, M, 0 if shared else M, int(with_same), float(ring_span), G, qpt)
    profiling.tally("races.fused_races.launches")
    return (ia, da, ib, db, ic, dc) if with_same else (ia, da, ic, dc)


def merge_min(part_d, part_i):
    """The chunk-order merge of S (min, argmin) pairs per query: part_d f32
    and part_i int32 [searches, S, n] (up to 4 searches) -> (idx, dist)
    [searches, n].  The race wrappers launch it inside their own call where
    they split M (and count it as ``races.merge_min.launches``); this entry
    serves tests and timing."""
    if not _require_device(part_d):
        return merge_min_plain(part_d, part_i)
    return _merge_min_cuda(part_d, part_i)


def _merge_min_cuda(part_d, part_i):
    """merge_min on CUDA tensors."""
    from ..build import library

    if part_d.dim() != 3 or not 1 <= part_d.shape[0] <= 4 or part_d.shape[1] < 1:
        raise ValueError(f"partials must be [searches <= 4, S, n], got {tuple(part_d.shape)}")
    _check("part_d", part_d, torch.float32, part_d.shape, part_d.device)
    _check("part_i", part_i, torch.int32, part_d.shape, part_d.device)
    searches, S, n = part_d.shape
    d = torch.empty((searches, n), dtype=torch.float32, device=part_d.device)
    i = torch.empty((searches, n), dtype=torch.int32, device=part_d.device)
    _launch("merge_min", part_d, library().cooper_merge_min, part_d.data_ptr(),
            part_i.data_ptr(), d.data_ptr(), i.data_ptr(), n, S, searches)
    profiling.tally("races.merge_min.launches")
    return i, d


KERNELS = (nn1, nn1_masked, bc_races, fused_races)
