"""Streaming k-nearest-neighbour search of the scan-to-map solve
(port of ``cooper_mapper_tpu/ops/pallas/knn_stream.py``).

``knn`` finds, for every query, the k reference points with the smallest
``(|q|^2 - 2 q.r) + |r|^2``, ascending by (distance, index): ties go to the
smaller index, as with ``jax.lax.top_k`` and the TPU kernel.  An invalid
reference point carries ``|r|^2 = BIG``, so it enters a list only when fewer
than k valid points exist, and then with a distance of about ``BIG`` that
no acceptance gate passes.

Shapes: queries ``[B, Q, 3]``; the reference is shared ``[M, 3]`` (mask
``[M]``) or per problem ``[B, M, 3]`` (``[B, M]``); ``M >= k``.  Outputs are
``[B, Q, k]``: int32 indices in ``[0, M)`` and f32 squared distances.

Dispatch follows the device: a CPU tensor runs ``knn_plain``, a CUDA tensor
launches a kernel of ``csrc/knn.cu`` or ``csrc/knn_select.cu`` or raises,
for every k with ``1 <= k <= M`` and any B.  Up to the library's
``cooper_knn_register_max_k()`` (32) each query's list lives in registers
(``knn_kernel<k, QPT>``); where the query blocks would not give every SM of
the card one (B = 1), that kernel splits M across blocks and merges their
sorted lists (``races._split_plan``, ``csrc/split.cuh``): the same bits as
one scan (``merge_first_k``).  A larger k takes the select route
(``knn_select``): up to the library's ``cooper_knn_select_warp_max_k()``
(1024) a warp per query, each lane keeping the smallest (distance, index)
keys of its own points, a block of up to 8 such warps sharing its tiles of
the reference (``knn_select_kernel``, ``races._select_plan``); the warp
sorts the lanes' lists and checks that none dropped a key of the answer,
else a warp select gives the list (``knn_select_kernel_pass2``); above
1024, a block per query finds the k-th key by radix select and sorts the k
keys at or under it (``knn_radix_kernel``).
Every route evaluates the distance with the plain version's f32 operations
in its order (``races.pairwise_sq_dist``), so they agree with it bit for
bit.  They differ from it where a distance is NaN: a NaN never enters a
list, so a NaN query gives (+inf, 0..k-1).

The launches are counted in ``utils/profiling.COUNTS``: ``knn.knn.launches``
(the register lists), ``knn.knn.merges`` (those calls that split M and so
launched ``merge_first_k`` too) and ``knn.knn_select.launches``.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import races
from .races import _split_plan

# Elements of one distance chunk of the plain version ([b, q, M] f32, plus
# its temporaries): ~64 MB at 2^24 keeps the card's launches few; on the CPU
# 2^20 (4 MB) stays in cache and runs ~1.5x faster.
_PLAIN_CHUNK_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 20}


def _check_knn(q, r_xyz, r_mask, k: int):
    """Validate a search's inputs; returns (B, Q, M, shared_reference)."""
    B, Q, M, shared = races._check_race(q, r_xyz, r_mask)
    if not 1 <= k <= M:
        raise ValueError(f"k-NN needs 1 <= k <= M, got k={k}, M={M}")
    return B, Q, M, shared


def _chunks(B, Q, M, device_type):
    """(batch slice, query slice) pairs covering [B, Q], each with at most
    ~_PLAIN_CHUNK_ELEMS distances: whole problems where several fit, else
    query slices of one problem."""
    per_q = max(1, _PLAIN_CHUNK_ELEMS[device_type] // M)
    if per_q >= Q:
        step = max(1, per_q // Q)
        return [(slice(s, min(B, s + step)), slice(0, Q)) for s in range(0, B, step)]
    return [(slice(b, b + 1), slice(s, min(Q, s + per_q)))
            for b in range(B) for s in range(0, Q, per_q)]


def _first_k(d, k: int):
    """The first k entries of each row of ``d`` [..., M] in (value, index)
    order: the first k columns of a stable sort.

    ``torch.topk`` does not promise the smaller index among equal values, so
    it only answers the rows where no tie can matter: k distinct values and
    nothing else equal to the k-th, where the k-set and its order are unique.
    Every other row goes to ``_first_k_tied``.
    """
    kk = min(k + 1, d.shape[-1])
    v, i = torch.topk(d, kk, dim=-1, largest=False, sorted=True)
    # a tie matters when the k values repeat or the (k+1)-th equals the k-th
    tied = (v[..., 1:] == v[..., :-1]).any(-1)
    v, i = v[..., :k].contiguous(), i[..., :k].contiguous()
    if bool(tied.any()):
        v[tied], i[tied] = _first_k_tied(d[tied], v[tied], i[tied])
    return i.to(torch.int32), v


def _first_k_tied(d, v, i):
    """The first k columns of a stable sort of each row of ``d`` [n, M],
    given the row's k smallest values ``v`` [n, k] ascending and their
    columns ``i`` from ``torch.topk``.  The c entries below the k-th value
    are ``v``'s first c (their set is unique); the rest are the first k - c
    columns equal to the k-th value, in index order.  The k columns are then
    ordered by (value, index).  NaN counts as larger than everything and
    equal to itself, as in ``torch.sort``."""
    k = v.shape[-1]
    vk = v[:, -1:]
    vk_nan = torch.isnan(vk)
    c = ((v < vk) | (vk_nan & ~torch.isnan(v))).sum(-1, keepdim=True)
    at_k = d == vk
    if bool(vk_nan.any()):
        at_k |= vk_nan & torch.isnan(d)
    # column of the r-th (1-based) entry equal to the k-th value
    rank = torch.arange(1, k + 1, device=d.device) - c
    cum = torch.cumsum(at_k, -1, dtype=torch.int32)
    at_cols = torch.searchsorted(cum, rank.clamp(min=1).to(torch.int32))
    cols = torch.where(rank >= 1, at_cols, i).sort(dim=-1).values
    vals, order = torch.sort(torch.gather(d, 1, cols), dim=-1, stable=True)
    return vals, torch.gather(cols, 1, order)


def knn_plain(q, r_xyz, r_mask, k: int = 5):
    """k-NN, plain PyTorch: (idx [B, Q, k] int32, sq_dist [B, Q, k] f32).

    Builds the distance tile in chunks and keeps the first k of each row in
    (distance, index) order (``_first_k``).
    """
    B, Q, M, shared = _check_knn(q, r_xyz, r_mask, k)
    rn = races._ref_norms(r_xyz, r_mask)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=q.device)
    dist = torch.empty((B, Q, k), dtype=torch.float32, device=q.device)
    for bs, qs in _chunks(B, Q, M, q.device.type):
        r, n = (r_xyz, rn) if shared else (r_xyz[bs], rn[bs])
        idx[bs, qs], dist[bs, qs] = _first_k(races.pairwise_sq_dist(q[bs, qs], r, n), k)
    return idx, dist


def knn(q, r_xyz, r_mask, k: int = 5):
    """k-NN: (idx [B, Q, k] int32, sq_dist [B, Q, k] f32), ascending by
    (distance, index)."""
    if not races._require_device(q):
        return knn_plain(q, r_xyz, r_mask, k)
    from ..build import library

    if k > library().cooper_knn_register_max_k():
        return _knn_select_cuda(q, r_xyz, r_mask, k)
    return _knn_cuda(q, r_xyz, r_mask, k)


def knn_select(q, r_xyz, r_mask, k: int):
    """The select route of the k-NN on its own, for any ``1 <= k <= M``:
    the same lists as ``knn``.  ``knn`` takes it on the card for every k
    above the register lists' largest."""
    if not races._require_device(q):
        return knn_plain(q, r_xyz, r_mask, k)
    return _knn_select_cuda(q, r_xyz, r_mask, k)


# Bytes of the radix select's scratch for one launch, where a query's keys
# exceed shared memory (k > 4096): the queries go rows at a time.
_SELECT_SCRATCH_BYTES = 1 << 27


def _knn_select_cuda(q, r_xyz, r_mask, k, plan=None):
    """The select kernels on CUDA tensors; ``plan`` = QB, the queries per
    block of the warp select, overrides ``races._select_plan``."""
    from ..build import library

    lib = library()
    B, Q, M, shared = _check_knn(q, r_xyz, r_mask, k)
    qb = plan or races._select_plan(B, Q, races.sm_count(q.device))
    rn = races._ref_norms(r_xyz, r_mask)
    out_d = torch.empty((B, Q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, Q, k), dtype=torch.int32, device=q.device)
    keys, rows, scratch = lib.cooper_knn_select_keys(k), 1, None
    if k <= lib.cooper_knn_select_warp_max_k():
        # the first pass's k-th key per query, for the second
        scratch = torch.empty(B * Q, dtype=torch.int64, device=q.device)
    elif keys > lib.cooper_knn_select_smem_keys():
        rows = max(1, min(B * Q, _SELECT_SCRATCH_BYTES // (8 * keys)))
        scratch = torch.empty((rows, keys), dtype=torch.int64, device=q.device)
    races._launch("knn_select", q, lib.cooper_knn_select,
                  q.data_ptr(), r_xyz.data_ptr(), rn.data_ptr(), out_d.data_ptr(),
                  out_i.data_ptr(), races._ptr(scratch), B, Q, M, 0 if shared else M, k, rows,
                  qb)
    profiling.tally("knn.knn_select.launches")
    return out_i, out_d


def _knn_cuda(q, r_xyz, r_mask, k=5, plan=None):
    """The k-NN kernel on CUDA tensors (the register lists, k up to
    ``cooper_knn_register_max_k()``); ``plan`` = (S, L) overrides
    ``_split_plan`` (the card tests pin chunk edges with it)."""
    from ..build import library

    lib = library()
    B, Q, M, shared = _check_knn(q, r_xyz, r_mask, k)
    block_queries = lib.cooper_knn_block_queries(k)
    if block_queries == 0:
        raise ValueError(f"the k-NN's register lists serve k <= "
                         f"{lib.cooper_knn_register_max_k()}, got k={k}: knn() takes the "
                         "select route above")
    S, L = plan or _split_plan(B, Q, M, races.sm_count(q.device), block_queries)
    races._check_plan(S, L, M)
    rn = races._ref_norms(r_xyz, r_mask)
    out = lambda dt, *lead: torch.empty(lead + (B, Q, k), dtype=dt, device=q.device)
    out_d, out_i = out(torch.float32), out(torch.int32)
    part_d, part_i = (out(torch.float32, S), out(torch.int32, S)) if S > 1 else (None, None)
    races._launch("knn", q, lib.cooper_knn,
                  q.data_ptr(), r_xyz.data_ptr(), rn.data_ptr(), out_d.data_ptr(),
                  out_i.data_ptr(), races._ptr(part_d), races._ptr(part_i), B, Q, M,
                  0 if shared else M, k, S, L)
    profiling.tally("knn.knn.launches")
    profiling.tally("knn.knn.merges", S > 1)
    return out_i, out_d


def merge_first_k_plain(part_d, part_i):
    """The chunk-order merge of S first-k lists per query, plain PyTorch:
    part_d f32 / part_i int32 [S, n, k], each chunk's list ascending ->
    (idx int32, dist f32) [n, k].  The merge meets the chunks' entries in
    order, from (+inf, 0..k-1), and puts an entry whose distance is below
    the list's last behind the equal ones ("<"); a chunk's scan stops at its
    first entry that cannot enter, so a NaN or +inf distance, and whatever
    follows it in its chunk, never does.  So the list is the first k finite
    entries by distance, ties in chunk order, then (+inf, 0), (+inf, 1), ...
    in the slots left."""
    S, n, k = part_d.shape
    live = torch.cummin((part_d < torch.inf).to(torch.int32), dim=-1).values.bool()
    d = torch.where(live, part_d, torch.inf).permute(1, 0, 2).reshape(n, S * k)
    i = part_i.permute(1, 0, 2).reshape(n, S * k)
    v, order = torch.sort(d, dim=1, stable=True)
    v, idx = v[:, :k].contiguous(), torch.gather(i, 1, order[:, :k])
    listed = v < torch.inf
    slot = torch.arange(k, device=part_d.device) - listed.sum(1, keepdim=True)
    return torch.where(listed, idx, slot).to(torch.int32), v


def merge_first_k(part_d, part_i):
    """The merge of a split k-NN's chunk lists (``csrc/split.cuh``
    ``merge_first_k``), [S, n, k] -> (idx, dist) [n, k], k up to the
    register lists' largest.  ``_knn_cuda`` launches it inside its own call
    where it splits M (counted as ``knn.knn.merges`` in
    ``utils/profiling.COUNTS``); this entry serves tests and timing.  On chunk lists as the k-NN kernel writes them (ascending by
    (distance, index), chunk z's indices above chunk z-1's) it equals
    ``merge_first_k_plain``."""
    if not races._require_device(part_d):
        return merge_first_k_plain(part_d, part_i)
    return _merge_first_k_cuda(part_d, part_i)


def _merge_first_k_cuda(part_d, part_i):
    """merge_first_k on CUDA tensors."""
    from ..build import library

    lib = library()
    if part_d.dim() != 3 or not 1 <= part_d.shape[2] <= lib.cooper_knn_register_max_k():
        raise ValueError(f"chunk lists must be [S, n, k <= "
                         f"{lib.cooper_knn_register_max_k()}], got {tuple(part_d.shape)}")
    races._check("part_d", part_d, torch.float32, part_d.shape, part_d.device)
    races._check("part_i", part_i, torch.int32, part_d.shape, part_d.device)
    S, n, k = part_d.shape
    d = torch.empty((n, k), dtype=torch.float32, device=part_d.device)
    i = torch.empty((n, k), dtype=torch.int32, device=part_d.device)
    races._launch("merge_first_k", part_d, lib.cooper_merge_first_k, part_d.data_ptr(),
                  part_i.data_ptr(), d.data_ptr(), i.data_ptr(), n, S, k)
    return i, d

