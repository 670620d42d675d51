"""Models, in numpy, of two of the k-NN's CUDA kernels, step for step as
``csrc/split.cuh``'s ``merge_first_k`` and ``csrc/knn_select.cu``'s
``knn_select_kernel`` run them: the same 64-bit (distance, index) keys, the
same threads, lanes and registers, the same compare-exchange networks.  The
CPU tests hold the models to the plain versions, so the kernels' logic is
checked where no card is; the card tests hold the kernels themselves.

Not a test file: ``tests/test_torch_knn.py`` imports it.
"""

from __future__ import annotations

import os
import re

import numpy as np

NO_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
LOW32 = np.uint64(0xFFFFFFFF)
FLT_MAX = np.float32(3.402823466e38)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "cooper_mapper_torch", "csrc")


def source_constant(name, file):
    """The value of ``constexpr int|bool name = ...`` in ``csrc/file``."""
    with open(os.path.join(CSRC, file)) as f:
        m = re.search(rf"\b{name} = (\w+)", f.read())
    v = m.group(1)
    return {"true": True, "false": False}.get(v, None) if not v.isdigit() else int(v)


def pow2_at_least(k):
    p = 1
    while p < k:
        p <<= 1
    return p


def make_key(d, j):
    """split.cuh's make_key: (ordered bits of d) << 32 | j, as uint64."""
    u = np.asarray(d, np.float32).view(np.uint32).astype(np.uint64)
    ordered = np.where(u & np.uint64(0x80000000), ~u & LOW32, u | np.uint64(0x80000000))
    return (ordered << np.uint64(32)) | np.asarray(j).astype(np.uint64)


def key_dist(key):
    """from_ordered_bits of the key's high half: the distance, as f32."""
    u = (key >> np.uint64(32)).astype(np.uint64)
    bits = np.where(u & np.uint64(0x80000000), u & np.uint64(0x7FFFFFFF), ~u & LOW32)
    return bits.astype(np.uint32).view(np.float32)


def decode(key, k):
    """The output of a list of keys [..., >= k] ascending: listed keys as
    (d, j), the slots past the F listed ones as (+inf, slot - F)."""
    key = key[..., :k]
    listed = key != NO_KEY
    F = listed.sum(-1, keepdims=True)
    d = np.where(listed, key_dist(key), np.float32(np.inf)).astype(np.float32)
    j = np.where(listed, (key & LOW32).astype(np.int64), np.arange(k) - F).astype(np.int32)
    return j, d


# ---------------------------------------------------------------------------
# merge_first_k: threads per query, strided chunks, pairwise list merges
# ---------------------------------------------------------------------------


def insert_key(a, c, do):
    """split.cuh's insert_key on rows [n, K] where ``do``."""
    K = a.shape[1]
    lt = c[:, None] < a
    new = a.copy()
    for s in range(K - 1, 0, -1):
        new[:, s] = np.where(lt[:, s - 1], a[:, s - 1], np.where(lt[:, s], c, a[:, s]))
    new[:, 0] = np.where(lt[:, 0], c, a[:, 0])
    return np.where(do[:, None], new, a)


def bitonic_clean(c):
    """split.cuh's bitonic_clean on rows [n, P]."""
    P = c.shape[1]
    s = P // 2
    while s:
        for i in range(P):
            if i & s:
                continue
            x, y = c[:, i].copy(), c[:, i + s].copy()
            c[:, i], c[:, i + s] = np.minimum(x, y), np.maximum(x, y)
        s //= 2


def merge_first(a, b):
    """split.cuh's merge_first: the K smallest keys of rows a and b [n, K]."""
    n, K = a.shape
    P = pow2_at_least(K)
    c = np.empty((n, P), np.uint64)
    for i in range(P):
        jb = P - 1 - i
        if i < K and jb < K:
            c[:, i] = np.minimum(a[:, i], b[:, jb])
        elif i < K:
            c[:, i] = a[:, i]
        else:
            c[:, i] = b[:, jb]
    bitonic_clean(c)
    return c[:, :K].copy()


def merge_first_k_model(part_d, part_i, W=None):
    """merge_first_k<K, W> on chunk lists [S, n, K] -> (idx, dist) [n, K].
    The chunks are staged R at a time (R from MERGE_K_SMEM, at most S);
    thread p of a query's W takes staged chunks p, p + W, ... of each round;
    the shuffles then merge the threads' lists, round m pairing threads p
    and p ^ 2^m."""
    W = W or source_constant("MERGE_K_W", "split.cuh")
    S, n, K = part_d.shape
    row = source_constant("MERGE_K_THREADS", "split.cuh") // W * K
    R = min(S, max(1, source_constant("MERGE_K_SMEM", "split.cuh") // (8 * row)))
    lists = []
    for p in range(W):
        key = np.full((n, K), NO_KEY)
        for z0 in range(0, S, R):
            for z in range(z0 + p, min(S, z0 + R), W):
                alive = np.ones(n, bool)
                for s in range(K):
                    d, j = part_d[z, :, s], part_i[z, :, s]
                    alive &= d < np.inf
                    c = make_key(np.where(alive, d, 0), np.where(alive, j, 0))
                    alive &= c < key[:, K - 1]
                    key = insert_key(key, c, alive)
        lists.append(key)
    m = 1
    while m < W:
        lists = [merge_first(lists[p], lists[p ^ m]) for p in range(W)]
        m *= 2
    return decode(lists[0], K)


# ---------------------------------------------------------------------------
# knn_select_kernel: a warp per query, the list striped over the lanes
# ---------------------------------------------------------------------------

LANES = np.arange(32)


def ce_lanes(v, stride, keep_min):
    o = v[LANES ^ stride]
    return np.where(np.where(keep_min, o < v, v < o), o, v)


def ce_regs(a, i, j, up):
    x, y = a[i].copy(), a[j].copy()
    lo, hi = np.minimum(x, y), np.maximum(x, y)
    a[i], a[j] = (lo, hi) if up else (hi, lo)


def warp_sort(a):
    """knn_select.cu's warp_sort on registers [T, 32] (element e = 32 i + lane)."""
    T = a.shape[0]
    size = 2
    while size <= 32 * T:
        stride = size // 2
        while stride:
            for i in range(T):
                if stride >= 32:
                    rs = stride >> 5
                    if not i & rs:
                        ce_regs(a, i, i + rs, ((i << 5) & size) == 0)
                else:
                    up = (((i << 5) | LANES) & size) == 0
                    a[i] = ce_lanes(a[i], stride, up == ((LANES & stride) == 0))
            stride //= 2
        size *= 2


def warp_clean(a):
    """knn_select.cu's warp_clean on registers [N, 32]."""
    N = a.shape[0]
    stride = 16 * N
    while stride:
        for i in range(N):
            if stride >= 32:
                rs = stride >> 5
                if not i & rs:
                    ce_regs(a, i, i + rs, True)
            else:
                a[i] = ce_lanes(a[i], stride, (LANES & stride) == 0)
        stride //= 2


def warp_merge(lst, queue):
    N, T = lst.shape[0], queue.shape[0]
    warp_sort(queue)
    for i in range(max(0, N - T), N):
        lst[i] = np.minimum(queue[N - 1 - i][LANES ^ 31], lst[i])
    warp_clean(lst)
    queue[:] = NO_KEY


def knn_select_model(d_row, k, trace=None):
    """knn_select_kernel's warp on one query: ``d_row`` [M] f32, the query's
    distances as the kernel computes them (the plain version's bits) ->
    (idx [k], dist [k]).  Lane l takes points l, l + 32, ....  Pass 1 (where
    k <= 32 L): each lane's L smallest keys; the warp sorts their union, tau
    its k-th key; exact where no lane's full list ends at or under tau.
    Else pass 2: the warp select over the points at or under tau's distance,
    SEL_UNROLL points per lane between two votes.  ``trace`` (a dict) gets
    "exact" and "merges"."""
    U = source_constant("SEL_UNROLL", "knn_select.cu")
    T = source_constant("SEL_QUEUE", "knn_select.cu")
    M = d_row.shape[0]
    P = max(source_constant("SEL_MIN_KEYS", "knn_select.cu"), pow2_at_least(k))
    N = P // 32
    L = min(4 * N, source_constant("SEL_MAX_LOCAL", "knn_select.cu"))
    trace = {} if trace is None else trace
    trace.update(exact=False, merges=0)
    order = np.arange(k)

    tau = NO_KEY
    if k <= 32 * L:
        lists = []
        for l in range(32):
            j = np.arange(l, M, 32)
            d = d_row[j]
            fin = d < np.inf
            keep = np.lexsort((j[fin], d[fin]))[:L]
            lists.append(list(zip(d[fin][keep], j[fin][keep])))
        local = np.full((L, 32), NO_KEY)
        for l, lst in enumerate(lists):
            for i, (d, j) in enumerate(lst):
                local[i, l] = make_key(d, j)
        last = local[L - 1].copy()
        warp_sort(local)
        tau = local[(k - 1) >> 5, (k - 1) & 31]
        if ((last == NO_KEY) | (last > tau)).all():
            trace["exact"] = True
            return decode(local[order >> 5, order & 31], k)

    bound = FLT_MAX if tau == NO_KEY else key_dist(tau)
    st = dict(lst=np.full((N, 32), NO_KEY), queue=np.full((T, 32), NO_KEY),
              queued=np.zeros(32, int), thr=NO_KEY, thr_d=np.float32(bound))

    def offer(d, j, has):
        ok = has & (d <= st["thr_d"])
        c = make_key(np.where(ok, d, 0), np.where(ok, j, 0))
        ok &= c < st["thr"]
        q = st["queue"]
        q[1:, ok] = q[:-1, ok]
        q[0, ok] = c[ok]
        st["queued"][ok] += 1

    def settle(room):
        if not (st["queued"] > room).any():
            return
        warp_merge(st["lst"], st["queue"])
        trace["merges"] += 1
        st["queued"][:] = 0
        st["thr"] = st["lst"][(k - 1) >> 5, (k - 1) & 31]
        st["thr_d"] = np.float32(bound) if st["thr"] == NO_KEY else key_dist(st["thr"])

    for base in range(0, M, 32 * U):
        for u in range(U):
            j = base + 32 * u + LANES
            offer(d_row[np.minimum(j, M - 1)], np.minimum(j, M - 1), j < M)
        settle(T - U)
    settle(0)
    return decode(st["lst"][order >> 5, order & 31], k)
