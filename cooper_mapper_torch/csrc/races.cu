// Nearest-neighbour race kernels of the scan-to-scan correspondence search,
// hand-written for Hopper (sm_90a).  Built by cooper_mapper_torch/build.py with
// plain nvcc (one process per source, then one link) into a C-ABI shared
// library that Python loads with ctypes; no PyTorch header is included.
//
// Replaces (cooper_mapper_tpu/ops/pallas/nn1.py):
//   nn1_kernel       <- nn1_pallas        / _nn1_kernel         (race A)
//   masked_kernel    <- nn1_masked_pallas / _nn1_masked_kernel  (ring race, "adj" or "same")
//   bc_races_kernel  <- bc_races_pallas   / _bc_races_kernel    (surf races B and C)
//   fused_races_kernel <- fused_races_pallas / _fused_races_kernel (every race of one
//                         search, A's ring found in the kernel; nn1.py:349, call :449)
//
// What each computes.  For every query q of problem b, over reference points
// j = 0..M-1 of that problem's reference (batch stride 0 = one reference
// shared by all problems):
//   d(q, j) = (|q|^2 - 2 (q . r_j)) + |r_j|^2
// with |r_j|^2 = BIG (1e12) for an invalid point and its ring 1e9.  A ring
// race replaces d by BIG where the candidate fails the ring test.  The output
// is (min_j d, first j attaining it), as a scan in index order with a strict
// "<" gives it: ties go to the smaller index, exactly like torch.argmin and
// the TPU kernels.  nn1_kernel, masked_kernel and fused_races_kernel form
// |r|^2, BIG, the f32 ring and ring_a's f32 themselves from the caller's mask
// (bool) and rings (int32); bc_races_kernel takes them from the wrapper.

// Rounding.  Every multiply and add is spelled with __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA.  The order is the plain
// PyTorch version's (cooper_mapper_torch/ops/races.py):
//   qn    = (qx*qx + qy*qy) + qz*qz      (|r|^2 the same way)
//   cross = (qx*rx + qy*ry) + qz*rz
//   d     = (qn - 2*cross) + rn
// and an int32 ring becomes f32 by round-to-nearest (__int2float_rn), as
// torch's .to(float32) does, so kernel and plain version produce
// bit-identical distances.
//
// What bounds it on this card.  Per (query, reference) pair a race does 8
// FP32 operations for the distance and 1-4 more for the ring test and the
// running minimum, and reads nothing from device memory: the reference tile
// sits in shared memory and every thread of a warp reads the same element
// (a broadcast; G consecutive ones in the fused kernel).  The inputs are a few MB per call, so the kernels are bound
// by FP32 issue rate, not by bandwidth.
//
// What the designs do about it.  All four kernels keep their queries' running
// minima in registers; blockIdx.y is the problem (a batch of more than
// 65,535 problems, CUDA's cap on grid y, is launched in slabs of at most
// that many: split.cuh's over_slabs).  A block stages TILE_M
// reference points as float4 (x, y, z, |r|^2) plus a float ring in shared
// memory, so the inner loop is one 16-byte shared broadcast and the
// arithmetic, nothing else.  The ragged last tile is bounded by M itself; no
// padding of the reference is needed.
//
// nn1_kernel and masked_kernel (times: time_search_kernels.py, PERF.md):
// * group minima, no index per pair.  Each query keeps only the minimum of
//   the current group of RACE_GROUP points, one fminf per pair, and once per
//   group records the group where its minimum is strictly below the running
//   one.  At the end the recorded group is scanned again for the first point
//   whose recomputed value equals the minimum (race_group, race_block).  So
//   race A issues the 9 operations per pair the function needs: 8 for d and
//   one fminf;
// * the settled rule (ring races): once every running minimum of a warp is
//   <= BIG, a candidate that fails its ring test cannot win, and
//   "ring test passes, then fminf" replaces forming the masked value;
// * full groups run loops with compile-time trip counts, unrolled, and the
//   ragged end its own loop;
// * queries per thread: 2 where a block scans the whole of M (each shared
//   broadcast of a point feeds two distance evaluations), 1 where M is split
//   (twice the query blocks, so half the chunks and a shorter merge for the
//   same grid); 4 was slower at every shape (PERF.md);
// * the wrapper's input prep is in the kernel (raw_point, raw_ring): the
//   wrapper launches this kernel and, where M is split, merge_min, nothing
//   else.
// bc_races_kernel computes d once per pair and feeds both masked reductions,
// the TPU kernel's saving:
// * the settled rule, by a vote every BC_STEP points; "same" and "adj" share
//   one rd = |ring - ring_a|;
// * full tiles run loops with compile-time trip counts, unrolled, and the
//   ragged end its own loop;
// * one query per thread.  Each shared broadcast of a point could feed
//   several queries, but 2 and 4 per thread were slower at the odometry
//   batch shape (PERF.md): the race is bound by its compares and selects,
//   not by the shared loads, and fewer threads hide less latency.
// nn1_kernel, masked_kernel and bc_races_kernel split M across blocks where
// the grid would not fill the card (B = 1 in the single-stream sweep: 1024
// queries are 4-8 blocks for 132 SMs).  The grid is (query blocks, B, S);
// block z scans one chunk of M and writes its (min, argmin) pairs to scratch,
// and merge_min (split.cuh) joins them: a lexicographic (d, chunk) minimum
// taken by several threads per query, no serial chain.  The wrapper picks S
// from B, Q, M and the card's SM count (ops/races._split_plan); S = 1 writes
// the output directly, no merge.  Why the merge gives the same bits as one
// scan: split.cuh.
// Given the caller's lists, the same three kernels walk only each problem's
// valid queries and valid reference points (RefWalk, QueryWalk): the time
// follows the valid pairs, not the padded slots, and the answers keep their
// bits.  Without lists they walk every slot, as before.

// fused_races_kernel (every race of one search in one launch, no scratch,
// no merge).  The TPU kernel holds the whole [tile_q, M] distance tile in
// VMEM, takes A's argmin, extracts A's ring with a masked min (Mosaic has no
// per-lane gather) and runs B and C on the same tile.  Here a thread cannot
// hold a row of M distances, and B and C need A's ring before they can mask,
// so the kernel makes two passes over the shared-memory tiles:
// * G lanes of a warp share one query (G a template argument, picked by
//   ops/races._fused_plan from B, Q and the SM count; 32 at B = 1): lane l
//   scans the points j with j % G == l, so 1024 queries at B = 1 fill
//   8 x G blocks instead of 8, and no merge launch is needed.  The lanes combine their
//   (d, j) results by the lexicographic minimum with __shfl_xor_sync
//   (lanes_min); it does not depend on the order of combination, so it
//   gives the bits of one strict-"<" scan, by split.cuh's argument for
//   chunks.  The G lanes of a query read G consecutive points of a shared
//   tile (no bank conflict), and the other queries of the warp read the
//   same ones (a broadcast).  Where the grid already fills the card
//   (B = 512), G = 1 with 2 queries per thread;
// * pass 1 is race A by group minima (race_group, one fminf per pair, the
//   argmin found again in the lane's recorded group: group_argmin).  After
//   the combine every lane of the query knows ia; one lane reads A's ring
//   from the raw ring and mask (RING_INVALID where A is invalid) and a
//   shuffle hands it on;
// * pass 2 is race C (and B for surf) by group minima with the settled rule,
//   one d and one rd = |ring - ring_a| per pair for both races (pair_group);
// * the reference is read as the caller holds it and formed in the kernel
//   (RawTile), the next tile's loads in flight while the current one is
//   scanned.  The wrapper launches this kernel and nothing else.
// The function needs 15 (surf) / 13 (corner) FP32 operations per pair
// (chip_smoke.py); the two passes issue about 9 + 14 (surf) or 9 + 12
// (corner), because d is computed in both.  A per-ring top 2 in one pass
// would reach the function's own count but needs a bound on the ring count.

#include "split.cuh"

namespace {

constexpr int THREADS = SEARCH_THREADS;   // threads per block
constexpr int TILE_M = 512;    // reference points staged per shared-memory tile
constexpr float BIG = 1.0e12f;
constexpr float RING_INVALID = 1.0e9f;
constexpr int RACE_GROUP = 32;   // points per group of nn1_kernel / masked_kernel
// Queries per thread of nn1_kernel / masked_kernel: where a block scans the
// whole of M (S = 1, a grid that fills the card) and where M is split.
constexpr int WHOLE_QPT = 2;
constexpr int SPLIT_QPT = 1;

struct RefTile {
  float4 p[TILE_M];    // x, y, z, |r|^2 (BIG where invalid)
  float ring[TILE_M];  // ring as float (1e9 where invalid)
};

// ---------------------------------------------------------------------------
// The walks of nn1_kernel, masked_kernel and bc_races_kernel: which query
// slots a block serves and which reference points it scans.
//
// Without lists a block walks every slot.  With the caller's lists (ops/races
// valid_list: a stable partition of the slots, valid first, each group in
// index order, and the valid count) it walks positions of the lists instead:
// * the reference: positions [0, n) of the problem's list, n its valid count.
//   Every scan, group and chunk runs over positions, and a point keeps its
//   slot, lst[position], for the output.  The list is increasing in slot
//   over [0, n), so the first minimum in position order is the first in slot
//   order: ties still go to the smaller index.  A list that is the identity
//   (every point valid, or none: then all M are walked, as without a list)
//   is walked as positions = slots, with no list read.
// * the queries: block x serves positions [x*T, (x+1)*T) of the problem's
//   query list and writes each answer at the query's own slot.  A position
//   at or past the valid count gets the fixed answer (BIG, 0) without a
//   scan; a block wholly past it writes those and exits.  Every output slot
//   is written by one launch.
// Why the answers are the whole walk's, bit for bit, on every listed query
// (ops/races.py has the plain versions): an invalid reference point carries
// |r|^2 = BIG and ring 1e9, so (for a finite query) it loses race A to every
// valid point, and in a ring race its value is BIG.  A ring race's whole walk
// is the lexicographic (d, j) minimum of the listed walk's answer and of
// (BIG, first invalid slot), as split.cuh merges chunks: ring_answer.
// ---------------------------------------------------------------------------

struct RefWalk {
  const int* lst;      // null: position = slot
  int n;               // positions walked
  int first_invalid;   // lst[n] where the list is partial (0 < n < M), else -1

  __device__ __forceinline__ int slot(int p) const { return lst ? lst[p] : p; }

  // Position of slot j, or -1 where j is not walked.  The listed part is
  // increasing, so a binary search finds it.
  __device__ __forceinline__ int position(int j) const {
    if (!lst) return j;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lst[mid] < j) lo = mid + 1; else hi = mid;
    }
    return lo < n && lst[lo] == j ? lo : -1;
  }
};

__device__ __forceinline__ RefWalk ref_walk(const int* __restrict__ r_list,
                                            const int* __restrict__ r_count,
                                            long long r_bstride, int b, int M) {
  RefWalk w{nullptr, M, -1};
  if (r_list == nullptr) return w;
  const int c = r_count[r_bstride ? b : 0];
  if (c > 0 && c < M) {
    w.lst = r_list + b * r_bstride;
    w.n = c;
    w.first_invalid = w.lst[c];
  }
  return w;
}

struct QueryWalk {
  const int* lst;   // null: position = slot
  int n;            // listed (valid) positions: those that are scanned

  __device__ __forceinline__ int slot(int p) const { return lst ? lst[p] : p; }
};

__device__ __forceinline__ QueryWalk query_walk(const int* __restrict__ q_list,
                                                const int* __restrict__ q_count, int b, int Q) {
  if (q_list == nullptr) return {nullptr, Q};
  const int c = q_count[b];
  return {c == Q ? nullptr : q_list + (long long)b * Q, c};
}

// A ring race's answer over the whole reference from its listed walk's
// (d, slot): the lexicographic minimum with (BIG, the first invalid slot).
// A chunk that walked nothing, (+inf, 0), becomes (BIG, first invalid),
// which the chunk-order merge puts behind every earlier chunk's BIG.
__device__ __forceinline__ void ring_answer(const RefWalk& w, float& d, int& j) {
  if (w.first_invalid >= 0 && (BIG < d || (BIG == d && w.first_invalid < j))) {
    d = BIG;
    j = w.first_invalid;
  }
}

// Cooperative load of reference positions [base, base + n) into shared memory.
template <bool WITH_RING>
__device__ __forceinline__ void load_tile(RefTile& t, const float* __restrict__ r,
                                          const float* __restrict__ rn,
                                          const float* __restrict__ ring, const RefWalk& w,
                                          int base, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int j = w.slot(base + k);
    t.p[k] = make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], rn[j]);
    if (WITH_RING) t.ring[k] = ring[j];
  }
}

// ---------------------------------------------------------------------------
// nn1_kernel and masked_kernel: race A and one ring race, by group minima
// ---------------------------------------------------------------------------

// Reference point j as the plain version forms it from the caller's tensors:
// (x, y, z, |r|^2) with |r|^2 = (x*x + y*y) + z*z, or BIG where the point is
// invalid; its ring as f32 (the rounding of torch's .to(float32)), or
// RING_INVALID.  The wrappers of nn1 and nn1_masked pass r_mask and r_ring
// as they are: these kernels form what the wrapper used to.
__device__ __forceinline__ float4 raw_point(const float* __restrict__ r,
                                            const bool* __restrict__ mask, int j) {
  const float x = r[3 * j], y = r[3 * j + 1], z = r[3 * j + 2];
  return make_float4(x, y, z, mask[j] ? sq_norm(x, y, z) : BIG);
}

__device__ __forceinline__ float raw_ring(const int* __restrict__ ring,
                                          const bool* __restrict__ mask, int j) {
  return mask[j] ? __int2float_rn(ring[j]) : RING_INVALID;
}

enum RaceKind { RACE_A, RACE_ADJ, RACE_SAME };

// One query of nn1_kernel / masked_kernel: its running minimum and the first
// index of the group of points that holds it (-1: none yet).
struct RaceQuery {
  float qx, qy, qz, qn, ring_a;
  int idx_a;
  float best;
  int group;
};

template <RaceKind K>
__device__ __forceinline__ bool ring_ok(const RaceQuery& w, float rg, int j, float span) {
  if (K == RACE_ADJ) {
    const float rd = fabsf(__fsub_rn(rg, w.ring_a));
    return rd > 0.0f && rd <= span;
  }
  return rg == w.ring_a && j != w.idx_a;   // RACE_SAME
}

// The race's value of candidate j: d, or BIG where a ring race's test fails.
template <RaceKind K>
__device__ __forceinline__ float race_value(const RaceQuery& w, float4 p, float rg, int j,
                                            float span) {
  const float d = sq_dist(w.qx, w.qy, w.qz, w.qn, p);
  if (K == RACE_A) return d;
  return ring_ok<K>(w, rg, j, span) ? d : BIG;
}

// The tile's points s, s + G, ..., N of them (n when N == 0; index base + k):
// each query's minimum over them by fminf, one per pair, no index kept; the
// group is recorded (by its first index, base + s) where that minimum is
// strictly below the running one.  fminf skips a NaN as the strict "<" of a
// scan does, and "<" between groups keeps the earlier group on a tie, so the
// recorded group holds the scan's (min, first argmin) over the points this
// thread scans.  G = 1 in nn1_kernel / masked_kernel (a thread scans every
// point of its chunk); G lanes of fused_races_kernel share one query and
// each takes every G-th point.
// SETTLED (ring races): every running minimum of the warp is already <= BIG,
// so a candidate that fails its ring test (value BIG) cannot win, and the
// rule "ring test passes, then fminf" gives the same minimum without forming
// the masked value.
template <RaceKind K, int QPT, int N, bool SETTLED, int G>
__device__ __forceinline__ void race_group(const RefTile& t, int s, int n, int base, float span,
                                           RaceQuery (&w)[QPT]) {
  float m[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) m[u] = INFINITY;
  // N > 0: n == N, unrolled
#pragma unroll
  for (int i = 0; i < (N > 0 ? N : n); ++i) {
    const int k = s + i * G;
    const float4 p = t.p[k];
    const float rg = K == RACE_A ? 0.0f : t.ring[k];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      if (K == RACE_A || !SETTLED) {
        m[u] = fminf(m[u], race_value<K>(w[u], p, rg, base + k, span));
      } else {
        const float d = sq_dist(w[u].qx, w[u].qy, w[u].qz, w[u].qn, p);
        if (ring_ok<K>(w[u], rg, base + k, span)) m[u] = fminf(m[u], d);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    if (m[u] < w[u].best) { w[u].best = m[u]; w[u].group = base + s; }
  }
}

// The settled rule's vote is taken over the whole warp: each lane's own
// condition is its queries' minima <= BIG, and the warp-wide vote keeps the
// branch uniform (a warp of G-lane groups settles when all its groups have).
template <RaceKind K, int QPT, int N, int G = 1>
__device__ __forceinline__ void race_step(const RefTile& t, int s, int n, int base, float span,
                                          RaceQuery (&w)[QPT]) {
  bool settled = K != RACE_A;
#pragma unroll
  for (int u = 0; u < QPT; ++u) settled = settled && w[u].best <= BIG;
  if (K != RACE_A && __all_sync(0xffffffffu, settled)) {
    race_group<K, QPT, N, true, G>(t, s, n, base, span, w);
  } else {
    race_group<K, QPT, N, false, G>(t, s, n, base, span, w);
  }
}

// Points of a group read from device memory at once, for all the queries of
// a thread together (8 for one query, 4 each for two: more would hold ~40
// registers per query through the rescan and spill where a thread has two).
constexpr int RESCAN_BATCH = 8;

// A thread's (min, first argmin) from its recorded group: the first point of
// the group (g, g + G, ..., N points below c1) whose value, recomputed by the
// same operations, equals the minimum.  A group lies in one tile.  In the
// last tile staged (base `last`) it is read from shared memory; an earlier
// one is read again from the caller's tensors (through the walk's list:
// positions, slot lst[j]; null lst, slot j), BATCH points' loads at a time,
// so that they are in flight together and not one after another.  bi is a
// position.  No group: (+inf, 0), as a scan from (+inf, 0) leaves it.
template <RaceKind K, int G, int N, int BATCH>
__device__ __forceinline__ void group_argmin(const RaceQuery& w, const RefTile& tile, int last,
                                             const float* __restrict__ r,
                                             const bool* __restrict__ mask,
                                             const int* __restrict__ ring,
                                             const int* __restrict__ lst, int c1, float span,
                                             float& bd, int& bi) {
  bd = INFINITY;
  bi = 0;
  const int g = w.group;
  if (g < 0) return;
  const int e = min(g + N * G, c1);   // past the group's last point
  if (g >= last) {
    // backwards, so that the first match is the one kept; no early exit
    for (int j = g + (e - 1 - g) / G * G; j >= g; j -= G) {
      const float rg = K == RACE_A ? 0.0f : tile.ring[j - last];
      const float v = race_value<K>(w, tile.p[j - last], rg, j, span);
      if (v == w.best) { bd = v; bi = j; }
    }
    return;
  }
  bool found = false;
  for (int j0 = g; j0 < e && !found; j0 += BATCH * G) {
    float4 p[BATCH];
    float rg[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int j = j0 + i * G;
      if (j < e) {
        const int sj = lst ? lst[j] : j;
        p[i] = raw_point(r, mask, sj);
        rg[i] = K == RACE_A ? 0.0f : raw_ring(ring, mask, sj);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int j = j0 + i * G;
      if (!found && j < e && race_value<K>(w, p[i], rg[i], j, span) == w.best) {
        found = true;
        bd = w.best;
        bi = j;
      }
    }
  }
}

// Block (x, b, z): THREADS * QPT query positions of problem b against the
// chunk z of the reference positions; writes (min, first argmin) to dst_d /
// dst_i[z * chunk_stride + the query's slot].  Lists: see RefWalk / QueryWalk.
template <RaceKind K, int QPT>
__device__ __forceinline__ void race_block(RefTile& tile, const float* __restrict__ q,
                                           const int* __restrict__ ra,
                                           const int* __restrict__ ia,
                                           const float* __restrict__ r,
                                           const bool* __restrict__ mask,
                                           const int* __restrict__ ring,
                                           const int* __restrict__ q_list,
                                           const int* __restrict__ q_count,
                                           const int* __restrict__ r_list,
                                           const int* __restrict__ r_count,
                                           float* __restrict__ dst_d, int* __restrict__ dst_i,
                                           int Q, int M, long long r_bstride, float span, int L,
                                           long long chunk_stride) {
  const int b = blockIdx.y;
  const int first = blockIdx.x * (THREADS * QPT);
  const int p0 = first + threadIdx.x;
  const long long zo = blockIdx.z * chunk_stride + (long long)b * Q;
  const QueryWalk qw = query_walk(q_list, q_count, b, Q);
  if (first >= qw.n) {   // no listed query in the block: the fixed answers
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int p = p0 + u * THREADS;
      if (p < Q) { dst_d[zo + qw.slot(p)] = BIG; dst_i[zo + qw.slot(p)] = 0; }
    }
    return;
  }
  const RefWalk rw = ref_walk(r_list, r_count, r_bstride, b, M);
  RaceQuery w[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    // a position past the listed ones scans position 0's query, unwritten
    const int p = p0 + u * THREADS;
    const long long qo = (long long)b * Q + qw.slot(p < qw.n ? p : 0);
    w[u].qx = q[3 * qo]; w[u].qy = q[3 * qo + 1]; w[u].qz = q[3 * qo + 2];
    w[u].qn = sq_norm(w[u].qx, w[u].qy, w[u].qz);
    w[u].ring_a = K == RACE_A ? 0.0f : __int2float_rn(ra[qo]);
    w[u].idx_a = K == RACE_SAME ? rw.position(ia[qo]) : 0;
    w[u].best = INFINITY;
    w[u].group = -1;
  }
  r += b * r_bstride * 3;
  mask += b * r_bstride;
  if (K != RACE_A) ring += b * r_bstride;

  int c0, c1;
  chunk_of_block(rw.n, L, c0, c1);
  int last = c0;   // base of the last tile staged
  for (int base = c0; base < c1; base += TILE_M) {
    const int n = min(TILE_M, c1 - base);
    last = base;
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const int j = rw.slot(base + k);
      tile.p[k] = raw_point(r, mask, j);
      if (K != RACE_A) tile.ring[k] = raw_ring(ring, mask, j);
    }
    __syncthreads();
    if (n == TILE_M) {
#pragma unroll 1
      for (int s = 0; s < TILE_M; s += RACE_GROUP) {
        race_step<K, QPT, RACE_GROUP>(tile, s, RACE_GROUP, base, span, w);
      }
    } else {
      int s = 0;
      for (; s + RACE_GROUP <= n; s += RACE_GROUP) {
        race_step<K, QPT, RACE_GROUP>(tile, s, RACE_GROUP, base, span, w);
      }
      if (s < n) race_step<K, QPT, 0>(tile, s, n - s, base, span, w);
    }
  }

  // each query's argmin, found again in its recorded group, as a slot
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int p = p0 + u * THREADS;
    float bd;
    int bi;
    group_argmin<K, 1, RACE_GROUP, RESCAN_BATCH / QPT>(w[u], tile, last, r, mask, ring, rw.lst,
                                                       c1, span, bd, bi);
    if (w[u].group >= 0) bi = rw.slot(bi);
    if (K != RACE_A) ring_answer(rw, bd, bi);
    if (p < Q) {
      const long long o = zo + qw.slot(p);
      const bool listed = p < qw.n;
      dst_d[o] = listed ? bd : BIG;
      dst_i[o] = listed ? bi : 0;
    }
  }
}

// Race A.
template <int QPT>
__global__ void __launch_bounds__(THREADS)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ r,
           const bool* __restrict__ mask, const int* __restrict__ q_list,
           const int* __restrict__ q_count, const int* __restrict__ r_list,
           const int* __restrict__ r_count, float* __restrict__ dst_d, int* __restrict__ dst_i,
           int Q, int M, long long r_bstride, int L, long long chunk_stride) {
  __shared__ RefTile tile;
  race_block<RACE_A, QPT>(tile, q, nullptr, nullptr, r, mask, nullptr, q_list, q_count, r_list,
                          r_count, dst_d, dst_i, Q, M, r_bstride, 0.0f, L, chunk_stride);
}

// One ring race: K = RACE_ADJ, 0 < |ring - ring_a| <= span; RACE_SAME,
// ring == ring_a and j != ia.
template <RaceKind K, int QPT>
__global__ void __launch_bounds__(THREADS)
masked_kernel(const float* __restrict__ q, const int* __restrict__ ra,
              const int* __restrict__ ia, const float* __restrict__ r,
              const bool* __restrict__ mask, const int* __restrict__ ring,
              const int* __restrict__ q_list, const int* __restrict__ q_count,
              const int* __restrict__ r_list, const int* __restrict__ r_count,
              float* __restrict__ dst_d, int* __restrict__ dst_i, int Q, int M,
              long long r_bstride, float span, int L, long long chunk_stride) {
  __shared__ RefTile tile;
  race_block<K, QPT>(tile, q, ra, ia, r, mask, ring, q_list, q_count, r_list, r_count, dst_d,
                     dst_i, Q, M, r_bstride, span, L, chunk_stride);
}

constexpr int BC_STEP = 64;   // points per step of the settled check

// One query of bc_races_kernel and its running minima.
struct BcQuery {
  float qx, qy, qz, qn, ring_a;
  int idx_a;
  float best_b, best_c;
  int bidx_b, bidx_c;
};

// Races B and C of the tile's points [s, s + n).  On these finite rings
// "same" is rd == 0 and "adj" is 0 < rd <= span, with rd = |ring - ring_a|:
// one subtraction serves both tests.  A candidate that fails its ring test
// counts as BIG, so it can win only while the minimum is above BIG (+inf at
// the start).  SETTLED: every minimum of the warp is already <= BIG, and the
// rule "ring test passes and d < minimum" gives the same bits without
// forming the masked value.
template <int N, bool SETTLED>
__device__ __forceinline__ void bc_scan(const RefTile& t, int s, int n, int base, float span,
                                        BcQuery& w) {
  // N > 0: n == N, unrolled
#pragma unroll 4
  for (int k = s; k < s + (N > 0 ? N : n); ++k) {
    const float4 p = t.p[k];
    const float rg = t.ring[k];
    const int j = base + k;
    const float d = sq_dist(w.qx, w.qy, w.qz, w.qn, p);
    const float rd = fabsf(__fsub_rn(rg, w.ring_a));
    const bool same = rd == 0.0f && j != w.idx_a;
    const bool adj = rd > 0.0f && rd <= span;
    if (SETTLED) {
      if (same && d < w.best_b) { w.best_b = d; w.bidx_b = j; }
      if (adj && d < w.best_c) { w.best_c = d; w.bidx_c = j; }
    } else {
      const float db = same ? d : BIG;
      if (db < w.best_b) { w.best_b = db; w.bidx_b = j; }
      const float dc = adj ? d : BIG;
      if (dc < w.best_c) { w.best_c = dc; w.bidx_c = j; }
    }
  }
}

// One step of BC_STEP points (fewer at the tile's end), by the SETTLED rule
// once the whole warp is settled: from the first few points on, as a rule.
template <int N>
__device__ __forceinline__ void bc_step(const RefTile& t, int s, int n, int base, float span,
                                        BcQuery& w) {
  if (__all_sync(0xffffffffu, w.best_b <= BIG && w.best_c <= BIG)) {
    bc_scan<N, true>(t, s, n, base, span, w);
  } else {
    bc_scan<N, false>(t, s, n, base, span, w);
  }
}

// Surf races B and C.  Block (x, b, z): THREADS query positions of problem b
// against the chunk z of the reference positions; it writes (min, argmin) of
// B to dst_db/dst_ib[z * chunk_stride + the query's slot] and of C to
// dst_dc/dst_ic.  Lists: see RefWalk / QueryWalk.
__global__ void __launch_bounds__(THREADS)
bc_races_kernel(const float* __restrict__ q, const float* __restrict__ ra,
                const int* __restrict__ ia, const float* __restrict__ r,
                const float* __restrict__ rn, const float* __restrict__ ring,
                const int* __restrict__ q_list, const int* __restrict__ q_count,
                const int* __restrict__ r_list, const int* __restrict__ r_count,
                float* __restrict__ dst_db, int* __restrict__ dst_ib,
                float* __restrict__ dst_dc, int* __restrict__ dst_ic, int Q,
                int M, long long r_bstride, float span, int L, long long chunk_stride) {
  __shared__ RefTile tile;
  const int b = blockIdx.y;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const long long zo = blockIdx.z * chunk_stride + (long long)b * Q;
  const QueryWalk qw = query_walk(q_list, q_count, b, Q);
  if (blockIdx.x * THREADS >= qw.n) {   // no listed query in the block: the fixed answers
    if (p < Q) {
      const long long o = zo + qw.slot(p);
      dst_db[o] = BIG; dst_ib[o] = 0;
      dst_dc[o] = BIG; dst_ic[o] = 0;
    }
    return;
  }
  const RefWalk rw = ref_walk(r_list, r_count, r_bstride, b, M);
  BcQuery w;
  {
    // a position past the listed ones scans position 0's query, unwritten
    const long long qo = (long long)b * Q + qw.slot(p < qw.n ? p : 0);
    w.qx = q[3 * qo]; w.qy = q[3 * qo + 1]; w.qz = q[3 * qo + 2];
    w.qn = sq_norm(w.qx, w.qy, w.qz);
    w.ring_a = ra[qo];
    w.idx_a = rw.position(ia[qo]);
    w.best_b = INFINITY; w.best_c = INFINITY;
    w.bidx_b = 0; w.bidx_c = 0;
  }
  r += b * r_bstride * 3;
  rn += b * r_bstride;
  ring += b * r_bstride;

  int c0, c1;
  chunk_of_block(rw.n, L, c0, c1);
  for (int base = c0; base < c1; base += TILE_M) {
    const int n = min(TILE_M, c1 - base);
    __syncthreads();
    load_tile<true>(tile, r, rn, ring, rw, base, n);
    __syncthreads();
    for (int s = 0; s < n; s += BC_STEP) {
      if (n - s >= BC_STEP) {
        bc_step<BC_STEP>(tile, s, BC_STEP, base, span, w);
      } else {
        bc_step<0>(tile, s, n - s, base, span, w);
      }
    }
  }
  if (p < Q) {
    // positions to slots (+inf: nothing entered, index 0 as the scan's start)
    if (w.best_b < INFINITY) w.bidx_b = rw.slot(w.bidx_b);
    if (w.best_c < INFINITY) w.bidx_c = rw.slot(w.bidx_c);
    ring_answer(rw, w.best_b, w.bidx_b);
    ring_answer(rw, w.best_c, w.bidx_c);
    const long long o = zo + qw.slot(p);
    const bool listed = p < qw.n;
    dst_db[o] = listed ? w.best_b : BIG; dst_ib[o] = listed ? w.bidx_b : 0;
    dst_dc[o] = listed ? w.best_c : BIG; dst_ic[o] = listed ? w.bidx_c : 0;
  }
}

// ---------------------------------------------------------------------------
// fused_races_kernel: every race of one search in one launch
// ---------------------------------------------------------------------------

// Points each lane of the fused kernel scans per group: its G lanes together
// cover N * G consecutive points per step, a divisor of TILE_M, so that no
// group straddles two tiles.
template <int G>
struct FusedGroup {
  static constexpr int N = RACE_GROUP * G <= TILE_M ? RACE_GROUP : TILE_M / G;
};

template <int V>
struct Int { static constexpr int value = V; };

constexpr int TILE_PER_THREAD = TILE_M / THREADS;

// One thread's share of a tile of the caller's tensors: fetched into
// registers while the block scans the tile before it, then formed into the
// shared tile as raw_point / raw_ring form a point.
template <bool WITH_RING>
struct RawTile {
  float x[TILE_PER_THREAD], y[TILE_PER_THREAD], z[TILE_PER_THREAD];
  int rg[TILE_PER_THREAD];
  bool ok[TILE_PER_THREAD];

  __device__ __forceinline__ void fetch(const float* __restrict__ r,
                                        const bool* __restrict__ mask,
                                        const int* __restrict__ ring, int base, int n) {
#pragma unroll
    for (int p = 0; p < TILE_PER_THREAD; ++p) {
      const int k = threadIdx.x + p * THREADS;
      if (k < n) {
        const int j = base + k;
        x[p] = r[3 * j]; y[p] = r[3 * j + 1]; z[p] = r[3 * j + 2];
        ok[p] = mask[j];
        if (WITH_RING) rg[p] = ring[j];
      }
    }
  }

  __device__ __forceinline__ void put(RefTile& t, int n) const {
#pragma unroll
    for (int p = 0; p < TILE_PER_THREAD; ++p) {
      const int k = threadIdx.x + p * THREADS;
      if (k < n) {
        t.p[k] = make_float4(x[p], y[p], z[p], ok[p] ? sq_norm(x[p], y[p], z[p]) : BIG);
        if (WITH_RING) t.ring[k] = ok[p] ? __int2float_rn(rg[p]) : RING_INVALID;
      }
    }
  }
};

// Every tile of [0, M) in turn, the next tile's loads in flight while the
// current one is scanned: scan(n, base) for each.  Returns the base of the
// last tile, which stays in shared memory.
template <bool WITH_RING, typename Scan>
__device__ __forceinline__ int scan_tiles(RefTile& tile, const float* __restrict__ r,
                                          const bool* __restrict__ mask,
                                          const int* __restrict__ ring, int M, Scan scan) {
  RawTile<WITH_RING> raw;
  raw.fetch(r, mask, ring, 0, min(TILE_M, M));
  for (int base = 0;; base += TILE_M) {
    const int n = min(TILE_M, M - base);
    __syncthreads();   // every thread is done with the tile before
    raw.put(tile, n);
    __syncthreads();
    if (base + TILE_M >= M) {
      scan(n, base);
      return base;
    }
    raw.fetch(r, mask, ring, base + TILE_M, min(TILE_M, M - base - TILE_M));
    scan(n, base);
  }
}

// The steps of one tile of n points for lane `lane` of a G-lane group:
// step(s, count, Int<N>) on its points s, s + G, ... of each full step of
// N * G points, then step(s, count, Int<0>) on what is left of a ragged
// tile.  The loop bounds depend on n only, so every lane of a warp takes
// each step (the settled rule's vote inside needs the whole warp).
template <int G, int N, typename Step>
__device__ __forceinline__ void lane_steps(int n, int lane, Step step) {
  constexpr int SPAN = N * G;
  int s = 0;
  if (n == TILE_M) {
#pragma unroll 1
    for (; s < TILE_M; s += SPAN) step(s + lane, N, Int<N>());
    return;
  }
  for (; s + SPAN <= n; s += SPAN) step(s + lane, N, Int<N>());
  if (s < n) {
    const int left = n - s - lane;
    step(s + lane, left > 0 ? (left + G - 1) / G : 0, Int<0>());
  }
}

// Surf races B ("same") and C ("adj") of the points s, s + G, ..., by group
// minima as race_group: one d and one rd = |ring - ring_a| per pair feed
// both ("same" is rd == 0, "adj" 0 < rd <= span, on finite rings).
template <int QPT, int N, bool SETTLED, int G>
__device__ __forceinline__ void pair_group(const RefTile& t, int s, int n, int base, float span,
                                           RaceQuery (&wb)[QPT], RaceQuery (&wc)[QPT]) {
  float mb[QPT], mc[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) { mb[u] = INFINITY; mc[u] = INFINITY; }
#pragma unroll
  for (int i = 0; i < (N > 0 ? N : n); ++i) {
    const int k = s + i * G;
    const float4 p = t.p[k];
    const float rg = t.ring[k];
    const int j = base + k;
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const RaceQuery& w = wc[u];
      const float d = sq_dist(w.qx, w.qy, w.qz, w.qn, p);
      const float rd = fabsf(__fsub_rn(rg, w.ring_a));
      const bool same = rd == 0.0f && j != w.idx_a;
      const bool adj = rd > 0.0f && rd <= span;
      if (SETTLED) {
        if (same) mb[u] = fminf(mb[u], d);
        if (adj) mc[u] = fminf(mc[u], d);
      } else {
        mb[u] = fminf(mb[u], same ? d : BIG);
        mc[u] = fminf(mc[u], adj ? d : BIG);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    if (mb[u] < wb[u].best) { wb[u].best = mb[u]; wb[u].group = base + s; }
    if (mc[u] < wc[u].best) { wc[u].best = mc[u]; wc[u].group = base + s; }
  }
}

template <int QPT, int N, int G>
__device__ __forceinline__ void pair_step(const RefTile& t, int s, int n, int base, float span,
                                          RaceQuery (&wb)[QPT], RaceQuery (&wc)[QPT]) {
  bool settled = true;
#pragma unroll
  for (int u = 0; u < QPT; ++u) settled = settled && wb[u].best <= BIG && wc[u].best <= BIG;
  if (__all_sync(0xffffffffu, settled)) {
    pair_group<QPT, N, true, G>(t, s, n, base, span, wb, wc);
  } else {
    pair_group<QPT, N, false, G>(t, s, n, base, span, wb, wc);
  }
}

// The lexicographic (d, j) minimum over the G lanes of a query (aligned
// groups of G lanes of the warp), left in every lane of the group.  It does
// not depend on the order of combination, so it is the minimum, and first
// argmin, of one strict-"<" scan over the union of the lanes' points.
template <int G>
__device__ __forceinline__ void lanes_min(float& d, int& j) {
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j, off);
    if (od < d || (od == d && oj < j)) { d = od; j = oj; }
  }
}

// Every race of one search.  WITH_SAME = surf (A, B, C), else corner (A, C).
// Block (x, b): THREADS / G * QPT queries of problem b, each served by G
// consecutive lanes; lane l of a query scans the points j with j % G == l.
template <int G, int QPT, bool WITH_SAME>
__global__ void __launch_bounds__(THREADS)
fused_races_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   const bool* __restrict__ mask, const int* __restrict__ ring,
                   float* __restrict__ out_da, int* __restrict__ out_ia,
                   float* __restrict__ out_db, int* __restrict__ out_ib,
                   float* __restrict__ out_dc, int* __restrict__ out_ic, int Q, int M,
                   long long r_bstride, float span) {
  constexpr int N = FusedGroup<G>::N;
  static_assert(32 % G == 0 && TILE_M % (N * G) == 0, "lane groups");
  constexpr int QB = THREADS / G;   // queries of the block per query slot
  __shared__ RefTile tile;
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * (QB * QPT) + threadIdx.x / G;
  RaceQuery a[QPT], wb[QPT], wc[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = q0 + u * QB;
    const long long qo = (long long)b * Q + (qi < Q ? qi : 0);
    a[u].qx = q[3 * qo]; a[u].qy = q[3 * qo + 1]; a[u].qz = q[3 * qo + 2];
    a[u].qn = sq_norm(a[u].qx, a[u].qy, a[u].qz);
    a[u].ring_a = 0.0f;
    a[u].idx_a = 0;
    a[u].best = INFINITY;
    a[u].group = -1;
  }
  r += b * r_bstride * 3;
  mask += b * r_bstride;
  ring += b * r_bstride;

  // pass 1: race A by group minima, each lane over its points.  Where M is
  // one tile, its rings are staged with it and pass 2 scans it as it is.
  const auto scan_a = [&](int n, int base) {
    lane_steps<G, N>(n, lane, [&](int s, int cnt, auto len) {
      race_step<RACE_A, QPT, decltype(len)::value, G>(tile, s, cnt, base, span, a);
    });
  };
  const bool one_tile = M <= TILE_M;
  int last = one_tile ? scan_tiles<true>(tile, r, mask, ring, M, scan_a)
                      : scan_tiles<false>(tile, r, mask, ring, M, scan_a);
  // A over the whole of M, in every lane of the query; one lane reads A's
  // ring (RING_INVALID where A is an invalid point) and hands it on
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    float da;
    int ia;
    group_argmin<RACE_A, G, N, RESCAN_BATCH / QPT>(a[u], tile, last, r, mask, ring, nullptr, M,
                                                   span, da, ia);
    lanes_min<G>(da, ia);
    float ra = lane == 0 ? raw_ring(ring, mask, ia) : 0.0f;
    ra = __shfl_sync(0xffffffffu, ra, 0, G);
    wc[u] = a[u];
    wc[u].ring_a = ra;
    wc[u].idx_a = ia;
    wc[u].best = INFINITY;
    wc[u].group = -1;
    wb[u] = wc[u];
    a[u].best = da;
    a[u].idx_a = ia;
  }

  // pass 2: race C, and B with WITH_SAME, on A's ring
  const auto scan_bc = [&](int n, int base) {
    lane_steps<G, N>(n, lane, [&](int s, int cnt, auto len) {
      constexpr int L = decltype(len)::value;
      if (WITH_SAME) {
        pair_step<QPT, L, G>(tile, s, cnt, base, span, wb, wc);
      } else {
        race_step<RACE_ADJ, QPT, L, G>(tile, s, cnt, base, span, wc);
      }
    });
  };
  if (one_tile) {
    scan_bc(M, 0);
  } else {
    last = scan_tiles<true>(tile, r, mask, ring, M, scan_bc);
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = q0 + u * QB;
    float dc, db = 0.0f;
    int ic, ib = 0;
    group_argmin<RACE_ADJ, G, N, RESCAN_BATCH / QPT>(wc[u], tile, last, r, mask, ring, nullptr,
                                                     M, span, dc, ic);
    lanes_min<G>(dc, ic);
    if (WITH_SAME) {
      group_argmin<RACE_SAME, G, N, RESCAN_BATCH / QPT>(wb[u], tile, last, r, mask, ring,
                                                        nullptr, M, span, db, ib);
      lanes_min<G>(db, ib);
    }
    if (lane == 0 && qi < Q) {
      const long long qo = (long long)b * Q + qi;
      out_da[qo] = a[u].best; out_ia[qo] = a[u].idx_a;
      if (WITH_SAME) { out_db[qo] = db; out_ib[qo] = ib; }
      out_dc[qo] = dc; out_ic[qo] = ic;
    }
  }
}

// The fused kernel's launches: G lanes per query, QPT queries per thread.
template <int G, int QPT, bool WITH_SAME>
int launch_fused(const float* q, const float* r, const bool* mask, const int* ring,
                 float* out_da, int* out_ia, float* out_db, int* out_ib, float* out_dc,
                 int* out_ic, int B, int Q, int M, int r_bstride, float span, cudaStream_t st) {
  constexpr int per_block = THREADS / G * QPT;
  const dim3 grid((Q + per_block - 1) / per_block, B);
  fused_races_kernel<G, QPT, WITH_SAME><<<grid, THREADS, 0, st>>>(
      q, r, mask, ring, out_da, out_ia, out_db, out_ib, out_dc, out_ic, Q, M, r_bstride, span);
  return (int)cudaGetLastError();
}

// (G, QPT) -> its launch; cudaErrorInvalidValue for a plan not built.  The
// two plans built are the ones that won at the search's shapes (PERF.md):
// G = 1 with 2 queries per thread where the grid fills the card, G = 32 (a
// warp per query) where it does not; G = 4, 8, 16 and G = 1 with one query
// per thread were slower at every shape measured.
template <bool WITH_SAME>
int launch_fused_plan(int G, int QPT, const float* q, const float* r, const bool* mask,
                      const int* ring, float* out_da, int* out_ia, float* out_db, int* out_ib,
                      float* out_dc, int* out_ic, int B, int Q, int M, int r_bstride, float span,
                      cudaStream_t st) {
  decltype(&launch_fused<1, 2, WITH_SAME>) fn = nullptr;
  if (G == 1 && QPT == 2) fn = launch_fused<1, 2, WITH_SAME>;
  if (G == 32 && QPT == 1) fn = launch_fused<32, 1, WITH_SAME>;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, r, mask, ring, out_da, out_ia, out_db, out_ib, out_dc, out_ic, B, Q, M,
            r_bstride, span, st);
}

// nn1_kernel / masked_kernel at QPT queries per thread over S chunks of M.
template <int QPT>
dim3 race_grid(int B, int Q, int S) {
  return dim3((Q + THREADS * QPT - 1) / (THREADS * QPT), B, S);
}

// After a split race's launch: check it, then merge its S chunks' (min,
// argmin) pairs [S, n] into out_d / out_i [n].
int merge_one(const float* part_d, const int* part_i, float* out_d, int* out_i, long long n,
              int S, cudaStream_t st) {
  const int err = (int)cudaGetLastError();
  if (err) return err;
  MinOut out = {{out_d, nullptr, nullptr, nullptr}, {out_i, nullptr, nullptr, nullptr}};
  return launch_merge_min(part_d, part_i, out, n, S, 1, st);
}

// The caller's lists of one launch (each pair may be null: no list): the
// query list [B,Q] i32 and its counts [B] i32; the reference list [*,M] i32
// and its counts [*] i32 (one of each where the reference is shared).
struct Lists {
  const int* q_list;
  const int* q_count;
  const int* r_list;
  const int* r_count;

  // The lists of the slab of problems from b0.
  Lists from(long long b0, int Q, int r_bstride) const {
    return {q_list ? q_list + b0 * Q : nullptr, q_count ? q_count + b0 : nullptr,
            r_list ? r_list + b0 * r_bstride : nullptr,
            r_count && r_bstride ? r_count + b0 : r_count};
  }
};

// nn1's launches for B <= MAX_GRID_Y problems: whole (S = 1) or split with
// the merge.
int launch_nn1(const float* q, const float* r, const bool* mask, Lists ls, float* out_d,
               int* out_i, float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
               int S, int L, cudaStream_t st) {
  if (S == 1) {
    nn1_kernel<WHOLE_QPT><<<race_grid<WHOLE_QPT>(B, Q, 1), THREADS, 0, st>>>(
        q, r, mask, ls.q_list, ls.q_count, ls.r_list, ls.r_count, out_d, out_i, Q, M,
        r_bstride, M, 0);
    return (int)cudaGetLastError();
  }
  const long long n = (long long)B * Q;
  nn1_kernel<SPLIT_QPT><<<race_grid<SPLIT_QPT>(B, Q, S), THREADS, 0, st>>>(
      q, r, mask, ls.q_list, ls.q_count, ls.r_list, ls.r_count, part_d, part_i, Q, M,
      r_bstride, L, n);
  return merge_one(part_d, part_i, out_d, out_i, n, S, st);
}

// nn1_masked's launches for B <= MAX_GRID_Y problems: whole (S = 1) or
// split with the merge.
template <RaceKind K>
int launch_masked(const float* q, const int* ring_a, const int* ia, const float* r,
                  const bool* mask, const int* ring, Lists ls, float* out_d, int* out_i,
                  float* part_d, int* part_i, int B, int Q, int M, int r_bstride, float span,
                  int S, int L, cudaStream_t st) {
  if (S == 1) {
    masked_kernel<K, WHOLE_QPT><<<race_grid<WHOLE_QPT>(B, Q, 1), THREADS, 0, st>>>(
        q, ring_a, ia, r, mask, ring, ls.q_list, ls.q_count, ls.r_list, ls.r_count, out_d,
        out_i, Q, M, r_bstride, span, M, 0);
    return (int)cudaGetLastError();
  }
  const long long n = (long long)B * Q;
  masked_kernel<K, SPLIT_QPT><<<race_grid<SPLIT_QPT>(B, Q, S), THREADS, 0, st>>>(
      q, ring_a, ia, r, mask, ring, ls.q_list, ls.q_count, ls.r_list, ls.r_count, part_d,
      part_i, Q, M, r_bstride, span, L, n);
  return merge_one(part_d, part_i, out_d, out_i, n, S, st);
}

// bc_races' launches for B <= MAX_GRID_Y problems: whole (S = 1) or split
// with the merge of both races.
int launch_bc_races(const float* q, const float* ra, const int* ia, const float* r,
                    const float* rn, const float* ring, Lists ls, float* out_db, int* out_ib,
                    float* out_dc, int* out_ic, float* part_d, int* part_i, int B, int Q,
                    int M, int r_bstride, float span, int S, int L, cudaStream_t st) {
  const long long n = (long long)B * Q;
  const dim3 grid((Q + THREADS - 1) / THREADS, B, S);
  if (S == 1) {
    bc_races_kernel<<<grid, THREADS, 0, st>>>(
        q, ra, ia, r, rn, ring, ls.q_list, ls.q_count, ls.r_list, ls.r_count, out_db, out_ib,
        out_dc, out_ic, Q, M, r_bstride, span, M, 0);
    return (int)cudaGetLastError();
  }
  const long long part_c = (long long)S * n;   // race C's partials follow race B's
  bc_races_kernel<<<grid, THREADS, 0, st>>>(
      q, ra, ia, r, rn, ring, ls.q_list, ls.q_count, ls.r_list, ls.r_count, part_d, part_i,
      part_d + part_c, part_i + part_c, Q, M, r_bstride, span, L, n);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  MinOut out = {{out_db, out_dc, nullptr, nullptr}, {out_ib, out_ic, nullptr, nullptr}};
  return launch_merge_min(part_d, part_i, out, n, S, 2, st);
}

}  // namespace

// C interface.  Pointers are device pointers of contiguous f32/i32 tensors:
// q [B,Q,3]; r [*,M,3]; rn, ring [*,M]; ra, ia and outputs [B,Q].
// r_bstride is the reference's batch stride in points (0 = shared).  Any
// B >= 1: more than MAX_GRID_Y problems are launched in slabs (over_slabs),
// a slab's pointers moved to its first problem; the split scratch is reused
// by each slab in turn.
// nn1, nn1_masked and bc_races take the walks' lists (null: no list, every
// slot walked): q_list [B,Q] and q_count [B], r_list [*,M] and r_count [*],
// i32, each list a stable partition of the slots with the valid ones first
// and its count the valid slots (ops/races.valid_list).  Block z of a split
// launch then scans the reference positions [z*L, min(n, (z+1)*L)), n the
// problem's count (M where it is 0 or M), and a query position at or past its
// count is answered (BIG, 0) without a scan.
// Each returns the cudaGetLastError() code of its launches (0 = launched).
extern "C" {

// Queries one block of a split nn1 / nn1_masked launch serves: the unit of
// the caller's split plan.  A launch with S == 1 serves WHOLE_QPT per thread.
int cooper_nn1_block_queries() { return THREADS * SPLIT_QPT; }

// Queries one block of an nn1 / nn1_masked launch with S == 1 serves.
int cooper_nn1_whole_block_queries() { return THREADS * WHOLE_QPT; }

// nn1 and nn1_masked read the reference as the caller holds it: r [*,M,3]
// f32, mask [*,M] bool (one byte), ring [*,M] i32, ring_a and ia [B,Q] i32.
// Block z scans [z*L, min(M, (z+1)*L)); the caller guarantees
// (S-1)*L < M <= S*L.  With S > 1, part_d / part_i [S,B,Q] take the chunks'
// results before merge_min joins them (unused, may be null, when S == 1).
int cooper_nn1(const float* q, const float* r, const bool* mask, const int* q_list,
               const int* q_count, const int* r_list, const int* r_count, float* out_d,
               int* out_i, float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
               int S, int L, void* stream) {
  const Lists ls = {q_list, q_count, r_list, r_count};
  return over_slabs(B, [&](int b0, int nb) {
    const long long qo = (long long)b0 * Q, ro = (long long)b0 * r_bstride;
    return launch_nn1(q + 3 * qo, r + 3 * ro, mask + ro, ls.from(b0, Q, r_bstride),
                      out_d + qo, out_i + qo, part_d, part_i, nb, Q, M, r_bstride, S, L,
                      (cudaStream_t)stream);
  });
}

int cooper_nn1_masked(const float* q, const int* ring_a, const int* ia, const float* r,
                      const bool* mask, const int* ring, const int* q_list,
                      const int* q_count, const int* r_list, const int* r_count, float* out_d,
                      int* out_i, float* part_d, int* part_i, int B, int Q, int M,
                      int r_bstride, int mode_same, float span, int S, int L, void* stream) {
  const auto launch = mode_same ? launch_masked<RACE_SAME> : launch_masked<RACE_ADJ>;
  const Lists ls = {q_list, q_count, r_list, r_count};
  return over_slabs(B, [&](int b0, int nb) {
    const long long qo = (long long)b0 * Q, ro = (long long)b0 * r_bstride;
    return launch(q + 3 * qo, ring_a + qo, ia + qo, r + 3 * ro, mask + ro, ring + ro,
                  ls.from(b0, Q, r_bstride), out_d + qo, out_i + qo, part_d, part_i, nb, Q, M,
                  r_bstride, span, S, L, (cudaStream_t)stream);
  });
}

// Queries one block of bc_races_kernel serves.
int cooper_bc_races_block_queries() { return THREADS; }

// Block z scans [z*L, min(M, (z+1)*L)); the caller guarantees
// (S-1)*L < M <= S*L.  With S > 1, part_d / part_i [2,S,B,Q] take the
// chunks' (B, C) results before merge_min joins them (unused, may be null,
// when S == 1).
int cooper_bc_races(const float* q, const float* ra, const int* ia,
                    const float* r, const float* rn, const float* ring, const int* q_list,
                    const int* q_count, const int* r_list, const int* r_count,
                    float* out_db, int* out_ib, float* out_dc, int* out_ic,
                    float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
                    float span, int S, int L, void* stream) {
  const Lists ls = {q_list, q_count, r_list, r_count};
  return over_slabs(B, [&](int b0, int nb) {
    const long long qo = (long long)b0 * Q, ro = (long long)b0 * r_bstride;
    return launch_bc_races(q + 3 * qo, ra + qo, ia + qo, r + 3 * ro, rn + ro, ring + ro,
                           ls.from(b0, Q, r_bstride), out_db + qo, out_ib + qo, out_dc + qo,
                           out_ic + qo, part_d, part_i, nb, Q, M, r_bstride, span, S, L,
                           (cudaStream_t)stream);
  });
}

// Threads per block of the fused kernel: a block serves THREADS / G * QPT
// queries (ops/races._fused_plan).
int cooper_fused_block_threads() { return THREADS; }

// The fused search reads the reference as the caller holds it: r [*,M,3]
// f32, mask [*,M] bool, ring [*,M] i32.  G lanes serve each query, QPT
// queries per thread: (1, 2) or (32, 1); another plan returns
// cudaErrorInvalidValue.  out_db / out_ib are unused (may be null) when
// with_same == 0.
int cooper_fused_races(const float* q, const float* r, const bool* mask, const int* ring,
                       float* out_da, int* out_ia, float* out_db, int* out_ib, float* out_dc,
                       int* out_ic, int B, int Q, int M, int r_bstride, int with_same,
                       float span, int G, int QPT, void* stream) {
  const auto launch = with_same ? launch_fused_plan<true> : launch_fused_plan<false>;
  return over_slabs(B, [&](int b0, int nb) {
    const long long qo = (long long)b0 * Q, ro = (long long)b0 * r_bstride;
    return launch(G, QPT, q + 3 * qo, r + 3 * ro, mask + ro, ring + ro, out_da + qo,
                  out_ia + qo, out_db ? out_db + qo : nullptr, out_ib ? out_ib + qo : nullptr,
                  out_dc + qo, out_ic + qo, nb, Q, M, r_bstride, span, (cudaStream_t)stream);
  });
}

// merge_min on its own: part_d / part_i [searches, S, n] -> out_d / out_i
// [searches, n], 1 <= searches <= 4.
int cooper_merge_min(const float* part_d, const int* part_i, float* out_d, int* out_i,
                     long long n, int S, int searches, void* stream) {
  if (searches < 1 || searches > 4 || S < 1) return (int)cudaErrorInvalidValue;
  MinOut out = {{out_d, out_d + n, out_d + 2 * n, out_d + 3 * n},
                {out_i, out_i + n, out_i + 2 * n, out_i + 3 * n}};
  return launch_merge_min(part_d, part_i, out, n, S, searches, (cudaStream_t)stream);
}

}  // extern "C"
