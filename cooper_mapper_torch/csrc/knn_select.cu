// The k-NN's select routes, for k above the register lists' largest
// (KNN_REG_MAX_K, knn_lists.cuh), hand-written for Hopper (sm_90a) and
// built beside knn.cu by cooper_mapper_torch/build.py.  What the k-NN
// computes, its order, ties, rounding and NaN rule: knn.cu.
//
// knn_select_kernel and knn_select_kernel_pass2: lanes' own lists, checked,
// and a warp select (Johnson, Douze and Jegou, "Billion-scale similarity
// search with GPUs", 2017, section 4) for the queries where the check fails.
// A list of k entries per query does not fit in one thread's registers; the
// lanes of a warp hold one between them.
// * What bounds it.  Per (query, point) pair: the 8 FP32 operations of d and
//   one compare against a threshold, as the register lists.  A block per
//   query that re-reads and re-computes the whole reference in each of up to
//   8 radix passes (knn_radix_kernel) took 28-39x that bound at the
//   scan-to-map shape (PERF.md).
// * knn_select_kernel<L>: a warp per query, QB queries of one problem per
//   block (QB <= SEL_MAX_QB, from B, Q and the SM count:
//   ops/races._select_plan).  The block streams the reference through
//   shared memory in tiles of SEL_TILE points, double-buffered with
//   cp.async, as float4 (x, y, z, |r|^2), read back from a 32-bit shared
//   address; lane l takes points l, l + 32, ....  So a point is read from L2
//   once per block, not once per query per radix pass.  Each lane keeps the
//   L smallest (d, j) of its own points in registers (L = 4 N up to
//   SEL_MAX_LOCAL: four times its mean share of the list), a float compare
//   against its L-th distance per point and no exchange between lanes.
//   Then the warp sorts the union of the lanes' lists (bitonic, striped:
//   element e in register e / 32 of lane e % 32, every register index a
//   constant) and takes its k-th key tau.  A lane drops only keys above its
//   list's last, so where no lane's full list ends at or under tau, the
//   union holds every key at or under tau and its first k are the answer:
//   the nearest points of a query spread over the lanes, and a spatial
//   order spreads them evenly.  Its registers bound the first pass at up to
//   64 per thread at L = 8 (4 blocks of 8 warps per SM).
// * knn_select_kernel_pass2<N>, a second launch whose warps leave at once
//   where pass 1 wrote the list (a kernel of its own, so that its registers
//   do not lower pass 1's occupancy): the warp select over the points at or
//   under tau's distance, read by the warp alone from device memory.  The
//   warp's list: its P = 32 N smallest keys so far (P = k rounded up to a
//   power of two, 64 to SEL_MAX_K), ascending, striped over the lanes'
//   registers.  Each lane has a queue of T keys; a point whose key is below
//   the list's k-th key goes to its lane's queue (a float compare against
//   the k-th distance first, the key compare only where it passes).  When a
//   queue may overflow the warp merges: a bitonic sort of the 32 T queued
//   keys (shuffles across lanes, compare-exchanges across a lane's
//   registers), then the P smallest of list and queue (the list against the
//   reversed queue), bitonic, sorted by the half-cleaners; then the new k-th
//   key is broadcast.  Every key below the k-th at the time it is met is
//   kept, and a key at or above it cannot be among the k smallest: the
//   list's first k are exact.  SEL_UNROLL points per lane between two votes
//   of the warp; a queue that holds more than T - SEL_UNROLL keys is merged
//   first, so none overflows.  Where k > 32 L, pass 2 alone runs, unbounded.
// * Instances: pass 1 at L = 8, 16; pass 2 at N = 2, 4, 8, 16, 32 keys per
//   lane, T = SEL_QUEUE.
//
// knn_radix_kernel: k above SEL_MAX_K, up to M, which no path of the port
// or of the JAX package uses.  A block per query: a radix select (8 bits
// per pass, the most significant first) finds the k-th smallest key: each
// pass counts, in a 256-bin shared histogram, the digits of the points
// whose higher digits equal the prefix found so far, and stops as soon as
// the chosen bin holds exactly the entries still wanted.  Then every point
// whose key is at or under the prefix (exactly k points) is gathered, the k
// keys are sorted (bitonic, in shared memory up to RADIX_SMEM_KEYS keys,
// else in a scratch row of device memory), and the output is written in
// order, each distance recomputed from its index by the same operations.
// No point is read from shared memory: a pass re-reads the reference from
// the L1 / L2 caches and recomputes d rather than keeping M keys per query.

#include <float.h>

#include "split.cuh"

namespace {

// ---------------------------------------------------------------------------
// knn_select_kernel: KNN_REG_MAX_K < k <= SEL_MAX_K, a warp per query
// ---------------------------------------------------------------------------

constexpr int SEL_MAX_QB = 8;       // queries (warps) per block, at most
constexpr int SEL_TILE = 512;       // reference points per shared-memory tile (16 per lane)
constexpr int SEL_MIN_KEYS = 64;    // the shortest list: 2 keys per lane
constexpr int SEL_MAX_K = 1024;     // the longest list: 32 keys per lane
constexpr int SEL_QUEUE = 8;        // queue slots per lane
constexpr int SEL_UNROLL = 4;       // pass 2's points per lane between two votes of the warp
constexpr int SEL_MAX_LOCAL = 16;   // keys of a lane's own list, at most

// keys of a lane's own list beside N keys per lane in the warp select's:
// four times a lane's mean share of the k-NN list, up to SEL_MAX_LOCAL
constexpr int sel_local(int N) { return 4 * N < SEL_MAX_LOCAL ? 4 * N : SEL_MAX_LOCAL; }

// Compare-exchange of two registers of a lane: (min, max) if up, else (max, min).
__device__ __forceinline__ void ce_regs(Key& x, Key& y, bool up) {
  const bool swap = up ? y < x : x < y;
  const Key a = swap ? y : x, b = swap ? x : y;
  x = a;
  y = b;
}

// Compare-exchange across the lanes `stride` apart: the smaller of v and the
// partner's value where keep_min, else the larger.
__device__ __forceinline__ Key ce_lanes(Key v, int stride, bool keep_min) {
  const Key o = __shfl_xor_sync(FULL_WARP, v, stride);
  return (keep_min ? o < v : v < o) ? o : v;
}

// Sort the warp's 32 T keys a (striped: element e = 32 i + lane in a[i])
// ascending: a bitonic sort.
template <int T>
__device__ __forceinline__ void warp_sort(Key (&a)[T], int lane) {
#pragma unroll
  for (int ls = 1; ls <= log2_of(32 * T); ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        if (stride >= 32) {
          const int rs = stride >> 5;
          if (!(i & rs)) ce_regs(a[i], a[i + rs], ((i << 5) & size) == 0);
        } else {
          const bool up = (((i << 5) | lane) & size) == 0;
          a[i] = ce_lanes(a[i], stride, up == ((lane & stride) == 0));
        }
      }
    }
  }
}

// Sort the warp's bitonic sequence of 32 N keys (striped) ascending: the
// half-cleaners.
template <int N>
__device__ __forceinline__ void warp_clean(Key (&a)[N], int lane) {
#pragma unroll
  for (int l = log2_of(16 * N); l >= 0; --l) {
    const int stride = 1 << l;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (stride >= 32) {
        const int rs = stride >> 5;
        if (!(i & rs)) ce_regs(a[i], a[i + rs], true);
      } else {
        a[i] = ce_lanes(a[i], stride, (lane & stride) == 0);
      }
    }
  }
}

// list = the P = 32 N smallest keys of list and queue; the queue emptied.
// With the queue sorted, list[e] = min(list[e], queue'[P-1-e]) (queue'
// the queue's first P keys, padded to P by NO_KEY where it holds fewer)
// holds the P smallest and is bitonic; only the last 32 T entries of the
// list meet a queued key: element P-1-e of the queue, for e = 32 i + lane,
// is register N-1-i of lane 31-lane.
template <int N, int T>
__device__ __forceinline__ void warp_merge(Key (&list)[N], Key (&queue)[T], int lane) {
  warp_sort<T>(queue, lane);
#pragma unroll
  for (int i = N > T ? N - T : 0; i < N; ++i) {
    const Key o = __shfl_xor_sync(FULL_WARP, queue[N - 1 - i], 31);
    list[i] = o < list[i] ? o : list[i];
  }
  warp_clean<N>(list, lane);
#pragma unroll
  for (int i = 0; i < T; ++i) queue[i] = NO_KEY;
}

// The list's k-th key (element k-1), in every lane.  Each register passes
// through an opaque move before the select, so that the compiler cannot
// fold the selects into one load at a computed index (which would move the
// list to local memory).
template <int N>
__device__ __forceinline__ Key kth_key(const Key (&list)[N], int k) {
  const int e = k - 1;
  Key v = NO_KEY;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    Key x;
    asm("mov.b64 %0, %1;" : "=l"(x) : "l"(list[i]));
    v = i == (e >> 5) ? x : v;
  }
  return __shfl_sync(FULL_WARP, v, e & 31);
}

// The warp's state: its list, its lanes' queues, and the key a point must be
// below to be queued (the list's k-th) with that key's distance, or, while
// the list holds fewer than k keys, no key and the bound's distance.
template <int N, int T>
struct WarpSelect {
  Key list[N], queue[T];
  int queued;
  float bound, thr_d;
  Key thr;

  __device__ __forceinline__ void start(float b) {
#pragma unroll
    for (int i = 0; i < N; ++i) list[i] = NO_KEY;
#pragma unroll
    for (int i = 0; i < T; ++i) queue[i] = NO_KEY;
    queued = 0;
    bound = b;
    thr = NO_KEY;
    thr_d = b;
  }

  // point j at distance d: into this lane's queue if its key is below thr
  __device__ __forceinline__ void offer(float d, int j) {
    if (d <= thr_d) {
      const Key c = make_key(d, j);
      if (c < thr) {
#pragma unroll
        for (int i = T - 1; i > 0; --i) queue[i] = queue[i - 1];
        queue[0] = c;
        ++queued;
      }
    }
  }

  // merge the queues into the list, warp-wide, where one holds more than
  // `room` keys
  __device__ __forceinline__ void settle(int room, int k, int lane) {
    if (!__any_sync(FULL_WARP, queued > room)) return;
    warp_merge<N, T>(list, queue, lane);
    queued = 0;
    thr = kth_key<N>(list, k);
    thr_d = thr == NO_KEY ? bound : from_ordered_bits((unsigned)(thr >> 32));
  }
};

// Tile `it` of the reference into the buffer at shared address `dst`, as
// float4 (x, y, z, |r|^2).
__device__ __forceinline__ void load_tile(unsigned dst, const float* r, const float* rn, int M,
                                          int it) {
  const int j0 = it * SEL_TILE, n = min(SEL_TILE, M - j0);
  for (int e = threadIdx.x; e < 4 * n; e += blockDim.x) {
    if (e < 3 * n) {
      const int p = e / 3;
      cp_async4(dst + 16 * p + 4 * (e - 3 * p), r + 3 * (long long)j0 + e);
    } else {
      const int p = e - 3 * n;
      cp_async4(dst + 16 * p + 12, rn + j0 + p);
    }
  }
}

// Write the first k keys of the warp's striped ascending list as query t's
// output: a listed key as (d, j), the slots past the F listed ones as
// (+inf, slot - F), the register lists' untouched slots.
template <int NN>
__device__ __forceinline__ void write_list(const Key (&list)[NN], int k, int lane, long long t,
                                           float* __restrict__ out_d, int* __restrict__ out_i) {
  int F = 0;
#pragma unroll
  for (int i = 0; i < NN; ++i) F += __popc(__ballot_sync(FULL_WARP, list[i] != NO_KEY));
  const long long o = t * k;
#pragma unroll
  for (int i = 0; i < NN; ++i) {
    const int e = (i << 5) | lane;
    if (e < k) {
      const bool in = list[i] != NO_KEY;
      out_d[o + e] = in ? from_ordered_bits((unsigned)(list[i] >> 32)) : INFINITY;
      out_i[o + e] = in ? (int)(unsigned)list[i] : e - F;
    }
  }
}

// The query of warp w of block (x, b): x * QB + w of problem b (QB =
// blockDim.x / 32), and whether there is one.
__device__ __forceinline__ bool warp_query(int Q, long long& t) {
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  t = (long long)blockIdx.y * Q + (qi < Q ? qi : 0);
  return qi < Q;
}

// Pass 1, where the lanes' own lists can hold k keys (k <= 32 L), a warp per
// query, QB queries of one problem per block.  Each lane keeps the L
// smallest keys of its points (l, l + 32, ...), with no exchange between
// lanes; the block streams the reference through shared memory in
// double-buffered tiles.  The warp then sorts the union of the lanes' lists;
// tau is its k-th key.  A lane dropped only keys above its list's last, so
// a lane whose list is not full, or ends above tau, dropped none at or
// under tau; where every lane is
// such, the union holds every key at or under tau, its first k are the
// answer, and tau_out[t] = 0 (never a key: its distance bits would be a
// NaN's).  Otherwise tau_out[t] = tau, which bounds the k-th key (the union
// holds k keys at or under it), for pass 2.
template <int L>
__global__ void __launch_bounds__(32 * SEL_MAX_QB, L <= 8 ? 4 : 1)
knn_select_kernel(const float* __restrict__ q, const float* __restrict__ r,
                  const float* __restrict__ rn, float* __restrict__ out_d,
                  int* __restrict__ out_i, Key* __restrict__ tau_out, int Q, int M,
                  long long r_bstride, int k) {
  __shared__ float4 tile[2][SEL_TILE];
  const int lane = threadIdx.x & 31;
  long long t;
  const bool active = warp_query(Q, t);        // warp-uniform
  const float qx = q[3 * t], qy = q[3 * t + 1], qz = q[3 * t + 2];
  const float qn = sq_norm(qx, qy, qz);
  r += blockIdx.y * r_bstride * 3;
  rn += blockIdx.y * r_bstride;
  // the tiles' 32-bit shared addresses, once (a generic address would be
  // converted again inside the loops)
  const unsigned tile0 = (unsigned)__cvta_generic_to_shared(&tile[0][0]);
  const int tiles = (M + SEL_TILE - 1) / SEL_TILE;

  // (distance, index) lists: a lane meets its points in index order, so the
  // strict "<" of insert_sorted keeps (d, j) order
  float ld[L];
  int li[L];
#pragma unroll
  for (int i = 0; i < L; ++i) { ld[i] = INFINITY; li[i] = 0; }
  for (int it = -1; it < tiles; ++it) {
    if (it + 1 < tiles) load_tile(tile0 + ((it + 1) & 1) * SEL_TILE * 16, r, rn, M, it + 1);
    cp_async_commit();
    if (it < 0) continue;
    cp_async_wait_all_but_one();
    __syncthreads();
    if (active) {
      const int j0 = it * SEL_TILE, n = min(SEL_TILE, M - j0);
      const unsigned tl = tile0 + (it & 1) * SEL_TILE * 16;
#pragma unroll 4
      for (int p = lane; p < n; p += 32) {
        const float d = sq_dist(qx, qy, qz, qn, lds128(tl + 16 * p));
        if (d < ld[L - 1]) insert_sorted<L>(ld, li, d, j0 + p);   // no NaN or +inf
      }
    }
    __syncthreads();   // the buffer is free again for the load of tile it + 2
  }
  if (!active) return;
  Key local[L];
#pragma unroll
  for (int i = 0; i < L; ++i) local[i] = ld[i] < INFINITY ? make_key(ld[i], li[i]) : NO_KEY;
  const Key last = local[L - 1];
  warp_sort<L>(local, lane);
  const Key tau = kth_key<L>(local, k);
  const bool exact = __all_sync(FULL_WARP, last == NO_KEY || last > tau);
  if (exact) write_list<L>(local, k, lane, t, out_d, out_i);
  if (lane == 0) tau_out[t] = exact ? 0ull : tau;
}

// Pass 2, for the queries that pass 1 left (tau_in[t] != 0; every query
// where tau_in is null): the warp select over the points at or under tau's
// distance (the largest finite float where there is none: d <= it lets no
// NaN or +inf through), a warp per query, each reading the reference from
// device memory on its own.  SEL_UNROLL points per lane between two votes;
// a queue of more than T - SEL_UNROLL keys is merged first, so none
// overflows.
template <int N>
__global__ void __launch_bounds__(32 * SEL_MAX_QB, 1)
knn_select_kernel_pass2(const float* __restrict__ q, const float* __restrict__ r,
                        const float* __restrict__ rn, float* __restrict__ out_d,
                        int* __restrict__ out_i, const Key* __restrict__ tau_in, int Q, int M,
                        long long r_bstride, int k) {
  const int lane = threadIdx.x & 31;
  long long t;
  if (!warp_query(Q, t)) return;
  const Key tau = tau_in ? tau_in[t] : NO_KEY;
  if (tau == 0ull) return;                     // pass 1 wrote the list
  const float qx = q[3 * t], qy = q[3 * t + 1], qz = q[3 * t + 2];
  const float qn = sq_norm(qx, qy, qz);
  r += blockIdx.y * r_bstride * 3;
  rn += blockIdx.y * r_bstride;
  constexpr int T = SEL_QUEUE;
  WarpSelect<N, T> ws;
  ws.start(tau == NO_KEY ? FLT_MAX : from_ordered_bits((unsigned)(tau >> 32)));
  for (int base = 0; base < M; base += 32 * SEL_UNROLL) {
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u) {
      const int j = base + 32 * u + lane;
      if (j < M)
        ws.offer(sq_dist(qx, qy, qz, qn, make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], rn[j])),
                 j);
    }
    ws.settle(T - SEL_UNROLL, k, lane);
  }
  ws.settle(0, k, lane);
  write_list<N>(ws.list, k, lane, t, out_d, out_i);
}

// Pass 1 where k <= 32 L (tau [B*Q] its scratch), then pass 2 (which exits
// at once for the queries pass 1 answered), over slabs of the B problems.
template <int N>
int launch_select(const float* q, const float* r, const float* rn, float* out_d, int* out_i,
                  Key* tau, int B, int Q, int M, int r_bstride, int k, int qb,
                  cudaStream_t st) {
  constexpr int L = sel_local(N);
  const bool first = k <= 32 * L;
  return over_slabs(B, [&](int b0, int nb) {
    const long long qo = (long long)b0 * Q, ro = (long long)b0 * r_bstride;
    const dim3 grid((unsigned)((Q + qb - 1) / qb), nb);
    if (first) {
      knn_select_kernel<L><<<grid, 32 * qb, 0, st>>>(
          q + 3 * qo, r + 3 * ro, rn + ro, out_d + qo * k, out_i + qo * k, tau + qo, Q, M,
          r_bstride, k);
      const int err = (int)cudaGetLastError();
      if (err) return err;
    }
    knn_select_kernel_pass2<N><<<grid, 32 * qb, 0, st>>>(
        q + 3 * qo, r + 3 * ro, rn + ro, out_d + qo * k, out_i + qo * k,
        first ? tau + qo : nullptr, Q, M, r_bstride, k);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// knn_radix_kernel: SEL_MAX_K < k <= M
// ---------------------------------------------------------------------------

constexpr int RADIX_THREADS = 256;
constexpr int RADIX_BINS = 256;          // 8 bits of the key per pass
constexpr int RADIX_SMEM_KEYS = 4096;    // sorted in shared memory up to this many keys

// Sort n (a power of two) keys ascending, all threads of the block; a may be
// shared or device memory (__syncthreads orders both within a block).
__device__ void bitonic_sort(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n / 2; i += RADIX_THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = a[lo], y = a[hi];
        if ((x > y) == ((lo & size) == 0)) { a[lo] = y; a[hi] = x; }
      }
    }
  }
  __syncthreads();
}

// Block t - t0 serves query t of the flattened [B, Q]: its first k points in
// (d, j) order.  P: k rounded up to a power of two; with P > RADIX_SMEM_KEYS
// the keys are sorted in scratch [gridDim.x, P].
__global__ void __launch_bounds__(RADIX_THREADS)
knn_radix_kernel(const float* __restrict__ q, const float* __restrict__ r,
                 const float* __restrict__ rn, float* __restrict__ out_d,
                 int* __restrict__ out_i, unsigned long long* __restrict__ scratch, int Q,
                 int M, long long r_bstride, int k, int P, long long t0) {
  __shared__ unsigned hist[RADIX_BINS];
  __shared__ unsigned long long skeys[RADIX_SMEM_KEYS];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_want, s_done, s_count;
  const long long t = t0 + blockIdx.x;
  const long long b = t / Q;
  const float qx = q[3 * t], qy = q[3 * t + 1], qz = q[3 * t + 2];
  const float qn = sq_norm(qx, qy, qz);
  r += b * r_bstride * 3;
  rn += b * r_bstride;
  const int lane = threadIdx.x & 31;
  const auto key_of = [&](int j, bool& in) -> unsigned long long {
    const float d = sq_dist(qx, qy, qz, qn, make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2],
                                                        rn[j]));
    in = d < INFINITY;   // NaN and +inf stay out, as in the register lists
    return ((unsigned long long)ordered_bits(d) << 32) | (unsigned)j;
  };

  // the radix select: shift = the bits below the current digit
  unsigned long long prefix = 0;   // the digits above `shift` chosen so far
  int shift = 64;
  int want = 0;                    // rank still wanted among keys with the prefix
  for (int pass = 0; pass < 8; ++pass) {
    const int s = shift - 8;
    for (int i = threadIdx.x; i < RADIX_BINS; i += RADIX_THREADS) hist[i] = 0u;
    __syncthreads();
    for (int base = 0; base < M; base += RADIX_THREADS) {
      const int j = base + threadIdx.x;
      int bin = -1;
      if (j < M) {
        bool in;
        const unsigned long long key = key_of(j, in);
        if (in && (shift == 64 || (key >> shift) == prefix)) bin = (int)((key >> s) & 255u);
      }
      // one atomic per distinct bin of the warp
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds bins 8l..8l+7; an inclusive scan of the lanes' sums
      unsigned c[8], sum = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) { c[u] = hist[8 * lane + u]; sum += c[u]; }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const unsigned total = __shfl_sync(0xffffffffu, incl, 31);
      int w = want;
      if (pass == 0) w = (int)min((unsigned)k, total);   // F = total points in
      const unsigned excl = incl - sum;
      // the lane whose bins reach rank w: excl < w <= incl
      const bool here = w > 0 && excl < (unsigned)w && (unsigned)w <= incl;
      if (here) {
        unsigned below = excl;
        int digit = 8 * lane;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (below + c[u] >= (unsigned)w) { digit = 8 * lane + u; break; }
          below += c[u];
        }
        const int rest = w - (int)below;
        s_prefix = (prefix << 8) | (unsigned)digit;
        s_want = rest;
        s_done = (int)hist[digit] == rest;
      }
      if (lane == 0 && w == 0) { s_want = 0; s_done = 1; }   // nothing to select
    }
    __syncthreads();
    prefix = s_prefix;
    want = s_want;
    shift = s;
    if (s_done) break;
    __syncthreads();   // every thread has read s_* before the next pass writes them
  }
  // kk keys are at or under the prefix: kk = min(k, F)
  const bool any = want > 0;
  unsigned long long* keys = P <= RADIX_SMEM_KEYS ? skeys : scratch + (long long)blockIdx.x * P;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  if (any) {
    for (int j = threadIdx.x; j < M; j += RADIX_THREADS) {
      bool in;
      const unsigned long long key = key_of(j, in);
      if (in && (key >> shift) <= prefix) keys[atomicAdd(&s_count, 1)] = key;
    }
  }
  __syncthreads();
  const int kk = s_count;
  for (int i = kk + threadIdx.x; i < P; i += RADIX_THREADS) keys[i] = ~0ull;
  bitonic_sort(keys, P);
  const long long o = t * k;
  for (int p = threadIdx.x; p < k; p += RADIX_THREADS) {
    if (p < kk) {
      const int j = (int)(keys[p] & 0xffffffffu);
      out_i[o + p] = j;
      out_d[o + p] = sq_dist(qx, qy, qz, qn,
                             make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], rn[j]));
    } else {
      out_i[o + p] = p - kk;   // the register lists' untouched slots
      out_d[o + p] = INFINITY;
    }
  }
}

}  // namespace

// C interface: the pointers, shapes and return codes of knn.cu's.
extern "C" {

// The largest k of the warp select; above it cooper_knn_select takes the
// radix select.
int cooper_knn_select_warp_max_k() { return SEL_MAX_K; }

// Keys each query's sort needs on the radix route: k rounded up to a power
// of two.  When it is above cooper_knn_select_smem_keys(), the caller passes
// a scratch of [rows, keys] 64-bit words, and the queries are launched rows
// at a time.
int cooper_knn_select_keys(int k) { return pow2_at_least(k); }
int cooper_knn_select_smem_keys() { return RADIX_SMEM_KEYS; }

// The select routes (any 1 <= k <= M is served): up to
// cooper_knn_select_warp_max_k(), the lanes' lists and the warp select, qb
// queries per block (1 <= qb <= 8), with scratch [B*Q] u64; above, the radix
// select, with scratch [rows, cooper_knn_select_keys(k)] u64 when the keys
// exceed shared memory (unused, may be null, otherwise; rows >= 1).
int cooper_knn_select(const float* q, const float* r, const float* rn, float* out_d,
                      int* out_i, void* scratch, int B, int Q, int M, int r_bstride, int k,
                      long long rows, int qb, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > M) return (int)cudaErrorInvalidValue;
  if (k <= SEL_MAX_K) {
    if (qb < 1 || qb > SEL_MAX_QB || !scratch) return (int)cudaErrorInvalidValue;
    Key* tau = (Key*)scratch;
    const int P = k < SEL_MIN_KEYS ? SEL_MIN_KEYS : pow2_at_least(k);
    switch (P / 32) {
      case 2: return launch_select<2>(q, r, rn, out_d, out_i, tau, B, Q, M, r_bstride, k, qb, st);
      case 4: return launch_select<4>(q, r, rn, out_d, out_i, tau, B, Q, M, r_bstride, k, qb, st);
      case 8: return launch_select<8>(q, r, rn, out_d, out_i, tau, B, Q, M, r_bstride, k, qb, st);
      case 16:
        return launch_select<16>(q, r, rn, out_d, out_i, tau, B, Q, M, r_bstride, k, qb, st);
      default:
        return launch_select<32>(q, r, rn, out_d, out_i, tau, B, Q, M, r_bstride, k, qb, st);
    }
  }
  const int P = pow2_at_least(k);
  const long long n = (long long)B * Q;
  const long long step = P <= RADIX_SMEM_KEYS ? (long long)1 << 30 : rows;
  if (step < 1) return (int)cudaErrorInvalidValue;
  for (long long t0 = 0; t0 < n; t0 += step) {
    const long long nb = n - t0 < step ? n - t0 : step;
    knn_radix_kernel<<<(unsigned)nb, RADIX_THREADS, 0, st>>>(
        q, r, rn, out_d, out_i, (unsigned long long*)scratch, Q, M, r_bstride, k, P, t0);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
