// Pieces shared by the search kernels of races.cu and knn.cu: the distance
// in the plain version's rounding, the sorted first-K insertion, and the
// merges that join the partial results of a search whose reference M is
// split across blocks.
//
// Why a split is exact.  Each search returns an order statistic of the pairs
// (q, j) in the lexicographic (d, j) order: the minimum (the races) or the
// first K (the k-NN).  The minimum, or first K, over a union of disjoint
// index ranges is the merge of the per-range results, taken in (d, j) order.
// So block z scans the chunk [z*L, min(M, (z+1)*L)) and writes its result to
// a scratch buffer [S, n] (or [S, n, K]), and a second kernel merges the S
// results of each query.  The chunk-order merge with the scan's strict "<"
// is one scan's result: chunks come in increasing index order and each
// chunk's list is ascending in (d, j), so every candidate the merge meets
// has a larger index than any listed entry of equal distance, and "<" keeps
// the smaller index.  merge_first_k needs no order: it keeps the K smallest
// 64-bit (d, j) keys of the chunks' finite entries, which is that list
// whatever the grouping, since no two keys are equal.  merge_min needs no
// order at all: it takes the lexicographic (d, z) minimum of the S pairs,
// with the scan's start (+inf, 0) as a chunk z = -1, and every chunk's index
// lies above every earlier chunk's, so a tie in d goes to the smaller index
// as in the chunk-order merge (and one scan), whatever the grouping.  A NaN
// distance never enters (a NaN compare is false), in the scan as in the
// merges.  Nothing depends on the order in which blocks finish.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SEARCH_THREADS = 128;   // threads per block of every search kernel

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (qn - 2*cross) + rn, cross = (qx*rx + qy*ry) + qz*rz: the plain version's
// operations in its order, never contracted into an FMA.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float qn,
                                         float4 r) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, r.x), __fmul_rn(qy, r.y)),
                                __fmul_rn(qz, r.z));
  return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), r.w);
}

// Put (d, j) into the ascending list (bd, bi) of K entries, dropping its last
// entry; the caller has checked d < bd[K-1].  The new entry goes before every
// entry it is strictly smaller than, so an equal distance stays behind the
// entry listed before it.  c[s] = d < bd[s] is monotone in s (the list is
// ascending and holds no NaN), so every slot is settled from the old list at
// once: no compare waits for another, unlike a bubble.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K], float d, int j) {
  bool c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) c[s] = d < bd[s];
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    bd[s] = c[s - 1] ? bd[s - 1] : (c[s] ? d : bd[s]);
    bi[s] = c[s - 1] ? bi[s - 1] : (c[s] ? j : bi[s]);
  }
  bd[0] = c[0] ? d : bd[0];
  bi[0] = c[0] ? j : bi[0];
}

// Problems per launch of a search kernel: grid y is the problem, and CUDA
// caps grid y at 65,535.  A batch of more problems is launched in slabs of
// at most this many, each with its pointers moved to its first problem
// (over_slabs), so a launch of B <= 65,535 problems is the same one launch.
constexpr int MAX_GRID_Y = 65535;

// launch(b0, nb) for each slab [b0, b0 + nb) of the B problems, in order;
// returns the first non-zero code, else 0.  Launches of one stream run in
// order, so a slab's scratch is free again for the next one.
template <typename Launch>
inline int over_slabs(int B, Launch launch) {
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int err = launch(b0, B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y);
    if (err) return err;
  }
  return 0;
}

// The chunk a block of a split search scans: [c0, c1).  S = 1 is the whole.
__device__ __forceinline__ void chunk_of_block(int M, int L, int& c0, int& c1) {
  c0 = blockIdx.z * L;
  c1 = min(M, c0 + L);
}

// ---------------------------------------------------------------------------
// 64-bit keys: (ordered bits of d) << 32 | j.  Unsigned order of the keys is
// the lexicographic (d, j) order, no two points' keys are equal, and NO_KEY
// (all ones) lies above every key of a finite d.  d is never -0 here: the
// distance's last operation adds |r|^2 >= +0.
// ---------------------------------------------------------------------------

using Key = unsigned long long;
constexpr Key NO_KEY = ~0ull;
constexpr unsigned FULL_WARP = 0xffffffffu;

// The float's bits as an unsigned that orders as the float does (negative
// values below positive ones), and back.
__device__ __forceinline__ unsigned ordered_bits(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ Key make_key(float d, int j) {
  return ((Key)ordered_bits(d) << 32) | (unsigned)j;
}

__host__ __device__ constexpr int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// log2 of a power of two.  The networks below step through their strides
// by a counter and 1 << counter, so that every loop fully unrolls and every
// register index is a constant (a loop that doubles its variable need not
// unroll, and its register arrays would go to local memory).
__host__ __device__ constexpr int log2_of(int p) {
  int l = 0;
  while ((1 << l) < p) ++l;
  return l;
}

// 4-byte asynchronous copies, global to a 32-bit shared address (sm_80 and
// later), and a 16-byte shared load from one.
__device__ __forceinline__ void cp_async4(unsigned smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ float4 lds128(unsigned smem) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(smem));
  return v;
}

// Put key c into the ascending list a of K keys, dropping its last; the
// caller has checked c < a[K-1].  Every slot is settled from the old list at
// once (c < a[s] is monotone in s), as in insert_sorted.
template <int K>
__device__ __forceinline__ void insert_key(Key (&a)[K], Key c) {
  bool lt[K];
#pragma unroll
  for (int s = 0; s < K; ++s) lt[s] = c < a[s];
#pragma unroll
  for (int s = K - 1; s > 0; --s) a[s] = lt[s - 1] ? a[s - 1] : (lt[s] ? c : a[s]);
  a[0] = lt[0] ? c : a[0];
}

// Sort the bitonic sequence c[0..P) ascending: the half-cleaners of a
// bitonic merge, P a power of two, every index a constant.
template <int P>
__device__ __forceinline__ void bitonic_clean(Key (&c)[P]) {
#pragma unroll
  for (int l = log2_of(P) - 1; l >= 0; --l) {
    const int s = 1 << l;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i & s) continue;
      const Key x = c[i], y = c[i + s];
      c[i] = y < x ? y : x;
      c[i + s] = y < x ? x : y;
    }
  }
}

// merge_first_k's shape: MERGE_K_W threads per query, MERGE_K_THREADS per
// block, chunks staged in rounds of up to MERGE_K_SMEM bytes (dynamic shared
// memory, sized to the chunks of a round).
constexpr int MERGE_K_W = 4, MERGE_K_THREADS = 64, MERGE_K_SMEM = 32768;

// a = the K smallest keys of the ascending lists a and lane (lane ^ off)'s
// a.  With both padded to P = pow2(K) by NO_KEY, c[i] = min(a[i], b[P-1-i])
// holds the P smallest of the 2P and is bitonic (a ascending against b
// descending); the half-cleaners sort it.  Positions where one side is
// padding take the other side without a compare.
template <int K>
__device__ __forceinline__ void merge_first(Key (&a)[K], int off) {
  constexpr int P = pow2_at_least(K);
  Key c[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int jb = P - 1 - i;
    const Key y = jb < K ? __shfl_xor_sync(FULL_WARP, a[jb], off) : NO_KEY;
    c[i] = i < K ? (jb < K && y < a[i] ? y : a[i]) : y;
  }
  bitonic_clean<P>(c);
#pragma unroll
  for (int s = 0; s < K; ++s) a[s] = c[s];
}

// Merge S first-K lists [S, n, K] into out [n, K], to what the chunk-order
// merge with strict "<" from (+inf, 0..K-1) gives.  A block serves QB =
// MERGE_K_THREADS / W consecutive queries, W threads each, all W in one
// warp (lane l of warp w: query w * 32/W + l % (32/W), thread l / (32/W)).
// The block stages R chunks at a time of its queries' lists into shared
// memory (R x QB x K values, each chunk's a contiguous run, every copy in
// flight at once), then each thread takes every W-th staged chunk and keeps
// the K smallest keys of its chunks' entries: its first chunk's list, sorted
// already, is its list, and each later one is inserted in order until an
// entry cannot enter (the lists are ascending; a NaN or +inf
// distance never enters, as in the scan, so a chunk's (+inf, slot) fillers
// never do).  The W threads of a query then merge their sorted lists
// pairwise by shuffles (merge_first), log2(W) rounds.  The K smallest keys
// of the union are the chunk-order merge's list: every chunk's indices lie
// above every earlier chunk's, so (d, j) order is the order of (d,
// arrival), whatever the grouping.  F < K finite entries end in (+inf, 0),
// (+inf, 1), ...: the merge's untouched start slots.
template <int K, int W>
__global__ void __launch_bounds__(MERGE_K_THREADS, 1)
merge_first_k(const float* __restrict__ pd, const int* __restrict__ pi,
              float* __restrict__ out_d, int* __restrict__ out_i, long long n, int S, int R) {
  constexpr int QW = 32 / W, QB = MERGE_K_THREADS / W;
  constexpr int ROW = QB * K;                // one chunk's lists of the block's queries
  extern __shared__ float4 merge_smem[];     // R x ROW distances, then R x ROW indices
  float* sd = reinterpret_cast<float*>(merge_smem);
  int* si = reinterpret_cast<int*>(sd + R * ROW);
  const int lane = threadIdx.x & 31;
  const int u = (threadIdx.x >> 5) * QW + lane % QW, p = lane / QW;
  const long long q0 = (long long)blockIdx.x * QB;
  const int nq = n - q0 < QB ? (int)(n - q0) : QB;
  const unsigned sd0 = (unsigned)__cvta_generic_to_shared(sd);
  const unsigned si0 = (unsigned)__cvta_generic_to_shared(si);
  Key key[K];
#pragma unroll
  for (int s = 0; s < K; ++s) key[s] = NO_KEY;
  bool first = true;
  // 16-byte copies where every staged run starts and ends on 16 bytes
  const bool wide = (n * K) % 4 == 0 && (nq * K) % 4 == 0 && ROW % 4 == 0 &&
                    (((unsigned long long)pd | (unsigned long long)pi) & 15) == 0;
  for (int z0 = 0; z0 < S; z0 += R) {
    const int nz = S - z0 < R ? S - z0 : R;
    if (wide) {
      for (int e = 4 * threadIdx.x; e < nz * ROW; e += 4 * MERGE_K_THREADS) {
        const int zz = e / ROW, off = e - zz * ROW;
        if (off < nq * K) {
          const long long g = ((long long)(z0 + zz) * n + q0) * K + off;
          cp_async16(sd0 + 4 * e, pd + g);
          cp_async16(si0 + 4 * e, pi + g);
        }
      }
    } else {
      for (int e = threadIdx.x; e < nz * ROW; e += MERGE_K_THREADS) {
        const int zz = e / ROW, off = e - zz * ROW;
        if (off < nq * K) {
          const long long g = ((long long)(z0 + zz) * n + q0) * K + off;
          cp_async4(sd0 + 4 * e, pd + g);
          cp_async4(si0 + 4 * e, pi + g);
        }
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (u < nq) {
      for (int zz = p; zz < nz; zz += W) {
        const float* d = sd + zz * ROW + u * K;
        const int* j = si + zz * ROW + u * K;
        if (first) {                           // sorted already: the thread's list
          bool live = true;
#pragma unroll
          for (int s = 0; s < K; ++s) {
            live = live && d[s] < INFINITY;
            key[s] = live ? make_key(d[s], j[s]) : NO_KEY;
          }
          first = false;
          continue;
        }
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const float ds = d[s];
          if (!(ds < INFINITY)) break;
          const Key c = make_key(ds, j[s]);
          if (!(c < key[K - 1])) break;
          insert_key<K>(key, c);
        }
      }
    }
    __syncthreads();   // the staged chunks are free for the next round
  }
#pragma unroll
  for (int m = 0; m < log2_of(W); ++m) merge_first<K>(key, QW << m);
  if (p != 0 || u >= nq) return;
  const long long t = q0 + u;
  int F = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) F += key[s] != NO_KEY;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool in = key[s] != NO_KEY;
    out_d[t * K + s] = in ? from_ordered_bits((unsigned)(key[s] >> 32)) : INFINITY;
    out_i[t * K + s] = in ? (int)(unsigned)key[s] : s - F;
  }
}

template <int K>
int launch_merge_first_k(const float* pd, const int* pi, float* out_d, int* out_i, long long n,
                         int S, cudaStream_t st) {
  constexpr int QB = MERGE_K_THREADS / MERGE_K_W;   // queries per block
  constexpr int ROW = QB * K;
  constexpr int RMAX = MERGE_K_SMEM / (8 * ROW) > 0 ? MERGE_K_SMEM / (8 * ROW) : 1;
  const int R = S < RMAX ? S : RMAX;
  const unsigned blocks = (unsigned)((n + QB - 1) / QB);
  merge_first_k<K, MERGE_K_W><<<blocks, MERGE_K_THREADS, 8 * R * ROW, st>>>(
      pd, pi, out_d, out_i, n, S, R);
  return (int)cudaGetLastError();
}

// Up to four minimum searches merged in one launch (blockIdx.y = search).
struct MinOut {
  float* d[4];
  int* i[4];
};

// Merge S (min, argmin) pairs per query, [searches, S, n] -> out[search] [n],
// to what the chunk-order merge with strict "<" from (+inf, 0) gives.  A
// block serves QB consecutive queries with WARPS warps: lane l of a warp
// takes query l % QB, so the lanes of one chunk read QB consecutive values
// (QB = 8: one 32-byte sector), and each of the W = WARPS * 32 / QB threads
// of a query takes every W-th chunk, with its loads in flight together.
// Each thread keeps the first (d, z) minimum of its chunks; the threads of a
// query then combine by the lexicographic (d, z) minimum, by shuffles inside
// the warp and through shared memory across warps.  No chain of S dependent
// steps: ceil(S / W) loads per thread, then log2(32 / QB) shuffles.
template <int QB, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
merge_min(const float* __restrict__ pd, const int* __restrict__ pi, MinOut out,
          long long n, int S) {
  constexpr int PER_WARP = 32 / QB;          // threads of one query in a warp
  constexpr int W = PER_WARP * WARPS;        // threads of one query
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = (long long)blockIdx.x * QB + lane % QB;
  const long long o = (long long)blockIdx.y * S * n + t;
  float best = INFINITY;
  int bz = -1, bidx = 0;                     // the scan's start, before chunk 0
  if (t < n) {
#pragma unroll 4
    for (int z = warp * PER_WARP + lane / QB; z < S; z += W) {
      const float d = pd[o + (long long)z * n];
      const int j = pi[o + (long long)z * n];
      if (d < best) { best = d; bz = z; bidx = j; }   // z ascends: a tie keeps the first
    }
  }
#pragma unroll
  for (int off = QB; off < 32; off *= 2) {
    const float od = __shfl_xor_sync(0xffffffffu, best, off);
    const int oz = __shfl_xor_sync(0xffffffffu, bz, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (od < best || (od == best && oz < bz)) { best = od; bz = oz; bidx = oi; }
  }
  if (WARPS > 1) {
    __shared__ float sd[WARPS][QB];
    __shared__ int sz[WARPS][QB], si[WARPS][QB];
    if (lane < QB) { sd[warp][lane] = best; sz[warp][lane] = bz; si[warp][lane] = bidx; }
    __syncthreads();
    if (warp == 0 && lane < QB) {
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        const float od = sd[w][lane];
        const int oz = sz[w][lane];
        if (od < best || (od == best && oz < bz)) { best = od; bz = oz; bidx = si[w][lane]; }
      }
    }
  }
  if (warp != 0 || lane >= QB || t >= n) return;
  // the search's outputs, picked with constant indices (a dynamic index
  // into the kernel's parameters would copy them to local memory)
  float* od = out.d[0];
  int* oi = out.i[0];
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    if (blockIdx.y == s) { od = out.d[s]; oi = out.i[s]; }
  }
  od[t] = best;
  oi[t] = bidx;
}

// The merge's shape: 8 queries per block (a full 32-byte sector per load), 16
// threads per query in 4 warps.  8 x 16 beat 32 x 4 (a warp per chunk
// stride) and a warp per query at S = 32-66 (time_search_kernels.py, PERF.md).
constexpr int MERGE_QB = 8, MERGE_WARPS = 4;

// Launch merge_min for `searches` searches; returns the launch's
// cudaGetLastError() code.
inline int launch_merge_min(const float* pd, const int* pi, MinOut out, long long n, int S,
                            int searches, cudaStream_t st) {
  const dim3 grid((unsigned)((n + MERGE_QB - 1) / MERGE_QB), searches);
  merge_min<MERGE_QB, MERGE_WARPS><<<grid, 32 * MERGE_WARPS, 0, st>>>(pd, pi, out, n, S);
  return (int)cudaGetLastError();
}

}  // namespace
