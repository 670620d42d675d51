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
// results of each query.  merge_first_k takes the chunks in order with the
// scan's strict "<": chunks come in increasing index order and each chunk's
// list is ascending in (d, j), so every candidate the merge meets has a
// larger index than any listed entry of equal distance, and "<" keeps the
// smaller index, exactly as one scan over all of M does.  merge_min needs no
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

// Merge S first-K lists [S, n, K] into out [n, K]: one thread per query,
// chunks in order, from (+inf, 0..K-1) as the scan starts.
template <int K>
__global__ void __launch_bounds__(SEARCH_THREADS)
merge_first_k(const float* __restrict__ pd, const int* __restrict__ pi,
              float* __restrict__ out_d, int* __restrict__ out_i, long long n, int S) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { bd[s] = INFINITY; bi[s] = s; }
  // unrolled so that several chunks' loads are in flight at once
#pragma unroll 4
  for (int z = 0; z < S; ++z) {
    const long long o = ((long long)z * n + t) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float d = pd[o + s];
      // the list is ascending: once an entry cannot enter, none after it can
      if (!(d < bd[K - 1])) break;
      insert_sorted<K>(bd, bi, d, pi[o + s]);
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_d[t * K + s] = bd[s];
    out_i[t * K + s] = bi[s];
  }
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

inline dim3 merge_grid(long long n, int searches) {
  return dim3((unsigned)((n + SEARCH_THREADS - 1) / SEARCH_THREADS), searches);
}

}  // namespace
