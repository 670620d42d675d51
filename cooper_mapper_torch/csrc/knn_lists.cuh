// The k-NN's register lists: knn_kernel<K, QPT> and its launches, for every
// K from 1 to KNN_REG_MAX_K, shared by the translation units that
// instantiate them (knn.cu: K <= 16; knn_lists_17_24.cu; knn_lists_25_32.cu).
// What the kernel computes and the select route for larger k: knn.cu.
//
// Order and ties.  The reference is scanned in increasing index order and a
// candidate enters the sorted list only if it is strictly smaller than the
// K-th entry, then moves up past strictly larger entries only (split.cuh's
// insert_sorted).  An equal distance therefore stays behind the smaller
// index already listed.  The list starts as (+inf, slot) so the first K
// references fill it (M >= K is required by the wrapper); every returned
// index lies in [0, M).  A NaN distance never enters, so a NaN query comes
// back as (+inf, 0..K-1).
//
// Rounding.  The distance is spelled with __fmul_rn / __fadd_rn / __fsub_rn,
// never contracted into an FMA, in the order of the plain PyTorch version
// (cooper_mapper_torch/ops/knn.py, via races.pairwise_sq_dist), so kernel and
// plain version agree bit for bit.
//
// What bounds it on this card.  Per (query, reference) pair: 8 FP32
// operations for the distance and 1 compare against the K-th best; the
// insertion that follows a successful compare is rare once the list holds
// near neighbours, if the points come in no spatial order.  Nothing per pair
// comes from device memory: the reference tile sits in shared memory and
// every thread of a block reads the same element (a broadcast).  So the FP32
// issue rate bounds it (no FMA: the rounding must be the plain version's).
//
// What the design does about it (times: time_search_kernels.py, PERF.md).
// * Deferred insertion.  A group of 32 points is tested against each query's
//   K-th best as it stood at the group's start, setting bits in a hit mask:
//   straight-line code, one compare per pair.  The hits are then inserted in
//   index order (knn_scan); the insertion itself settles every slot of the
//   list at once (split.cuh's insert_sorted) instead of a serial bubble.
// * A sampled bound.  The reference is often stored in spatial order (the
//   cube map's surround, the voxel filter's output): scanned in index order,
//   it keeps bringing nearer points, so the list's K-th best falls slowly and
//   many times more points enter and leave again than in random order, each
//   a divergent insertion for its warp.  A first pass over every stride-th
//   point of the chunk gives an
//   upper bound on the chunk's K-th distance (sample_bound), and the scan
//   lets only points at or under it through.  That is exact: every point of
//   the chunk's first K is at or under any such bound.
// * Queries per thread: KNN_QPT = 2 up to K = KNN_QPT2_MAX_K (knn_qpt).
//   Each shared-memory broadcast of (x, y, z, |r|^2) feeds two distance
//   evaluations, and each query's K-list stays in registers (K and QPT are
//   template constants).  2 is the fastest at the scan-to-map batch shape
//   and about even with 1 at B = 1; 4 and 8 were slower: fewer threads hide
//   less latency (PERF.md).  A thread's two lists cost 4 K registers, so
//   above KNN_QPT2_MAX_K a thread keeps one query.
// * M split across blocks where the grid would not fill the card (B = 1 in
//   the single-stream sweep: 8-32 query blocks for 132 SMs).  The grid is
//   (query blocks, B, S); block z scans one chunk of M and writes its sorted
//   list to scratch, and merge_first_k (split.cuh) joins the S lists in chunk
//   order.  The wrapper picks S from B, Q, M and the card's SM count
//   (ops/races._split_plan); S = 1 writes the output directly, no merge.
//   Why the merge gives the same bits as one scan: split.cuh.
// * More than 65,535 problems (grid y) are launched in slabs (split.cuh's
//   over_slabs): a launch of fewer is the one launch it always was.

#pragma once

#include <array>
#include <utility>

#include "split.cuh"

namespace {

constexpr int KNN_QPT = 2;       // queries per thread, up to KNN_QPT2_MAX_K
constexpr int KNN_QPT2_MAX_K = 16;
constexpr int KNN_REG_MAX_K = 32;  // the largest k of the register lists
constexpr int KNN_TILE_M = 512;  // reference points staged per shared-memory tile
constexpr int KNN_SAMPLE = 256;  // points of a chunk's sample (sample_bound)
constexpr int KNN_MIN_STRIDE = 4;  // shorter chunks (under 4 x KNN_SAMPLE) go unsampled

// Test the tile's points [0, n) against each of the thread's queries, in
// groups of 32.  Within a group every distance is compared with the query's
// K-th best as it stood at the group's start, and a pass sets the point's bit
// in the query's hit mask: straight-line code, no branch per point.  Then the
// hits are inserted in index order (lowest bit first), each recomputed and
// checked against the list as it stands.  The K-th best only falls, so the
// stale threshold lets through a superset of the points that enter: the same
// list as testing every point in turn.
template <int QPT, int G>
__device__ __forceinline__ void knn_group(const float4* __restrict__ tile, int m,
                                          const float (&qx)[QPT], const float (&qy)[QPT],
                                          const float (&qz)[QPT], const float (&qn)[QPT],
                                          const float (&thr)[QPT], unsigned (&hit)[QPT]) {
  // G > 0: a full group of G points, unrolled; G == 0: the last m points
#pragma unroll
  for (int t = 0; t < (G > 0 ? G : m); ++t) {
    const float4 p = tile[t];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      if (sq_dist(qx[u], qy[u], qz[u], qn[u], p) < thr[u]) hit[u] |= 1u << t;
    }
  }
}

template <int K, int QPT>
__device__ __forceinline__ void knn_scan(const float4* __restrict__ tile, int n, int base,
                                         const float (&qx)[QPT], const float (&qy)[QPT],
                                         const float (&qz)[QPT], const float (&qn)[QPT],
                                         const float (&cap)[QPT], float (&bd)[QPT][K],
                                         int (&bi)[QPT][K]) {
  for (int g = 0; g < n; g += 32) {
    float thr[QPT];
    unsigned hit[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) { thr[u] = fminf(bd[u][K - 1], cap[u]); hit[u] = 0u; }
    if (n - g >= 32) {
      knn_group<QPT, 32>(tile + g, 32, qx, qy, qz, qn, thr, hit);
    } else {
      knn_group<QPT, 0>(tile + g, n - g, qx, qy, qz, qn, thr, hit);
    }
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      while (hit[u]) {
        const int t = __ffs(hit[u]) - 1;
        hit[u] &= hit[u] - 1u;
        const float d = sq_dist(qx[u], qy[u], qz[u], qn[u], tile[g + t]);
        if (d < bd[u][K - 1]) insert_sorted<K>(bd[u], bi[u], d, base + g + t);
      }
    }
  }
}

// cap[u] for each query: the float above the K-th smallest distance over a
// strided sample of the chunk [c0, c1) (every stride-th point, about
// KNN_SAMPLE of them), or +inf where the chunk is too short to sample.  The
// reference is often stored in spatial order (the cube map's surround, the
// voxel filter's output), so a scan in index order keeps finding nearer
// points as it approaches the query: the list's own K-th best falls slowly
// and many points enter and leave again.  The sample's bound spans the
// chunk, so only the points near the query pass the scan's test.
template <int K, int QPT>
__device__ __forceinline__ void sample_bound(float4* tile, const float* __restrict__ r,
                                             const float* __restrict__ rn, int c0, int c1,
                                             const float (&qx)[QPT], const float (&qy)[QPT],
                                             const float (&qz)[QPT], const float (&qn)[QPT],
                                             float (&cap)[QPT]) {
  const int stride = (c1 - c0) / KNN_SAMPLE;
#pragma unroll
  for (int u = 0; u < QPT; ++u) cap[u] = INFINITY;
  if (stride < KNN_MIN_STRIDE) return;          // block-uniform
  const int n = (c1 - c0 + stride - 1) / stride;  // < KNN_SAMPLE * (1 + 1 / KNN_MIN_STRIDE)
  for (int k = threadIdx.x; k < n; k += SEARCH_THREADS) {
    const int j = c0 + k * stride;
    tile[k] = make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], rn[j]);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    float sd[K];
    int unused[K];   // insert_sorted's index list; only the distances are read
#pragma unroll
    for (int s = 0; s < K; ++s) sd[s] = INFINITY;
    for (int k = 0; k < n; ++k) {
      const float d = sq_dist(qx[u], qy[u], qz[u], qn[u], tile[k]);
      if (d < sd[K - 1]) insert_sorted<K>(sd, unused, d, k);
    }
    cap[u] = nextafterf(sd[K - 1], INFINITY);
  }
}

template <int K, int QPT>
__global__ void __launch_bounds__(SEARCH_THREADS)
knn_kernel(const float* __restrict__ q, const float* __restrict__ r,
           const float* __restrict__ rn, float* __restrict__ dst_d,
           int* __restrict__ dst_i, int Q, int M, long long r_bstride, int L,
           long long chunk_stride) {
  __shared__ float4 tile[KNN_TILE_M];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * (SEARCH_THREADS * QPT) + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT], qn[QPT];
  float bd[QPT][K];
  int bi[QPT][K];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = q0 + u * SEARCH_THREADS;
    const long long qo = (long long)b * Q + (qi < Q ? qi : 0);
    qx[u] = q[3 * qo]; qy[u] = q[3 * qo + 1]; qz[u] = q[3 * qo + 2];
    qn[u] = sq_norm(qx[u], qy[u], qz[u]);
#pragma unroll
    for (int s = 0; s < K; ++s) { bd[u][s] = INFINITY; bi[u][s] = s; }
  }
  r += b * r_bstride * 3;
  rn += b * r_bstride;

  int c0, c1;
  chunk_of_block(M, L, c0, c1);
  // a point can be among the chunk's first K only if d <= tau, the K-th
  // smallest distance over any K of the chunk's points; cap = the next float
  // above tau, so "d < cap" is "d <= tau"
  float cap[QPT];
  sample_bound<K, QPT>(tile, r, rn, c0, c1, qx, qy, qz, qn, cap);
  for (int base = c0; base < c1; base += KNN_TILE_M) {
    const int n = min(KNN_TILE_M, c1 - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += SEARCH_THREADS) {
      const int j = base + k;
      tile[k] = make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], rn[j]);
    }
    __syncthreads();
    knn_scan<K, QPT>(tile, n, base, qx, qy, qz, qn, cap, bd, bi);
  }

  dst_d += blockIdx.z * chunk_stride;
  dst_i += blockIdx.z * chunk_stride;
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = q0 + u * SEARCH_THREADS;
    if (qi < Q) {
      const long long o = ((long long)b * Q + qi) * K;
#pragma unroll
      for (int s = 0; s < K; ++s) { dst_d[o + s] = bd[u][s]; dst_i[o + s] = bi[u][s]; }
    }
  }
}

constexpr int knn_qpt(int K) { return K <= KNN_QPT2_MAX_K ? KNN_QPT : 1; }

// One launch (and the merge where S > 1) of B <= MAX_GRID_Y problems.
template <int K>
int launch_knn_slab(const float* q, const float* r, const float* rn, float* out_d, int* out_i,
                    float* part_d, int* part_i, int B, int Q, int M, int r_bstride, int S,
                    int L, cudaStream_t stream) {
  constexpr int QPT = knn_qpt(K);
  const long long n = (long long)B * Q;
  const dim3 grid((Q + SEARCH_THREADS * QPT - 1) / (SEARCH_THREADS * QPT), B, S);
  if (S == 1) {
    knn_kernel<K, QPT><<<grid, SEARCH_THREADS, 0, stream>>>(
        q, r, rn, out_d, out_i, Q, M, r_bstride, M, 0);
    return (int)cudaGetLastError();
  }
  knn_kernel<K, QPT><<<grid, SEARCH_THREADS, 0, stream>>>(
      q, r, rn, part_d, part_i, Q, M, r_bstride, L, n * K);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_merge_first_k<K>(part_d, part_i, out_d, out_i, n, S, stream);
}

template <int K>
int launch_knn(const float* q, const float* r, const float* rn, float* out_d, int* out_i,
               float* part_d, int* part_i, int B, int Q, int M, int r_bstride, int S, int L,
               cudaStream_t stream) {
  return over_slabs(B, [&](int b0, int nb) {
    const long long qo = (long long)b0 * Q, ro = (long long)b0 * r_bstride;
    return launch_knn_slab<K>(q + 3 * qo, r + 3 * ro, rn + ro, out_d + qo * K,
                              out_i + qo * K, part_d, part_i, nb, Q, M, r_bstride, S, L,
                              stream);
  });
}

using KnnLaunch = decltype(&launch_knn<1>);

template <int LO, std::size_t... I>
constexpr std::array<KnnLaunch, sizeof...(I)> knn_launches(std::index_sequence<I...>) {
  return {{&launch_knn<LO + (int)I>...}};
}

// launch_knn<k> for LO <= k <= HI (the caller checks the range)
template <int LO, int HI>
int launch_knn_in(int k, const float* q, const float* r, const float* rn, float* out_d,
                  int* out_i, float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
                  int S, int L, cudaStream_t stream) {
  static constexpr std::array<KnnLaunch, HI - LO + 1> table =
      knn_launches<LO>(std::make_index_sequence<HI - LO + 1>{});
  return table[k - LO](q, r, rn, out_d, out_i, part_d, part_i, B, Q, M, r_bstride, S, L,
                       stream);
}

using MergeLaunch = decltype(&launch_merge_first_k<1>);

template <int LO, std::size_t... I>
constexpr std::array<MergeLaunch, sizeof...(I)> merge_launches(std::index_sequence<I...>) {
  return {{&launch_merge_first_k<LO + (int)I>...}};
}

// launch_merge_first_k<k> for LO <= k <= HI (the caller checks the range)
template <int LO, int HI>
int launch_merge_in(int k, const float* pd, const int* pi, float* out_d, int* out_i, long long n,
                    int S, cudaStream_t stream) {
  static constexpr std::array<MergeLaunch, HI - LO + 1> table =
      merge_launches<LO>(std::make_index_sequence<HI - LO + 1>{});
  return table[k - LO](pd, pi, out_d, out_i, n, S, stream);
}

}  // namespace

// The larger k of the register lists, each range instantiated in a
// translation unit of its own (knn_lists_17_24.cu, knn_lists_25_32.cu) so
// that the build compiles them in parallel; launch_knn_in's arguments.
int knn_lists_17_24(int k, const float* q, const float* r, const float* rn, float* out_d,
                    int* out_i, float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
                    int S, int L, cudaStream_t stream);
int knn_lists_25_32(int k, const float* q, const float* r, const float* rn, float* out_d,
                    int* out_i, float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
                    int S, int L, cudaStream_t stream);
// merge_first_k on its own for the same ranges of k (launch_merge_in's arguments)
int merge_lists_17_24(int k, const float* pd, const int* pi, float* out_d, int* out_i,
                      long long n, int S, cudaStream_t stream);
int merge_lists_25_32(int k, const float* pd, const int* pi, float* out_d, int* out_i,
                      long long n, int S, cudaStream_t stream);
