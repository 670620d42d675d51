// Streaming k-nearest-neighbour kernel of the scan-to-map correspondence
// search, hand-written for Hopper (sm_90a).  Built with races.cu by
// cooper_mapper_torch/build.py (one plain nvcc call, C interface, ctypes).
//
// Replaces (cooper_mapper_tpu/ops/pallas/knn_stream.py):
//   knn_kernel<K, QPT>  <- knn_pallas / _knn_kernel  (and _knn_kernel_v2, the
//                          same function with another extraction scheme)
//
// What it computes.  For every query q of problem b, the K reference points
// j = 0..M-1 of that problem's reference (batch stride 0 = one reference
// shared by all problems) with the smallest
//   d(q, j) = (|q|^2 - 2 (q . r_j)) + |r_j|^2,
// where the wrapper has already set |r_j|^2 = BIG (1e12) at an invalid point,
// listed ascending by (distance, index): the order of jax.lax.top_k over the
// masked distance tile and of the TPU kernel.  Outputs idx [B,Q,K] int32 and
// d [B,Q,K] f32.  K = 5 (the scan-to-map neighbourhood) and K = 10 (the
// feature classifier's) are built.
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
// * Queries per thread: KNN_QPT = 2.  Each shared-memory broadcast of
//   (x, y, z, |r|^2) feeds two distance evaluations, and each query's K-list
//   stays in registers (K and QPT are template constants).  2 is the fastest
//   at the scan-to-map batch shape and about even with 1 at B = 1; 4 and 8
//   were slower: fewer threads hide less latency (PERF.md).
// * M split across blocks where the grid would not fill the card (B = 1 in
//   the single-stream sweep: 8-32 query blocks for 132 SMs).  The grid is
//   (query blocks, B, S); block z scans one chunk of M and writes its sorted
//   list to scratch, and merge_first_k (split.cuh) joins the S lists in chunk
//   order.  The wrapper picks S from B, Q, M and the card's SM count
//   (ops/races._split_plan); S = 1 writes the output directly, no merge.
//   Why the merge gives the same bits as one scan: split.cuh.

#include "split.cuh"

namespace {

constexpr int KNN_QPT = 2;       // queries per thread
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

template <int K>
int launch_knn(const float* q, const float* r, const float* rn, float* out_d, int* out_i,
               float* part_d, int* part_i, int B, int Q, int M, int r_bstride, int S,
               int L, cudaStream_t stream) {
  const long long n = (long long)B * Q;
  const dim3 grid((Q + SEARCH_THREADS * KNN_QPT - 1) / (SEARCH_THREADS * KNN_QPT), B, S);
  if (S == 1) {
    knn_kernel<K, KNN_QPT><<<grid, SEARCH_THREADS, 0, stream>>>(
        q, r, rn, out_d, out_i, Q, M, r_bstride, M, 0);
    return (int)cudaGetLastError();
  }
  knn_kernel<K, KNN_QPT><<<grid, SEARCH_THREADS, 0, stream>>>(
      q, r, rn, part_d, part_i, Q, M, r_bstride, L, n * K);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  merge_first_k<K><<<merge_grid(n, 1), SEARCH_THREADS, 0, stream>>>(
      part_d, part_i, out_d, out_i, n, S);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface.  Pointers are device pointers of contiguous f32/i32 tensors:
// q [B,Q,3]; r [*,M,3]; rn [*,M]; outputs [B,Q,k]; with S > 1 the scratch
// part_d / part_i [S,B,Q,k] (unused, may be null, when S == 1).  r_bstride
// is the reference's batch stride in points (0 = shared).  Block z scans
// [z*L, min(M, (z+1)*L)); the caller guarantees (S-1)*L < M <= S*L.
// Returns the cudaGetLastError() code of the launches (0 = launched), or
// cudaErrorInvalidValue for a k that is not built.
extern "C" {

// Queries one block of the k-NN kernel serves, or 0 if k is not built.
int cooper_knn_block_queries(int k) {
  return (k == 5 || k == 10) ? SEARCH_THREADS * KNN_QPT : 0;
}

int cooper_knn(const float* q, const float* r, const float* rn, float* out_d,
               int* out_i, float* part_d, int* part_i, int B, int Q, int M,
               int r_bstride, int k, int S, int L, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 5)
    return launch_knn<5>(q, r, rn, out_d, out_i, part_d, part_i, B, Q, M, r_bstride, S, L, s);
  if (k == 10)
    return launch_knn<10>(q, r, rn, out_d, out_i, part_d, part_i, B, Q, M, r_bstride, S, L, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
