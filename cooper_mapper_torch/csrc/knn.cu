// Streaming k-nearest-neighbour kernels of the scan-to-map correspondence
// search, hand-written for Hopper (sm_90a).  Built beside races.cu and
// knn_lists_*.cu by cooper_mapper_torch/build.py (plain nvcc, one process per
// source, C interface, ctypes).
//
// Replaces (cooper_mapper_tpu/ops/pallas/knn_stream.py), for every static k
// the TPU kernel takes:
//   knn_kernel<K, QPT>      <- knn_pallas / _knn_kernel  (and _knn_kernel_v2,
//                              the same function with another extraction
//                              scheme), 1 <= k <= KNN_REG_MAX_K: the lists in
//                              registers (knn_lists.cuh)
//   knn_select_kernel<N, T> <- the same, KNN_REG_MAX_K < k <= SEL_MAX_K: a
//                              warp select (knn_select.cu)
//   knn_radix_kernel        <- the same, SEL_MAX_K < k <= M: a radix select,
//                              then a sort (knn_select.cu)
//
// What it computes.  For every query q of problem b, the K reference points
// j = 0..M-1 of that problem's reference (batch stride 0 = one reference
// shared by all problems) with the smallest
//   d(q, j) = (|q|^2 - 2 (q . r_j)) + |r_j|^2,
// where the wrapper has already set |r_j|^2 = BIG (1e12) at an invalid point,
// listed ascending by (distance, index): the order of jax.lax.top_k over the
// masked distance tile and of the TPU kernel.  Outputs idx [B,Q,K] int32 and
// d [B,Q,K] f32.  knn_kernel is built for every K from 1 to KNN_REG_MAX_K
// (5 is the scan-to-map neighbourhood, 10 the feature classifier's); a larger
// k takes the select routes, which return the same lists.
//
// Order, ties and rounding: the register lists' (knn_lists.cuh).  Every
// route evaluates d with the plain PyTorch version's operations in its order
// (cooper_mapper_torch/ops/knn.py, via races.pairwise_sq_dist), so kernel
// and plain version agree bit for bit.  The select routes order 64-bit keys
// (ordered bits of d) << 32 | j (split.cuh's make_key): unsigned order of
// the keys is the (d, j) order, and no two keys are equal, so the k smallest
// keys are the k-NN list whatever order the points are met in.  A point whose
// d is NaN or +inf is left out, as the register lists leave it out (it never
// compares below +inf), and a row of F < k such points ends in (+inf, 0),
// (+inf, 1), ... as the register lists' untouched slots do; so a NaN query
// gives (+inf, 0..k-1) on every route.

#include "knn_lists.cuh"

// C interface.  Pointers are device pointers of contiguous f32/i32 tensors:
// q [B,Q,3]; r [*,M,3]; rn [*,M]; outputs [B,Q,k]; r_bstride is the
// reference's batch stride in points (0 = shared).  Any B >= 1.  Each
// returns the cudaGetLastError() code of its launches (0 = launched), or
// cudaErrorInvalidValue for a k its route does not serve.
extern "C" {

// The largest k of the register lists (cooper_knn); above it, and up to M,
// cooper_knn_select (knn_select.cu).
int cooper_knn_register_max_k() { return KNN_REG_MAX_K; }

// Queries one block of cooper_knn serves at k, or 0 if the register lists
// do not serve k.
int cooper_knn_block_queries(int k) {
  return (k >= 1 && k <= KNN_REG_MAX_K) ? SEARCH_THREADS * knn_qpt(k) : 0;
}

// The register lists, 1 <= k <= KNN_REG_MAX_K.  With S > 1 the scratch
// part_d / part_i [S,B,Q,k] (unused, may be null, when S == 1).  Block z
// scans [z*L, min(M, (z+1)*L)); the caller guarantees (S-1)*L < M <= S*L.
int cooper_knn(const float* q, const float* r, const float* rn, float* out_d,
               int* out_i, float* part_d, int* part_i, int B, int Q, int M,
               int r_bstride, int k, int S, int L, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > KNN_REG_MAX_K) return (int)cudaErrorInvalidValue;
  if (k <= 16)
    return launch_knn_in<1, 16>(k, q, r, rn, out_d, out_i, part_d, part_i, B, Q, M, r_bstride,
                                S, L, st);
  return (k <= 24 ? knn_lists_17_24 : knn_lists_25_32)(k, q, r, rn, out_d, out_i, part_d,
                                                       part_i, B, Q, M, r_bstride, S, L, st);
}

// The register lists' merge on its own: part_d / part_i [S, n, k], chunk
// z's sorted first-k list of each query -> out [n, k], 1 <= k <= KNN_REG_MAX_K.
int cooper_merge_first_k(const float* part_d, const int* part_i, float* out_d, int* out_i,
                         long long n, int S, int k, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > KNN_REG_MAX_K || S < 1) return (int)cudaErrorInvalidValue;
  if (k <= 16) return launch_merge_in<1, 16>(k, part_d, part_i, out_d, out_i, n, S, st);
  return (k <= 24 ? merge_lists_17_24 : merge_lists_25_32)(k, part_d, part_i, out_d, out_i, n,
                                                           S, st);
}

}  // extern "C"
