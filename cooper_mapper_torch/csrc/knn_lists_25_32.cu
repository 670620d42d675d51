// The k-NN's register lists for 25 <= k <= 32 (knn_lists.cuh), in a
// translation unit of their own so that the build compiles them beside the
// others, in parallel.  knn.cu's cooper_knn calls knn_lists_25_32, its
// cooper_merge_first_k merge_lists_25_32.

#include "knn_lists.cuh"

int knn_lists_25_32(int k, const float* q, const float* r, const float* rn, float* out_d,
                    int* out_i, float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
                    int S, int L, cudaStream_t stream) {
  return launch_knn_in<25, 32>(k, q, r, rn, out_d, out_i, part_d, part_i, B, Q, M,
                                  r_bstride, S, L, stream);
}

int merge_lists_25_32(int k, const float* pd, const int* pi, float* out_d, int* out_i,
                      long long n, int S, cudaStream_t stream) {
  return launch_merge_in<25, 32>(k, pd, pi, out_d, out_i, n, S, stream);
}
