// Streaming k-nearest-neighbour kernel of the scan-to-map correspondence
// search, hand-written for Hopper (sm_90a).  Built with races.cu by
// cooper_mapper_torch/build.py (one plain nvcc call, C interface, ctypes).
//
// Replaces (cooper_mapper_tpu/ops/pallas/knn_stream.py):
//   knn_kernel<5>  <- knn_pallas / _knn_kernel  (and _knn_kernel_v2, the same
//                     function with another extraction scheme)
//
// What it computes.  For every query q of problem b, the K reference points
// j = 0..M-1 of that problem's reference (batch stride 0 = one reference
// shared by all problems) with the smallest
//   d(q, j) = (|q|^2 - 2 (q . r_j)) + |r_j|^2,
// where the wrapper has already set |r_j|^2 = BIG (1e12) at an invalid point,
// listed ascending by (distance, index): the order of jax.lax.top_k over the
// masked distance tile and of the TPU kernel.  Outputs idx [B,Q,K] int32 and
// d [B,Q,K] f32.
//
// Order and ties.  The reference is scanned in increasing index order and a
// candidate enters the sorted list only if it is strictly smaller than the
// K-th entry, then bubbles up past strictly larger entries only.  An equal
// distance therefore stays behind the smaller index already listed.  The list
// starts as (+inf, slot) so the first K references fill it (M >= K is
// required by the wrapper); every returned index lies in [0, M).
//
// Rounding.  The distance is spelled with __fmul_rn / __fadd_rn / __fsub_rn,
// never contracted into an FMA, in the order of the plain PyTorch version
// (cooper_mapper_torch/ops/knn.py, via races.pairwise_sq_dist):
//   qn = (qx*qx + qy*qy) + qz*qz,  cross = (qx*rx + qy*ry) + qz*rz,
//   d  = (qn - 2*cross) + rn,
// so kernel and plain version agree bit for bit.
//
// What bounds it on this card.  Per (query, reference) pair: 8 FP32
// operations for the distance and 1 compare against the K-th best; the
// insertion that follows a successful compare is rare once the list holds
// near neighbours.  Nothing per pair comes from device memory: the reference
// tile sits in shared memory and every thread of a block reads the same
// element (a broadcast).  So the FP32 issue rate bounds it.
//
// What the design does about it.  The TPU kernel extracts the K winners in K
// masked passes over a [TQ, TM] tile, because Mosaic has no per-lane branch
// or gather.  Here one thread owns one (problem, query) and keeps its sorted
// K-list in registers (K is a template constant, the loops unroll), so the
// reference is read once, not K times.  A block stages TILE_M points as
// float4 (x, y, z, |r|^2) in shared memory; the ragged last tile is bounded
// by M itself, so nothing is padded.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;   // queries per block
constexpr int TILE_M = 512;    // reference points staged per shared-memory tile

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ q, const float* __restrict__ r,
           const float* __restrict__ rn, float* __restrict__ out_d,
           int* __restrict__ out_i, int Q, int M, long long r_bstride) {
  __shared__ float4 tile[TILE_M];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  const long long qo = (long long)b * Q + (live ? qi : 0);
  const float qx = q[3 * qo], qy = q[3 * qo + 1], qz = q[3 * qo + 2];
  const float qn = sq_norm(qx, qy, qz);
  r += b * r_bstride * 3;
  rn += b * r_bstride;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { bd[s] = INFINITY; bi[s] = s; }

  for (int base = 0; base < M; base += TILE_M) {
    const int n = min(TILE_M, M - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int j = base + k;
      tile[k] = make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], rn[j]);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 p = tile[k];
      const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                    __fmul_rn(qz, p.z));
      const float d = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), p.w);
      if (d < bd[K - 1]) {
        bd[K - 1] = d;
        bi[K - 1] = base + k;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (bd[s] < bd[s - 1]) {
            const float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
            const int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
          }
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[qo * K + s] = bd[s];
      out_i[qo * K + s] = bi[s];
    }
  }
}

}  // namespace

// C interface.  Pointers are device pointers of contiguous f32/i32 tensors:
// q [B,Q,3]; r [*,M,3]; rn [*,M]; outputs [B,Q,k].  r_bstride is the
// reference's batch stride in points (0 = shared).  Only k = 5 (the
// reference's neighbourhood size, ScanMatch.cpp:97/116) is instantiated.
// Returns the cudaGetLastError() code of the launch (0 = launched), or
// cudaErrorInvalidValue for another k.
extern "C" {

int cooper_knn(const float* q, const float* r, const float* rn, float* out_d,
               int* out_i, int B, int Q, int M, int r_bstride, int k,
               void* stream) {
  if (k != 5) return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + THREADS - 1) / THREADS, B);
  knn_kernel<5><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      q, r, rn, out_d, out_i, Q, M, r_bstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
