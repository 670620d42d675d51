// Nearest-neighbour race kernels of the scan-to-scan correspondence search,
// hand-written for Hopper (sm_90a).  Built by cooper_mapper_torch/build.py with
// one plain nvcc call into a C-ABI shared library that Python loads with
// ctypes; no PyTorch header is included.
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
// where the wrapper has already set |r_j|^2 = BIG (1e12) for an invalid point
// and its ring to 1e9.  A ring race replaces d by BIG where the candidate
// fails the ring test.  The output is (min_j d, first j attaining it): the
// scan runs in index order with a strict "<", so ties go to the smaller
// index, exactly like torch.argmin and the TPU kernels.
//
// Rounding.  Every multiply and add is spelled with __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA.  The order is the plain
// PyTorch version's (cooper_mapper_torch/ops/races.py):
//   qn    = (qx*qx + qy*qy) + qz*qz
//   cross = (qx*rx + qy*ry) + qz*rz
//   d     = (qn - 2*cross) + rn
// so kernel and plain version produce bit-identical distances.
//
// What bounds it on this card.  Per (query, reference) pair a race does ~8
// FP32 operations for the distance and 1-6 more for the ring test and the
// running minimum, and reads nothing from device memory: the reference tile
// sits in shared memory and every thread of a block reads the same element
// (a broadcast).  The inputs are a few MB per call, so the kernels are bound
// by FP32 issue rate, not by bandwidth.
//
// What the design does about it.  One thread per query keeps its running
// (min, argmin) in registers; blockIdx.y is the problem.  A block stages
// TILE_M reference points as float4 (x, y, z, |r|^2) plus a float ring in
// shared memory, so the inner loop is one 16-byte shared broadcast and the
// arithmetic, nothing else.  The bc kernel computes d once per pair and feeds
// both masked reductions, the TPU kernel's saving.  The ragged last tile is
// bounded by M itself; no padding of the reference is needed.
//
// fused_races_kernel.  The TPU kernel holds the whole [tile_q, M] distance
// tile in VMEM, takes A's argmin, extracts A's ring with a masked min (Mosaic
// has no per-lane gather) and runs B and C on the same tile.  Here a thread
// cannot hold its row of M distances, and B and C need A's ring before they
// can mask, so the kernel makes two passes over the shared-memory tiles in
// one launch: pass 1 is nn1_kernel's race A; the thread then reads ring[ia]
// itself (one load from device memory); pass 2 is bc_races_kernel's loop
// (WITH_SAME, surf) or masked_kernel<0>'s (corner).  The distance is
// computed twice per pair, so the kernel issues ~21-23 FP32 operations per
// pair against the 13-15 the function needs (the bound in chip_smoke.py):
// operations bound it, as for the split races.  What it saves is one launch
// and the ring gather between A and B/C (2 or 3 launches become 1).  A
// per-ring top-2 in one pass would reach the function's own count.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;   // queries per block
constexpr int TILE_M = 512;    // reference points staged per shared-memory tile
constexpr float BIG = 1.0e12f;

struct RefTile {
  float4 p[TILE_M];    // x, y, z, |r|^2 (BIG where invalid)
  float ring[TILE_M];  // ring as float (1e9 where invalid)
};

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float qn,
                                         float4 r) {
  float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, r.x), __fmul_rn(qy, r.y)),
                          __fmul_rn(qz, r.z));
  return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), r.w);
}

// Cooperative load of reference points [base, base + n) into shared memory.
template <bool WITH_RING>
__device__ __forceinline__ void load_tile(RefTile& t, const float* __restrict__ r,
                                          const float* __restrict__ rn,
                                          const float* __restrict__ ring,
                                          int base, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int j = base + k;
    t.p[k] = make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], rn[j]);
    if (WITH_RING) t.ring[k] = ring[j];
  }
}

__global__ void __launch_bounds__(THREADS)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ r,
           const float* __restrict__ rn, float* __restrict__ out_d,
           int* __restrict__ out_i, int Q, int M, long long r_bstride) {
  __shared__ RefTile tile;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  const long long qo = (long long)b * Q + (live ? qi : 0);
  const float qx = q[3 * qo], qy = q[3 * qo + 1], qz = q[3 * qo + 2];
  const float qn = sq_norm(qx, qy, qz);
  r += b * r_bstride * 3;
  rn += b * r_bstride;

  float best = INFINITY;
  int bidx = 0;
  for (int base = 0; base < M; base += TILE_M) {
    const int n = min(TILE_M, M - base);
    __syncthreads();
    load_tile<false>(tile, r, rn, nullptr, base, n);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float d = sq_dist(qx, qy, qz, qn, tile.p[k]);
      if (d < best) { best = d; bidx = base + k; }
    }
  }
  if (live) { out_d[qo] = best; out_i[qo] = bidx; }
}

// MODE 0 = "adj": 0 < |ring - ra| <= span;  MODE 1 = "same": ring == ra, j != ia.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
masked_kernel(const float* __restrict__ q, const float* __restrict__ ra,
              const int* __restrict__ ia, const float* __restrict__ r,
              const float* __restrict__ rn, const float* __restrict__ ring,
              float* __restrict__ out_d, int* __restrict__ out_i, int Q, int M,
              long long r_bstride, float span) {
  __shared__ RefTile tile;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  const long long qo = (long long)b * Q + (live ? qi : 0);
  const float qx = q[3 * qo], qy = q[3 * qo + 1], qz = q[3 * qo + 2];
  const float qn = sq_norm(qx, qy, qz);
  const float ring_a = ra[qo];
  const int idx_a = ia[qo];
  r += b * r_bstride * 3;
  rn += b * r_bstride;
  ring += b * r_bstride;

  float best = INFINITY;
  int bidx = 0;
  for (int base = 0; base < M; base += TILE_M) {
    const int n = min(TILE_M, M - base);
    __syncthreads();
    load_tile<true>(tile, r, rn, ring, base, n);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float d = sq_dist(qx, qy, qz, qn, tile.p[k]);
      bool ok;
      if (MODE == 0) {
        const float rd = fabsf(__fsub_rn(tile.ring[k], ring_a));
        ok = rd > 0.0f && rd <= span;
      } else {
        ok = tile.ring[k] == ring_a && base + k != idx_a;
      }
      d = ok ? d : BIG;
      if (d < best) { best = d; bidx = base + k; }
    }
  }
  if (live) { out_d[qo] = best; out_i[qo] = bidx; }
}

__global__ void __launch_bounds__(THREADS)
bc_races_kernel(const float* __restrict__ q, const float* __restrict__ ra,
                const int* __restrict__ ia, const float* __restrict__ r,
                const float* __restrict__ rn, const float* __restrict__ ring,
                float* __restrict__ out_db, int* __restrict__ out_ib,
                float* __restrict__ out_dc, int* __restrict__ out_ic, int Q,
                int M, long long r_bstride, float span) {
  __shared__ RefTile tile;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  const long long qo = (long long)b * Q + (live ? qi : 0);
  const float qx = q[3 * qo], qy = q[3 * qo + 1], qz = q[3 * qo + 2];
  const float qn = sq_norm(qx, qy, qz);
  const float ring_a = ra[qo];
  const int idx_a = ia[qo];
  r += b * r_bstride * 3;
  rn += b * r_bstride;
  ring += b * r_bstride;

  float best_b = INFINITY, best_c = INFINITY;
  int bidx_b = 0, bidx_c = 0;
  for (int base = 0; base < M; base += TILE_M) {
    const int n = min(TILE_M, M - base);
    __syncthreads();
    load_tile<true>(tile, r, rn, ring, base, n);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float d = sq_dist(qx, qy, qz, qn, tile.p[k]);
      const float rg = tile.ring[k];
      const float db = (rg == ring_a && base + k != idx_a) ? d : BIG;
      if (db < best_b) { best_b = db; bidx_b = base + k; }
      const float rd = fabsf(__fsub_rn(rg, ring_a));
      const float dc = (rd > 0.0f && rd <= span) ? d : BIG;
      if (dc < best_c) { best_c = dc; bidx_c = base + k; }
    }
  }
  if (live) {
    out_db[qo] = best_b; out_ib[qo] = bidx_b;
    out_dc[qo] = best_c; out_ic[qo] = bidx_c;
  }
}

// Every race of one search.  WITH_SAME = surf (A, B, C), else corner (A, C).
template <bool WITH_SAME>
__global__ void __launch_bounds__(THREADS)
fused_races_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   const float* __restrict__ rn, const float* __restrict__ ring,
                   float* __restrict__ out_da, int* __restrict__ out_ia,
                   float* __restrict__ out_db, int* __restrict__ out_ib,
                   float* __restrict__ out_dc, int* __restrict__ out_ic, int Q,
                   int M, long long r_bstride, float span) {
  __shared__ RefTile tile;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  const long long qo = (long long)b * Q + (live ? qi : 0);
  const float qx = q[3 * qo], qy = q[3 * qo + 1], qz = q[3 * qo + 2];
  const float qn = sq_norm(qx, qy, qz);
  r += b * r_bstride * 3;
  rn += b * r_bstride;
  ring += b * r_bstride;

  // pass 1: race A
  float best_a = INFINITY;
  int idx_a = 0;
  for (int base = 0; base < M; base += TILE_M) {
    const int n = min(TILE_M, M - base);
    __syncthreads();
    load_tile<false>(tile, r, rn, nullptr, base, n);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float d = sq_dist(qx, qy, qz, qn, tile.p[k]);
      if (d < best_a) { best_a = d; idx_a = base + k; }
    }
  }
  const float ring_a = ring[idx_a];   // 1e9 where A is an invalid point

  // pass 2: races B (surf only) and C on A's ring
  float best_b = INFINITY, best_c = INFINITY;
  int bidx_b = 0, bidx_c = 0;
  for (int base = 0; base < M; base += TILE_M) {
    const int n = min(TILE_M, M - base);
    __syncthreads();
    load_tile<true>(tile, r, rn, ring, base, n);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float d = sq_dist(qx, qy, qz, qn, tile.p[k]);
      const float rg = tile.ring[k];
      if (WITH_SAME) {
        const float db = (rg == ring_a && base + k != idx_a) ? d : BIG;
        if (db < best_b) { best_b = db; bidx_b = base + k; }
      }
      const float rd = fabsf(__fsub_rn(rg, ring_a));
      const float dc = (rd > 0.0f && rd <= span) ? d : BIG;
      if (dc < best_c) { best_c = dc; bidx_c = base + k; }
    }
  }
  if (live) {
    out_da[qo] = best_a; out_ia[qo] = idx_a;
    if (WITH_SAME) { out_db[qo] = best_b; out_ib[qo] = bidx_b; }
    out_dc[qo] = best_c; out_ic[qo] = bidx_c;
  }
}

dim3 grid_for(int B, int Q) { return dim3((Q + THREADS - 1) / THREADS, B); }

}  // namespace

// C interface.  Pointers are device pointers of contiguous f32/i32 tensors:
// q [B,Q,3]; r [*,M,3]; rn, ring [*,M]; ra, ia and outputs [B,Q].
// r_bstride is the reference's batch stride in points (0 = shared).
// Each returns the cudaGetLastError() code of its launch (0 = launched).
extern "C" {

int cooper_nn1(const float* q, const float* r, const float* rn, float* out_d,
               int* out_i, int B, int Q, int M, int r_bstride, void* stream) {
  nn1_kernel<<<grid_for(B, Q), THREADS, 0, (cudaStream_t)stream>>>(
      q, r, rn, out_d, out_i, Q, M, r_bstride);
  return (int)cudaGetLastError();
}

int cooper_nn1_masked(const float* q, const float* ra, const int* ia,
                      const float* r, const float* rn, const float* ring,
                      float* out_d, int* out_i, int B, int Q, int M,
                      int r_bstride, int mode_same, float span, void* stream) {
  if (mode_same) {
    masked_kernel<1><<<grid_for(B, Q), THREADS, 0, (cudaStream_t)stream>>>(
        q, ra, ia, r, rn, ring, out_d, out_i, Q, M, r_bstride, span);
  } else {
    masked_kernel<0><<<grid_for(B, Q), THREADS, 0, (cudaStream_t)stream>>>(
        q, ra, ia, r, rn, ring, out_d, out_i, Q, M, r_bstride, span);
  }
  return (int)cudaGetLastError();
}

int cooper_bc_races(const float* q, const float* ra, const int* ia,
                    const float* r, const float* rn, const float* ring,
                    float* out_db, int* out_ib, float* out_dc, int* out_ic,
                    int B, int Q, int M, int r_bstride, float span,
                    void* stream) {
  bc_races_kernel<<<grid_for(B, Q), THREADS, 0, (cudaStream_t)stream>>>(
      q, ra, ia, r, rn, ring, out_db, out_ib, out_dc, out_ic, Q, M, r_bstride,
      span);
  return (int)cudaGetLastError();
}

// out_db / out_ib are unused (may be null) when with_same == 0.
int cooper_fused_races(const float* q, const float* r, const float* rn,
                       const float* ring, float* out_da, int* out_ia,
                       float* out_db, int* out_ib, float* out_dc, int* out_ic,
                       int B, int Q, int M, int r_bstride, int with_same,
                       float span, void* stream) {
  if (with_same) {
    fused_races_kernel<true><<<grid_for(B, Q), THREADS, 0, (cudaStream_t)stream>>>(
        q, r, rn, ring, out_da, out_ia, out_db, out_ib, out_dc, out_ic, Q, M,
        r_bstride, span);
  } else {
    fused_races_kernel<false><<<grid_for(B, Q), THREADS, 0, (cudaStream_t)stream>>>(
        q, r, rn, ring, out_da, out_ia, out_db, out_ib, out_dc, out_ic, Q, M,
        r_bstride, span);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
