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
// What the design does about it.  nn1, masked and fused kernels: one thread
// per query keeps its running (min, argmin) in registers; blockIdx.y is the
// problem.  A block stages TILE_M reference points as float4 (x, y, z, |r|^2)
// plus a float ring in shared memory, so the inner loop is one 16-byte shared
// broadcast and the arithmetic, nothing else.  The ragged last tile is
// bounded by M itself; no padding of the reference is needed.
//
// bc_races_kernel computes d once per pair and feeds both masked reductions,
// the TPU kernel's saving, and is built for this card (times:
// time_search_kernels.py, PERF.md):
// * the settled rule: a candidate that fails its ring test counts as BIG and
//   can win only while the race's minimum is above BIG, i.e. at the first
//   points of a scan.  Once every minimum of a warp is <= BIG (a vote every
//   BC_STEP points), "ring test passes and d < minimum" gives the same bits
//   without forming the masked value: two selects per pair go.
//   "same" and "adj" share one rd = |ring - ring_a|;
// * full tiles run loops with compile-time trip counts, unrolled, and the
//   ragged end its own loop;
// * one query per thread.  Each shared broadcast of a point could feed
//   several queries, but 2 and 4 per thread were slower at the odometry
//   batch shape (PERF.md): the race is bound by its compares and selects,
//   not by the shared loads, and fewer threads hide less latency;
// * M split across blocks where the grid would not fill the card (B = 1 in
//   the single-stream sweep: 1024 queries are 8 blocks for 132 SMs).  The
//   grid is (query blocks, B, S); block z scans one chunk of M and writes its
//   (min, argmin) pairs to scratch, and merge_min (split.cuh) joins them in
//   chunk order.  The wrapper picks S from B, Q, M and the card's SM count
//   (ops/races._split_plan); S = 1 writes the output directly, no merge.
//   Why the merge gives the same bits as one scan: split.cuh.

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

#include "split.cuh"

namespace {

constexpr int THREADS = SEARCH_THREADS;   // threads per block
constexpr int TILE_M = 512;    // reference points staged per shared-memory tile
constexpr float BIG = 1.0e12f;

struct RefTile {
  float4 p[TILE_M];    // x, y, z, |r|^2 (BIG where invalid)
  float ring[TILE_M];  // ring as float (1e9 where invalid)
};

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

// Surf races B and C.  Block (x, b, z): THREADS queries of problem b
// against the chunk z of M; it writes (min, argmin) of B to
// dst_db/dst_ib[z * chunk_stride + query] and of C to dst_dc/dst_ic.
__global__ void __launch_bounds__(THREADS)
bc_races_kernel(const float* __restrict__ q, const float* __restrict__ ra,
                const int* __restrict__ ia, const float* __restrict__ r,
                const float* __restrict__ rn, const float* __restrict__ ring,
                float* __restrict__ dst_db, int* __restrict__ dst_ib,
                float* __restrict__ dst_dc, int* __restrict__ dst_ic, int Q,
                int M, long long r_bstride, float span, int L, long long chunk_stride) {
  __shared__ RefTile tile;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * THREADS + threadIdx.x;
  BcQuery w;
  {
    const long long qo = (long long)b * Q + (qi < Q ? qi : 0);
    w.qx = q[3 * qo]; w.qy = q[3 * qo + 1]; w.qz = q[3 * qo + 2];
    w.qn = sq_norm(w.qx, w.qy, w.qz);
    w.ring_a = ra[qo];
    w.idx_a = ia[qo];
    w.best_b = INFINITY; w.best_c = INFINITY;
    w.bidx_b = 0; w.bidx_c = 0;
  }
  r += b * r_bstride * 3;
  rn += b * r_bstride;
  ring += b * r_bstride;

  int c0, c1;
  chunk_of_block(M, L, c0, c1);
  for (int base = c0; base < c1; base += TILE_M) {
    const int n = min(TILE_M, c1 - base);
    __syncthreads();
    load_tile<true>(tile, r, rn, ring, base, n);
    __syncthreads();
    for (int s = 0; s < n; s += BC_STEP) {
      if (n - s >= BC_STEP) {
        bc_step<BC_STEP>(tile, s, BC_STEP, base, span, w);
      } else {
        bc_step<0>(tile, s, n - s, base, span, w);
      }
    }
  }
  if (qi < Q) {
    const long long o = blockIdx.z * chunk_stride + (long long)b * Q + qi;
    dst_db[o] = w.best_b; dst_ib[o] = w.bidx_b;
    dst_dc[o] = w.best_c; dst_ic[o] = w.bidx_c;
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

// Queries one block of bc_races_kernel serves.
int cooper_bc_races_block_queries() { return THREADS; }

// Block z scans [z*L, min(M, (z+1)*L)); the caller guarantees
// (S-1)*L < M <= S*L.  With S > 1, part_d / part_i [2,S,B,Q] take the
// chunks' (B, C) results before merge_min joins them (unused, may be null,
// when S == 1).
int cooper_bc_races(const float* q, const float* ra, const int* ia,
                    const float* r, const float* rn, const float* ring,
                    float* out_db, int* out_ib, float* out_dc, int* out_ic,
                    float* part_d, int* part_i, int B, int Q, int M, int r_bstride,
                    float span, int S, int L, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * Q;
  const dim3 grid((Q + THREADS - 1) / THREADS, B, S);
  if (S == 1) {
    bc_races_kernel<<<grid, THREADS, 0, st>>>(
        q, ra, ia, r, rn, ring, out_db, out_ib, out_dc, out_ic, Q, M, r_bstride, span,
        M, 0);
    return (int)cudaGetLastError();
  }
  const long long part_c = (long long)S * n;   // race C's partials follow race B's
  bc_races_kernel<<<grid, THREADS, 0, st>>>(
      q, ra, ia, r, rn, ring, part_d, part_i, part_d + part_c, part_i + part_c, Q, M,
      r_bstride, span, L, n);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  MinOut out = {{out_db, out_dc, nullptr, nullptr}, {out_ib, out_ic, nullptr, nullptr}};
  merge_min<<<merge_grid(n, 2), SEARCH_THREADS, 0, st>>>(part_d, part_i, out, n, S);
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
