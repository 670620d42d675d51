// Streaming k-nearest-neighbour kernels of the scan-to-map correspondence
// search, hand-written for Hopper (sm_90a).  Built beside races.cu and
// knn_lists_*.cu by cooper_mapper_torch/build.py (plain nvcc, one process per
// source, C interface, ctypes).
//
// Replaces (cooper_mapper_tpu/ops/pallas/knn_stream.py), for every static k
// the TPU kernel takes:
//   knn_kernel<K, QPT>   <- knn_pallas / _knn_kernel  (and _knn_kernel_v2, the
//                           same function with another extraction scheme),
//                           1 <= k <= KNN_REG_MAX_K: the lists in registers
//   knn_select_kernel    <- the same, KNN_REG_MAX_K < k <= M: a select-then-
//                           sort route (below)
//
// What it computes.  For every query q of problem b, the K reference points
// j = 0..M-1 of that problem's reference (batch stride 0 = one reference
// shared by all problems) with the smallest
//   d(q, j) = (|q|^2 - 2 (q . r_j)) + |r_j|^2,
// where the wrapper has already set |r_j|^2 = BIG (1e12) at an invalid point,
// listed ascending by (distance, index): the order of jax.lax.top_k over the
// masked distance tile and of the TPU kernel.  Outputs idx [B,Q,K] int32 and
// d [B,Q,K] f32.  knn_kernel is built for every K from 1 to KNN_REG_MAX_K
// (5 is the scan-to-map neighbourhood, 10 the feature classifier's; its
// design: knn_lists.cuh); a larger k takes knn_select_kernel, which returns
// the same lists.
//
// Order, ties and rounding: the register lists' (knn_lists.cuh).  Both
// routes evaluate d with the plain PyTorch version's operations in its order
// (cooper_mapper_torch/ops/knn.py, via races.pairwise_sq_dist), so kernel
// and plain version agree bit for bit.
//
// knn_select_kernel: k above KNN_REG_MAX_K, up to M.  A list of k entries
// per query does not fit in registers, so a block serves one query and
// selects instead of inserting.  Each point's 64-bit key is
// (ordered bits of d) << 32 | j: unsigned order of the keys is the (d, j)
// order, and no two keys are equal.  A radix select (8 bits per pass, the
// most significant first) finds the k-th smallest key: each pass counts, in
// a 256-bin shared histogram, the digits of the points whose higher digits
// equal the prefix found so far, and stops as soon as the chosen bin holds
// exactly the entries still wanted.  Then every point whose key is at or
// under the prefix (exactly k points) is gathered, the k keys are sorted
// (bitonic, in shared memory up to SEL_SMEM_KEYS keys, else in a scratch row
// of device memory), and the output is written in order, each distance
// recomputed from its index by the same operations.  A point whose d is NaN
// or +inf is left out, as the register lists leave it out (it never
// compares below +inf), and a row of F < k such points ends in
// (+inf, 0), (+inf, 1), ... as the register lists' untouched slots do; so a
// NaN query gives (+inf, 0..k-1) on both routes.  No point is read from
// shared memory: a pass re-reads the reference from the L1 / L2 caches and
// recomputes d (8 FP32 operations) rather than keeping M keys per query.

#include "knn_lists.cuh"

namespace {

// ---------------------------------------------------------------------------
// knn_select_kernel: k > KNN_REG_MAX_K
// ---------------------------------------------------------------------------

constexpr int SEL_THREADS = 256;
constexpr int SEL_BINS = 256;          // 8 bits of the key per pass
constexpr int SEL_SMEM_KEYS = 4096;    // sorted in shared memory up to this many keys

// The float's bits as an unsigned that orders as the float does (negative
// values below positive ones); d is never -0 here (|r|^2 >= +0 is added last).
__device__ __forceinline__ unsigned ordered_bits(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Sort n (a power of two) keys ascending, all threads of the block; a may be
// shared or device memory (__syncthreads orders both within a block).
__device__ void bitonic_sort(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n / 2; i += SEL_THREADS) {
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
// (d, j) order.  P: k rounded up to a power of two; with P > SEL_SMEM_KEYS
// the keys are sorted in scratch [gridDim.x, P].
__global__ void __launch_bounds__(SEL_THREADS)
knn_select_kernel(const float* __restrict__ q, const float* __restrict__ r,
                  const float* __restrict__ rn, float* __restrict__ out_d,
                  int* __restrict__ out_i, unsigned long long* __restrict__ scratch, int Q,
                  int M, long long r_bstride, int k, int P, long long t0) {
  __shared__ unsigned hist[SEL_BINS];
  __shared__ unsigned long long skeys[SEL_SMEM_KEYS];
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
    for (int i = threadIdx.x; i < SEL_BINS; i += SEL_THREADS) hist[i] = 0u;
    __syncthreads();
    for (int base = 0; base < M; base += SEL_THREADS) {
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
  unsigned long long* keys = P <= SEL_SMEM_KEYS ? skeys : scratch + (long long)blockIdx.x * P;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  if (any) {
    for (int j = threadIdx.x; j < M; j += SEL_THREADS) {
      bool in;
      const unsigned long long key = key_of(j, in);
      if (in && (key >> shift) <= prefix) keys[atomicAdd(&s_count, 1)] = key;
    }
  }
  __syncthreads();
  const int kk = s_count;
  for (int i = kk + threadIdx.x; i < P; i += SEL_THREADS) keys[i] = ~0ull;
  bitonic_sort(keys, P);
  const long long o = t * k;
  for (int p = threadIdx.x; p < k; p += SEL_THREADS) {
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

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

}  // namespace

// C interface.  Pointers are device pointers of contiguous f32/i32 tensors:
// q [B,Q,3]; r [*,M,3]; rn [*,M]; outputs [B,Q,k]; r_bstride is the
// reference's batch stride in points (0 = shared).  Any B >= 1.  Each
// returns the cudaGetLastError() code of its launches (0 = launched), or
// cudaErrorInvalidValue for a k its route does not serve.
extern "C" {

// The largest k of the register lists (cooper_knn); above it, and up to M,
// cooper_knn_select.
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

// Keys each query's sort needs: k rounded up to a power of two.  When it is
// above cooper_knn_select_smem_keys(), the caller passes a scratch of
// [rows, keys] 64-bit words, and the queries are launched rows at a time.
int cooper_knn_select_keys(int k) { return pow2_at_least(k); }
int cooper_knn_select_smem_keys() { return SEL_SMEM_KEYS; }

// The select route, KNN_REG_MAX_K < k <= M (any 1 <= k <= M is served).
// scratch [rows, cooper_knn_select_keys(k)] u64 when the keys exceed
// shared memory (unused, may be null, otherwise; rows >= 1).
int cooper_knn_select(const float* q, const float* r, const float* rn, float* out_d,
                      int* out_i, void* scratch, int B, int Q, int M, int r_bstride, int k,
                      long long rows, void* stream) {
  if (k < 1 || k > M) return (int)cudaErrorInvalidValue;
  const int P = pow2_at_least(k);
  const long long n = (long long)B * Q;
  const long long step = P <= SEL_SMEM_KEYS ? (long long)1 << 30 : rows;
  if (step < 1) return (int)cudaErrorInvalidValue;
  for (long long t0 = 0; t0 < n; t0 += step) {
    const long long nb = n - t0 < step ? n - t0 : step;
    knn_select_kernel<<<(unsigned)nb, SEL_THREADS, 0, (cudaStream_t)stream>>>(
        q, r, rn, out_d, out_i, (unsigned long long*)scratch, Q, M, r_bstride, k, P, t0);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
