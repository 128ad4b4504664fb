// K3-K7: projective point arithmetic for the MSM.
//
// Replaces the Pallas kernels of mina_bridge_tpu/curves/pallas_kernels.py
// (all launched through _pallas_apply, BLOCK = 1024 lanes):
//   K3 padd               (body padd_rows): complete add, RCB16 Alg 7; here
//      also the MSM's bucket weighting (padd_weight_sum: sum_d d B_d for
//      every window in one launch) and its fix-up of the buckets whose
//      segment crosses a lane (padd_fixup, one launch)
//   K4 pdouble            (body pdouble_rows): doubling, RCB16 Alg 9; here
//      k doublings in one launch
//   K5 padd_select        (body padd_select_rows): mask ? q : p + q; here
//      also the MSM's whole Blelloch lane repair in one launch
//      (padd_select_scan)
//   K6 padd_mixed_select2 (body padd_mixed_select2_rows): keep_q ? q :
//      (q_inf ? p : p +mixed q), RCB16 Alg 8, q given as (x, y) rows with
//      Z = 1 - q_inf; here all T steps of the MSM's chunked scan in one
//      launch (the TPU ran one wave of the scan per call)
//   K7 padd_mixed_select  (body padd_mixed_select_rows): the same with a
//      3-row q whose Z row is exactly 0 (identity) or 1 (affine)
// The formulas, and the per-thread steps of the three MSM phases, are in
// points.cuh.
//
// Layout: the rows layout of the JAX package, (nrows, 22, N) int64 limbs
// with the lane last, so thread n reads limb l of coordinate c at
// (c * 22 + l) * N + n and a warp's loads are contiguous.
//
// K3 padd, K5 padd_select, K7: one add per lane and launch. Bound on this
// card: bytes at wide shapes (11-14 products a lane, ~6-7 k 32-bit
// multiply-adds, against 1-1.6 KB of int64 limbs in and out), launches at
// the narrow ones. With one thread a lane (padd, padd_select) a wide
// launch has ~1 warp a scheduler, and each thread's chain of ~25
// products sets the time instead (PERF.md); K7 splits each lane over six
// threads (points.cuh, k7): its conversions and its add run as a program
// of six phases, one inlined mul32 for all its products.
//
// K4, K6 and the MSM phases are chains, and a chain is bound by the
// latency of its instructions, not by bytes: K4 walks 13 doublings per
// Horner window on one lane; K6 walks T = N / G scan steps per lane with
// few warps per SM; the weighting walks S buckets a thread and then a
// log-depth tree; the lane repair runs 2 log2 G dependent levels of one
// block. Each keeps its points as Montgomery words (in registers, or in
// shared memory between a block's levels), runs in one launch instead of
// one launch a step, and takes every product from one out-of-line
// fld::mul32 body (the 32-bit carry-chain product, 1.43x faster than mul
// as a lone chain): inlined, a scan step's ~20 products fill the
// instruction cache. K3 padd and K5 padd_select take the same body. The
// K6 scan loads a step's operands when the step starts: a step is ~20 us
// of a warp's instructions, so the loads land long before use (a cp.async
// prefetch of step t + 1 into shared memory ran a few per cent slower on
// the H100; PERF.md).
#include <cuda_runtime.h>

#include "points.cuh"

namespace {

using fld::Fe;
using pts::Pt;

constexpr int THREADS = 128;
constexpr int SCAN_THREADS = 64;
constexpr int PHASE_THREADS = 256;  // the lane repair's blocks, the most the weighting's take
constexpr size_t MAX_SHARED = 232448;  // bytes a block may take on an H100
constexpr int MUL = fld::MUL32_CALL;
// K7's lanes a block (scripts/torch_kernel_sweep.py took 32 of 16, 32 and
// 64; PERF.md), six threads a lane; at least 5 blocks an SM, so the 640
// blocks of 20,480 lanes are resident in one wave on 132 SMs.
constexpr int K7_LANES = 32, K7_THREADS = pts::k7::TASKS * K7_LANES, K7_MIN_BLOCKS = 5;

unsigned blocks_for(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <int F>
__global__ void padd_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                            int64_t* __restrict__ out, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  pts::store_pt<F, MUL>(pts::padd_f<F, MUL>(pts::load_pt<F, MUL>(p, n, N), pts::load_pt<F, MUL>(q, n, N)), out, n,
                        N);
}

template <int F>
__global__ void pdouble_kernel(const int64_t* __restrict__ p, int64_t* __restrict__ out, int64_t N, int k) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  Pt r = pts::load_pt<F, MUL>(p, n, N);
  for (int i = 0; i < k; i++) r = pts::pdouble_f<F, MUL>(r);
  pts::store_pt<F, MUL>(r, out, n, N);
}

template <int F>
__global__ void padd_select_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                                   const int32_t* __restrict__ keep_q, int64_t* __restrict__ out,
                                   int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Pt qp = pts::load_pt<F, MUL>(q, n, N);
  if (keep_q[n]) {
    pts::store_pt<F, MUL>(qp, out, n, N);
    return;
  }
  pts::store_pt<F, MUL>(pts::padd_f<F, MUL>(pts::load_pt<F, MUL>(p, n, N), qp), out, n, N);
}

// K6 over a whole chunked scan. Lane n = w * G + g owns stream positions
// [n * T, (n + 1) * T) of the (W, N = G * T) plane, which is window w's
// chunk g; step t combines the lane's carry with position n * T + t:
//   keep_q ? (x, y, 1 - q_inf) : (q_inf ? carry : carry +mixed (x, y)),
// and writes the new carry to vals[t] as canonical limbs.
//   carry: (3, 22, W * G) the carry before step 0
//   xy:    (2, 22, W * N) the sorted x and y rows (row stride W * N)
//   keep_q, q_inf: (W * N) int32
//   vals:  (T, 3, 22, W * G)
template <int F>
__global__ void __launch_bounds__(SCAN_THREADS)
    padd_mixed_select2_scan_kernel(const int64_t* __restrict__ carry, const int64_t* __restrict__ xy,
                                   const int32_t* __restrict__ keep_q, const int32_t* __restrict__ q_inf,
                                   int64_t* __restrict__ vals, int64_t lanes, int64_t T) {
  constexpr int P = MUL;
  const int64_t n = (int64_t)blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (n >= lanes) return;
  const int64_t plane = lanes * T;
  const int64_t step = 3 * (int64_t)fld::REP_LIMBS * lanes;
  Pt acc = pts::load_pt<F, P>(carry, n, lanes);
  for (int64_t t = 0; t < T; t++) {
    const int64_t pos = n * T + t;
    const Fe x2 = fld::from_limbs<F, P>(xy + pos, plane);
    const Fe y2 = fld::from_limbs<F, P>(xy + fld::REP_LIMBS * plane + pos, plane);
    const int inf = q_inf[pos];
    if (keep_q[pos])
      acc = Pt{x2, y2, inf ? fld::zero<F>() : fld::one<F>()};
    else if (!inf)
      acc = pts::padd_mixed_f<F, P>(acc, x2, y2);
    pts::store_pt<F, P>(acc, vals + t * step, n, lanes);
  }
}

// K3, the bucket weighting (points.cuh: weight_walk, weight_merge). Grid
// (B, W): block (b, w) takes chunks b C .. (b + 1) C - 1 of window w, one a
// thread (C = blockDim.x, K = B C chunks, S = D / K buckets a chunk), walks
// them, and reduces its C chunks by the tree in shared memory. With B > 1
// each block writes its root (tw, ma) to partials (W, 2 B) Montgomery
// points; the last block of a window to finish (counters (W,) start at 0)
// reads them back and runs the tree's last log2 B levels. The sums are the
// same as one tree over all K chunks, so B does not change the result.
//   buckets: (3, 22, W, D + 1), bucket 0 unread; out: (3, 22, W)
template <int F>
__global__ void __launch_bounds__(PHASE_THREADS)
    padd_weight_sum_kernel(const int64_t* __restrict__ buckets, int64_t* __restrict__ out, Pt* partials,
                           int* counters, int W, int D, int K) {
  extern __shared__ uint64_t smem[];
  __shared__ int is_last;
  Pt* tw = reinterpret_cast<Pt*>(smem);
  Pt* ma = tw + blockDim.x;
  const int C = blockDim.x, B = gridDim.x, b = blockIdx.x, w = blockIdx.y, j = threadIdx.x;
  const int S = D / K;
  Pt tot, run;
  pts::weight_walk<F, MUL>(buckets, (int64_t)w * (D + 1) + (int64_t)(b * C + j) * S + 1, (int64_t)W * (D + 1), S,
                           tot, run);
  tw[j] = tot;
  ma[j] = run;
  __syncthreads();
  for (int s = 1; s < C; s <<= 1) {
    pts::weight_merge<F, MUL>(tw, ma, j, C / 2, s, C, 2 * s < K);
    __syncthreads();
  }
  if (B > 1) {
    Pt* part = partials + (int64_t)w * 2 * B;
    if (j == 0) {
      part[b] = tw[0];
      part[B + b] = ma[0];
      __threadfence();
      is_last = atomicAdd(&counters[w], 1) == B - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (j < B) {  // the blocks' roots, read past L1 (B <= C)
      const auto* src_tw = reinterpret_cast<const unsigned long long*>(part + j);
      const auto* src_ma = reinterpret_cast<const unsigned long long*>(part + B + j);
      auto* dst_tw = reinterpret_cast<unsigned long long*>(tw + j);
      auto* dst_ma = reinterpret_cast<unsigned long long*>(ma + j);
      for (int k = 0; k < (int)(sizeof(Pt) / 8); k++) {
        dst_tw[k] = __ldcg(src_tw + k);
        dst_ma[k] = __ldcg(src_ma + k);
      }
    }
    __syncthreads();
    for (int s = 1; s < B; s <<= 1) {
      pts::weight_merge<F, MUL>(tw, ma, j, C / 2, s, B, 2 * s < B);
      __syncthreads();
    }
  }
  if (j == 0) pts::store_pt<F, MUL>(tw[0], out, w, W);
}

// K3, the fix-up (points.cuh: fixup_lane): one thread per lane (w, g) of
// the chunked scan, at most one add each, in place in buckets.
//   buckets: (3, 22, W, NB); inflow: (3, 22, W, G); dig: (W, G T) int64
template <int F>
__global__ void padd_fixup_kernel(int64_t* __restrict__ buckets, const int64_t* __restrict__ inflow,
                                  const int64_t* __restrict__ dig, int64_t W, int64_t G, int64_t T, int64_t NB) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= W * G) return;
  pts::fixup_lane<F, MUL>(buckets, inflow, dig, n / G, n % G, W, G, T, NB);
}

// K5, the lane repair (points.cuh: lane_up, lane_down): one block per
// window runs the in-place Blelloch scan over its G lanes, a level between
// barriers. The lanes' points sit in shared memory, or in scratch (W, G)
// in device memory when scratch is given (G too large for shared memory);
// the flags always in shared memory.
//   carry: (3, 22, W, G); has_start: (W, G) int32; out: (3, 22, W, G)
template <int F>
__global__ void __launch_bounds__(PHASE_THREADS)
    padd_select_scan_kernel(const int64_t* __restrict__ carry, const int32_t* __restrict__ has_start,
                            int64_t* __restrict__ out, Pt* scratch, int W, int G) {
  extern __shared__ uint64_t smem[];
  const int w = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  Pt* a;
  int32_t* f;
  if (scratch) {
    a = scratch + (int64_t)w * G;
    f = reinterpret_cast<int32_t*>(smem);
  } else {
    a = reinterpret_cast<Pt*>(smem);
    f = reinterpret_cast<int32_t*>(a + G);
  }
  const int64_t lanes = (int64_t)W * G, base = (int64_t)w * G;
  for (int i = t; i < G; i += nt) {
    a[i] = pts::load_pt<F, MUL>(carry, base + i, lanes);
    f[i] = has_start[base + i] != 0;
  }
  __syncthreads();
  for (int s = 1; s < G; s <<= 1) {
    for (int m = t; m < G / (2 * s); m += nt) pts::lane_up<F, MUL>(a, f, m, s);
    __syncthreads();
  }
  if (t == 0) a[G - 1] = pts::identity<F>();
  __syncthreads();
  for (int s = G / 2; s >= 1; s >>= 1) {
    for (int m = t; m < G / (2 * s); m += nt) pts::lane_down<F, MUL>(a, f, m, s);
    __syncthreads();
  }
  for (int i = t; i < G; i += nt) pts::store_pt<F, MUL>(a[i], out, base + i, lanes);
}

// K7 (points.cuh: k7::block): K7_LANES lanes a block, six threads a lane.
template <int F>
__global__ void __launch_bounds__(K7_THREADS, K7_MIN_BLOCKS)
    padd_mixed_select_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                             const int32_t* __restrict__ keep_q, const int32_t* __restrict__ q_inf,
                             int64_t* __restrict__ out, int64_t N) {
  extern __shared__ uint64_t slots[];
  pts::k7::block<F>(K7_LANES, slots, p, q, keep_q, q_inf, out, N);
}

}  // namespace

// p, q, out: (3, 22, N) int64 rows. Each returns cudaGetLastError().
extern "C" int mbt_padd(int field, const int64_t* p, const int64_t* q, int64_t* out, int64_t N,
                        void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      padd_kernel<0><<<blocks_for(N, THREADS), THREADS, 0, s>>>(p, q, out, N);
    else
      padd_kernel<1><<<blocks_for(N, THREADS), THREADS, 0, s>>>(p, q, out, N);
  }
  return (int)cudaGetLastError();
}

// k >= 1 doublings of each lane.
extern "C" int mbt_pdouble(int field, const int64_t* p, int64_t* out, int64_t N, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      pdouble_kernel<0><<<blocks_for(N, THREADS), THREADS, 0, s>>>(p, out, N, k);
    else
      pdouble_kernel<1><<<blocks_for(N, THREADS), THREADS, 0, s>>>(p, out, N, k);
  }
  return (int)cudaGetLastError();
}

// keep_q: (N,) int32.
extern "C" int mbt_padd_select(int field, const int64_t* p, const int64_t* q, const int32_t* keep_q,
                               int64_t* out, int64_t N, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      padd_select_kernel<0><<<blocks_for(N, THREADS), THREADS, 0, s>>>(p, q, keep_q, out, N);
    else
      padd_select_kernel<1><<<blocks_for(N, THREADS), THREADS, 0, s>>>(p, q, keep_q, out, N);
  }
  return (int)cudaGetLastError();
}

// carry: (3, 22, W, G); xy: (2, 22, W, N) with N = G * T; keep_q, q_inf:
// (W, N) int32; vals: (T, 3, 22, W, G).
extern "C" int mbt_padd_mixed_select2_scan(int field, const int64_t* carry, const int64_t* xy,
                                           const int32_t* keep_q, const int32_t* q_inf, int64_t* vals,
                                           int64_t W, int64_t G, int64_t T, void* stream) {
  if (W < 0 || G < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const int64_t lanes = W * G;
  if (lanes > 0 && T > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned b = blocks_for(lanes, SCAN_THREADS);
    if (field == 0)
      padd_mixed_select2_scan_kernel<0><<<b, SCAN_THREADS, 0, s>>>(carry, xy, keep_q, q_inf, vals, lanes, T);
    else
      padd_mixed_select2_scan_kernel<1><<<b, SCAN_THREADS, 0, s>>>(carry, xy, keep_q, q_inf, vals, lanes, T);
  }
  return (int)cudaGetLastError();
}

static bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// K3's bucket weighting. buckets: (3, 22, W, D + 1); out: (3, 22, W);
// partials: W * 2 * (K / C) Montgomery points of scratch; counters: (W,)
// int32, zero. D, K and C powers of two with C <= K <= D, C <= 256 and
// K / C <= C.
extern "C" int mbt_padd_weight_sum(int field, const int64_t* buckets, int64_t* out, void* partials, int* counters,
                                   int64_t W, int64_t D, int64_t K, int64_t C, void* stream) {
  if (W < 0 || !pow2(D) || !pow2(K) || !pow2(C) || K > D || C > K || C > PHASE_THREADS ||
      K / C > C || W > 65535)
    return (int)cudaErrorInvalidValue;
  if (W > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = 2 * C * sizeof(Pt);
    const dim3 grid((unsigned)(K / C), (unsigned)W);
    Pt* part = (Pt*)partials;
    if (field == 0) {
      cudaFuncSetAttribute(padd_weight_sum_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      padd_weight_sum_kernel<0><<<grid, (unsigned)C, smem, s>>>(buckets, out, part, counters, (int)W, (int)D, (int)K);
    } else {
      cudaFuncSetAttribute(padd_weight_sum_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      padd_weight_sum_kernel<1><<<grid, (unsigned)C, smem, s>>>(buckets, out, part, counters, (int)W, (int)D, (int)K);
    }
  }
  return (int)cudaGetLastError();
}

// K3's fix-up, in place. buckets: (3, 22, W, NB); inflow: (3, 22, W, G);
// dig: (W, G * T) int64, each digit in [0, NB).
extern "C" int mbt_padd_fixup(int field, int64_t* buckets, const int64_t* inflow, const int64_t* dig, int64_t W,
                              int64_t G, int64_t T, int64_t NB, void* stream) {
  if (W < 0 || G < 0 || T < 1 || NB < 1) return (int)cudaErrorInvalidValue;
  const int64_t lanes = W * G;
  if (lanes > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      padd_fixup_kernel<0><<<blocks_for(lanes, THREADS), THREADS, 0, s>>>(buckets, inflow, dig, W, G, T, NB);
    else
      padd_fixup_kernel<1><<<blocks_for(lanes, THREADS), THREADS, 0, s>>>(buckets, inflow, dig, W, G, T, NB);
  }
  return (int)cudaGetLastError();
}

// K5's lane repair. carry, out: (3, 22, W, G); has_start: (W, G) int32;
// G a power of two. scratch: null (points in shared memory) or W * G
// Montgomery points.
extern "C" int mbt_padd_select_scan(int field, const int64_t* carry, const int32_t* has_start, int64_t* out,
                                    void* scratch, int64_t W, int64_t G, void* stream) {
  const size_t smem = (size_t)G * (sizeof(int32_t) + (scratch ? 0 : sizeof(Pt)));
  if (W < 0 || W > 0x7fffffff || !pow2(G) || smem > MAX_SHARED) return (int)cudaErrorInvalidValue;
  if (W > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    Pt* sc = (Pt*)scratch;
    if (field == 0) {
      cudaFuncSetAttribute(padd_select_scan_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      padd_select_scan_kernel<0><<<(unsigned)W, PHASE_THREADS, smem, s>>>(carry, has_start, out, sc, (int)W, (int)G);
    } else {
      cudaFuncSetAttribute(padd_select_scan_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      padd_select_scan_kernel<1><<<(unsigned)W, PHASE_THREADS, smem, s>>>(carry, has_start, out, sc, (int)W, (int)G);
    }
  }
  return (int)cudaGetLastError();
}

// q: (3, 22, N) int64 rows with a Z row of 0 or 1; keep_q, q_inf: (N,) int32.
extern "C" int mbt_padd_mixed_select(int field, const int64_t* p, const int64_t* q,
                                     const int32_t* keep_q, const int32_t* q_inf, int64_t* out,
                                     int64_t N, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = pts::k7::block_bytes(K7_LANES);  // 25,728 bytes
    const unsigned b = blocks_for(N, K7_LANES);
    if (field == 0)
      padd_mixed_select_kernel<0><<<b, K7_THREADS, smem, s>>>(p, q, keep_q, q_inf, out, N);
    else
      padd_mixed_select_kernel<1><<<b, K7_THREADS, smem, s>>>(p, q, keep_q, q_inf, out, N);
  }
  return (int)cudaGetLastError();
}
