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
// The formulas, and the programs of the three MSM phases, are in
// points.cuh.
//
// Layout: the rows layout of the JAX package, (nrows, 22, N) int64 limbs
// with the lane last, so thread n reads limb l of coordinate c at
// (c * 22 + l) * N + n and a warp's loads are contiguous.
//
// K3 padd and the fix-up, K5 padd_select, K7: one add per lane and
// launch. Bound on this card: bytes at wide shapes (11-14 products a lane,
// ~6-7 k 32-bit multiply-adds, against 1-1.6 KB of int64 limbs in and
// out), launches and the dependent path at the narrow ones (the Horner
// walk's one lane). With one thread a lane a wide launch has ~1 warp a
// scheduler, and each thread's chain of ~25 products sets the time instead
// (PERF.md). So each splits a lane over threads: K7 over six (points.cuh,
// k7: its conversions and its add as a program of six phases, one inlined
// mul32 for all its products); padd, the fix-up and padd_select take up to
// 32, 64 and 32 lanes a block (split::padd_lanes, fixup_lanes,
// select_lanes: one thread a coordinate in and out, the add as one round
// of split ops, six threads a lane, two products deep), and the fix-up's
// lanes that fix no bucket and padd_select's kept lanes are dead ops that
// load and multiply nothing (a kept lane stores q).
//
// K4, K6 and the MSM phases are chains, and a chain is bound by the
// latency of its instructions, not by bytes: K4 walks 13 doublings per
// Horner window on one lane; K6 walks T = N / G scan steps per lane with
// few warps per SM; the weighting walks S buckets a chunk and then a
// log-depth tree; the lane repair runs 2 log2 G dependent levels. Each
// keeps its points as Montgomery words (in registers, or in shared memory
// between levels) and runs in one launch instead of one launch a step. K4
// and K6 take every product from one out-of-line fld::mul32 body (the
// 32-bit carry-chain product, 1.43x faster than mul as a lone chain):
// inlined, a scan step's ~20 products fill the instruction cache. The
// weighting and the repair split each point op over threads (points.cuh,
// split: two products deep, six threads an add), so a level costs two
// products' latency and a wide level fills the SMs; the weighting loads a
// block's buckets with consecutive threads on consecutive buckets, and the
// repair spreads a window over a cluster of up to 8 blocks (distributed
// shared memory for the levels above a block). The K6 scan loads a step's operands when the
// step starts: a step is ~20 us of a warp's instructions, so the loads
// land long before use (a cp.async prefetch of step t + 1 into shared
// memory ran a few per cent slower on the H100; PERF.md).
#include <cuda_runtime.h>

#include "points.cuh"

namespace {

using fld::Fe;
using pts::Pt;
namespace split = pts::split;

constexpr int THREADS = 128;
constexpr int SCAN_THREADS = 64;
constexpr size_t MAX_SHARED = 232448;  // bytes a block may take on an H100
constexpr int MUL = fld::MUL32_CALL;
// K7's lanes a block (scripts/torch_kernel_sweep.py took 32 of 16, 32 and
// 64; PERF.md), six threads a lane; at least 5 blocks an SM, so the 640
// blocks of 20,480 lanes are resident in one wave on 132 SMs.
constexpr int K7_LANES = 32, K7_THREADS = pts::k7::TASKS * K7_LANES, K7_MIN_BLOCKS = 5;

unsigned blocks_for(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// The lanes of block b: lanes a block from b * lanes, fewer in the last.
__device__ int block_lanes(int64_t n, int lanes, int64_t& first) {
  first = (int64_t)blockIdx.x * lanes;
  return n - first < lanes ? (int)(n - first) : lanes;
}

// K3, the one-step add (points.cuh: split::padd_lanes): `lanes` lanes a
// block, the block's threads on the split add's tasks.
template <int F>
__global__ void __launch_bounds__(split::THREADS, 2)
    padd_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q, int64_t* __restrict__ out, int64_t N,
                int lanes) {
  extern __shared__ uint64_t smem[];
  int64_t n0;
  const int m = block_lanes(N, lanes, n0);
  split::padd_lanes<F>(split::Threads{(int)threadIdx.x, (int)blockDim.x}, smem, p, q, out, n0, m, N);
}

template <int F>
__global__ void pdouble_kernel(const int64_t* __restrict__ p, int64_t* __restrict__ out, int64_t N, int k) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  Pt r = pts::load_pt<F, MUL>(p, n, N);
  for (int i = 0; i < k; i++) r = pts::pdouble_f<F, MUL>(r);
  pts::store_pt<F, MUL>(r, out, n, N);
}

// K5, the one-step select (points.cuh: split::select_lanes): `lanes` lanes
// a block, a kept lane's q stored, the other lanes' adds one round of
// split ops.
template <int F>
__global__ void __launch_bounds__(split::THREADS, 2)
    padd_select_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                       const int32_t* __restrict__ keep_q, int64_t* __restrict__ out, int64_t N, int lanes) {
  extern __shared__ uint64_t smem[];
  int64_t n0;
  const int m = block_lanes(N, lanes, n0);
  split::select_lanes<F>(split::Threads{(int)threadIdx.x, (int)blockDim.x}, smem, p, q, keep_q, out, n0, m, N);
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

// K3, the bucket weighting (points.cuh: split::weight_grid): a cooperative
// launch, units of C chunks walked, then the tree's levels over all
// blocks, each point op split over threads (split::THREADS a block).
//   buckets: (3, 22, W, D + 1), bucket 0 unread; out: (3, 22, W);
//   roots: W K chunk roots (6 slots each) of scratch
template <int F>
__global__ void __launch_bounds__(split::THREADS, 2)
    padd_weight_sum_kernel(const int64_t* __restrict__ buckets, int64_t* __restrict__ out, uint64_t* roots, int W,
                           int D, int K, int C) {
  extern __shared__ uint64_t smem[];
  split::weight_grid<F>(split::GridBlock{smem}, buckets, out, roots, W, D, K, C, split::NoStamp{});
}

// K3, the fix-up (points.cuh: split::fixup_lanes): `lanes` lanes (w, g)
// of the chunked scan a block, at most one add each, in place in buckets.
//   buckets: (3, 22, W, NB); inflow: (3, 22, W, G); dig: (W, G T) int64
template <int F>
__global__ void __launch_bounds__(split::THREADS, 2)
    padd_fixup_kernel(int64_t* __restrict__ buckets, const int64_t* __restrict__ inflow,
                      const int64_t* __restrict__ dig, int64_t W, int64_t G, int64_t T, int64_t NB, int lanes) {
  extern __shared__ uint64_t smem[];
  int64_t l0;
  const int m = block_lanes(W * G, lanes, l0);
  split::fixup_lanes<F>(split::Threads{(int)threadIdx.x, (int)blockDim.x}, smem, buckets, inflow, dig, l0, m, W, G,
                        T, NB);
}

// K5, the lane repair (points.cuh: split::lane_scan): a cluster of CL
// blocks a window (grid W CL), each point op split over threads
// (split::THREADS a block), block 0 running the levels above a block on
// the blocks' roots over distributed shared memory.
//   carry: (3, 22, W, G); has_start: (W, G) int32; out: (3, 22, W, G)
template <int F>
__global__ void __launch_bounds__(split::THREADS, 2)
    padd_select_scan_kernel(const int64_t* __restrict__ carry, const int32_t* __restrict__ has_start,
                            int64_t* __restrict__ out, uint64_t* scratch, int W, int G, int CL) {
  extern __shared__ uint64_t smem[];
  split::lane_scan<F>(split::ClusterBlock{smem, CL}, carry, has_start, out, scratch, W, G, split::NoStamp{});
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

// The launch shape of K3's padd and fix-up and K5's one-step select over
// n lanes: up to `most` lanes a block, six threads a lane rounded up to
// whole warps (one warp at the Horner walk's one lane).
// scripts/torch_kernel_sweep.py --parts k3 took 32 lanes a block for padd
// (faster than 64 and 16 at 4,097 and 20,480 lanes) and 64 for the fix-up
// (faster than 32 and 16 at the 2^16 MSM's shape); at one lane 32, 64 and
// 384 threads take the same time; --parts k5 took 32 for the select
// (PERF.md).
struct LaneShape {
  int lanes, threads;
};

static LaneShape lane_shape(int64_t n, int most) {
  const int lanes = n < most ? (int)n : most;
  return {lanes, (6 * lanes + 31) / 32 * 32};
}

static bool shape_ok(const LaneShape& sh) {
  return sh.lanes >= 1 && sh.lanes <= split::JOBS && sh.threads >= 1 && sh.threads <= split::THREADS;
}

// K3's padd at a given shape: `lanes` lanes a block of `threads` threads.
extern "C" int mbt_padd_at(int field, const int64_t* p, const int64_t* q, int64_t* out, int64_t N, int lanes,
                           int threads, void* stream) {
  const LaneShape sh = {lanes, threads};
  if (N < 0 || !shape_ok(sh)) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = split::pair_bytes(false);  // 37,120 bytes
    if (field == 0)
      padd_kernel<0><<<blocks_for(N, lanes), threads, smem, s>>>(p, q, out, N, lanes);
    else
      padd_kernel<1><<<blocks_for(N, lanes), threads, smem, s>>>(p, q, out, N, lanes);
  }
  return (int)cudaGetLastError();
}

// p, q, out: (3, 22, N) int64 rows. Each returns cudaGetLastError().
extern "C" int mbt_padd(int field, const int64_t* p, const int64_t* q, int64_t* out, int64_t N, void* stream) {
  const LaneShape sh = lane_shape(N > 0 ? N : 1, split::PADD_LANES);
  return mbt_padd_at(field, p, q, out, N, sh.lanes, sh.threads, stream);
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

// K5's one-step select at a given shape: `lanes` lanes a block of
// `threads` threads.
extern "C" int mbt_padd_select_at(int field, const int64_t* p, const int64_t* q, const int32_t* keep_q, int64_t* out,
                                  int64_t N, int lanes, int threads, void* stream) {
  if (N < 0 || !shape_ok({lanes, threads})) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = split::pair_bytes(true);  // 37,632 bytes
    if (field == 0)
      padd_select_kernel<0><<<blocks_for(N, lanes), threads, smem, s>>>(p, q, keep_q, out, N, lanes);
    else
      padd_select_kernel<1><<<blocks_for(N, lanes), threads, smem, s>>>(p, q, keep_q, out, N, lanes);
  }
  return (int)cudaGetLastError();
}

// keep_q: (N,) int32.
extern "C" int mbt_padd_select(int field, const int64_t* p, const int64_t* q, const int32_t* keep_q,
                               int64_t* out, int64_t N, void* stream) {
  const LaneShape sh = lane_shape(N > 0 ? N : 1, split::SELECT_LANES);
  return mbt_padd_select_at(field, p, q, keep_q, out, N, sh.lanes, sh.threads, stream);
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

// K3's bucket weighting: its launch's shared memory, or 0 if the
// arguments are refused. D, K and C powers of two with C <= K <= D, at
// most 65535 windows, and a unit (C chunks of S = D / K buckets) in shared
// memory.
static size_t weight_sum_smem(int64_t W, int64_t D, int64_t K, int64_t C) {
  if (W < 0 || W > 65535 || !pow2(D) || !pow2(K) || !pow2(C) || K > D || C > K) return 0;
  const size_t smem = split::weight_bytes((int)(D / K), (int)C);
  return smem > MAX_SHARED ? 0 : smem;
}

// The launch setup of kernel k (0, 1: the weighting on field 0, 1; 2, 3:
// the repair) on the current device for smem bytes of shared memory: the
// most shared memory allowed so far (cudaFuncSetAttribute, raised only
// when a launch needs more) and the blocks the card holds at once at the
// last size asked. Kept for the process, so that a launch at the size of
// the one before makes no attribute or occupancy query.
struct LaunchSetup {
  size_t allowed, smem;
  int64_t held;
};

constexpr int SETUP_DEVICES = 16;

static LaunchSetup launch_setup(int k, const void* fn, size_t smem) {
  static LaunchSetup cache[4][SETUP_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  LaunchSetup none = {};
  LaunchSetup& c = dev < SETUP_DEVICES ? cache[k][dev] : none;
  if (c.smem == smem && c.allowed >= smem) return c;
  if (c.allowed < smem) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    c.allowed = smem;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, split::THREADS, smem);
  c.smem = smem;
  c.held = (int64_t)sms * per_sm;
  return c;
}

// The weighting's blocks: as many as the card holds at once (its
// cooperative launch needs them all resident), at most one a chunk.
static unsigned weight_sum_blocks(int64_t units, const LaunchSetup& setup) {
  return (unsigned)(units < setup.held ? units : setup.held);
}

template <int F>
static void launch_weight_sum(const int64_t* buckets, int64_t* out, void* roots, int64_t W, int64_t D, int64_t K,
                              int64_t C, size_t smem, cudaStream_t s) {
  const void* fn = (const void*)padd_weight_sum_kernel<F>;
  const LaunchSetup setup = launch_setup(F, fn, smem);
  int w = (int)W, d = (int)D, k = (int)K, c = (int)C;
  void* args[] = {(void*)&buckets, (void*)&out, (void*)&roots, &w, &d, &k, &c};
  cudaLaunchCooperativeKernel(fn, weight_sum_blocks(W * K, setup), split::THREADS, args, smem, s);
}

// K3's bucket weighting. buckets: (3, 22, W, D + 1); out: (3, 22, W);
// roots: W K chunk roots (W * 2 * K Montgomery points) of scratch.
extern "C" int mbt_padd_weight_sum(int field, const int64_t* buckets, int64_t* out, void* roots, int64_t W, int64_t D,
                                   int64_t K, int64_t C, void* stream) {
  const size_t smem = weight_sum_smem(W, D, K, C);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (W > 0)
    (field == 0 ? launch_weight_sum<0> : launch_weight_sum<1>)(buckets, out, roots, W, D, K, C, smem,
                                                               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K3's fix-up at a given shape: `lanes` lanes a block of `threads` threads.
extern "C" int mbt_padd_fixup_at(int field, int64_t* buckets, const int64_t* inflow, const int64_t* dig, int64_t W,
                                 int64_t G, int64_t T, int64_t NB, int lanes, int threads, void* stream) {
  if (W < 0 || G < 0 || T < 1 || NB < 1 || !shape_ok({lanes, threads})) return (int)cudaErrorInvalidValue;
  const int64_t n = W * G;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = split::pair_bytes(true);  // 37,632 bytes
    if (field == 0)
      padd_fixup_kernel<0><<<blocks_for(n, lanes), threads, smem, s>>>(buckets, inflow, dig, W, G, T, NB, lanes);
    else
      padd_fixup_kernel<1><<<blocks_for(n, lanes), threads, smem, s>>>(buckets, inflow, dig, W, G, T, NB, lanes);
  }
  return (int)cudaGetLastError();
}

// K3's fix-up, in place. buckets: (3, 22, W, NB); inflow: (3, 22, W, G);
// dig: (W, G * T) int64, each digit in [0, NB).
extern "C" int mbt_padd_fixup(int field, int64_t* buckets, const int64_t* inflow, const int64_t* dig, int64_t W,
                              int64_t G, int64_t T, int64_t NB, void* stream) {
  const LaneShape sh = lane_shape(W > 0 && G > 0 ? W * G : 1, split::FIXUP_LANES);
  return mbt_padd_fixup_at(field, buckets, inflow, dig, W, G, T, NB, sh.lanes, sh.threads, stream);
}

// K5's lane repair: its launch's shared memory (the lanes' points unless
// they are in scratch, the round scratch, block 0's top items, the flags),
// or 0 if the arguments are refused.
static size_t lane_scan_smem(int64_t W, int64_t G, bool scratch) {
  if (W < 0 || !pow2(G) || W * split::lane_cluster(G) > 0x7fffffff) return 0;
  const int Gc = (int)(G / split::lane_cluster(G));
  const size_t smem = split::lane_bytes(Gc, scratch);
  return smem > MAX_SHARED ? 0 : smem;
}

// A cluster launch of the lane repair: CL blocks a window.
static cudaLaunchConfig_t lane_scan_config(int64_t W, int64_t G, size_t smem, cudaStream_t s,
                                           cudaLaunchAttribute* attr) {
  const int CL = split::lane_cluster(G);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(W * CL));
  cfg.blockDim = dim3(split::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int F>
static void launch_lane_scan(const int64_t* carry, const int32_t* has_start, int64_t* out, void* scratch, int64_t W,
                             int64_t G, size_t smem, cudaStream_t s) {
  launch_setup(2 + F, (const void*)padd_select_scan_kernel<F>, smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = lane_scan_config(W, G, smem, s, &attr);
  cudaLaunchKernelEx(&cfg, padd_select_scan_kernel<F>, carry, has_start, out, (uint64_t*)scratch, (int)W, (int)G,
                     split::lane_cluster(G));
}

// K5's lane repair. carry, out: (3, 22, W, G); has_start: (W, G) int32;
// G a power of two. scratch: null (points in shared memory) or W * G
// Montgomery points.
extern "C" int mbt_padd_select_scan(int field, const int64_t* carry, const int32_t* has_start, int64_t* out,
                                    void* scratch, int64_t W, int64_t G, void* stream) {
  const size_t smem = lane_scan_smem(W, G, scratch != nullptr);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (W > 0)
    (field == 0 ? launch_lane_scan<0> : launch_lane_scan<1>)(carry, has_start, out, scratch, W, G, smem,
                                                             (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// What a launch of the weighting (kind 0: n = D, K, C) or the lane repair
// (kind 1: n = G, K = 1 if its lanes are in scratch) gets on this card:
// info[0..5] = the weighting's units (all windows) or the repair's blocks
// a window (its cluster), threads a block, shared memory bytes a block,
// registers a thread, blocks an SM can hold, and the weighting's blocks in
// all or the clusters the card can hold at once (the repair). Returns a
// CUDA error, or cudaErrorInvalidValue for refused arguments.
extern "C" int mbt_split_launch_info(int kind, int64_t W, int64_t n, int64_t K, int64_t C, int64_t* info) {
  const bool lane = kind == 1;
  const size_t smem = lane ? lane_scan_smem(W, n, K != 0) : weight_sum_smem(W, n, K, C);
  if (smem == 0 || W < 1) return (int)cudaErrorInvalidValue;
  const void* fn = lane ? (const void*)padd_select_scan_kernel<0> : (const void*)padd_weight_sum_kernel<0>;
  const LaunchSetup setup = launch_setup(lane ? 2 : 0, fn, smem);
  cudaFuncAttributes fa;
  int per_sm = 0, clusters = 0;
  cudaFuncGetAttributes(&fa, fn);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, split::THREADS, smem);
  if (lane) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = lane_scan_config(W, n, smem, nullptr, &attr);
    cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  }
  info[5] = lane ? clusters : weight_sum_blocks(W * K, setup);
  info[0] = lane ? split::lane_cluster(n) : split::weight_units((int)W, (int)K, (int)C, (int)info[5]);
  info[1] = split::THREADS;
  info[2] = (int64_t)smem;
  info[3] = fa.numRegs;
  info[4] = per_sm;
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
