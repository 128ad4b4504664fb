// K7 split into its parts, for scripts/torch_kernel_sweep.py only: no path
// of the system calls these kernels. Each computes K7's function
// (keep_q ? q : (q_inf ? p : p +mixed q)) or a part of it:
//   kind 0, copy: keep_q ? q : p through from_limbs and to_limbs, no add,
//   one thread a lane;
//   kind 1, whole: the masks, then load_pt, padd_mixed_f and store_pt, one
//   thread a lane (the form K7 had before it took six threads a lane);
// prod picks the product of every site of kinds 0 and 1: 0 MUL64 (mul
// inlined at each), 1 MUL32_CALL (one out-of-line mul32), 2 MUL32 (mul32
// inlined at each, below);
//   kind 2, serial program: points.cu's K7 program (points.cuh, k7) with
//   all six phases' tasks of a lane run by one thread (prod unread);
//   kind 3, points.cu's kernel at `threads` / 6 lanes a block (16, 32 or
//   64; prod unread).
#include <cuda_runtime.h>

#include "points.cuh"

// MUL32: the points.cuh formulas' products as mul32 inlined at each site.
constexpr int MUL32 = 2;
namespace fld {
template <>
FHD Fe mulx<0, MUL32>(const Fe& a, const Fe& b) {
  return mul32<0>(a, b);
}
template <>
FHD Fe mulx<1, MUL32>(const Fe& a, const Fe& b) {
  return mul32<1>(a, b);
}
}  // namespace fld

namespace {

using fld::Fe;
using pts::Pt;

template <int F, int P, bool COPY>
__global__ void split_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                             const int32_t* __restrict__ keep_q, const int32_t* __restrict__ q_inf,
                             int64_t* __restrict__ out, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  if (keep_q[n]) {
    pts::store_pt<F, P>(pts::load_pt<F, P>(q, n, N), out, n, N);
    return;
  }
  const Pt pp = pts::load_pt<F, P>(p, n, N);
  if (COPY || q_inf[n]) {
    pts::store_pt<F, P>(pp, out, n, N);
    return;
  }
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  const Fe x2 = fld::from_limbs<F, P>(q + n, N);
  const Fe y2 = fld::from_limbs<F, P>(q + cs + n, N);
  pts::store_pt<F, P>(pts::padd_mixed_f<F, P>(pp, x2, y2), out, n, N);
}

template <int F>
__global__ void serial_program_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                                      const int32_t* __restrict__ keep_q, const int32_t* __restrict__ q_inf,
                                      int64_t* __restrict__ out, int64_t N) {
  extern __shared__ uint64_t slots[];
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const pts::k7::Slots S{slots, (int)blockDim.x, (int)threadIdx.x};
  const int sel = pts::k7::select(keep_q[n], q_inf[n]);
#pragma unroll 1
  for (int phase = 0; phase < pts::k7::PHASES; phase++)
#pragma unroll 1
    for (int t = 0; t < pts::k7::TASKS; t++) pts::k7::task<F>(phase, t, S, sel, p, q, out, n, N);
}

// As points.cu's kernel (the same at least 960 threads an SM) at LPB lanes a block.
template <int F, int LPB>
__global__ void __launch_bounds__(pts::k7::TASKS * LPB, 160 / LPB)
    program_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q, const int32_t* __restrict__ keep_q,
                   const int32_t* __restrict__ q_inf, int64_t* __restrict__ out, int64_t N) {
  extern __shared__ uint64_t slots[];
  pts::k7::block<F>(LPB, slots, p, q, keep_q, q_inf, out, N);
}

template <int F, int LPB>
void program(cudaStream_t s, const int64_t* p, const int64_t* q, const int32_t* keep_q, const int32_t* q_inf,
             int64_t* out, int64_t N) {
  const size_t smem = pts::k7::block_bytes(LPB);
  cudaFuncSetAttribute(program_kernel<F, LPB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  program_kernel<F, LPB><<<(unsigned)((N + LPB - 1) / LPB), pts::k7::TASKS * LPB, smem, s>>>(p, q, keep_q, q_inf,
                                                                                            out, N);
}

template <int F, int P, bool COPY>
void launch(unsigned b, int threads, cudaStream_t s, const int64_t* p, const int64_t* q, const int32_t* keep_q,
            const int32_t* q_inf, int64_t* out, int64_t N) {
  split_kernel<F, P, COPY><<<b, threads, 0, s>>>(p, q, keep_q, q_inf, out, N);
}

template <int F>
int dispatch(int kind, int prod, unsigned b, int threads, cudaStream_t s, const int64_t* p, const int64_t* q,
             const int32_t* keep_q, const int32_t* q_inf, int64_t* out, int64_t N) {
  using Fn = void (*)(unsigned, int, cudaStream_t, const int64_t*, const int64_t*, const int32_t*, const int32_t*,
                      int64_t*, int64_t);
  constexpr Fn table[2][3] = {
      {launch<F, fld::MUL64, true>, launch<F, fld::MUL32_CALL, true>, launch<F, MUL32, true>},
      {launch<F, fld::MUL64, false>, launch<F, fld::MUL32_CALL, false>, launch<F, MUL32, false>},
  };
  if (kind < 2) {
    table[kind][prod](b, threads, s, p, q, keep_q, q_inf, out, N);
  } else if (kind == 3) {
    const int lpb = threads / pts::k7::TASKS;
    if (lpb == 16) program<F, 16>(s, p, q, keep_q, q_inf, out, N);
    if (lpb == 32) program<F, 32>(s, p, q, keep_q, q_inf, out, N);
    if (lpb == 64) program<F, 64>(s, p, q, keep_q, q_inf, out, N);
  } else {
    const size_t smem = (size_t)threads * 4 * pts::k7::LANE_SLOTS * sizeof(uint64_t);
    cudaFuncSetAttribute(serial_program_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    serial_program_kernel<F><<<b, threads, smem, s>>>(p, q, keep_q, q_inf, out, N);
  }
  return 0;
}

}  // namespace

// The arguments of mbt_padd_mixed_select, with threads a block (32-256 for
// kinds 0-2; 96, 192 or 384 for kind 3), kind (0 copy, 1 whole, 2 serial
// program, 3 six threads a lane) and prod (0-2) as above.
// Returns cudaGetLastError().
extern "C" int mbt_k7_split(int field, int kind, int prod, const int64_t* p, const int64_t* q,
                            const int32_t* keep_q, const int32_t* q_inf, int64_t* out, int64_t N, int threads,
                            void* stream) {
  const bool six = threads == 96 || threads == 192 || threads == 384;
  if (kind < 0 || kind > 3 || prod < 0 || prod > 2 || (kind == 3 ? !six : threads < 32 || threads > 256 || threads % 32))
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    const unsigned b = (unsigned)((N + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      dispatch<0>(kind, prod, b, threads, s, p, q, keep_q, q_inf, out, N);
    else
      dispatch<1>(kind, prod, b, threads, s, p, q, keep_q, q_inf, out, N);
  }
  return (int)cudaGetLastError();
}
