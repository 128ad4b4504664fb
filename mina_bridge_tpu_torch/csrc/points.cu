// K3-K7: projective point arithmetic for the MSM, one thread per lane.
//
// Replaces the Pallas kernels of mina_bridge_tpu/curves/pallas_kernels.py
// (all launched through _pallas_apply, BLOCK = 1024 lanes):
//   K3 padd               (body padd_rows): complete add, RCB16 Alg 7
//   K4 pdouble            (body pdouble_rows): doubling, RCB16 Alg 9
//   K5 padd_select        (body padd_select_rows): mask ? q : p + q
//   K6 padd_mixed_select2 (body padd_mixed_select2_rows): keep_q ? q :
//      (q_inf ? p : p +mixed q), RCB16 Alg 8, q given as (x, y) rows with
//      Z = 1 - q_inf
//   K7 padd_mixed_select  (body padd_mixed_select_rows): the same with a
//      3-row q whose Z row is exactly 0 (identity) or 1 (affine)
// All formulas are for a = 0, b3 = 3 * b = 15 (y^2 = x^3 + 5).
//
// Layout: the rows layout of the JAX package, (nrows, 22, N) int64 limbs
// with the lane last, so thread n reads limb l of coordinate c at
// (c * 22 + l) * N + n and a warp's loads are contiguous.
//
// Bound on this card: bytes. A lane does 11-14 field products (~6-7 k
// 32-bit multiply-adds) against 1-1.6 KB of int64 limbs in and out, which
// is under the card's ratio of operations to bytes; the 22 x 8-byte limb
// layout is four times the 32 bytes an element needs.
// Design: each thread converts its operands to Montgomery words once,
// runs the straight-line formula in registers and writes canonical limbs.
// Lanes are bounds-checked, so no padding lanes exist; a lane whose q is
// the identity (q_inf = 1) never takes the mixed add, as in the reference.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using fld::Fe;

struct Pt {
  Fe x, y, z;
};

template <int F>
__device__ __forceinline__ Pt load_pt(const int64_t* p, int64_t n, int64_t N) {
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  return {fld::from_limbs<F>(p + n, N), fld::from_limbs<F>(p + cs + n, N),
          fld::from_limbs<F>(p + 2 * cs + n, N)};
}

template <int F>
__device__ __forceinline__ void store_pt(const Pt& r, int64_t* o, int64_t n, int64_t N) {
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  fld::to_limbs<F>(r.x, o + n, N);
  fld::to_limbs<F>(r.y, o + cs + n, N);
  fld::to_limbs<F>(r.z, o + 2 * cs + n, N);
}

// Complete addition (RCB16 Algorithm 7, a = 0).
template <int F>
__device__ Pt padd_f(const Pt& p, const Pt& q) {
  using namespace fld;
  Fe t0 = mul<F>(p.x, q.x);
  Fe t1 = mul<F>(p.y, q.y);
  Fe t2 = mul<F>(p.z, q.z);
  Fe t3 = add<F>(p.x, p.y);
  Fe t4 = add<F>(q.x, q.y);
  t3 = mul<F>(t3, t4);
  t4 = add<F>(t0, t1);
  t3 = sub<F>(t3, t4);
  t4 = add<F>(p.y, p.z);
  Fe x3 = add<F>(q.y, q.z);
  t4 = mul<F>(t4, x3);
  x3 = add<F>(t1, t2);
  t4 = sub<F>(t4, x3);
  x3 = add<F>(p.x, p.z);
  Fe y3 = add<F>(q.x, q.z);
  x3 = mul<F>(x3, y3);
  y3 = add<F>(t0, t2);
  y3 = sub<F>(x3, y3);
  x3 = add<F>(t0, t0);
  t0 = add<F>(x3, t0);
  t2 = mul_b3<F>(t2);
  Fe z3 = add<F>(t1, t2);
  t1 = sub<F>(t1, t2);
  y3 = mul_b3<F>(y3);
  x3 = mul<F>(t4, y3);
  t2 = mul<F>(t3, t1);
  x3 = sub<F>(t2, x3);
  y3 = mul<F>(y3, t0);
  t1 = mul<F>(t1, z3);
  y3 = add<F>(t1, y3);
  t0 = mul<F>(t0, t3);
  z3 = mul<F>(z3, t4);
  z3 = add<F>(z3, t0);
  return {x3, y3, z3};
}

// Exception-free doubling (RCB16 Algorithm 9, a = 0).
template <int F>
__device__ Pt pdouble_f(const Pt& p) {
  using namespace fld;
  Fe t0 = mul<F>(p.y, p.y);
  Fe z3 = add<F>(t0, t0);
  z3 = add<F>(z3, z3);
  z3 = add<F>(z3, z3);
  Fe t1 = mul<F>(p.y, p.z);
  Fe t2 = mul<F>(p.z, p.z);
  t2 = mul_b3<F>(t2);
  Fe x3 = mul<F>(t2, z3);
  Fe y3 = add<F>(t0, t2);
  z3 = mul<F>(t1, z3);
  t1 = add<F>(t2, t2);
  t2 = add<F>(t1, t2);
  t0 = sub<F>(t0, t2);
  y3 = mul<F>(t0, y3);
  y3 = add<F>(x3, y3);
  t1 = mul<F>(p.x, p.y);
  x3 = mul<F>(t0, t1);
  x3 = add<F>(x3, x3);
  return {x3, y3, z3};
}

// Mixed addition (RCB16 Algorithm 8, a = 0): q has Z = 1. Invalid for an
// identity q; callers select around that case.
template <int F>
__device__ Pt padd_mixed_f(const Pt& p, const Fe& x2, const Fe& y2) {
  using namespace fld;
  Fe t0 = mul<F>(p.x, x2);
  Fe t1 = mul<F>(p.y, y2);
  Fe t3 = add<F>(x2, y2);
  Fe t4 = add<F>(p.x, p.y);
  t3 = mul<F>(t3, t4);
  t4 = add<F>(t0, t1);
  t3 = sub<F>(t3, t4);
  t4 = mul<F>(y2, p.z);
  t4 = add<F>(t4, p.y);
  Fe y3 = mul<F>(x2, p.z);
  y3 = add<F>(y3, p.x);
  Fe x3 = add<F>(t0, t0);
  t0 = add<F>(x3, t0);
  Fe t2 = mul_b3<F>(p.z);
  Fe z3 = add<F>(t1, t2);
  t1 = sub<F>(t1, t2);
  y3 = mul_b3<F>(y3);
  x3 = mul<F>(t4, y3);
  t2 = mul<F>(t3, t1);
  x3 = sub<F>(t2, x3);
  y3 = mul<F>(y3, t0);
  t1 = mul<F>(t1, z3);
  y3 = add<F>(t1, y3);
  t0 = mul<F>(t0, t3);
  z3 = mul<F>(z3, t4);
  z3 = add<F>(z3, t0);
  return {x3, y3, z3};
}

template <int F>
__global__ void padd_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                            int64_t* __restrict__ out, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  store_pt<F>(padd_f<F>(load_pt<F>(p, n, N), load_pt<F>(q, n, N)), out, n, N);
}

template <int F>
__global__ void pdouble_kernel(const int64_t* __restrict__ p, int64_t* __restrict__ out, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  store_pt<F>(pdouble_f<F>(load_pt<F>(p, n, N)), out, n, N);
}

template <int F>
__global__ void padd_select_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                                   const int32_t* __restrict__ keep_q, int64_t* __restrict__ out,
                                   int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Pt qp = load_pt<F>(q, n, N);
  if (keep_q[n]) {
    store_pt<F>(qp, out, n, N);
    return;
  }
  store_pt<F>(padd_f<F>(load_pt<F>(p, n, N), qp), out, n, N);
}

template <int F>
__global__ void padd_mixed_select2_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q2,
                                          const int32_t* __restrict__ keep_q,
                                          const int32_t* __restrict__ q_inf, int64_t* __restrict__ out,
                                          int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  const int inf = q_inf[n] != 0;
  if (keep_q[n]) {
    const Fe x2 = fld::from_limbs<F>(q2 + n, N);
    const Fe y2 = fld::from_limbs<F>(q2 + cs + n, N);
    const Pt r = {x2, y2, inf ? fld::zero<F>() : fld::one<F>()};
    store_pt<F>(r, out, n, N);
    return;
  }
  const Pt pp = load_pt<F>(p, n, N);
  if (inf) {
    store_pt<F>(pp, out, n, N);
    return;
  }
  const Fe x2 = fld::from_limbs<F>(q2 + n, N);
  const Fe y2 = fld::from_limbs<F>(q2 + cs + n, N);
  store_pt<F>(padd_mixed_f<F>(pp, x2, y2), out, n, N);
}

template <int F>
__global__ void padd_mixed_select_kernel(const int64_t* __restrict__ p, const int64_t* __restrict__ q,
                                         const int32_t* __restrict__ keep_q,
                                         const int32_t* __restrict__ q_inf, int64_t* __restrict__ out,
                                         int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  if (keep_q[n]) {
    store_pt<F>(load_pt<F>(q, n, N), out, n, N);
    return;
  }
  const Pt pp = load_pt<F>(p, n, N);
  if (q_inf[n]) {
    store_pt<F>(pp, out, n, N);
    return;
  }
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  const Fe x2 = fld::from_limbs<F>(q + n, N);
  const Fe y2 = fld::from_limbs<F>(q + cs + n, N);
  store_pt<F>(padd_mixed_f<F>(pp, x2, y2), out, n, N);
}

constexpr int THREADS = 128;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// p, q, out: (3, 22, N) int64 rows. Each returns cudaGetLastError().
extern "C" int mbt_padd(int field, const int64_t* p, const int64_t* q, int64_t* out, int64_t N,
                        void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      padd_kernel<0><<<blocks_for(N), THREADS, 0, s>>>(p, q, out, N);
    else
      padd_kernel<1><<<blocks_for(N), THREADS, 0, s>>>(p, q, out, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int mbt_pdouble(int field, const int64_t* p, int64_t* out, int64_t N, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      pdouble_kernel<0><<<blocks_for(N), THREADS, 0, s>>>(p, out, N);
    else
      pdouble_kernel<1><<<blocks_for(N), THREADS, 0, s>>>(p, out, N);
  }
  return (int)cudaGetLastError();
}

// keep_q: (N,) int32.
extern "C" int mbt_padd_select(int field, const int64_t* p, const int64_t* q, const int32_t* keep_q,
                               int64_t* out, int64_t N, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      padd_select_kernel<0><<<blocks_for(N), THREADS, 0, s>>>(p, q, keep_q, out, N);
    else
      padd_select_kernel<1><<<blocks_for(N), THREADS, 0, s>>>(p, q, keep_q, out, N);
  }
  return (int)cudaGetLastError();
}

// q2: (2, 22, N) int64 rows (x, y); keep_q, q_inf: (N,) int32.
extern "C" int mbt_padd_mixed_select2(int field, const int64_t* p, const int64_t* q2,
                                      const int32_t* keep_q, const int32_t* q_inf, int64_t* out,
                                      int64_t N, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      padd_mixed_select2_kernel<0><<<blocks_for(N), THREADS, 0, s>>>(p, q2, keep_q, q_inf, out, N);
    else
      padd_mixed_select2_kernel<1><<<blocks_for(N), THREADS, 0, s>>>(p, q2, keep_q, q_inf, out, N);
  }
  return (int)cudaGetLastError();
}

// q: (3, 22, N) int64 rows with a Z row of 0 or 1; keep_q, q_inf: (N,) int32.
extern "C" int mbt_padd_mixed_select(int field, const int64_t* p, const int64_t* q,
                                     const int32_t* keep_q, const int32_t* q_inf, int64_t* out,
                                     int64_t N, void* stream) {
  if (N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      padd_mixed_select_kernel<0><<<blocks_for(N), THREADS, 0, s>>>(p, q, keep_q, q_inf, out, N);
    else
      padd_mixed_select_kernel<1><<<blocks_for(N), THREADS, 0, s>>>(p, q, keep_q, q_inf, out, N);
  }
  return (int)cudaGetLastError();
}
