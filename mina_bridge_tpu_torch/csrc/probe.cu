// Latency probe for the kernels' field products. It ports no TPU kernel
// and nothing in the system calls it: chip_smoke.py times it to give the
// critical-path floors of K1, K2 and the chains (dependent products x one
// product's latency) and to compare the products of field.cuh.
//
// One warp, one block: every lane runs `iters` dependent products
// a <- a * b, as K2's lone warp on its SM does, so the time over `iters`
// is the latency of one product with nothing to hide it.
#include <cuda_runtime.h>

#include "pow_chain.cuh"

namespace {

template <int F, int KIND>
__global__ void product_chain_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out, int iters) {
  const int lane = threadIdx.x;
  fld::Fe a = fld::from_limbs<F>(x + lane * fld::REP_LIMBS, 1);
  const fld::Fe b = fld::from_limbs<F>(x + (lane + 32) * fld::REP_LIMBS, 1);
  for (int i = 0; i < iters; i++) {
    if constexpr (KIND == 0) a = fld::mul<F>(a, b);
    if constexpr (KIND == 1) a = fld::mul32<F>(a, b);
    if constexpr (KIND == 2) a = fld::sqr32<F>(a);
  }
  fld::to_limbs<F>(a, out + lane * fld::REP_LIMBS, 1);
}

// The lane-group product as K1 takes it (G lanes a chain, inlined): 32 / G
// chains a <- a * b in one warp; chain e is lanes G e .. G e + G - 1.
template <int F, int G>
__global__ void group_chain_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out, int iters) {
  const int k = threadIdx.x % G, e = threadIdx.x / G;
  fld::Fe a = fld::from_limbs<F>(x + e * fld::REP_LIMBS, 1);
  const fld::Fe b = fld::from_limbs<F>(x + (e + 32) * fld::REP_LIMBS, 1);
  for (int i = 0; i < iters; i++) a = fld::group_mul<F, G>(a, b, k);
  if (k == 0) fld::to_limbs<F>(a, out + e * fld::REP_LIMBS, 1);
}

}  // namespace

// x: (64, 22) int64 limbs (lane i takes a = x[i], b = x[32 + i]); out:
// (32, 22). kind 0: a * b^iters by fld::mul (4 x 64-bit CIOS), 1: the same
// by fld::mul32 (8 x 32-bit CIOS, PTX carry chains), 2: a^(2^iters) by
// fld::sqr32, 3: a * b^iters by the 2-lane group product (16 chains: rows
// 0-15 of out, from a = x[e], b = x[32 + e]). Returns cudaGetLastError().
extern "C" int mbt_product_chain(int field, int kind, const int64_t* x, int64_t* out, int iters,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind < 0 || kind > 3) return (int)cudaErrorInvalidValue;
  if (field == 0 && kind == 0) product_chain_kernel<0, 0><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 0 && kind == 1) product_chain_kernel<0, 1><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 0 && kind == 2) product_chain_kernel<0, 2><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 1 && kind == 0) product_chain_kernel<1, 0><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 1 && kind == 1) product_chain_kernel<1, 1><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 1 && kind == 2) product_chain_kernel<1, 2><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 0 && kind == 3) group_chain_kernel<0, 2><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 1 && kind == 3) group_chain_kernel<1, 2><<<1, 32, 0, s>>>(x, out, iters);
  return (int)cudaGetLastError();
}
