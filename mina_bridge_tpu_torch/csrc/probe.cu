// Latency probe for the kernels' field products. It ports no TPU kernel
// and nothing in the system calls it: chip_smoke.py times it to give K2's
// critical-path floor (dependent products per block x one product's
// latency) and to compare the two products of field.cuh.
//
// One warp, one block: every lane runs `iters` dependent products
// a <- a * b, as K2's lone warp on its SM does, so the time over `iters`
// is the latency of one product with nothing to hide it.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int F, bool MUL32>
__global__ void product_chain_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out, int iters) {
  const int lane = threadIdx.x;
  fld::Fe a = fld::from_limbs<F>(x + lane * fld::REP_LIMBS, 1);
  const fld::Fe b = fld::from_limbs<F>(x + (lane + 32) * fld::REP_LIMBS, 1);
  for (int i = 0; i < iters; i++) a = MUL32 ? fld::mul32<F>(a, b) : fld::mul<F>(a, b);
  fld::to_limbs<F>(a, out + lane * fld::REP_LIMBS, 1);
}

}  // namespace

// x: (64, 22) int64 limbs (lane i takes a = x[i], b = x[32 + i]); out:
// (32, 22), a * b^iters. kind 0: fld::mul (4 x 64-bit CIOS), 1: fld::mul32
// (8 x 32-bit CIOS, PTX carry chains). Returns cudaGetLastError().
extern "C" int mbt_product_chain(int field, int kind, const int64_t* x, int64_t* out, int iters,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0 && kind == 0) product_chain_kernel<0, false><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 0 && kind == 1) product_chain_kernel<0, true><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 1 && kind == 0) product_chain_kernel<1, false><<<1, 32, 0, s>>>(x, out, iters);
  if (field == 1 && kind == 1) product_chain_kernel<1, true><<<1, 32, 0, s>>>(x, out, iters);
  return (int)cudaGetLastError();
}
