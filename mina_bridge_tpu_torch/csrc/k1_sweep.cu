// K1's alternatives, for scripts/torch_kernel_sweep.py only: no path of
// the system calls these kernels. Each runs K1's chain (pow_chain.cuh,
// pow_lanes) for x^e with a block of `threads` and each product taken by
//   group 1: one thread an element, fld::sqr32 for the squarings and
//            fld::mul32 for the multiplies;
//   group 2, 4, 8: the lane-group product fld::group_mul over that many
//            lanes;
// each inlined at the chain's three sites or called as one out-of-line
// body. pow_chain.cu is the group 2, inlined, 64-thread case.
#include <cuda_runtime.h>

#include "pow_chain.cuh"

namespace {

using fld::Fe;

template <int F>
__device__ __noinline__ Fe sqr32_call(Fe a) {
  return fld::sqr32<F>(a);
}

template <int F, int G>
__device__ __noinline__ Fe group_mul_call(Fe a, Fe b, int k) {
  return fld::group_mul<F, G>(a, b, k);
}

template <int F, bool CALL>
struct SingleProduct {
  int k;  // unread: one thread an element
  __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) const {
    if constexpr (CALL)
      return fld::mul32_call<F>(a, b);
    else
      return fld::mul32<F>(a, b);
  }
  __device__ __forceinline__ Fe sqr(const Fe& a) const {
    if constexpr (CALL)
      return sqr32_call<F>(a);
    else
      return fld::sqr32<F>(a);
  }
};

template <int F, int G, bool CALL>
struct GroupProduct {
  int k;
  __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) const {
    if constexpr (CALL)
      return group_mul_call<F, G>(a, b, k);
    else
      return fld::group_mul<F, G>(a, b, k);
  }
  __device__ __forceinline__ Fe sqr(const Fe& a) const { return mul(a, a); }
};

template <int F, int G, class Product>
__global__ void sweep_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                             const int32_t* __restrict__ sched, int nsteps, int tsize, int64_t n) {
  extern __shared__ Fe table[];
  fld::pow_lanes<F, G, Product>(x, out, sched, nsteps, tsize, n, table);
}

template <int F, int G, class Product>
void go(unsigned blocks, int threads, size_t smem, cudaStream_t s, const int64_t* x, int64_t* out,
        const int32_t* sched, int nsteps, int tsize, int64_t n) {
  cudaFuncSetAttribute(sweep_kernel<F, G, Product>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sweep_kernel<F, G, Product><<<blocks, threads, smem, s>>>(x, out, sched, nsteps, tsize, n);
}

template <int F>
void launch(const int64_t* x, int64_t* out, const int32_t* sched, int nsteps, int tsize, int64_t n, int threads,
            int group, int inlined, cudaStream_t s) {
  const int per_block = threads / group;
  const unsigned b = (unsigned)((n + per_block - 1) / per_block);
  const size_t smem = (size_t)tsize * per_block * sizeof(Fe);
  if (group == 1)
    (inlined ? go<F, 1, SingleProduct<F, false>> : go<F, 1, SingleProduct<F, true>>)(b, threads, smem, s, x, out,
                                                                                      sched, nsteps, tsize, n);
  if (group == 2)
    (inlined ? go<F, 2, GroupProduct<F, 2, false>> : go<F, 2, GroupProduct<F, 2, true>>)(b, threads, smem, s, x, out,
                                                                                         sched, nsteps, tsize, n);
  if (group == 4)
    (inlined ? go<F, 4, GroupProduct<F, 4, false>> : go<F, 4, GroupProduct<F, 4, true>>)(b, threads, smem, s, x, out,
                                                                                         sched, nsteps, tsize, n);
  if (group == 8)
    (inlined ? go<F, 8, GroupProduct<F, 8, false>> : go<F, 8, GroupProduct<F, 8, true>>)(b, threads, smem, s, x, out,
                                                                                         sched, nsteps, tsize, n);
}

}  // namespace

// The arguments of mbt_pow_chain, and threads: a block's threads (32, 64,
// 128 or 256); group: lanes a product (1, 2, 4 or 8); inlined: the
// products inlined at each site instead of called. Returns
// cudaGetLastError().
extern "C" int mbt_k1_sweep(int field, const int64_t* x, int64_t* out, const int32_t* sched, int nsteps, int tsize,
                            int64_t n, int threads, int group, int inlined, void* stream) {
  if (nsteps < 1 || tsize < 1 || tsize > 16 || (threads != 32 && threads != 64 && threads != 128 && threads != 256) ||
      (group != 1 && group != 2 && group != 4 && group != 8))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      launch<0>(x, out, sched, nsteps, tsize, n, threads, group, inlined, s);
    else
      launch<1>(x, out, sched, nsteps, tsize, n, threads, group, inlined, s);
  }
  return (int)cudaGetLastError();
}
