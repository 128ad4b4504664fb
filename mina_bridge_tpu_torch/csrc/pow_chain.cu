// K1: fixed-exponent power chain x^e (Fermat inversion, e = p - 2).
//
// Replaces mina_bridge_tpu/fields/chain_kernel.py::pow_const_rows (one
// Pallas block running the square-and-multiply ladder with the exponent
// bits in SMEM). Same function: x^e on lazy limbs for any e >= 1.
//
// Bound on this card: the chain's latency. One element is ~254 dependent
// squarings and a few dozen multiplies against 176 bytes in and out, and
// the main path's batches are a few hundred elements (B * k), far too few
// to fill the card, so the time is one element's dependent products.
// Design, to shorten that chain and each of its links:
//  - a left-to-right sliding window of w bits, built from e on the host
//    (fields/chain_kernel.py::window_schedule): steps of (squarings before,
//    odd power index), so p - 2 takes 254 squarings and 27 multiplies by
//    x, x^3, ..., x^15 (w = 4), plus 8 products for that table, instead of
//    254 squarings and 76 multiplies;
//  - the odd powers in shared memory, one column an element (a table that
//    registers would have to index dynamically);
//  - each product split over a group of GROUP = 2 lanes (fld::group_mul,
//    pow_chain.cuh: each lane owns half the columns of the Montgomery
//    row, the reduction word and one column a row pass by shuffles),
//    inlined at the chain's three sites; blocks of THREADS = 64, so that a
//    small batch spreads over many SMs.
// scripts/torch_kernel_sweep.py times the alternatives (csrc/k1_sweep.cu:
// one thread an element on fld::sqr32 and fld::mul32, groups of 4 and 8
// lanes, called products, other block sizes and widths); PERF.md has the
// numbers behind the choice.
#include <cuda_runtime.h>

#include "pow_chain.cuh"

namespace {

using fld::Fe;

constexpr int THREADS = 64, GROUP = 2;

template <int F>
__global__ void pow_group_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                                 const int32_t* __restrict__ sched, int nsteps, int tsize, int64_t n) {
  extern __shared__ Fe table[];  // table[k * (THREADS / GROUP) + element of the block] = x^(2k + 1)
  fld::pow_lanes<F, GROUP, fld::GroupProduct<F, GROUP>>(x, out, sched, nsteps, tsize, n, table);
}

}  // namespace

// x, out: (n, 22) int64 limbs. sched: (nsteps, 2) int32 steps of
// (squarings, odd power index or -1), the first (0, index) giving the
// start; tsize: the odd powers x^1 .. x^(2 tsize - 1) the steps use
// (<= 16, at most 16 KB of shared memory a block). Returns
// cudaGetLastError().
extern "C" int mbt_pow_chain(int field, const int64_t* x, int64_t* out, const int32_t* sched, int nsteps,
                             int tsize, int64_t n, void* stream) {
  if (nsteps < 1 || tsize < 1 || tsize > 16) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    constexpr int per_block = THREADS / GROUP;
    const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
    const size_t smem = (size_t)tsize * per_block * sizeof(Fe);
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      pow_group_kernel<0><<<blocks, THREADS, smem, s>>>(x, out, sched, nsteps, tsize, n);
    else
      pow_group_kernel<1><<<blocks, THREADS, smem, s>>>(x, out, sched, nsteps, tsize, n);
  }
  return (int)cudaGetLastError();
}
