// K1's chain for one element: x^e by a sliding-window schedule (built on
// the host, fields/chain_kernel.py::window_schedule), each product split
// over a lane group. pow_chain.cu runs it on the card; field_host.cpp runs
// the same functions on the host (a group's lanes in turn), so the CPU
// tests check the schedule and the product.
#pragma once
#include "field.cuh"

namespace fld {

// ---------------------------------------------------------------------------
// The lane-group product: one Montgomery product split over G lanes (G = 2,
// 4 or 8) that each hold both whole operands. Lane k owns the S = 8 / G
// columns kS .. kS + S - 1 of the CIOS row as 64-bit sums (carry-save:
// no carry crosses a lane inside the loop). Per word b_i of b:
//   step1: acc += a[kS..] b_i; lane 0 forms the reduction word m;
//   (m is broadcast from lane 0)
//   step2: acc += m p[kS..]; the lane hands its lowest column down;
//   (shuffle down: each lane takes lane k + 1's lowest column)
//   step3: the row shifts one column down; lane 0's lowest column, now
//          a multiple of 2^32, carries its high half into the next.
// Then every lane gathers the 8 columns, resolves the carries and
// subtracts p once, so each ends with the whole product again. The steps
// are plain functions of one lane's state, so the host build runs them
// lane by lane in the same order.
// ---------------------------------------------------------------------------
template <int G>
struct GroupLane {
  static constexpr int S = 8 / G;
  uint64_t acc[S];  // columns kS + j, j < S
  uint64_t hi;      // the column kS + S, which the next lane owns
};

// acc[j] += lo(u v), and its high half into the next column.
template <int G>
FHD void group_mac(GroupLane<G>& st, int j, uint32_t u, uint32_t v) {
  const uint64_t pr = (uint64_t)u * v;
  st.acc[j] += (uint32_t)pr;
  if (j + 1 < GroupLane<G>::S)
    st.acc[j + 1] += pr >> 32;
  else
    st.hi += pr >> 32;
}

template <int F, int G>
FHD uint32_t group_step1(GroupLane<G>& st, int k, const uint32_t a[8], uint32_t bi) {
#pragma unroll
  for (int j = 0; j < GroupLane<G>::S; j++) group_mac<G>(st, j, a[k * GroupLane<G>::S + j], bi);
  return (uint32_t)st.acc[0] * (uint32_t)Params<F>::inv();  // lane 0's is the m of this row
}

template <int G>
FHD uint64_t group_step2(GroupLane<G>& st, int k, const uint32_t p[8], uint32_t m) {
#pragma unroll
  for (int j = 0; j < GroupLane<G>::S; j++) group_mac<G>(st, j, m, p[k * GroupLane<G>::S + j]);
  return st.acc[0];
}

// below: lane k + 1's lowest column (unread in the top lane).
template <int G>
FHD void group_step3(GroupLane<G>& st, int k, uint64_t below) {
  constexpr int S = GroupLane<G>::S;
  const uint64_t low = st.acc[0];
#pragma unroll
  for (int j = 0; j + 1 < S; j++) st.acc[j] = st.acc[j + 1];
  st.acc[S - 1] = st.hi + (k + 1 < G ? below : 0);
  st.hi = 0;
  if (k == 0) st.acc[0] += low >> 32;  // low is 0 mod 2^32 after m p
}

// The 8 columns (each < 2^40) of a value below 2p -> [0, p).
template <int F>
FHD Fe group_finish(const uint64_t col[8]) {
  uint32_t x[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const uint64_t s = col[j] + c;  // no overflow: col[j] < 2^40, c < 2^9
    x[j] = (uint32_t)s;
    c = s >> 32;
  }
  return csub32<F>(x);
}

template <int F, int G>
FHD void group_load(GroupLane<G>& st, const Fe& a, const Fe& b, uint32_t x[8], uint32_t y[8], uint32_t p[8]) {
  split32(a, x);
  split32(b, y);
  split32(Params<F>::p(), p);
#pragma unroll
  for (int j = 0; j < GroupLane<G>::S; j++) st.acc[j] = 0;
  st.hi = 0;
}

#ifdef __CUDACC__
// a * b / R mod p by the lane's group (k = lane % G, every lane of the warp
// taking part; a, b < p and the same in the whole group).
template <int F, int G>
__device__ __forceinline__ Fe group_mul(Fe a, Fe b, int k) {
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int S = GroupLane<G>::S;
  GroupLane<G> st;
  uint32_t x[8], y[8], p[8];
  group_load<F, G>(st, a, b, x, y, p);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t m = __shfl_sync(ALL, group_step1<F, G>(st, k, x, y[i]), 0, G);
    const uint64_t low = group_step2<G>(st, k, p, m);
    group_step3<G>(st, k, __shfl_down_sync(ALL, low, 1, G));
  }
  uint64_t col[8];
#pragma unroll
  for (int q = 0; q < 8; q++) col[q] = __shfl_sync(ALL, st.acc[q % S], q / S, G);
  return group_finish<F>(col);
}

#endif

// The same product with the group's lanes run in turn (the host build).
template <int F, int G>
FHD Fe group_mul_lanes(const Fe& a, const Fe& b) {
  constexpr int S = GroupLane<G>::S;
  GroupLane<G> st[G];
  uint32_t x[8], y[8], p[8];
  for (int k = 0; k < G; k++) group_load<F, G>(st[k], a, b, x, y, p);
  for (int i = 0; i < 8; i++) {
    uint32_t m = 0;
    uint64_t low[G];
    for (int k = 0; k < G; k++) {
      const uint32_t mk = group_step1<F, G>(st[k], k, x, y[i]);
      if (k == 0) m = mk;
    }
    for (int k = 0; k < G; k++) low[k] = group_step2<G>(st[k], k, p, m);
    for (int k = 0; k < G; k++) group_step3<G>(st[k], k, low[k + 1 < G ? k + 1 : k]);
  }
  uint64_t col[8];
  for (int q = 0; q < 8; q++) col[q] = st[q / S].acc[q % S];
  return group_finish<F>(col);
}

// K1's product: lane k of a group of G lanes (group_mul), or the group's
// lanes in turn on the host.
template <int F, int G>
struct GroupProduct {
  int k;
  FHD Fe mul(const Fe& a, const Fe& b) const {
#ifdef __CUDA_ARCH__
    return group_mul<F, G>(a, b, k);
#else
    return group_mul_lanes<F, G>(a, b);
#endif
  }
  FHD Fe sqr(const Fe& a) const { return mul(a, a); }
};

// base^e in Montgomery form. sched: nsteps rows of (squarings, index): the
// first (0, index) starts acc at base^(2 index + 1); each later row squares
// acc that many times, then multiplies it by base^(2 index + 1) unless
// index is -1. tab[k * stride], k < tsize, receives base^(2k + 1).
template <int F, class Product>
FHD Fe pow_window(const Fe& base, const int32_t* sched, int nsteps, int tsize, Fe* tab, int stride,
                  const Product& pr) {
  tab[0] = base;
  if (tsize > 1) {
    const Fe x2 = pr.sqr(base);
    Fe t = base;
    for (int k = 1; k < tsize; k++) {
      t = pr.mul(t, x2);
      tab[k * stride] = t;
    }
  }
  Fe acc = tab[sched[1] * stride];
  for (int s = 1; s < nsteps; s++) {
    const int nsq = sched[2 * s], idx = sched[2 * s + 1];
    for (int r = 0; r < nsq; r++) acc = pr.sqr(acc);
    if (idx >= 0) acc = pr.mul(acc, tab[idx * stride]);
  }
  return acc;
}

#ifdef __CUDACC__
// One block's share of K1 on groups of G lanes: lanes G e .. G e + G - 1
// take element blockIdx.x * (blockDim.x / G) + e of x's n. A group past n
// runs on a copy of the last element, since every lane of a warp takes
// part in the shuffles, and stores nothing (one lane a group, G = 1,
// returns at once). table: the block's odd powers, tsize rows of
// blockDim.x / G. Product: mul and sqr for lane k, built from {k}.
template <int F, int G, class Product>
__device__ __forceinline__ void pow_lanes(const int64_t* x, int64_t* out, const int32_t* sched, int nsteps, int tsize,
                                          int64_t n, Fe* table) {
  const int k = threadIdx.x % G, e = threadIdx.x / G, per_block = blockDim.x / G;
  const int64_t i = (int64_t)blockIdx.x * per_block + e;
  if (G == 1 && i >= n) return;
  const int64_t src = i < n ? i : n - 1;
  const Fe base = from_limbs<F, MUL32_CALL>(x + src * REP_LIMBS, 1);
  const Fe acc = pow_window<F>(base, sched, nsteps, tsize, table + e, per_block, Product{k});
  if (i < n && k == 0) to_limbs<F, MUL32_CALL>(acc, out + i * REP_LIMBS, 1);
}
#endif

}  // namespace fld
