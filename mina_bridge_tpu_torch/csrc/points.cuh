// Projective point formulas on Pallas/Vesta (a = 0, b3 = 3 * b = 15,
// y^2 = x^3 + 5), shared by the kernels of points.cu and the host build
// of the CPU tests (field_host.cpp).
//
// Counterpart of the jnp bodies in mina_bridge_tpu/curves/pallas_kernels.py
// (padd_rows, pdouble_rows, padd_mixed_rows). P picks how the field
// products are taken (fld::Product): one out-of-line mul32 for K3-K6, mul
// inlined for K7. All compute the same values, so the formulas give the
// same points either way.
//
// Below the formulas are the per-thread steps of the MSM's three
// one-launch phases (the bucket weighting and the fix-up of K3, the lane
// scan of K5). points.cu runs them in its kernels between block barriers;
// field_host.cpp runs the same steps in loops, so the CPU tests check
// their index arithmetic.
#pragma once
#include "field.cuh"

#if defined(__CUDACC__)
#define PHD __host__ __device__
#else
#define PHD inline
#endif

namespace pts {

using fld::Fe;

struct Pt {
  Fe x, y, z;
};

// A point of a (rows, 22, N) int64 limb batch: coordinate c's limb l of
// lane n at (c * 22 + l) * N + n.
template <int F, int P>
PHD Pt load_pt(const int64_t* p, int64_t n, int64_t N) {
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  return {fld::from_limbs<F, P>(p + n, N), fld::from_limbs<F, P>(p + cs + n, N),
          fld::from_limbs<F, P>(p + 2 * cs + n, N)};
}

template <int F, int P>
PHD void store_pt(const Pt& r, int64_t* o, int64_t n, int64_t N) {
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  fld::to_limbs<F, P>(r.x, o + n, N);
  fld::to_limbs<F, P>(r.y, o + cs + n, N);
  fld::to_limbs<F, P>(r.z, o + 2 * cs + n, N);
}

template <int F, int P>
PHD Fe mul_b3(const Fe& a) {
  return fld::mulx<F, P>(a, fld::Params<F>::b3());
}

// Complete addition (RCB16 Algorithm 7, a = 0).
template <int F, int P>
PHD Pt padd_f(const Pt& p, const Pt& q) {
  using fld::add;
  using fld::sub;
  Fe t0 = fld::mulx<F, P>(p.x, q.x);
  Fe t1 = fld::mulx<F, P>(p.y, q.y);
  Fe t2 = fld::mulx<F, P>(p.z, q.z);
  Fe t3 = add<F>(p.x, p.y);
  Fe t4 = add<F>(q.x, q.y);
  t3 = fld::mulx<F, P>(t3, t4);
  t4 = add<F>(t0, t1);
  t3 = sub<F>(t3, t4);
  t4 = add<F>(p.y, p.z);
  Fe x3 = add<F>(q.y, q.z);
  t4 = fld::mulx<F, P>(t4, x3);
  x3 = add<F>(t1, t2);
  t4 = sub<F>(t4, x3);
  x3 = add<F>(p.x, p.z);
  Fe y3 = add<F>(q.x, q.z);
  x3 = fld::mulx<F, P>(x3, y3);
  y3 = add<F>(t0, t2);
  y3 = sub<F>(x3, y3);
  x3 = add<F>(t0, t0);
  t0 = add<F>(x3, t0);
  t2 = mul_b3<F, P>(t2);
  Fe z3 = add<F>(t1, t2);
  t1 = sub<F>(t1, t2);
  y3 = mul_b3<F, P>(y3);
  x3 = fld::mulx<F, P>(t4, y3);
  t2 = fld::mulx<F, P>(t3, t1);
  x3 = sub<F>(t2, x3);
  y3 = fld::mulx<F, P>(y3, t0);
  t1 = fld::mulx<F, P>(t1, z3);
  y3 = add<F>(t1, y3);
  t0 = fld::mulx<F, P>(t0, t3);
  z3 = fld::mulx<F, P>(z3, t4);
  z3 = add<F>(z3, t0);
  return {x3, y3, z3};
}

// Exception-free doubling (RCB16 Algorithm 9, a = 0). Its dependent path
// is 3 products: z^2 -> b3 z^2 -> x3 = 2 (y^2 - 3 b3 z^2) x y.
template <int F, int P>
PHD Pt pdouble_f(const Pt& p) {
  using fld::add;
  using fld::sub;
  Fe t0 = fld::mulx<F, P>(p.y, p.y);
  Fe z3 = add<F>(t0, t0);
  z3 = add<F>(z3, z3);
  z3 = add<F>(z3, z3);
  Fe t1 = fld::mulx<F, P>(p.y, p.z);
  Fe t2 = fld::mulx<F, P>(p.z, p.z);
  t2 = mul_b3<F, P>(t2);
  Fe x3 = fld::mulx<F, P>(t2, z3);
  Fe y3 = add<F>(t0, t2);
  z3 = fld::mulx<F, P>(t1, z3);
  t1 = add<F>(t2, t2);
  t2 = add<F>(t1, t2);
  t0 = sub<F>(t0, t2);
  y3 = fld::mulx<F, P>(t0, y3);
  y3 = add<F>(x3, y3);
  t1 = fld::mulx<F, P>(p.x, p.y);
  x3 = fld::mulx<F, P>(t0, t1);
  x3 = add<F>(x3, x3);
  return {x3, y3, z3};
}

// Mixed addition (RCB16 Algorithm 8, a = 0): q has Z = 1. Invalid for an
// identity q; callers select around that case. Its dependent path from p
// is 3 products: p.z -> b3 (x2 p.z + p.x) -> x3 = (y2 p.z + p.y) (...).
template <int F, int P>
PHD Pt padd_mixed_f(const Pt& p, const Fe& x2, const Fe& y2) {
  using fld::add;
  using fld::sub;
  Fe t0 = fld::mulx<F, P>(p.x, x2);
  Fe t1 = fld::mulx<F, P>(p.y, y2);
  Fe t3 = add<F>(x2, y2);
  Fe t4 = add<F>(p.x, p.y);
  t3 = fld::mulx<F, P>(t3, t4);
  t4 = add<F>(t0, t1);
  t3 = sub<F>(t3, t4);
  t4 = fld::mulx<F, P>(y2, p.z);
  t4 = add<F>(t4, p.y);
  Fe y3 = fld::mulx<F, P>(x2, p.z);
  y3 = add<F>(y3, p.x);
  Fe x3 = add<F>(t0, t0);
  t0 = add<F>(x3, t0);
  Fe t2 = mul_b3<F, P>(p.z);
  Fe z3 = add<F>(t1, t2);
  t1 = sub<F>(t1, t2);
  y3 = mul_b3<F, P>(y3);
  x3 = fld::mulx<F, P>(t4, y3);
  t2 = fld::mulx<F, P>(t3, t1);
  x3 = sub<F>(t2, x3);
  y3 = fld::mulx<F, P>(y3, t0);
  t1 = fld::mulx<F, P>(t1, z3);
  y3 = add<F>(t1, y3);
  t0 = fld::mulx<F, P>(t0, t3);
  z3 = fld::mulx<F, P>(z3, t4);
  z3 = add<F>(z3, t0);
  return {x3, y3, z3};
}

template <int F>
PHD Pt identity() {
  return {fld::zero<F>(), fld::one<F>(), fld::zero<F>()};
}

// ---------------------------------------------------------------------------
// K3, the bucket weighting: total_w = sum_{d=1}^{D} d B_{w,d}.
//
// A window's D buckets are cut into K chunks of S = D / K; chunk j holds
// buckets j S + 1 .. (j + 1) S. For a group of chunks starting at bucket
// o + 1, keep tw = sum (d - o) B_d over its buckets and ma = M A, where A
// is the group's plain sum and M its width in buckets. Two neighbouring
// groups of width M combine as tw = (tw_l + tw_r) + ma_r and
// ma = 2 (ma_l + ma_r), so a binary tree over the K chunks ends in
// sum d B_d at the root (o = 0).
// ---------------------------------------------------------------------------

// One chunk: walk buckets lane0 + S - 1 down to lane0 of a (3, 22, nlanes)
// batch with run += B; tot += run (so tot = sum (d - o) B_d), then double
// run log2 S times (ma = S A).
template <int F, int P>
PHD void weight_walk(const int64_t* b, int64_t lane0, int64_t nlanes, int S, Pt& tot, Pt& run) {
  run = identity<F>();
  tot = identity<F>();
  for (int s = S - 1; s >= 0; s--) {
    run = padd_f<F, P>(run, load_pt<F, P>(b, lane0 + s, nlanes));
    tot = padd_f<F, P>(tot, run);
  }
  for (int k = S; k > 1; k >>= 1) run = pdouble_f<F, P>(run);
}

// Thread j's part of one tree level over n entries (groups of s leaves at
// tw[i s], ma[i s]) for a block of 2 half threads: thread i < half combines
// merge i's tw, thread half + i its ma, which only a level below the root
// needs (with_ma). The two roles sit in different warps, so no warp runs
// both.
template <int F, int P>
PHD void weight_merge(Pt* tw, Pt* ma, int j, int half, int s, int n, bool with_ma) {
  const bool second = j >= half;
  const int l = (second ? j - half : j) * 2 * s, r = l + s;
  if (r >= n) return;
  if (!second)
    tw[l] = padd_f<F, P>(padd_f<F, P>(tw[l], tw[r]), ma[r]);
  else if (with_ma)
    ma[l] = pdouble_f<F, P>(padd_f<F, P>(ma[l], ma[r]));
}

// ---------------------------------------------------------------------------
// K5, the lane repair: an in-place Blelloch scan of a window's G lane
// carries a[] with segment flags f[] (G a power of two). The up-sweep
// combine is f_r ? a_r : a_l + a_r, the down-sweep's f_l ? a_l : e + a_l
// (e the parent's exclusive value), as in pmsm's loop of one-step K5
// launches; the left entries that loop stashes are the ones an in-place
// scan leaves untouched.
// ---------------------------------------------------------------------------

// Merge m of the up-sweep level whose groups are s lanes wide.
template <int F, int P>
PHD void lane_up(Pt* a, int32_t* f, int m, int s) {
  const int l = m * 2 * s + s - 1, r = l + s;
  if (!f[r]) a[r] = padd_f<F, P>(a[l], a[r]);
  f[r] |= f[l];
}

// Merge m of the down-sweep level whose groups are s lanes wide.
template <int F, int P>
PHD void lane_down(Pt* a, const int32_t* f, int m, int s) {
  const int l = m * 2 * s + s - 1, r = l + s;
  const Pt left = a[l], e = a[r];
  a[l] = e;
  a[r] = f[l] ? left : padd_f<F, P>(e, left);
}

// ---------------------------------------------------------------------------
// K3, the fix-up: lane (w, g) of the chunked scan owns positions
// [g T, (g + 1) T) of window w's sorted digits dig (W, G T). The bucket
// whose segment holds position g T needs the lane's inflow iff the segment
// began in an earlier lane and ends in this one; then
// bucket = bucket + inflow, in place in buckets (3, 22, W, NB).
// ---------------------------------------------------------------------------
template <int F, int P>
PHD void fixup_lane(int64_t* buckets, const int64_t* inflow, const int64_t* dig, int64_t w, int64_t g,
                    int64_t W, int64_t G, int64_t T, int64_t NB) {
  if (g == 0) return;
  const int64_t* dw = dig + w * G * T;
  const int64_t p0 = g * T, d = dw[p0];
  if (dw[p0 - 1] != d || (g + 1 < G && dw[p0 + T] == d) || d < 0 || d >= NB) return;
  const int64_t idx = w * NB + d, nb = W * NB;
  const Pt sum = padd_f<F, P>(load_pt<F, P>(buckets, idx, nb), load_pt<F, P>(inflow, w * G + g, W * G));
  store_pt<F, P>(sum, buckets, idx, nb);
}

}  // namespace pts
