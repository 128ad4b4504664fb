// Host build of field.cuh and points.cuh for the CPU tests: the kernels'
// arithmetic, compiled with a host C++ compiler, on int64 limb arrays.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libfield_host.so field_host.cpp
//
// Every function writes canonical limbs.
#include <stdint.h>

#include <vector>

#include "field.cuh"
#include "points.cuh"
#include "pow_chain.cuh"

namespace {

template <int F, typename Op>
void map2(const int64_t* a, const int64_t* b, int64_t* out, int64_t n, Op op) {
  for (int64_t i = 0; i < n; i++) {
    const fld::Fe x = fld::from_limbs<F>(a + i * fld::REP_LIMBS, 1);
    const fld::Fe y = fld::from_limbs<F>(b + i * fld::REP_LIMBS, 1);
    fld::to_limbs<F>(op(x, y), out + i * fld::REP_LIMBS, 1);
  }
}

template <int F>
int run(int op, const int64_t* a, const int64_t* b, int64_t* out, int64_t n) {
  switch (op) {
    case 0:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::mul<F>(x, y); });
      return 0;
    case 1:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe&) { return fld::square<F>(x); });
      return 0;
    case 2:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::add<F>(x, y); });
      return 0;
    case 3:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::sub<F>(x, y); });
      return 0;
    case 4:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe&) { return fld::mul_b3<F>(x); });
      return 0;
    case 5:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::mul32<F>(x, y); });
      return 0;
    case 6:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) {
        return fld::mds_row<F>(x, y, y, y, x, x);
      });
      return 0;
    case 7:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe&) { return fld::sqr32<F>(x); });
      return 0;
    case 8:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::group_mul_lanes<F, 2>(x, y); });
      return 0;
    case 9:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::group_mul_lanes<F, 4>(x, y); });
      return 0;
    case 10:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::group_mul_lanes<F, 8>(x, y); });
      return 0;
  }
  return 1;
}

constexpr int MUL = fld::MUL32_CALL;

template <int F>
int points(int op, const int64_t* p, const int64_t* q, int64_t* out, int64_t n) {
  if (op < 0 || op > 2) return 1;
  const int64_t cs = (int64_t)fld::REP_LIMBS * n;
  for (int64_t i = 0; i < n; i++) {
    const pts::Pt a = pts::load_pt<F, MUL>(p, i, n);
    pts::Pt r;
    if (op == 0)
      r = pts::padd_mixed_f<F, MUL>(a, fld::from_limbs<F, MUL>(q + i, n), fld::from_limbs<F, MUL>(q + cs + i, n));
    else if (op == 1)
      r = pts::pdouble_f<F, MUL>(a);
    else
      r = pts::padd_f<F, MUL>(a, pts::load_pt<F, MUL>(q, i, n));
    pts::store_pt<F, MUL>(r, out, i, n);
  }
  return 0;
}

// padd_weight_sum_kernel, its blocks and threads run in turn.
template <int F>
void weight_sum(const int64_t* buckets, int64_t* out, int64_t W, int64_t D, int64_t K, int64_t C) {
  const int64_t B = K / C, S = D / K;
  std::vector<pts::Pt> tw(C), ma(C), ptw(B), pma(B);
  for (int64_t w = 0; w < W; w++) {
    for (int64_t b = 0; b < B; b++) {
      for (int64_t j = 0; j < C; j++)
        pts::weight_walk<F, MUL>(buckets, w * (D + 1) + (b * C + j) * S + 1, W * (D + 1), (int)S, tw[j], ma[j]);
      for (int s = 1; s < C; s <<= 1)
        for (int j = 0; j < C; j++)
          pts::weight_merge<F, MUL>(tw.data(), ma.data(), j, (int)C / 2, s, (int)C, 2 * s < K);
      ptw[b] = tw[0];
      pma[b] = ma[0];
    }
    for (int s = 1; s < B; s <<= 1)
      for (int j = 0; j < C; j++)
        pts::weight_merge<F, MUL>(ptw.data(), pma.data(), j, (int)C / 2, s, (int)B, 2 * s < B);
    pts::store_pt<F, MUL>(ptw[0], out, w, W);
  }
}

// padd_select_scan_kernel, one window after another.
template <int F>
void lane_scan(const int64_t* carry, const int32_t* has_start, int64_t* out, int64_t W, int64_t G) {
  std::vector<pts::Pt> a(G);
  std::vector<int32_t> f(G);
  for (int64_t w = 0; w < W; w++) {
    for (int64_t i = 0; i < G; i++) {
      a[i] = pts::load_pt<F, MUL>(carry, w * G + i, W * G);
      f[i] = has_start[w * G + i] != 0;
    }
    for (int s = 1; s < G; s <<= 1)
      for (int m = 0; m < G / (2 * s); m++) pts::lane_up<F, MUL>(a.data(), f.data(), m, s);
    a[G - 1] = pts::identity<F>();
    for (int s = (int)G / 2; s >= 1; s >>= 1)
      for (int m = 0; m < G / (2 * s); m++) pts::lane_down<F, MUL>(a.data(), f.data(), m, s);
    for (int64_t i = 0; i < G; i++) pts::store_pt<F, MUL>(a[i], out, w * G + i, W * G);
  }
}

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// pow_group_kernel: each element's chain on the 2-lane product (its lanes
// in turn), its table in a local column.
template <int F>
void pow_chain(const int64_t* x, int64_t* out, const int32_t* sched, int nsteps, int tsize, int64_t n) {
  std::vector<fld::Fe> tab(tsize);
  for (int64_t i = 0; i < n; i++) {
    const fld::Fe base = fld::from_limbs<F, MUL>(x + i * fld::REP_LIMBS, 1);
    const fld::Fe acc = fld::pow_window<F>(base, sched, nsteps, tsize, tab.data(), 1, fld::GroupProduct<F, 2>{0});
    fld::to_limbs<F, MUL>(acc, out + i * fld::REP_LIMBS, 1);
  }
}

// padd_mixed_select_kernel: blocks of lpb lanes, each phase's tasks in
// turn (in reverse when asked: the result must not depend on it).
template <int F>
void k7_blocks(const int64_t* p, const int64_t* q, const int32_t* keep_q, const int32_t* q_inf, int64_t* out,
               int64_t n, int lpb, bool reverse) {
  std::vector<uint64_t> slots(4 * pts::k7::LANE_SLOTS * lpb);
  std::vector<int> sel(lpb);
  for (int64_t b0 = 0; b0 < n; b0 += lpb) {
    for (int l = 0; l < lpb; l++) sel[l] = b0 + l < n ? pts::k7::select(keep_q[b0 + l], q_inf[b0 + l]) : pts::k7::RX;
    for (int phase = 0; phase < pts::k7::PHASES; phase++)
      for (int i = 0; i < pts::k7::TASKS; i++)
        for (int l = 0; l < lpb; l++) {
          const pts::k7::Slots S{slots.data(), lpb, l};
          pts::k7::task<F>(phase, reverse ? pts::k7::TASKS - 1 - i : i, S, sel[l], p, q, out, b0 + l, n);
        }
  }
}

}  // namespace

// op: 0 mul, 1 square (of a), 2 add, 3 sub, 4 multiply a by 15, 5 mul32
// (the 32-bit-limb product), 6 mds_row: a b + b b + a a reduced once,
// 7 sqr32 (of a), 8-10 the lane-group product of pow_chain.cuh over 2, 4
// and 8 lanes, run lane by lane.
extern "C" int mbt_host_binop(int field, int op, const int64_t* a, const int64_t* b, int64_t* out,
                              int64_t n) {
  return field == 0 ? run<0>(op, a, b, out, n) : run<1>(op, a, b, out, n);
}

// The point formulas of K6, K4 and K3 on mul32, over rows layouts: p and
// out (3, 22, n). op 0: p +mixed q with q (2, 22, n) affine (x, y) (K6's
// add; q must not be the identity), 1: the doubling of p (K4's step), 2:
// the complete add p + q with q (3, 22, n) (K3's).
extern "C" int mbt_host_points(int field, int op, const int64_t* p, const int64_t* q, int64_t* out,
                               int64_t n) {
  return field == 0 ? points<0>(op, p, q, out, n) : points<1>(op, p, q, out, n);
}

// The MSM phases of points.cu with their kernels' arguments (no scratch):
// K3's bucket weighting, K3's fix-up (in place) and K5's lane repair.
extern "C" int mbt_host_weight_sum(int field, const int64_t* buckets, int64_t* out, int64_t W, int64_t D, int64_t K,
                                   int64_t C) {
  if (W < 0 || !pow2(D) || !pow2(K) || !pow2(C) || K > D || C > K || K / C > C) return 1;
  (field == 0 ? weight_sum<0> : weight_sum<1>)(buckets, out, W, D, K, C);
  return 0;
}

extern "C" int mbt_host_fixup(int field, int64_t* buckets, const int64_t* inflow, const int64_t* dig, int64_t W,
                              int64_t G, int64_t T, int64_t NB) {
  if (W < 0 || G < 0 || T < 1 || NB < 1) return 1;
  for (int64_t w = 0; w < W; w++)
    for (int64_t g = 0; g < G; g++)
      (field == 0 ? pts::fixup_lane<0, MUL> : pts::fixup_lane<1, MUL>)(buckets, inflow, dig, w, g, W, G, T, NB);
  return 0;
}

extern "C" int mbt_host_lane_scan(int field, const int64_t* carry, const int32_t* has_start, int64_t* out, int64_t W,
                                  int64_t G) {
  if (W < 0 || !pow2(G)) return 1;
  (field == 0 ? lane_scan<0> : lane_scan<1>)(carry, has_start, out, W, G);
  return 0;
}

// K1's chain (pow_chain.cu) with the kernel's arguments.
extern "C" int mbt_host_pow(int field, const int64_t* x, int64_t* out, const int32_t* sched, int nsteps, int tsize,
                            int64_t n) {
  if (nsteps < 1 || tsize < 1 || tsize > 16) return 1;
  (field == 0 ? pow_chain<0> : pow_chain<1>)(x, out, sched, nsteps, tsize, n);
  return 0;
}

// K7 (points.cu, k7::task) with the kernel's arguments: p, q, out (3, 22,
// n) rows, q's Z row 0 or 1; keep_q, q_inf (n,) int32; lpb lanes a block;
// reverse: run each phase's tasks last to first.
extern "C" int mbt_host_k7(int field, const int64_t* p, const int64_t* q, const int32_t* keep_q,
                           const int32_t* q_inf, int64_t* out, int64_t n, int lpb, int reverse) {
  if (lpb < 1) return 1;
  (field == 0 ? k7_blocks<0> : k7_blocks<1>)(p, q, keep_q, q_inf, out, n, lpb, reverse != 0);
  return 0;
}
