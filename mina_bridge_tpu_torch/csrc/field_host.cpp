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

template <int F>
void pow_chain(const int64_t* x, int64_t* out, const int32_t* bits, int nbits, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const fld::Fe base = fld::from_limbs<F>(x + i * fld::REP_LIMBS, 1);
    fld::Fe acc = base;
    for (int r = 0; r < nbits; r++) {
      acc = fld::square<F>(acc);
      if (bits[r]) acc = fld::mul<F>(acc, base);
    }
    fld::to_limbs<F>(acc, out + i * fld::REP_LIMBS, 1);
  }
}

}  // namespace

// op: 0 mul, 1 square (of a), 2 add, 3 sub, 4 multiply a by 15, 5 mul32
// (the 32-bit-limb product), 6 mds_row: a b + b b + a a reduced once.
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

// The pow_chain.cu ladder: bits after the exponent's leading one, msb first.
extern "C" void mbt_host_pow(int field, const int64_t* x, int64_t* out, const int32_t* bits,
                             int nbits, int64_t n) {
  if (field == 0)
    pow_chain<0>(x, out, bits, nbits, n);
  else
    pow_chain<1>(x, out, bits, nbits, n);
}
