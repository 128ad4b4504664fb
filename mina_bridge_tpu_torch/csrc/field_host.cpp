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
    case 14:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::add32<F>(x, y); });
      return 0;
    case 15:
      map2<F>(a, b, out, n, [](const fld::Fe& x, const fld::Fe& y) { return fld::sub32<F>(x, y); });
      return 0;
    case 11:
    case 12:
    case 13: {
      const uint64_t k = op == 11 ? 15 : (op == 12 ? 45 : 64);
      map2<F>(a, b, out, n, [k](const fld::Fe& x, const fld::Fe&) { return fld::mul_small<F>(x, k); });
      return 0;
    }
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

// padd_weight_sum_kernel and padd_select_scan_kernel: the kernels'
// programs (split::weight_grid, split::lane_scan) on split::SerialBlocks,
// the blocks of a step in turn, each phase's tasks in turn; with reverse,
// both last to first (the result must not depend on it). The weighting
// runs on HOST_BLOCKS blocks, the repair window by window on its cluster.
constexpr int HOST_BLOCKS = 3;

constexpr size_t words_of(size_t bytes) { return (bytes + sizeof(uint64_t) - 1) / sizeof(uint64_t); }

template <int F>
void weight_sum(const int64_t* buckets, int64_t* out, int64_t W, int64_t D, int64_t K, int64_t C, bool reverse) {
  using namespace pts::split;
  const size_t words = words_of(weight_bytes((int)(D / K), (int)C));
  std::vector<uint64_t> smem(HOST_BLOCKS * words), roots(4 * W_ROOT_SLOTS * W * K);
  const SerialBlocks grid{HOST_BLOCKS, 0, reverse, smem.data(), words};
  weight_grid<F>(grid, buckets, out, roots.data(), (int)W, (int)D, (int)K, (int)C, NoStamp{});
}

template <int F>
void lane_scan(const int64_t* carry, const int32_t* has_start, int64_t* out, int64_t W, int64_t G, bool reverse) {
  using namespace pts::split;
  const int CL = lane_cluster(G);
  const size_t words = words_of(lane_bytes((int)(G / CL), false));
  std::vector<uint64_t> smem(CL * words);
  for (int64_t w = 0; w < W; w++) {
    const SerialBlocks cl{CL, (int)(w * CL), reverse, smem.data(), words};
    pts::split::lane_scan<F>(cl, carry, has_start, out, nullptr, (int)W, (int)G, NoStamp{});
  }
}

// padd_kernel, padd_fixup_kernel and padd_select_kernel: the kernels'
// block programs (split::padd_lanes, fixup_lanes, select_lanes) on the
// kernels' blocks of lanes in turn, each phase's tasks in turn; with
// reverse, both last to first.
template <class Fn>
void lane_blocks(int64_t n, int lanes, bool reverse, Fn fn) {
  const int64_t nb = (n + lanes - 1) / lanes;
  for (int64_t i = 0; i < nb; i++) {
    const int64_t b = reverse ? nb - 1 - i : i;
    fn(b * lanes, (int)(n - b * lanes < lanes ? n - b * lanes : lanes));
  }
}

template <int F>
void padd_blocks(const int64_t* p, const int64_t* q, int64_t* out, int64_t n, bool reverse) {
  using namespace pts::split;
  std::vector<uint64_t> smem(words_of(pair_bytes(false)));
  lane_blocks(n, PADD_LANES, reverse,
              [&](int64_t n0, int m) { padd_lanes<F>(Serial{reverse}, smem.data(), p, q, out, n0, m, n); });
}

template <int F>
void fixup_blocks(int64_t* buckets, const int64_t* inflow, const int64_t* dig, int64_t W, int64_t G, int64_t T,
                  int64_t NB, bool reverse) {
  using namespace pts::split;
  std::vector<uint64_t> smem(words_of(pair_bytes(true)));
  lane_blocks(W * G, FIXUP_LANES, reverse, [&](int64_t l0, int m) {
    fixup_lanes<F>(Serial{reverse}, smem.data(), buckets, inflow, dig, l0, m, W, G, T, NB);
  });
}

template <int F>
void select_blocks(const int64_t* p, const int64_t* q, const int32_t* keep_q, int64_t* out, int64_t n, bool reverse) {
  using namespace pts::split;
  std::vector<uint64_t> smem(words_of(pair_bytes(true)));
  lane_blocks(n, SELECT_LANES, reverse, [&](int64_t n0, int m) {
    select_lanes<F>(Serial{reverse}, smem.data(), p, q, keep_q, out, n0, m, n);
  });
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
// and 8 lanes, run lane by lane, 11-13 mul_small of a by 15, 45 and 64,
// 14 add32, 15 sub32 (the 32-bit-limb carry-chain add and sub).
extern "C" int mbt_host_binop(int field, int op, const int64_t* a, const int64_t* b, int64_t* out,
                              int64_t n) {
  return field == 0 ? run<0>(op, a, b, out, n) : run<1>(op, a, b, out, n);
}

// The one-thread point formulas on mul32, over rows layouts: p and out
// (3, 22, n). op 0: p +mixed q with q (2, 22, n) affine (x, y) (K6's add;
// q must not be the identity), 1: the doubling of p (K4's step), 2: the
// complete add p + q with q (3, 22, n) (padd_f, which no kernel runs: the
// one-thread oracle of the split add).
extern "C" int mbt_host_points(int field, int op, const int64_t* p, const int64_t* q, int64_t* out,
                               int64_t n) {
  return field == 0 ? points<0>(op, p, q, out, n) : points<1>(op, p, q, out, n);
}

// K3's one-step add (points.cu, padd_kernel) with the kernel's arguments:
// p, q, out (3, 22, n) rows; reverse: run the blocks and each phase's tasks
// last to first.
extern "C" int mbt_host_padd(int field, const int64_t* p, const int64_t* q, int64_t* out, int64_t n, int reverse) {
  if (n < 0) return 1;
  (field == 0 ? padd_blocks<0> : padd_blocks<1>)(p, q, out, n, reverse != 0);
  return 0;
}

// K5's one-step select (points.cu, padd_select_kernel) with the kernel's
// arguments: p, q, out (3, 22, n) rows, keep_q (n,) int32; reverse as above.
extern "C" int mbt_host_select(int field, const int64_t* p, const int64_t* q, const int32_t* keep_q, int64_t* out,
                               int64_t n, int reverse) {
  if (n < 0) return 1;
  (field == 0 ? select_blocks<0> : select_blocks<1>)(p, q, keep_q, out, n, reverse != 0);
  return 0;
}

// The MSM phases of points.cu with their kernels' arguments (no scratch):
// K3's bucket weighting, K3's fix-up (in place) and K5's lane repair;
// reverse: run each step's blocks and each phase's tasks last to first.
extern "C" int mbt_host_weight_sum(int field, const int64_t* buckets, int64_t* out, int64_t W, int64_t D, int64_t K,
                                   int64_t C, int reverse) {
  if (W < 0 || !pow2(D) || !pow2(K) || !pow2(C) || K > D || C > K) return 1;
  (field == 0 ? weight_sum<0> : weight_sum<1>)(buckets, out, W, D, K, C, reverse != 0);
  return 0;
}

extern "C" int mbt_host_fixup(int field, int64_t* buckets, const int64_t* inflow, const int64_t* dig, int64_t W,
                              int64_t G, int64_t T, int64_t NB, int reverse) {
  if (W < 0 || G < 0 || T < 1 || NB < 1) return 1;
  (field == 0 ? fixup_blocks<0> : fixup_blocks<1>)(buckets, inflow, dig, W, G, T, NB, reverse != 0);
  return 0;
}

extern "C" int mbt_host_lane_scan(int field, const int64_t* carry, const int32_t* has_start, int64_t* out, int64_t W,
                                  int64_t G, int reverse) {
  if (W < 0 || !pow2(G)) return 1;
  (field == 0 ? lane_scan<0> : lane_scan<1>)(carry, has_start, out, W, G, reverse != 0);
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
