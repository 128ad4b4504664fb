// Projective point formulas on Pallas/Vesta (a = 0, b3 = 3 * b = 15,
// y^2 = x^3 + 5), shared by the kernels of points.cu and the host build
// of the CPU tests (field_host.cpp).
//
// Counterpart of the jnp bodies in mina_bridge_tpu/curves/pallas_kernels.py
// (padd_rows, pdouble_rows, padd_mixed_rows). P picks how the field
// products are taken (fld::Product): one out-of-line mul32 for K3-K6. All
// compute the same values, so the formulas give the same points either
// way. K7 runs the mixed add as a program of field operations (k7 below),
// with one inlined mul32 for all of its products.
//
// Below the formulas are the per-thread steps of the MSM's three
// one-launch phases (the bucket weighting and the fix-up of K3, the lane
// scan of K5). points.cu runs them in its kernels between block barriers;
// field_host.cpp runs the same steps in loops, so the CPU tests check
// their index arithmetic.
#pragma once
#include <stddef.h>

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

// ---------------------------------------------------------------------------
// K7: keep_q ? q : (q_inf ? p : p +mixed q), q's Z row 0 or 1.
//
// A block takes lpb lanes and runs a fixed program in six phases, with a
// barrier between phases: each phase is up to six independent tasks a
// lane, one thread a (task, lane), and a task is a few field operations
// on the lane's slots (coordinates and temporaries, in shared memory).
//   0: convert p's and q's six coordinates (one a task: 2 products);
//   1: padd_mixed_f's six independent products (and their sums);
//   2: the sums and differences of its middle;
//   3: its five products of the second level;
//   4: its last two products and the result's coordinates;
//   5: the selected point's three coordinates out (1 product each).
// So a lane's 28 products run on up to six threads, six deep, and the
// card holds six times the warps of one thread a lane, to hide each
// product's latency. Every task of a phase writes slots that no other
// task of the phase reads or writes, so the order of tasks does not
// matter. One loop body holds the only product (an inlined mul32), so
// all of it is one copy of the code. Every lane runs the same operations
// whatever its masks say; the masks pick the slots phase 5 writes out.
// ---------------------------------------------------------------------------
namespace k7 {

enum Code : uint8_t { NOP, LOAD, MUL, ADD, SUB, OUT };

struct Op {
  uint8_t code, dst, a, b;
};

// Lane slots, then the constants b3, R^2 and R^3 (from_limbs's factors)
// and the integer 1 (to_limbs's). T0..Y3 hold the conversions' high
// parts in phase 0. RX, RY, RZ: the sum; OUT takes slot a of the point
// that starts at the lane's selected slot (QX, PX or RX).
enum Slot : uint8_t {
  PX, PY, PZ, QX, QY, QZ, T0, T1, T2, T3, T4, Y3, U, V, W, X, A, B, C, D, E, F, RX, RY, RZ,
  LANE_SLOTS, B3 = LANE_SLOTS, R2, R3, UNIT
};

constexpr int PHASES = 6, TASKS = 6, STEPS = 4;

#define K7_N {NOP, 0, 0, 0}
#define K7_CONV(c, h) {{LOAD, c, c, h}, {MUL, c, c, R2}, {MUL, h, h, R3}, {ADD, c, c, h}}
#define K7_PROGRAM                                                                                          \
  {                                                                                                         \
    {K7_CONV(PX, T0), K7_CONV(PY, T1), K7_CONV(PZ, T2), K7_CONV(QX, T3), K7_CONV(QY, T4), K7_CONV(QZ, Y3)}, \
    {{{MUL, T0, PX, QX}, K7_N, K7_N, K7_N},                 /* t0 = px x2 */                                \
     {{MUL, T1, PY, QY}, K7_N, K7_N, K7_N},                 /* t1 = py y2 */                                \
     {{ADD, T3, QX, QY}, {ADD, U, PX, PY}, {MUL, T3, T3, U}, K7_N}, /* t3 = (x2 + y2)(px + py) */          \
     {{MUL, T4, QY, PZ}, {ADD, T4, T4, PY}, K7_N, K7_N},    /* t4 = y2 pz + py */                           \
     {{MUL, Y3, QX, PZ}, {ADD, Y3, Y3, PX}, K7_N, K7_N},    /* y3 = x2 pz + px */                           \
     {{MUL, T2, PZ, B3}, K7_N, K7_N, K7_N}},                /* t2 = b3 pz */                                \
    {{{ADD, U, T0, T1}, {SUB, U, T3, U}, K7_N, K7_N},       /* t3 - t0 - t1 */                              \
     {{SUB, V, T1, T2}, K7_N, K7_N, K7_N},                  /* t1 - t2 */                                   \
     {{ADD, W, T1, T2}, K7_N, K7_N, K7_N},                  /* z3 = t1 + t2 */                              \
     {{ADD, X, T0, T0}, {ADD, X, X, T0}, K7_N, K7_N},       /* 3 t0 */                                      \
     {K7_N, K7_N, K7_N, K7_N},                                                                              \
     {K7_N, K7_N, K7_N, K7_N}},                                                                             \
    {{{MUL, Y3, Y3, B3}, K7_N, K7_N, K7_N},                 /* y3 = b3 y3 */                                \
     {{MUL, A, U, V}, K7_N, K7_N, K7_N},                    /* t2 = t3 t1 */                                \
     {{MUL, B, V, W}, K7_N, K7_N, K7_N},                    /* t1 = t1 z3 */                                \
     {{MUL, C, X, U}, K7_N, K7_N, K7_N},                    /* t0 = t0 t3 */                                \
     {{MUL, D, W, T4}, K7_N, K7_N, K7_N},                   /* z3 = z3 t4 */                                \
     {K7_N, K7_N, K7_N, K7_N}},                                                                             \
    {{{MUL, E, T4, Y3}, {SUB, RX, A, E}, K7_N, K7_N},       /* x3 = t2 - t4 y3 */                           \
     {{MUL, F, Y3, X}, {ADD, RY, B, F}, K7_N, K7_N},        /* y3 = t1 + y3 t0 */                           \
     {{ADD, RZ, D, C}, K7_N, K7_N, K7_N},                   /* z3 = z3 + t0 */                              \
     {K7_N, K7_N, K7_N, K7_N},                                                                              \
     {K7_N, K7_N, K7_N, K7_N},                                                                              \
     {K7_N, K7_N, K7_N, K7_N}},                                                                             \
    {{{OUT, 0, 0, UNIT}, K7_N, K7_N, K7_N},                                                                 \
     {{OUT, 0, 1, UNIT}, K7_N, K7_N, K7_N},                                                                 \
     {{OUT, 0, 2, UNIT}, K7_N, K7_N, K7_N},                                                                 \
     {K7_N, K7_N, K7_N, K7_N},                                                                              \
     {K7_N, K7_N, K7_N, K7_N},                                                                              \
     {K7_N, K7_N, K7_N, K7_N}},                                                                             \
  }
#if defined(__CUDACC__)
__constant__ Op PROGRAM_DEVICE[PHASES][TASKS][STEPS] = K7_PROGRAM;
#endif
constexpr Op PROGRAM_HOST[PHASES][TASKS][STEPS] = K7_PROGRAM;
#undef K7_PROGRAM
#undef K7_CONV
#undef K7_N

PHD Op program(int phase, int task, int step) {
#ifdef __CUDA_ARCH__
  return PROGRAM_DEVICE[phase][task][step];
#else
  return PROGRAM_HOST[phase][task][step];
#endif
}

template <int F>
PHD Fe constant(int k) {
  if (k == B3) return fld::Params<F>::b3();
  if (k == R2) return fld::Params<F>::r2();
  if (k == R3) return fld::Params<F>::r3();
  return {{1, 0, 0, 0}};
}

// A block's slots: word w of slot k of lane l at s[(4 k + w) lpb + l], so a
// warp of one task reads consecutive words.
struct Slots {
  uint64_t* s;
  int lpb, l;
  PHD Fe get(int k) const {
    const uint64_t* b = s + 4 * k * lpb + l;
    return {{b[0], b[lpb], b[2 * lpb], b[3 * lpb]}};
  }
  PHD void put(int k, const Fe& v) const {
    uint64_t* b = s + 4 * k * lpb + l;
    b[0] = v.w[0];
    b[lpb] = v.w[1];
    b[2 * lpb] = v.w[2];
    b[3 * lpb] = v.w[3];
  }
};

// The lane's selected point (phase 5): q if keep_q, else p if q_inf, else
// the sum. Read once, by the first task of phase 0.
PHD int select(int keep, int inf) { return keep ? QX : (inf ? PX : RX); }

// One task of one phase for lane n (of N; a lane past N loads and stores
// nothing). sel: the lane's select() value.
template <int F>
PHD void task(int phase, int t, const Slots& S, int sel, const int64_t* p, const int64_t* q, int64_t* out, int64_t n,
              int64_t N) {
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  const bool live = n < N;
#pragma unroll 1
  for (int k = 0; k < STEPS; k++) {
    const Op op = program(phase, t, k);
    if (op.code == NOP) break;
    if (op.code == LOAD) {
      Fe lo = {{0, 0, 0, 0}}, hi = {{0, 0, 0, 0}};
      if (live) fld::limbs_to_words((op.a < 3 ? p + op.a * cs : q + (op.a - 3) * cs) + n, N, lo, hi);
      S.put(op.dst, lo);
      S.put(op.b, hi);
      continue;
    }
    const Fe a = S.get(op.code == OUT ? sel + op.a : op.a);
    const Fe b = op.b < LANE_SLOTS ? S.get(op.b) : constant<F>(op.b);
    Fe r;
    if (op.code == ADD)
      r = fld::add<F>(a, b);
    else if (op.code == SUB)
      r = fld::sub<F>(a, b);
    else
      r = fld::mul32<F>(a, b);
    if (op.code != OUT)
      S.put(op.dst, r);
    else if (live)
      fld::words_to_limbs(r, out + op.a * cs + n, N);
  }
}

// A block's shared memory: lpb lanes' slots, then their select() values.
constexpr size_t block_bytes(int lpb) { return (size_t)lpb * (4 * LANE_SLOTS * sizeof(uint64_t) + sizeof(int)); }

#ifdef __CUDACC__
// One block of K7: lpb lanes and TASKS lpb threads; thread (t, l) runs
// task t of every phase for lane l, a barrier after each phase. slots:
// the block's block_bytes(lpb) of shared memory.
template <int F>
__device__ __forceinline__ void block(int lpb, uint64_t* slots, const int64_t* p, const int64_t* q,
                                      const int32_t* keep_q, const int32_t* q_inf, int64_t* out, int64_t N) {
  const int t = threadIdx.x / lpb, l = threadIdx.x % lpb;
  const int64_t n = (int64_t)blockIdx.x * lpb + l;
  int* sel = reinterpret_cast<int*>(slots + 4 * LANE_SLOTS * lpb);
  if (t == 0) sel[l] = n < N ? select(keep_q[n], q_inf[n]) : RX;
  const Slots S{slots, lpb, l};
#pragma unroll 1
  for (int phase = 0; phase < PHASES; phase++) {
    task<F>(phase, t, S, phase == PHASES - 1 ? sel[l] : 0, p, q, out, n, N);
    __syncthreads();
  }
}
#endif

}  // namespace k7

}  // namespace pts
