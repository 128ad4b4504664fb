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
// Below the formulas are K3's one-step add, K5's one-step select and the
// MSM's three one-launch phases (K3's bucket weighting and fix-up, K5's
// lane scan) as programs of split point operations (namespace split: each
// add and doubling over several threads, phases between block barriers).
// points.cu runs them in its kernels; field_host.cpp runs the same code
// with every phase's tasks in turn (split::Serial), so the CPU tests check
// their index arithmetic and that no phase's tasks race.
#pragma once
#include <stddef.h>

#include "field.cuh"

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#endif

#if defined(__CUDACC__)
#define PHD __host__ __device__
#define PHD_CALL __host__ __device__ __noinline__
#else
#define PHD inline
#define PHD_CALL inline
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

// Complete addition (RCB16 Algorithm 7, a = 0) on one thread. No kernel
// runs it: the host build's op 2 keeps it as the one-thread oracle that
// the CPU tests hold the split add against.
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
// Split point operations: K3's one-step add, K5's one-step select, the
// MSM's bucket weighting and fix-up (K3) and its lane repair (K5) run
// every complete add and doubling over several threads.
//
// Points and temporaries sit in shared memory as Montgomery words (Vec).
// A round of operations (Op: p + q or 2 p, each on points of a Vec) runs
// in three phases with a block barrier after each:
//   1: the operation's independent products, one thread a (product, op):
//      the add's six (RCB16 Alg 7: x x', y y', z z' and the three cross
//      sums' products), the doubling's four (y^2, y z, z^2, x y);
//   2: the second level's products, each thread first forming its two
//      operands from phase 1's results with additions and small multiples
//      (15 = b3, 3, 8 and 45 by fld::mul_small, no Montgomery product):
//      six for the add, four for the doubling;
//   3: the result's three coordinates (sums of phase 2's products), handed
//      to the round's caller, one thread a coordinate.
// So an add is two products deep, not the ~14 of one thread's padd_f, and
// a round of m operations keeps 6 m threads busy. The values are padd_f's
// and pdouble_f's field elements, so the points are the same
// representatives the one-thread formulas (and the plain versions) give.
// Every task of a phase writes slots that no other task of the phase
// reads or writes, so the order of tasks within a phase does not matter
// (the host build runs them in either order). One loop body holds the
// products of phases 1 and 2 (one inlined mul32), so all of them share
// one copy of the code.
// ---------------------------------------------------------------------------
namespace split {

// Items with slots of one field element each: word w of slot k of item i
// at s[(4 k + w) n + i], so a warp's threads, on consecutive items, touch
// consecutive words.
struct Vec {
  uint64_t* s;
  int n;
  PHD Fe get(int k, int i) const {
    const uint64_t* b = s + (int64_t)4 * k * n + i;
    return {{b[0], b[n], b[2 * n], b[3 * n]}};
  }
  PHD void put(int k, int i, const Fe& v) const {
    uint64_t* b = s + (int64_t)4 * k * n + i;
    b[0] = v.w[0];
    b[n] = v.w[1];
    b[2 * n] = v.w[2];
    b[3 * n] = v.w[3];
  }
};

constexpr int PT_SLOTS = 3;   // a point: x, y, z
constexpr int TMP_SLOTS = 12;  // an op's temporaries: phase 1's six products, phase 2's six
constexpr int JOBS = 64;       // ops a round holds at once (tmp items)
constexpr int THREADS = 6 * JOBS;  // a block: one thread a (product, op)

// A point: item i of v, its coordinates in slots k, k + 1, k + 2.
struct PRef {
  Vec v;
  int k, i;
  PHD Fe get(int c) const { return v.get(k + c, i); }
  PHD void put(int c, const Fe& x) const { v.put(k + c, i, x); }
};

enum Kind : int { ADD, DBL };

// out = p + q (ADD, padd_f's order of operands) or 2 p (DBL); a dead op
// (live false) computes nothing and its round's caller gets no value.
struct Op {
  int kind;
  PRef p, q;
  bool live;
};

// Phase 1: product k's operands from the op's points.
template <int F>
PHD void operands1(int kind, const PRef& p, const PRef& q, int k, Fe& a, Fe& b) {
  if (kind == DBL) {
    a = p.get(k == 3 ? 0 : (k == 2 ? 2 : 1));  // y y, y z, z z, x y
    b = p.get(k == 0 || k == 3 ? 1 : 2);
  } else if (k < 3) {  // x x', y y', z z'
    a = p.get(k);
    b = q.get(k);
  } else {  // (x + y)(x' + y'), (y + z)(y' + z'), (x + z)(x' + z')
    const int c0 = k == 4 ? 1 : 0, c1 = k == 3 ? 1 : 2;
    a = fld::add32<F>(p.get(c0), p.get(c1));
    b = fld::add32<F>(q.get(c0), q.get(c1));
  }
}

// Phase 2: product k's operands from phase 1's products (tmp slots 0-5 of
// job j), in padd_f's and pdouble_f's names.
template <int F>
PHD void operands2(int kind, const Vec& tmp, int j, int k, Fe& a, Fe& b) {
  using fld::mul_small;
  auto add = [](const Fe& x, const Fe& y) { return fld::add32<F>(x, y); };
  auto sub = [](const Fe& x, const Fe& y) { return fld::sub32<F>(x, y); };
  if (kind == DBL) {  // tmp: y^2, y z, z^2, x y
    const Fe y2 = tmp.get(0, j);
    if (k < 2) {  // x3 = (b3 z^2) (8 y^2), z3 = (y z) (8 y^2)
      a = k == 0 ? mul_small<F>(tmp.get(2, j), 15) : tmp.get(1, j);
      b = mul_small<F>(y2, 8);
    } else {  // t0 = y^2 - 3 b3 z^2; y3 = t0 (y^2 + b3 z^2); x3 = t0 (x y)
      a = sub(y2, mul_small<F>(tmp.get(2, j), 45));
      b = k == 2 ? add(y2, mul_small<F>(tmp.get(2, j), 15)) : tmp.get(3, j);
    }
    return;
  }
  // tmp: t0 = x x', t1 = y y', t2 = z z', then the three cross products:
  //   t3 = xy' - t0 - t1, t4 = yz' - t1 - t2, y3 = b3 (xz' - t0 - t2),
  //   3 t0, t1 - b3 t2, z3 = t1 + b3 t2
  const Fe t0 = tmp.get(0, j), t1 = tmp.get(1, j), t2 = tmp.get(2, j);
  switch (k) {
    case 0:  // x3 = t4 y3
      a = sub(tmp.get(4, j), add(t1, t2));
      b = mul_small<F>(sub(tmp.get(5, j), add(t0, t2)), 15);
      break;
    case 1:  // t2 = t3 (t1 - b3 t2)
      a = sub(tmp.get(3, j), add(t0, t1));
      b = sub(t1, mul_small<F>(t2, 15));
      break;
    case 2:  // y3 = y3 (3 t0)
      a = mul_small<F>(sub(tmp.get(5, j), add(t0, t2)), 15);
      b = mul_small<F>(t0, 3);
      break;
    case 3:  // t1 = (t1 - b3 t2) z3
      a = sub(t1, mul_small<F>(t2, 15));
      b = add(t1, mul_small<F>(t2, 15));
      break;
    case 4:  // t0 = (3 t0) t3
      a = mul_small<F>(t0, 3);
      b = sub(tmp.get(3, j), add(t0, t1));
      break;
    default:  // z3 = z3 t4
      a = add(t1, mul_small<F>(t2, 15));
      b = sub(tmp.get(4, j), add(t1, t2));
  }
}

// Phase 1 or 2's product k of an op (phase 1 from its points p, q; phase
// 2 from tmp slots 0-5 of job j) into tmp slot 6 ph + k. Out of line: a
// kernel holds one copy of the operand forms and of the product.
template <int F>
PHD_CALL void product_task(int ph, int kind, int k, PRef p, PRef q, Vec tmp, int j) {
  Fe a, b;
  if (ph == 0)
    operands1<F>(kind, p, q, k, a, b);
  else
    operands2<F>(kind, tmp, j, k, a, b);
  tmp.put(6 * ph + k, j, fld::mul32<F>(a, b));
}

// Phase 3: coordinate c of the result from phase 2's products (slots 6-11).
template <int F>
PHD Fe result(int kind, const Vec& tmp, int j, int c) {
  if (kind == DBL) {  // x3 = 2 t0 x y, y3 = b3 z^2 8 y^2 + t0 (...), z3 = y z 8 y^2
    if (c == 0) return fld::add32<F>(tmp.get(9, j), tmp.get(9, j));
    if (c == 1) return fld::add32<F>(tmp.get(6, j), tmp.get(8, j));
    return tmp.get(7, j);
  }
  if (c == 0) return fld::sub32<F>(tmp.get(7, j), tmp.get(6, j));  // t3 t1 - t4 y3
  return fld::add32<F>(tmp.get(7 + 2 * c, j), tmp.get(6 + 2 * c, j));  // t1 z3 + y3 t0, z3 t4 + t0 t3
}

// How a block's threads take a phase's tasks: on the card thread tid of nt
// takes tasks tid, tid + nt, ...; sync() is the block barrier and any()
// __syncthreads_or. The host build's Serial runs every task of a phase in
// turn (or last to first) and needs no barrier.
struct Threads {
  int tid, nt;
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
  template <class Fn>
  PHD void tasks(int n, Fn fn) const {
#pragma unroll 1
    for (int t = tid; t < n; t += nt) fn(t);
  }
  PHD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
  template <class Fn>
  PHD bool any(int n, Fn pred) const {
    int v = 0;
#pragma unroll 1
    for (int t = tid; t < n; t += nt) v |= pred(t) ? 1 : 0;
#ifdef __CUDA_ARCH__
    return __syncthreads_or(v) != 0;
#else
    return v != 0;
#endif
  }
};

struct Serial {
  bool reverse;
  template <class Fn>
  PHD void tasks(int n, Fn fn) const {
    for (int t = 0; t < n; t++) fn(reverse ? n - 1 - t : t);
  }
  PHD void sync() const {}
  template <class Fn>
  PHD bool any(int n, Fn pred) const {
    bool v = false;
    for (int t = 0; t < n; t++) v |= pred(reverse ? n - 1 - t : t);
    return v;
  }
};

// A block's scratch for rounds: tmp (JOBS items of TMP_SLOTS) and the
// jobs' states (0 dead, else 1 + the op's kind).
struct Work {
  Vec tmp;
  int* live;
};

// Ops 0..n-1 (op(o) -> Op), JOBS at a time: three phases each; then
// done(o, c, v) for each op and coordinate (v the result's coordinate c
// where the op is live). FLAGGED: ops may be dead (the lane repair's
// selects); a pass before phase 1 keeps their states and skips phases 1
// and 2 when no op of the batch is live, and op is read only there and in
// phase 1, so done may write what op reads (the op's points, its flags).
// Otherwise every op is live, there is no such pass, and op must not read
// what done writes within a round (the weighting's ops).
template <int F, bool FLAGGED, class E, class OpFn, class Done>
PHD void run(const E& ex, const Work& wk, int n, OpFn op, Done done) {
  for (int base = 0; base < n; base += JOBS) {
    const int m = n - base < JOBS ? n - base : JOBS;
    auto kind_of = [&](int j) { return FLAGGED ? wk.live[j] - 1 : op(base + j).kind; };
    bool any = true;
    if (FLAGGED)
      any = ex.any(m, [&](int j) {
        const Op o = op(base + j);
        return (wk.live[j] = o.live ? 1 + o.kind : 0) != 0;
      });
    if (any) {
#pragma unroll 1
      for (int ph = 0; ph < 2; ph++) {
        ex.tasks(6 * m, [&](int t) {
          const int j = t % m, k = t / m, kind = kind_of(j);
          if (kind < 0 || (kind == DBL && k >= 4)) return;
          if (ph == 0) {
            const Op o = op(base + j);
            product_task<F>(0, kind, k, o.p, o.q, wk.tmp, j);
          } else {
            product_task<F>(1, kind, k, PRef{}, PRef{}, wk.tmp, j);
          }
        });
        ex.sync();
      }
    }
    ex.tasks(3 * m, [&](int t) {
      const int j = t % m, c = t / m, kind = kind_of(j);
      done(base + j, c, kind >= 0 ? result<F>(kind, wk.tmp, j, c) : fld::zero<F>());
    });
    ex.sync();
  }
}

// 22 limbs (stride apart) -> Montgomery form: fld::from_limbs on the
// out-of-line mul32, skipping the product of the part above 2^256 where it
// is 0 (canonical limbs, as every kernel writes).
template <int F>
PHD Fe to_mont(const int64_t* x, int64_t stride) {
  Fe lo, hi;
  fld::limbs_to_words(x, stride, lo, hi);
  const Fe r = fld::mul32_call<F>(lo, fld::Params<F>::r2());
  return fld::is_zero<F>(hi) ? r : fld::add32<F>(r, fld::mul32_call<F>(hi, fld::Params<F>::r3()));
}

template <int F>
PHD Fe identity_coord(int c) {
  return c == 1 ? fld::one<F>() : fld::zero<F>();
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
//
// First every chunk walks its buckets top down, run += B; tot += run (so
// tot = sum (d - o) B_d), and doubles run log2 S times (ma = S A): a unit
// of at most C chunks a block, their state in shared memory (item j of st:
// chunk j's ma in slots 0-2, its tw in 3-5, its S buckets from slot 6), round k
// running chunk j's k-th run add beside its (k-1)-th tot add, then the
// doublings beside the last tot add. The chunks' (ma, tw) then go to a Vec
// of all windows' chunk roots (item w K + j), and the tree's levels run on
// it, two rounds a level: tw_l + tw_r beside ma_l + ma_r, then + ma_r
// beside the doubling.
// ---------------------------------------------------------------------------
constexpr int W_MA = 0, W_TW = 3, W_BUCKETS = 6, W_ROOT_SLOTS = 6;
PHD constexpr int weight_slots(int S) { return W_BUCKETS + PT_SLOTS * S; }

// Load the n chunks of a unit, global chunks g0 .. g0 + n - 1 (chunk g is
// window g / K's chunk g % K), as Montgomery words, consecutive threads on
// consecutive buckets; every chunk's ma and tw start at the identity.
// buckets: (3, 22, W (D + 1)) lanes, bucket 0 of a window unread.
template <int F, class E>
PHD void weight_load(const E& ex, const Vec& st, int n, const int64_t* buckets, int g0, int W, int D, int K) {
  const int S = D / K, nS = n * S;
  const int64_t nb = (int64_t)W * (D + 1), cs = (int64_t)fld::REP_LIMBS * nb;
  ex.tasks(3 * nS + 6 * n, [&](int t) {
    if (t < 3 * nS) {
      const int i = t % nS, c = t / nS, j = i / S, g = g0 + j;
      const int64_t lane = (int64_t)(g / K) * (D + 1) + (int64_t)(g % K) * S + 1 + i % S;
      st.put(W_BUCKETS + PT_SLOTS * (i % S) + c, j, to_mont<F>(buckets + c * cs + lane, nb));
    } else {
      const int u = t - 3 * nS, j = u % n, k = u / n;  // slots 0-5: ma, tw
      st.put(k, j, identity_coord<F>(k % 3));
    }
  });
  ex.sync();
}

// The walks of st's first C chunks over their S buckets (log2 S
// doublings at the end).
template <int F, class E>
PHD void weight_walk(const E& ex, const Work& wk, const Vec& st, int C, int S) {
  int nd = 0;
  while ((1 << nd) < S) nd++;
  const int rounds = S + (nd > 1 ? nd : 1);
#pragma unroll 1
  for (int k = 0; k < rounds; k++) {
    // ops o < C: chunk o's tot add where this round has one (it reads run
    // before the run add or doubling writes it, also where the ops run in
    // several batches); the rest: its run add (rounds 0..S-1), then its
    // doublings (rounds S..S+nd-1)
    const bool tot = k >= 1 && k <= S, more = k < S + nd;
    run<F, false>(
        ex, wk, (tot && more ? 2 : 1) * C,
        [&](int o) {
          const int j = o % C;
          const PRef ma{st, W_MA, j}, tw{st, W_TW, j};
          if (tot && o < C) return Op{ADD, tw, ma, true};
          if (k < S) return Op{ADD, ma, PRef{st, W_BUCKETS + PT_SLOTS * (S - 1 - k), j}, true};
          return Op{DBL, ma, ma, true};
        },
        [&](int o, int c, const Fe& v) { st.put((tot && o < C ? W_TW : W_MA) + c, o % C, v); });
  }
}

// Merges [g0, g1) of one tree level over groups of s chunks, in the Vec
// tr of chunk roots (items w K + j): merge g of the W K / (2 s) is window
// w = g / M's (M = K / (2 s)) merge of items l = w K + (g % M) 2 s and
// r = l + s; ma is kept below the root (2 s < K).
template <int F, class E>
PHD void weight_level(const E& ex, const Work& wk, const Vec& tr, int K, int s, int g0, int g1) {
  const int M = K / (2 * s), cnt = g1 - g0;
  if (cnt <= 0) return;
  const bool with_ma = 2 * s < K;
  auto left = [&](int o) {
    const int g = g0 + o % cnt;
    return (g / M) * K + (g % M) * 2 * s;
  };
#pragma unroll 1
  for (int half = 0; half < 2; half++)
    run<F, false>(
        ex, wk, with_ma ? 2 * cnt : cnt,
        [&](int o) {
          const int l = left(o), r = l + s;
          if (o < cnt) return Op{ADD, PRef{tr, W_TW, l}, PRef{tr, half ? W_MA : W_TW, r}, true};
          if (half == 0) return Op{ADD, PRef{tr, W_MA, l}, PRef{tr, W_MA, r}, true};
          return Op{DBL, PRef{tr, W_MA, l}, PRef{tr, W_MA, l}, true};
        },
        [&](int o, int c, const Fe& v) { tr.put((o < cnt ? W_TW : W_MA) + c, left(o), v); });
}

// Units: the W K chunks of all windows in nu units of cu = ceil(W K / nu)
// chunks (the last ones short or empty), nu the larger of the grid's
// blocks and ceil(W K / C), so that a unit fits C items and the card's
// blocks share the walks evenly. Unit u: chunks from u cu, n of them.
PHD int weight_units(int W, int K, int C, int blocks) {
  const int ch = (W * K + C - 1) / C;
  return ch > blocks ? ch : blocks;
}

// Unit u of nu: its chunks loaded, walked and their (ma, tw) copied to the
// chunk roots tr (item g for global chunk g).
template <int F, class E>
PHD void weight_unit(const E& ex, const Work& wk, uint64_t* words, const Vec& tr, const int64_t* buckets, int W, int D,
                     int K, int u, int nu) {
  const int total = W * K, cu = (total + nu - 1) / nu, g0 = u * cu < total ? u * cu : total;
  const int n = g0 + cu < total ? cu : total - g0;
  if (n <= 0) return;
  const Vec st{words, cu};
  weight_load<F>(ex, st, n, buckets, g0, W, D, K);
  weight_walk<F>(ex, wk, st, n, D / K);
  ex.tasks(4 * W_ROOT_SLOTS * n, [&](int t) {
    const int j = t % n, q = t / n;
    tr.s[(int64_t)q * tr.n + g0 + j] = st.s[q * cu + j];
  });
  ex.sync();
}

// The windows' totals (item w K's tw) as canonical limbs, out (3, 22, W):
// windows w0, w0 + step, ...
template <int F, class E>
PHD void weight_store(const E& ex, const Vec& tr, int64_t* out, int W, int K, int w0, int step) {
  const int nw = w0 < W ? (W - w0 + step - 1) / step : 0;
  ex.tasks(3 * nw, [&](int t) {
    const int w = w0 + (t % nw) * step, c = t / nw;
    fld::to_limbs<F, fld::MUL32_CALL>(tr.get(W_TW + c, w * K), out + (int64_t)c * fld::REP_LIMBS * W + w, W);
  });
}

// The tree's levels of merges per window above which a level runs over
// all of the grid's blocks (a grid barrier before each); from it on, each
// window's last levels run on one block.
constexpr int WEIGHT_WINDOW_MERGES = 8;

// ---------------------------------------------------------------------------
// K5, the lane repair: an in-place Blelloch scan of a window's G lane
// carries a[] with segment flags f[] (G a power of two). The up-sweep
// combine is f_r ? a_r : a_l + a_r, the down-sweep's f_l ? a_l : e + a_l
// (e the parent's exclusive value), as in pmsm's loop of one-step K5
// launches; the left entries that loop stashes are the ones an in-place
// scan leaves untouched.
//
// A window's lanes are split over a cluster of CL blocks (lane_cluster),
// Gc = G / CL contiguous lanes each. The levels whose groups fit in Gc
// lanes run in each block on its own lanes; the levels above them touch
// only the blocks' last lanes (their roots), so block 0 runs them on a
// copy of the CL roots (top) that every block writes into its shared
// memory, and each block reads its root back: the same adds on the same
// operands as one scan over G lanes.
// ---------------------------------------------------------------------------
constexpr int LANE_CLUSTER = 8;  // blocks a window at most (a portable cluster)
constexpr int LANE_MIN = 32;     // lanes a block at least, where G allows

PHD int lane_cluster(int64_t G) {
  const int64_t c = G / LANE_MIN;
  return c < 1 ? 1 : (c > LANE_CLUSTER ? LANE_CLUSTER : (int)c);
}

// Lane i of the window's block: load its carry (3, 22, lanes) at lane
// index base + i and its flag.
template <int F, class E>
PHD void lane_load(const E& ex, const Vec& a, int32_t* f, const int64_t* carry, const int32_t* has_start, int64_t base,
                   int64_t lanes) {
  const int n = a.n;
  const int64_t cs = (int64_t)fld::REP_LIMBS * lanes;
  ex.tasks(3 * n, [&](int t) {
    const int i = t % n, c = t / n;
    a.put(c, i, to_mont<F>(carry + c * cs + base + i, lanes));
    if (c == 0) f[i] = has_start[base + i] != 0;
  });
  ex.sync();
}

template <int F, class E>
PHD void lane_store(const E& ex, const Vec& a, int64_t* out, int64_t base, int64_t lanes) {
  const int n = a.n;
  const int64_t cs = (int64_t)fld::REP_LIMBS * lanes;
  ex.tasks(3 * n, [&](int t) {
    const int i = t % n, c = t / n;
    fld::to_limbs<F, fld::MUL32_CALL>(a.get(c, i), out + c * cs + base + i, lanes);
  });
}

// The up-sweep's levels over a's n lanes.
template <int F, class E>
PHD void lane_up(const E& ex, const Work& wk, const Vec& a, int32_t* f) {
#pragma unroll 1
  for (int s = 1; s < a.n; s <<= 1)
    run<F, true>(
        ex, wk, a.n / (2 * s),
        [&](int m) {
          const int l = m * 2 * s + s - 1, r = l + s;
          return Op{ADD, PRef{a, 0, l}, PRef{a, 0, r}, !f[r]};
        },
        [&](int m, int c, const Fe& v) {
          const int l = m * 2 * s + s - 1, r = l + s;
          if (wk.live[m % JOBS]) a.put(c, r, v);
          if (c == 0) f[r] |= f[l];
        });
}

// The down-sweep's levels over a's n lanes.
template <int F, class E>
PHD void lane_down(const E& ex, const Work& wk, const Vec& a, const int32_t* f) {
#pragma unroll 1
  for (int s = a.n / 2; s >= 1; s >>= 1)
    run<F, true>(
        ex, wk, a.n / (2 * s),
        [&](int m) {
          const int l = m * 2 * s + s - 1, r = l + s;
          return Op{ADD, PRef{a, 0, r}, PRef{a, 0, l}, !f[l]};
        },
        [&](int m, int c, const Fe& v) {
          const int l = m * 2 * s + s - 1, r = l + s;
          const Fe left = a.get(c, l);
          a.put(c, l, a.get(c, r));
          a.put(c, r, wk.live[m % JOBS] ? v : left);
        });
}

// Block 0's part between the cluster's barriers: the scan's top levels
// over the CL roots, the root of all set to the identity between sweeps.
template <int F, class E>
PHD void lane_top(const E& ex, const Work& wk, const Vec& top, int32_t* topf) {
  lane_up<F>(ex, wk, top, topf);
  ex.tasks(3, [&](int c) { top.put(c, top.n - 1, identity_coord<F>(c)); });
  ex.sync();
  lane_down<F>(ex, wk, top, topf);
}

// Shared memory of a block of a split program: its point items (`slots`
// slots of n items), the round scratch (tmp of JOBS items, then the jobs'
// states) and `ints` more int32 words.
constexpr size_t block_bytes(int slots, int n, int ints) {
  return ((size_t)4 * slots * n + (size_t)4 * TMP_SLOTS * JOBS) * sizeof(uint64_t) +
         ((size_t)ints + JOBS) * sizeof(int32_t);
}

// The weighting's block: C chunks of S buckets.
constexpr size_t weight_bytes(int S, int C) { return block_bytes(weight_slots(S), C, 0); }

// The repair's block: Gc lanes (their points unless they are in scratch),
// block 0's top items (LANE_CLUSTER points), the lanes' and the top's flags.
constexpr size_t lane_bytes(int Gc, bool scratch) {
  return block_bytes(PT_SLOTS, scratch ? 0 : Gc, Gc + LANE_CLUSTER) +
         (size_t)4 * PT_SLOTS * LANE_CLUSTER * sizeof(uint64_t);
}

// The round scratch of a block whose first `words` words hold its items.
PHD Work block_work(uint64_t* smem, size_t words) {
  uint64_t* tmp = smem + words;
  return {{tmp, JOBS}, reinterpret_cast<int*>(tmp + 4 * TMP_SLOTS * JOBS)};
}

// ---------------------------------------------------------------------------
// K3's one-step add (padd) and the MSM's fix-up (padd_fixup): a block takes
// m <= JOBS consecutive lanes (PADD_LANES, FIXUP_LANES), one add a lane, as
// one round of split ops on the lanes' two points (item i of a Vec: p in
// slots 0-2, q in 3-5), loaded as Montgomery words and stored as canonical
// limbs one thread a (coordinate, lane); consecutive threads take
// consecutive lanes, so a wide launch loads and stores coalesced. At one
// lane the dependent path is a conversion in, two levels of products and a
// conversion out.
//
// The fix-up: lane l = w G + g of the chunked scan owns positions
// [g T, (g + 1) T) of window w's sorted digits dig (W, G T). The bucket d
// whose segment holds position g T needs the lane's inflow iff the
// segment began in an earlier lane (the digit at g T - 1 is d) and ends in
// this one (g is the window's last lane, or the digit at (g + 1) T is not
// d); then bucket = bucket + inflow, in place in buckets (3, 22, W, NB).
// A segment of sorted digits has one last position, so a bucket has at
// most one fixing lane: the lanes' in-place writes never meet, whatever
// the order of blocks (the host build's test checks that no bucket is
// fixed twice).
// ---------------------------------------------------------------------------
constexpr int PAIR_SLOTS = 2 * PT_SLOTS;

// A block's shared memory: JOBS lanes' two points, the round scratch, and
// (the fix-up) JOBS bucket indexes or (the select) JOBS flags.
constexpr size_t pair_bytes(bool fixup) { return block_bytes(PAIR_SLOTS, JOBS, fixup ? 2 * JOBS : 0); }

// Lanes a block of padd and of the fix-up (points.cu, lane_shape: the
// faster shapes of scripts/torch_kernel_sweep.py --parts k3).
constexpr int PADD_LANES = 32, FIXUP_LANES = JOBS;

// The lanes' points, the round scratch after them.
PHD Vec pair_items(uint64_t* smem) { return {smem, JOBS}; }
PHD Work pair_work(uint64_t* smem) { return block_work(smem, (size_t)4 * PAIR_SLOTS * JOBS); }

// p + q over lanes n0 .. n0 + m - 1 of (3, 22, N) rows; out the same.
template <int F, class E>
PHD void padd_lanes(const E& ex, uint64_t* smem, const int64_t* p, const int64_t* q, int64_t* out, int64_t n0, int m,
                    int64_t N) {
  const Vec v = pair_items(smem);
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  ex.tasks(PAIR_SLOTS * m, [&](int t) {
    const int i = t % m, k = t / m;
    v.put(k, i, to_mont<F>((k < PT_SLOTS ? p + k * cs : q + (k - PT_SLOTS) * cs) + n0 + i, N));
  });
  ex.sync();
  run<F, false>(
      ex, pair_work(smem), m, [&](int o) { return Op{ADD, PRef{v, 0, o}, PRef{v, PT_SLOTS, o}, true}; },
      [&](int o, int c, const Fe& r) { fld::to_limbs<F, fld::MUL32_CALL>(r, out + c * cs + n0 + o, N); });
}

// The bucket that lane (w, g) fixes, as its index w NB + d among the W NB,
// or -1 if it fixes none.
PHD int64_t fix_bucket(const int64_t* dig, int64_t w, int64_t g, int64_t G, int64_t T, int64_t NB) {
  if (g == 0) return -1;
  const int64_t* dw = dig + w * G * T;
  const int64_t p0 = g * T, d = dw[p0];
  if (dw[p0 - 1] != d || (g + 1 < G && dw[p0 + T] == d) || d < 0 || d >= NB) return -1;
  return w * NB + d;
}

// The fix-up of lanes l0 .. l0 + m - 1 of the W G: a dead op where a lane
// fixes no bucket, which loads and stores nothing.
template <int F, class E>
PHD void fixup_lanes(const E& ex, uint64_t* smem, int64_t* buckets, const int64_t* inflow, const int64_t* dig,
                     int64_t l0, int m, int64_t W, int64_t G, int64_t T, int64_t NB) {
  const Vec v = pair_items(smem);
  const Work wk = pair_work(smem);
  int64_t* at = reinterpret_cast<int64_t*>(wk.live + JOBS);  // 8-byte aligned: JOBS is even
  const int64_t nb = W * NB, lanes = W * G, bs = (int64_t)fld::REP_LIMBS * nb, is = (int64_t)fld::REP_LIMBS * lanes;
  ex.tasks(m, [&](int i) { at[i] = fix_bucket(dig, (l0 + i) / G, (l0 + i) % G, G, T, NB); });
  ex.sync();
  ex.tasks(PAIR_SLOTS * m, [&](int t) {
    const int i = t % m, k = t / m;
    if (at[i] < 0) return;
    v.put(k, i, k < PT_SLOTS ? to_mont<F>(buckets + k * bs + at[i], nb)
                             : to_mont<F>(inflow + (k - PT_SLOTS) * is + l0 + i, lanes));
  });
  ex.sync();
  run<F, true>(
      ex, wk, m, [&](int o) { return Op{ADD, PRef{v, 0, o}, PRef{v, PT_SLOTS, o}, at[o] >= 0}; },
      [&](int o, int c, const Fe& r) {
        if (at[o] >= 0) fld::to_limbs<F, fld::MUL32_CALL>(r, buckets + c * bs + at[o], nb);
      });
}

// ---------------------------------------------------------------------------
// K5's one-step select (padd_select): out = keep_q ? q : p + q over m <=
// JOBS consecutive lanes a block (SELECT_LANES), the fix-up's program with
// keep_q as the dead flag: a first pass puts the lanes' flags where the
// fix-up keeps its bucket indexes; a live lane's p and q are converted one
// thread a (coordinate, lane) and added in one FLAGGED round of split ops
// (a batch with no live lane skips the products); a kept lane loads and
// multiplies nothing and stores q as canonical limbs (canon_limbs), one
// thread a (coordinate, lane), where a live lane stores its sum. The two
// stores never touch the same lane. (Listing a block's live lanes first,
// so that only their threads run products, was no faster: where live
// lanes are sparse a block's time is its dependent chain of loads,
// products and barriers, not its products' count; PERF.md.)
// ---------------------------------------------------------------------------

// Lanes a block of the select (points.cu, lane_shape). In
// scripts/torch_kernel_sweep.py --parts k5, 32 ran within 1% of 16 and
// 10-17% faster than 64 at 4,097 and 10,240 lanes, within 2% of 64 and
// 12% faster than 16 at 20,480 (PERF.md).
constexpr int SELECT_LANES = 32;

// a < p, a as four 64-bit words.
template <int F>
PHD bool below_p(const Fe& a) {
  const Fe p = fld::Params<F>::p();
  for (int j = 3; j > 0; j--)
    if (a.w[j] != p.w[j]) return a.w[j] < p.w[j];
  return a.w[0] < p.w[0];
}

// 22 limbs (stride apart) -> canonical limbs at o: a value below p (as
// canonical limbs are) is re-split without a product, the same limbs as a
// copy; a larger one (lazy limbs) goes through Montgomery form.
template <int F>
PHD void canon_limbs(const int64_t* x, int64_t* o, int64_t stride) {
  Fe lo, hi;
  fld::limbs_to_words(x, stride, lo, hi);
  if (fld::is_zero<F>(hi) && below_p<F>(lo))
    fld::words_to_limbs(lo, o, stride);
  else
    fld::to_limbs<F, fld::MUL32_CALL>(to_mont<F>(x, stride), o, stride);
}

// keep_q ? q : p + q over lanes n0 .. n0 + m - 1 of (3, 22, N) rows; out
// the same, keep_q (N,) int32.
template <int F, class E>
PHD void select_lanes(const E& ex, uint64_t* smem, const int64_t* p, const int64_t* q, const int32_t* keep_q,
                      int64_t* out, int64_t n0, int m, int64_t N) {
  const Vec v = pair_items(smem);
  const Work wk = pair_work(smem);
  int32_t* keep = wk.live + JOBS;  // the fix-up's bucket indexes
  const int64_t cs = (int64_t)fld::REP_LIMBS * N;
  ex.tasks(m, [&](int i) { keep[i] = keep_q[n0 + i] != 0; });
  ex.sync();
  ex.tasks(PAIR_SLOTS * m, [&](int t) {
    const int i = t % m, k = t / m;
    if (keep[i]) return;
    v.put(k, i, to_mont<F>((k < PT_SLOTS ? p + k * cs : q + (k - PT_SLOTS) * cs) + n0 + i, N));
  });
  ex.sync();
  run<F, true>(
      ex, wk, m, [&](int o) { return Op{ADD, PRef{v, 0, o}, PRef{v, PT_SLOTS, o}, !keep[o]}; },
      [&](int o, int c, const Fe& r) {
        const int64_t at = c * cs + n0 + o;
        if (keep[o])
          canon_limbs<F>(q + at, out + at, N);
        else
          fld::to_limbs<F, fld::MUL32_CALL>(r, out + at, N);
      });
}

// A block's program marks the start of unit u (stamp(-1, u)) and the end
// of each of its steps (stamp(k, u)), all its threads after a barrier; the
// kernels on the path and the host build take NoStamp,
// scripts/torch_weight_sweep.py's timeline records the time.
struct NoStamp {
  PHD void operator()(int, int) const {}
};

// How a kernel's blocks take the steps of its program, the barriers
// between steps spanning blocks (a grid's or a cluster's):
//   blocks(): the blocks the program spans (the grid, or a cluster);
//   step(fn): fn(r, blk, ex, smem) for the block of rank r among them,
//     blk its index in the launch's grid, ex its threads, smem its shared
//     memory;
//   sync(): the barrier between steps;
//   arrive(), wait(): a split barrier (every block has started after the
//     wait); peer(p, r): p in block r's shared memory.
// On the card (GridBlock, ClusterBlock below) step runs fn once, for this
// block. The host build's SerialBlocks runs fn for every block in turn (or
// last to first), each with its own shared memory, and needs no barrier:
// the kernels and the host build run the same program.
struct SerialBlocks {
  int nb, first;  // nb blocks, grid indexes first .. first + nb - 1
  bool reverse;
  uint64_t* smem;  // nb blocks' shared memory, `words` words each
  size_t words;
  PHD int blocks() const { return nb; }
  template <class Fn>
  PHD void step(Fn fn) const {
    for (int i = 0; i < nb; i++) {
      const int r = reverse ? nb - 1 - i : i;
      fn(r, first + r, Serial{reverse}, smem + r * words);
    }
  }
  PHD void sync() const {}
  PHD void arrive() const {}
  PHD void wait() const {}
  template <class T>
  PHD T* peer(T* p, int r) const {
    const int64_t mine = (int64_t)(reinterpret_cast<uint64_t*>(p) - smem) / (int64_t)words;
    return reinterpret_cast<T*>(reinterpret_cast<uint64_t*>(p) + (r - mine) * (int64_t)words);
  }
};

// K3's bucket weighting (points.cu, padd_weight_sum_kernel: a cooperative
// launch of as many blocks as the card holds). Block b walks units u = b,
// b + nb, ... (weight_units; stamp(-1, u) before, stamp(1, u) after);
// then every level of the tree whose windows hold more than
// WEIGHT_WINDOW_MERGES merges runs over all blocks, a contiguous share of
// the level's merges a block, a barrier before each (stamp(k, units + k /
// 5) for level k, block 0); then block b finishes windows b, b + nb, ...
// alone and stores their totals. roots: the chunk roots, W K items of 6
// slots.
template <int F, class Blocks, class Stamp>
FHD void weight_grid(const Blocks& grid, const int64_t* buckets, int64_t* out, uint64_t* roots, int W, int D, int K,
                     int C, Stamp stamp) {
  const int nb = grid.blocks(), units = weight_units(W, K, C, nb);
  const size_t words = (size_t)4 * weight_slots(D / K) * C;
  const Vec tr{roots, W * K};
  grid.step([&](int b, int, const auto& ex, uint64_t* smem) {
    const Work wk = block_work(smem, words);
#pragma unroll 1
    for (int u = b; u < units; u += nb) {
      stamp(-1, u);
      weight_unit<F>(ex, wk, smem, tr, buckets, W, D, K, u, units);
      stamp(1, u);
    }
  });
  int s = 1, level = 0;
#pragma unroll 1
  for (; s < K && K / (2 * s) > WEIGHT_WINDOW_MERGES; s <<= 1, level++) {
    grid.sync();
    const int total = W * (K / (2 * s)), per = (total + nb - 1) / nb;
    grid.step([&](int b, int, const auto& ex, uint64_t* smem) {
      const int g0 = b * per < total ? b * per : total, g1 = g0 + per < total ? g0 + per : total;
      weight_level<F>(ex, block_work(smem, words), tr, K, s, g0, g1);
      if (b == 0) stamp(level % 5, units + level / 5);
    });
  }
  grid.sync();
  grid.step([&](int b, int, const auto& ex, uint64_t* smem) {
    const Work wk = block_work(smem, words);
#pragma unroll 1
    for (int w = b; w < W; w += nb)
#pragma unroll 1
      for (int s2 = s; s2 < K; s2 <<= 1)
        weight_level<F>(ex, wk, tr, K, s2, w * (K / (2 * s2)), (w + 1) * (K / (2 * s2)));
    weight_store<F>(ex, tr, out, W, K, b, nb);
  });
}

// A block of the repair in its shared memory (lane_bytes): its lanes'
// points (in smem, or block blk's part of scratch (W, G, 12 words) in
// device memory when scratch is given), the round scratch, block 0's top
// items, the lanes' flags, the top's flags.
struct LaneBlock {
  Vec a;
  Work wk;
  uint64_t* top;
  int32_t *f, *topf;
};

PHD LaneBlock lane_layout(uint64_t* smem, uint64_t* scratch, int blk, int Gc) {
  const Vec a{scratch ? scratch + (int64_t)blk * 4 * PT_SLOTS * Gc : smem, Gc};
  const Work wk = block_work(smem, scratch ? 0 : (size_t)4 * PT_SLOTS * Gc);
  uint64_t* top = reinterpret_cast<uint64_t*>(wk.live + JOBS);  // 8-byte aligned: JOBS is even
  int32_t* f = reinterpret_cast<int32_t*>(top + 4 * PT_SLOTS * LANE_CLUSTER);
  return {a, wk, top, f, f + Gc};
}

// K5's lane repair of one window (points.cu, padd_select_scan_kernel: a
// cluster of CL blocks a window, grid W CL). Block r of the cluster (grid
// block blk) holds lanes r Gc .. (r + 1) Gc - 1 (Gc = G / CL), at lane
// index blk Gc of all windows'; it loads them (stamp 0), runs the
// up-sweep's levels within them (1) and, once every block of the cluster
// has started, writes its root (the last lane, with its flag) into block
// 0's top items; block 0 runs the top levels on them; each block reads
// its root back (2, 3), runs the down-sweep's levels (4) and stores its
// lanes.
template <int F, class Blocks, class Stamp>
FHD void lane_scan(const Blocks& cl, const int64_t* carry, const int32_t* has_start, int64_t* out,
                   uint64_t* scratch, int W, int G, Stamp stamp) {
  const int CL = cl.blocks(), Gc = G / CL;
  const int64_t lanes = (int64_t)W * G;
  cl.step([&](int r, int blk, const auto& ex, uint64_t* smem) {
    const LaneBlock lb = lane_layout(smem, scratch, blk, Gc);
    stamp(-1, blk);
    lane_load<F>(ex, lb.a, lb.f, carry, has_start, (int64_t)blk * Gc, lanes);
    cl.arrive();
    stamp(0, blk);
    lane_up<F>(ex, lb.wk, lb.a, lb.f);
    stamp(1, blk);
    cl.wait();
    const Vec top0{cl.peer(lb.top, 0), CL};
    int32_t* topf0 = cl.peer(lb.topf, 0);
    ex.tasks(4, [&](int c) {
      if (c < 3)
        top0.put(c, r, lb.a.get(c, Gc - 1));
      else
        topf0[r] = lb.f[Gc - 1];
    });
  });
  cl.sync();
  cl.step([&](int r, int blk, const auto& ex, uint64_t* smem) {
    if (r != 0) return;
    const LaneBlock lb = lane_layout(smem, scratch, blk, Gc);
    lane_top<F>(ex, lb.wk, Vec{lb.top, CL}, lb.topf);
  });
  cl.sync();
  cl.step([&](int r, int blk, const auto& ex, uint64_t* smem) {
    const LaneBlock lb = lane_layout(smem, scratch, blk, Gc);
    stamp(2, blk);
    const Vec top0{cl.peer(lb.top, 0), CL};
    ex.tasks(3, [&](int c) { lb.a.put(c, Gc - 1, top0.get(c, r)); });
    ex.sync();
    stamp(3, blk);
    lane_down<F>(ex, lb.wk, lb.a, lb.f);
    stamp(4, blk);
    lane_store<F>(ex, lb.a, out, (int64_t)blk * Gc, lanes);
  });
  cl.sync();  // block 0's top stays readable until every block has read its root
}

#ifdef __CUDACC__
// This block of a cooperative grid (every block of it resident). Its
// members are host-device so that the programs above stay so; they do
// nothing on the host, where no kernel runs.
struct GridBlock {
  uint64_t* smem;
  PHD int blocks() const {
#ifdef __CUDA_ARCH__
    return (int)gridDim.x;
#else
    return 0;
#endif
  }
#pragma nv_exec_check_disable
  template <class Fn>
  PHD void step(Fn fn) const {
#ifdef __CUDA_ARCH__
    fn((int)blockIdx.x, (int)blockIdx.x, Threads{(int)threadIdx.x, (int)blockDim.x}, smem);
#endif
  }
  PHD void sync() const {
#ifdef __CUDA_ARCH__
    cooperative_groups::this_grid().sync();
#endif
  }
};

// This block of a cluster of n blocks along x. arrive() and wait() are
// barrier.cluster's two halves: after the wait every block of the cluster
// has arrived, so has started, and its shared memory may be touched.
struct ClusterBlock {
  uint64_t* smem;
  int n;
  PHD int blocks() const { return n; }
#pragma nv_exec_check_disable
  template <class Fn>
  PHD void step(Fn fn) const {
#ifdef __CUDA_ARCH__
    fn((int)cooperative_groups::this_cluster().block_rank(), (int)blockIdx.x,
       Threads{(int)threadIdx.x, (int)blockDim.x}, smem);
#endif
  }
  PHD void sync() const {
#ifdef __CUDA_ARCH__
    cooperative_groups::this_cluster().sync();
#endif
  }
  PHD void arrive() const {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
#endif
  }
  PHD void wait() const {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
#endif
  }
  template <class T>
  PHD T* peer(T* p, int r) const {
#ifdef __CUDA_ARCH__
    return cooperative_groups::this_cluster().map_shared_rank(p, r);
#else
    return p;
#endif
  }
};
#endif

}  // namespace split

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
