// Pasta field arithmetic for the port's hand-written kernels.
//
// Counterpart of mina_bridge_tpu/fields/rows.py (mul_r / square_r / add_r /
// sub_r / mul_small_r), which is the field library inside every Pallas
// kernel of the JAX package. It is not a kernel by itself: pow_chain.cu,
// transcript.cu, points.cu and probe.cu include it.
//
// Representation: an element is four 64-bit words in Montgomery form
// (R = 2^256), fully reduced to [0, p). The TPU library kept 22 lazy
// 13-bit limbs in int32 because the TPU has no 64-bit multiply; here a
// CIOS Montgomery product does the work of the 22x22 limb convolution and
// its folds. There are two: mul, on four 64-bit words, and mul32, on the
// same value as eight 32-bit limbs with PTX carry chains (below), which
// runs a lone dependent chain 1.43x faster on an H100 and is the product
// of the kernels' inner work; sqr32 is its squaring, 36 word products.
// mulx<F, P> picks one at compile time.
//
// The kernels' tensors keep the torch port's layout: 22 non-negative
// int64 limbs of 13 bits (a lazy value may exceed p and reach ~2^290).
// from_limbs() accumulates the limbs into five words and reduces the part
// above bit 256 with R^3 (2^256 * R), so no input needs to be canonical;
// to_limbs() writes the canonical value back as 22 limbs (top two zero).
//
// Every function is __host__ __device__: the 64x64->128 product is
// __umul64hi on the card and unsigned __int128 on the host, and the PTX
// carry chains have plain uint64_t twins, so the same arithmetic compiles
// with g++ into a host shim that the CPU tests check against the plain
// torch field ops.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define FHD __host__ __device__ __forceinline__
#define FHD_CALL __host__ __device__ __noinline__
#else
#define FHD inline
#define FHD_CALL inline
#endif

namespace fld {

constexpr int REP_LIMBS = 22;
constexpr int LIMB_BITS = 13;
constexpr uint64_t LIMB_MASK = (1ULL << LIMB_BITS) - 1;

struct Fe {
  uint64_t w[4];
};

// F = 0: Fp (Pallas base field = Vesta scalar field).
// F = 1: Fq (Vesta base field = Pallas scalar field).
template <int F>
struct Params;

template <>
struct Params<0> {
  static FHD Fe p() {
    return {{0x992d30ed00000001ULL, 0x224698fc094cf91bULL, 0x0ULL, 0x4000000000000000ULL}};
  }
  static FHD uint64_t inv() { return 0x992d30ecffffffffULL; }  // -p^-1 mod 2^64
  static FHD Fe r2() {  // R^2 mod p
    return {{0x8c78ecb30000000fULL, 0xd7d30dbd8b0de0e7ULL, 0x7797a99bc3c95d18ULL, 0x096d41af7b9cb714ULL}};
  }
  static FHD Fe r3() {  // R^3 mod p
    return {{0xf185a5993a9e10f9ULL, 0xf6a68f3b6ac5b1d1ULL, 0xdf8d1014353fd42cULL, 0x2ae309222d2d9910ULL}};
  }
  static FHD Fe b3() {  // 15 (= 3 * curve b) in Montgomery form
    return {{0xb295b960ffffffc5ULL, 0x19babde9db4296a3ULL, 0xfffffffffffffff8ULL, 0x3fffffffffffffffULL}};
  }
  static FHD Fe one() {  // R mod p
    return {{0x34786d38fffffffdULL, 0x992c350be41914adULL, 0xffffffffffffffffULL, 0x3fffffffffffffffULL}};
  }
};

template <>
struct Params<1> {
  static FHD Fe p() {
    return {{0x8c46eb2100000001ULL, 0x224698fc0994a8ddULL, 0x0ULL, 0x4000000000000000ULL}};
  }
  static FHD uint64_t inv() { return 0x8c46eb20ffffffffULL; }
  static FHD Fe r2() {
    return {{0xfc9678ff0000000fULL, 0x67bb433d891a16e3ULL, 0x7fae231004ccf590ULL, 0x096d41af7ccfdaa9ULL}};
  }
  static FHD Fe r3() {
    return {{0x008b421c249dae4cULL, 0xe13bda50dba41326ULL, 0x88fececb8e15cb63ULL, 0x07dd97a06e6792c8ULL}};
  }
  static FHD Fe b3() {
    return {{0xaba7cf64ffffffc5ULL, 0x19babde9cabd14f0ULL, 0xfffffffffffffff8ULL, 0x3fffffffffffffffULL}};
  }
  static FHD Fe one() {
    return {{0x5b2b3e9cfffffffdULL, 0x992c350be3420567ULL, 0xffffffffffffffffULL, 0x3fffffffffffffffULL}};
  }
};

// a * b + c + carry -> low word; carry <- high word. Cannot overflow:
// (2^64-1)^2 + 2 (2^64-1) = 2^128 - 1.
FHD uint64_t mac(uint64_t a, uint64_t b, uint64_t c, uint64_t& carry) {
#ifdef __CUDA_ARCH__
  uint64_t lo = a * b;
  uint64_t hi = __umul64hi(a, b);
  lo += c;
  hi += (lo < c);
  lo += carry;
  hi += (lo < carry);
  carry = hi;
  return lo;
#else
  unsigned __int128 t = (unsigned __int128)a * b + c + carry;
  carry = (uint64_t)(t >> 64);
  return (uint64_t)t;
#endif
}

// a + b + carry (carry in {0, 1}) -> sum; carry <- carry out.
FHD uint64_t adc(uint64_t a, uint64_t b, uint64_t& carry) {
  uint64_t s = a + b;
  uint64_t c1 = s < a;
  uint64_t s2 = s + carry;
  uint64_t c2 = s2 < s;
  carry = c1 + c2;
  return s2;
}

// a - b - borrow (borrow in {0, 1}) -> difference; borrow <- borrow out.
FHD uint64_t sbb(uint64_t a, uint64_t b, uint64_t& borrow) {
  uint64_t d = a - b;
  uint64_t b1 = a < b;
  uint64_t d2 = d - borrow;
  uint64_t b2 = d < borrow;
  borrow = b1 + b2;
  return d2;
}

// hi * 2^256 + r, known < 2p, -> [0, p).
template <int F>
FHD Fe reduce_once(const Fe& r, uint64_t hi) {
  const Fe p = Params<F>::p();
  Fe d;
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) d.w[j] = sbb(r.w[j], p.w[j], br);
  return (hi != 0 || br == 0) ? d : r;
}

// Montgomery product a * b / R mod p (CIOS). Needs a * b < 2^256 * p,
// e.g. b < p and a any 256-bit value; the result is in [0, p).
template <int F>
FHD Fe mul(const Fe& a, const Fe& b) {
  const Fe p = Params<F>::p();
  const uint64_t inv = Params<F>::inv();
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) t[j] = mac(a.w[j], b.w[i], t[j], c);
    uint64_t cc = 0;
    t[4] = adc(t[4], c, cc);
    t[5] = cc;
    uint64_t m = t[0] * inv;
    c = 0;
    (void)mac(m, p.w[0], t[0], c);
#pragma unroll
    for (int j = 1; j < 4; j++) t[j - 1] = mac(m, p.w[j], t[j], c);
    cc = 0;
    t[3] = adc(t[4], c, cc);
    t[4] = t[5] + cc;
  }
  Fe r = {{t[0], t[1], t[2], t[3]}};
  return reduce_once<F>(r, t[4]);
}

template <int F>
FHD Fe square(const Fe& a) {
  return mul<F>(a, a);
}

template <int F>
FHD Fe add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) s.w[j] = adc(a.w[j], b.w[j], c);
  return reduce_once<F>(s, c);
}

template <int F>
FHD Fe sub(const Fe& a, const Fe& b) {
  const Fe p = Params<F>::p();
  Fe d, e;
  uint64_t br = 0, c = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) d.w[j] = sbb(a.w[j], b.w[j], br);
#pragma unroll
  for (int j = 0; j < 4; j++) e.w[j] = adc(d.w[j], p.w[j], c);
  return br ? e : d;
}

// 15 * a: the curve constant b3 = 3 * b of the RCB formulas.
template <int F>
FHD Fe mul_b3(const Fe& a) {
  return mul<F>(a, Params<F>::b3());
}

template <int F>
FHD Fe zero() {
  return {{0, 0, 0, 0}};
}

template <int F>
FHD Fe one() {
  return Params<F>::one();
}

template <int F>
FHD bool is_zero(const Fe& a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

// ---------------------------------------------------------------------------
// 32-bit-limb Montgomery arithmetic (K2's product).
//
// The same R = 2^256 and the same Fe words as above, seen as eight 32-bit
// limbs (limb 2k is the low half of w[k]), so mul32 computes exactly what
// mul computes. Hopper's integer multiplier is 32 bits wide: each 64x64
// product of mul costs several dependent IMADs and every carry a compare
// and an add. Here every carry chain is one inline-PTX block of
// mad.lo.cc / madc.hi.cc / addc.cc, one instruction per limb with the
// carry in the flag; a chain never spans two asm statements, because the
// flag does not survive what the compiler may put between them. Off the
// card (the host build of the tests) the same functions are plain
// uint64_t arithmetic on 32-bit limbs.
// ---------------------------------------------------------------------------

FHD void split32(const Fe& a, uint32_t x[8]) {
#pragma unroll
  for (int k = 0; k < 4; k++) {
    x[2 * k] = (uint32_t)a.w[k];
    x[2 * k + 1] = (uint32_t)(a.w[k] >> 32);
  }
}

FHD Fe join32(const uint32_t x[8]) {
  Fe a;
#pragma unroll
  for (int k = 0; k < 4; k++) a.w[k] = (uint64_t)x[2 * k] | ((uint64_t)x[2 * k + 1] << 32);
  return a;
}

// t[0..9] += a[0..7] * b. The caller keeps the sum below 2^320.
FHD void mac_row(uint32_t* t, const uint32_t* a, uint32_t b) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b));
#else
  uint64_t c = 0;
  for (int j = 0; j < 8; j++) {
    const uint64_t s = (uint64_t)a[j] * b + t[j] + c;  // < 2^64
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  const uint64_t s = (uint64_t)t[8] + c;
  t[8] = (uint32_t)s;
  t[9] += (uint32_t)(s >> 32);
#endif
}

// a[0..7] += b[0..7] + carry (carry in {0, 1}); returns the carry out.
FHD uint32_t add8(uint32_t* a, const uint32_t* b, uint32_t carry) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "add.cc.u32  %8, %8, 0xffffffff;\n\t"  // sets the flag iff carry == 1
      "addc.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]),
        "+r"(a[7]), "+r"(carry)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return carry;
#else
  uint64_t c = carry;
  for (int j = 0; j < 8; j++) {
    const uint64_t s = (uint64_t)a[j] + b[j] + c;
    a[j] = (uint32_t)s;
    c = s >> 32;
  }
  return (uint32_t)c;
#endif
}

// x (< 2p) -> [0, p): x - p unless that borrows.
template <int F>
FHD Fe csub32(const uint32_t x[8]) {
  uint32_t p[8], d[8];
  split32(Params<F>::p(), p);
  uint32_t borrow;
#ifdef __CUDA_ARCH__
  asm volatile(
      "sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(borrow)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]), "r"(x[7]),
        "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
#else
  uint64_t br = 0;
  for (int j = 0; j < 8; j++) {
    const uint64_t s = (uint64_t)x[j] - p[j] - br;
    d[j] = (uint32_t)s;
    br = (s >> 32) & 1;
  }
  borrow = (uint32_t)br;
#endif
  return borrow ? join32(x) : join32(d);
}

// The helpers below (sub8, add8_to, mul_row9) keep inline PTX safe when
// an operand is a compile-time constant (a prime's zero limbs, a zeroed
// row): no read-write operand may start as a constant, since the compiler
// may hand the same register to an input of equal value, and a write-only
// operand is written after every input is read (mul_row9 works in
// registers of its own).

// a[0..7] -= b[0..7]; returns the borrow out (0 or 1). a must not be a
// compile-time constant.
FHD uint32_t sub8(uint32_t* a, const uint32_t* b) {
  uint32_t borrow;
#ifdef __CUDA_ARCH__
  asm volatile(
      "sub.cc.u32  %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32    %8, 0, 0;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]),
        "=r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return borrow & 1;
#else
  uint64_t br = 0;
  for (int j = 0; j < 8; j++) {
    const uint64_t s = (uint64_t)a[j] - b[j] - br;
    a[j] = (uint32_t)s;
    br = (s >> 32) & 1;
  }
  borrow = (uint32_t)br;
  return borrow;
#endif
}

// a[0..7] += b[0..7]; returns the carry out. a must not be a compile-time
// constant (add8's carry in is one).
FHD uint32_t add8_to(uint32_t* a, const uint32_t* b) {
  uint32_t carry;
#ifdef __CUDA_ARCH__
  asm volatile(
      "add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]),
        "=r"(carry)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
#else
  uint64_t c = 0;
  for (int j = 0; j < 8; j++) {
    const uint64_t s = (uint64_t)a[j] + b[j] + c;
    a[j] = (uint32_t)s;
    c = s >> 32;
  }
  carry = (uint32_t)c;
#endif
  return carry;
}

// t[0..8] = a[0..7] * b.
FHD void mul_row9(uint32_t* t, const uint32_t* a, uint32_t b) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n\t"
      ".reg .u32 r<9>;\n\t"
      "mul.lo.u32     r0, %9, %17;\n\t"
      "mul.lo.u32     r1, %10, %17;\n\t"
      "mul.lo.u32     r2, %11, %17;\n\t"
      "mul.lo.u32     r3, %12, %17;\n\t"
      "mul.lo.u32     r4, %13, %17;\n\t"
      "mul.lo.u32     r5, %14, %17;\n\t"
      "mul.lo.u32     r6, %15, %17;\n\t"
      "mul.lo.u32     r7, %16, %17;\n\t"
      "mul.hi.u32     r8, %16, %17;\n\t"
      "mad.hi.cc.u32  r1, %9, %17, r1;\n\t"
      "madc.hi.cc.u32 r2, %10, %17, r2;\n\t"
      "madc.hi.cc.u32 r3, %11, %17, r3;\n\t"
      "madc.hi.cc.u32 r4, %12, %17, r4;\n\t"
      "madc.hi.cc.u32 r5, %13, %17, r5;\n\t"
      "madc.hi.cc.u32 r6, %14, %17, r6;\n\t"
      "madc.hi.cc.u32 r7, %15, %17, r7;\n\t"
      "addc.u32       r8, r8, 0;\n\t"
      "mov.u32 %0, r0;\n\t"
      "mov.u32 %1, r1;\n\t"
      "mov.u32 %2, r2;\n\t"
      "mov.u32 %3, r3;\n\t"
      "mov.u32 %4, r4;\n\t"
      "mov.u32 %5, r5;\n\t"
      "mov.u32 %6, r6;\n\t"
      "mov.u32 %7, r7;\n\t"
      "mov.u32 %8, r8;\n\t"
      "}"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]), "=r"(t[6]), "=r"(t[7]),
        "=r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b));
#else
  uint64_t c = 0;
  for (int j = 0; j < 8; j++) {
    const uint64_t s = (uint64_t)a[j] * b + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  t[8] = (uint32_t)c;
#endif
}

// a + b mod p on eight 32-bit limbs (the carry chains above): the value of
// add<F> (a, b < p < 2^255, so a + b has no carry out of 2^256).
template <int F>
FHD Fe add32(const Fe& a, const Fe& b) {
  uint32_t x[8], y[8];
  split32(a, x);
  split32(b, y);
  add8_to(x, y);
  return csub32<F>(x);
}

// a - b mod p on eight 32-bit limbs: the value of sub<F>.
template <int F>
FHD Fe sub32(const Fe& a, const Fe& b) {
  uint32_t x[8], y[8], p[8];
  split32(a, x);
  split32(b, y);
  split32(Params<F>::p(), p);
  const uint32_t mask = 0u - sub8(x, y);
#pragma unroll
  for (int j = 0; j < 8; j++) p[j] &= mask;
  add8_to(x, p);
  return join32(x);
}

// k * a mod p for a < p and 1 <= k <= 64, without a Montgomery product:
// t = k a < 2^262; with q = t >> 254 and p = 2^254 + c (c < 2^127 for both
// Pasta primes), t - q p = (t mod 2^254) - q c lies in (-2^133, 2^254), so
// one conditional addition of p makes it canonical. The same value as
// mul(a, k R mod p) (e.g. mul_b3 at k = 15) in a fraction of the work.
template <int F>
FHD Fe mul_small(const Fe& a, uint32_t k) {
  uint32_t x[8], p[8], t[9], qp[9];
  split32(a, x);
  split32(Params<F>::p(), p);
  mul_row9(t, x, k);
  const uint32_t q = (t[8] << 2) | (t[7] >> 30);
  mul_row9(qp, p, q);
  const uint32_t borrow = sub8(t, qp);
  const uint32_t mask = 0u - ((t[8] - qp[8] - borrow) != 0);  // the difference is negative
#pragma unroll
  for (int j = 0; j < 8; j++) p[j] &= mask;
  add8_to(t, p);
  return join32(t);
}

// One Montgomery step: t += m * p with m = t[0] * (-p^-1 mod 2^32), so
// t[0] becomes 0; then t /= 2^32.
template <int F>
FHD void redc_step(uint32_t t[10], const uint32_t p[8]) {
  const uint32_t m = t[0] * (uint32_t)Params<F>::inv();
  mac_row(t, p, m);
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = t[j + 1];
  t[9] = 0;
}

// Montgomery product a * b / R mod p, 8 x 32-bit CIOS. Needs a * b < 2^256 * p
// (e.g. b < p); the result is in [0, p) and equals mul<F>(a, b).
template <int F>
FHD Fe mul32(const Fe& a, const Fe& b) {
  uint32_t x[8], y[8], p[8];
  split32(a, x);
  split32(b, y);
  split32(Params<F>::p(), p);
  uint32_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    mac_row(t, x, y[i]);  // t < 2^289: fits the ten words
    redc_step<F>(t, p);
  }
  return csub32<F>(t);  // t < 2p < 2^256
}

// The unreduced product a * b as a 512-bit value w[0..15] (w[16] stays 0).
FHD void wide32(const Fe& a, const Fe& b, uint32_t w[17]) {
  uint32_t x[8], y[8];
  split32(a, x);
  split32(b, y);
#pragma unroll
  for (int i = 0; i < 17; i++) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) mac_row(w + i, x, y[i]);
}

// w[0..15] += v[0..15] (the sum stays below 2^512).
FHD void add_wide(uint32_t w[17], const uint32_t v[17]) {
  add8(w + 8, v + 8, add8(w, v, 0));
}

// Montgomery reduction of a 512-bit T < 2^256 * p: T / R mod p in [0, p).
// With T = T_lo + T_hi R, REDC(T) = T_hi + (T_lo + M p) / R, where the
// second term is at most p and T_hi < p, so one subtraction suffices.
template <int F>
FHD Fe redc32(const uint32_t T[17]) {
  uint32_t p[8];
  split32(Params<F>::p(), p);
  uint32_t t[10] = {T[0], T[1], T[2], T[3], T[4], T[5], T[6], T[7], 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) redc_step<F>(t, p);
  add8(t, T + 8, 0);  // < 2p < 2^256: no carry out
  return csub32<F>(t);
}

// t[0..N] += a[0..N-1] * b, where the caller knows the sum fits in
// t[0..N] (no carry leaves t[N]): the rows of sqr32's triangle.
template <int N>
FHD void mac_row_short(uint32_t* t, const uint32_t* a, uint32_t b) {
#ifdef __CUDA_ARCH__
  if constexpr (N == 1)
    asm volatile(
        "mad.lo.cc.u32  %0, %2, %3, %0;\n\t"
        "addc.u32       %1, %1, 0;\n\t"
        "mad.hi.u32     %1, %2, %3, %1;"
        : "+r"(t[0]), "+r"(t[1])
        : "r"(a[0]), "r"(b));
  else if constexpr (N == 2)
    asm volatile(
        "mad.lo.cc.u32  %0, %3, %5, %0;\n\t"
        "madc.lo.cc.u32 %1, %4, %5, %1;\n\t"
        "addc.u32       %2, %2, 0;\n\t"
        "mad.hi.cc.u32  %1, %3, %5, %1;\n\t"
        "madc.hi.u32    %2, %4, %5, %2;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2])
        : "r"(a[0]), "r"(a[1]), "r"(b));
  else if constexpr (N == 3)
    asm volatile(
        "mad.lo.cc.u32  %0, %4, %7, %0;\n\t"
        "madc.lo.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
        "addc.u32       %3, %3, 0;\n\t"
        "mad.hi.cc.u32  %1, %4, %7, %1;\n\t"
        "madc.hi.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.u32    %3, %6, %7, %3;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(b));
  else if constexpr (N == 4)
    asm volatile(
        "mad.lo.cc.u32  %0, %5, %9, %0;\n\t"
        "madc.lo.cc.u32 %1, %6, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.lo.cc.u32 %3, %8, %9, %3;\n\t"
        "addc.u32       %4, %4, 0;\n\t"
        "mad.hi.cc.u32  %1, %5, %9, %1;\n\t"
        "madc.hi.cc.u32 %2, %6, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.hi.u32    %4, %8, %9, %4;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b));
  else if constexpr (N == 5)
    asm volatile(
        "mad.lo.cc.u32  %0, %6, %11, %0;\n\t"
        "madc.lo.cc.u32 %1, %7, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %11, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %11, %4;\n\t"
        "addc.u32       %5, %5, 0;\n\t"
        "mad.hi.cc.u32  %1, %6, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %7, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %11, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %11, %4;\n\t"
        "madc.hi.u32    %5, %10, %11, %5;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(b));
  else if constexpr (N == 6)
    asm volatile(
        "mad.lo.cc.u32  %0, %7, %13, %0;\n\t"
        "madc.lo.cc.u32 %1, %8, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %13, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.lo.cc.u32 %5, %12, %13, %5;\n\t"
        "addc.u32       %6, %6, 0;\n\t"
        "mad.hi.cc.u32  %1, %7, %13, %1;\n\t"
        "madc.hi.cc.u32 %2, %8, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %10, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.hi.u32    %6, %12, %13, %6;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(b));
  else if constexpr (N == 7)
    asm volatile(
        "mad.lo.cc.u32  %0, %8, %15, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %15, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %15, %2;\n\t"
        "madc.lo.cc.u32 %3, %11, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %12, %15, %4;\n\t"
        "madc.lo.cc.u32 %5, %13, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %14, %15, %6;\n\t"
        "addc.u32       %7, %7, 0;\n\t"
        "mad.hi.cc.u32  %1, %8, %15, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %15, %3;\n\t"
        "madc.hi.cc.u32 %4, %11, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %13, %15, %6;\n\t"
        "madc.hi.u32    %7, %14, %15, %7;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(b));
#else
  uint64_t c = 0;
  for (int j = 0; j < N; j++) {
    const uint64_t s = (uint64_t)a[j] * b + t[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  t[N] += (uint32_t)c;
#endif
}

// Rows I.. of the cross-product triangle: w[2I + 1 ..] += x[I + 1..7] x[I].
// After row I the sum is below 2^(32 (I + 9)) (it is sum_{i <= I} x_i 2^(32 i)
// times a value below 2^256), so row I's top word w[I + 8] never carries.
template <int I>
FHD void sqr_rows(uint32_t w[17], const uint32_t x[8]) {
  if constexpr (I < 7) {
    mac_row_short<7 - I>(w + 2 * I + 1, x + I + 1, x[I]);
    sqr_rows<I + 1>(w, x);
  }
}

// Montgomery square a^2 / R mod p (a < p), equal to mul32<F>(a, a): each
// cross product x_i x_j (i < j) once, 28 word products, then the sum
// doubled and the 8 squares x_i^2 added: 36 word products for the 64 of
// mul32, then the same reduction as redc32.
template <int F>
FHD Fe sqr32(const Fe& a) {
  uint32_t x[8], w[17];
  split32(a, x);
#pragma unroll
  for (int i = 0; i < 17; i++) w[i] = 0;
  sqr_rows<0>(w, x);  // the cross sum, below a^2 / 2 < 2^511
#ifdef __CUDA_ARCH__
  asm volatile(
      "add.cc.u32     %1, %1, %1;\n\t"
      "addc.cc.u32    %2, %2, %2;\n\t"
      "addc.cc.u32    %3, %3, %3;\n\t"
      "addc.cc.u32    %4, %4, %4;\n\t"
      "addc.cc.u32    %5, %5, %5;\n\t"
      "addc.cc.u32    %6, %6, %6;\n\t"
      "addc.cc.u32    %7, %7, %7;\n\t"
      "addc.cc.u32    %8, %8, %8;\n\t"
      "addc.cc.u32    %9, %9, %9;\n\t"
      "addc.cc.u32    %10, %10, %10;\n\t"
      "addc.cc.u32    %11, %11, %11;\n\t"
      "addc.cc.u32    %12, %12, %12;\n\t"
      "addc.cc.u32    %13, %13, %13;\n\t"
      "addc.cc.u32    %14, %14, %14;\n\t"
      "addc.u32       %15, %15, %15;\n\t"
      "mad.lo.cc.u32  %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32    %15, %23, %23, %15;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]), "+r"(w[5]), "+r"(w[6]), "+r"(w[7]),
        "+r"(w[8]), "+r"(w[9]), "+r"(w[10]), "+r"(w[11]), "+r"(w[12]), "+r"(w[13]), "+r"(w[14]), "+r"(w[15])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]), "r"(x[7]));
#else
  uint64_t c = 0;
  for (int k = 1; k < 16; k++) {  // double (w[0] is 0; no carry leaves w[15])
    const uint64_t s = ((uint64_t)w[k] << 1) + c;
    w[k] = (uint32_t)s;
    c = s >> 32;
  }
  c = 0;
  for (int k = 0; k < 8; k++) {  // + x_k^2 at word 2k
    const uint64_t sq = (uint64_t)x[k] * x[k];
    uint64_t s = (uint64_t)w[2 * k] + (uint32_t)sq + c;
    w[2 * k] = (uint32_t)s;
    s = (uint64_t)w[2 * k + 1] + (sq >> 32) + (s >> 32);
    w[2 * k + 1] = (uint32_t)s;
    c = s >> 32;
  }
#endif
  return redc32<F>(w);  // a^2 < p^2 < 2^256 p
}

// One row of a 3x3 MDS product, reduced once: m0 s0 + m1 s1 + m2 s2 (all
// operands < p). Each term is below p^2 and 3 p^2 < 2^256 p (3p < 2^256
// for both Pasta primes, p = 2^254 + a small term), so the 512-bit sum of
// the three unreduced products takes a single Montgomery reduction.
template <int F>
FHD Fe mds_row(const Fe& m0, const Fe& s0, const Fe& m1, const Fe& s1, const Fe& m2,
               const Fe& s2) {
  uint32_t a[17], b[17], c[17];
  wide32(m0, s0, a);
  wide32(m1, s1, b);
  wide32(m2, s2, c);
  add_wide(a, b);
  add_wide(a, c);
  return redc32<F>(a);
}

// ---------------------------------------------------------------------------
// The product a kernel picks at compile time, and the limb conversions.
// ---------------------------------------------------------------------------

// How a kernel's formulas take their products; all give the same value,
// a * b / R mod p in [0, p), with the same precondition (a * b < 2^256 * p,
// e.g. b < p). MUL64 inlines mul at each use: the limb conversions'
// default, which only K2's conversions (outside its rounds) and the
// probe's mul kind still take. MUL32_CALL calls one out-of-line mul32 body
// per field (K3-K6, K1's conversions): a chain kernel runs ~20 products a
// step, and ~20 inlined copies of a product of several hundred
// instructions overflow the instruction cache that its few warps run
// from. K7 calls mul32 itself, at one site in a loop (points.cuh, k7), and
// K1's chain takes its own 2-lane product (pow_chain.cuh).
enum Product { MUL64 = 0, MUL32_CALL = 1 };

template <int F>
FHD_CALL Fe mul32_call(Fe a, Fe b) {
  return mul32<F>(a, b);
}

template <int F, int P>
FHD Fe mulx(const Fe& a, const Fe& b) {
  if constexpr (P == MUL32_CALL)
    return mul32_call<F>(a, b);
  else
    return mul<F>(a, b);
}

// 22 non-negative limbs (limb i at x[i * stride], each < 2^40) summed into
// the 256-bit words lo and the bits above 2^256, hi (no product).
FHD void limbs_to_words(const int64_t* x, int64_t stride, Fe& lo, Fe& hi) {
  uint64_t w[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < REP_LIMBS; i++) {
    const uint64_t v = (uint64_t)x[i * stride];
    const int bit = LIMB_BITS * i, k = bit >> 6, off = bit & 63;
    uint64_t c = 0;
    w[k] = adc(w[k], v << off, c);
    w[k + 1] = adc(w[k + 1], off ? (v >> (64 - off)) : 0, c);
#pragma unroll
    for (int m = k + 2; m < 6; m++) w[m] = adc(w[m], 0, c);
  }
  lo = {{w[0], w[1], w[2], w[3]}};
  hi = {{w[4], w[5], 0, 0}};
}

// 22 non-negative limbs (limb i at x[i * stride], each < 2^40) -> Montgomery form.
template <int F, int P = MUL64>
FHD Fe from_limbs(const int64_t* x, int64_t stride) {
  Fe lo, hi;
  limbs_to_words(x, stride, lo, hi);
  return add<F>(mulx<F, P>(lo, Params<F>::r2()), mulx<F, P>(hi, Params<F>::r3()));
}

// A canonical value (not Montgomery form) -> 22 limbs of 13 bits.
FHD void words_to_limbs(const Fe& c, int64_t* out, int64_t stride) {
#pragma unroll
  for (int i = 0; i < REP_LIMBS; i++) {
    const int bit = LIMB_BITS * i, k = bit >> 6, off = bit & 63;
    uint64_t v = 0;
    if (k < 4) {
      v = c.w[k] >> off;
      if (off > 64 - LIMB_BITS && k + 1 < 4) v |= c.w[k + 1] << (64 - off);
    }
    out[i * stride] = (int64_t)(v & LIMB_MASK);
  }
}

// Montgomery form -> canonical value as 22 limbs of 13 bits.
template <int F, int P = MUL64>
FHD void to_limbs(const Fe& a, int64_t* out, int64_t stride) {
  const Fe unit = {{1, 0, 0, 0}};
  words_to_limbs(mulx<F, P>(a, unit), out, stride);
}

}  // namespace fld
