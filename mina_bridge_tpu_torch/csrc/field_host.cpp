// Host build of field.cuh for the CPU tests: the kernels' arithmetic,
// compiled with a host C++ compiler, on arrays of 22-limb int64 elements.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libfield_host.so field_host.cpp
//
// Every function takes (n, 22) int64 limb arrays and writes canonical limbs.
#include <stdint.h>

#include "field.cuh"

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

// The pow_chain.cu ladder: bits after the exponent's leading one, msb first.
extern "C" void mbt_host_pow(int field, const int64_t* x, int64_t* out, const int32_t* bits,
                             int nbits, int64_t n) {
  if (field == 0)
    pow_chain<0>(x, out, bits, nbits, n);
  else
    pow_chain<1>(x, out, bits, nbits, n);
}
