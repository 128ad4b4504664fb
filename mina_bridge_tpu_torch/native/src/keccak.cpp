// Native Keccak-256 (Ethereum padding) for the host runtime hot paths:
// batch-Merkle commitment building and EVM ABI hashing
// (bridge/aligned.py, bridge/eth.py). Mirrors the role of the native
// keccak bundled by ethers/alloy in the reference (core/src/eth.rs);
// the pure-Python implementation in bridge/keccak.py stays as the
// portable fallback and correctness oracle. The port's own copy of
// mina_bridge_tpu/native/src/keccak.cpp, with the same C ABI.
//
// Build (native/__init__.py does it at first use, into build/native/):
//   g++ -O3 -shared -fPIC -o libmbt_native-<hash>.so keccak.cpp
// ABI (C, ctypes-friendly):
//   void mbtpu_keccak256(const uint8_t* in, uint64_t len, uint8_t out[32]);
//   void mbtpu_keccak256_batch(const uint8_t* in, const uint64_t* offsets,
//                              uint64_t n, uint8_t* out /* n*32 */);
//   void mbtpu_merkle_levels(const uint8_t* leaves /* n*32 */, uint64_t n,
//                            uint8_t* out /* (n-1)*32, level-major */);

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

inline uint64_t rol(uint64_t x, unsigned n) {
  return n ? (x << n) | (x >> (64 - n)) : x;
}

void keccak_f(uint64_t st[25]) {
  for (int round = 0; round < 24; ++round) {
    // theta
    uint64_t bc[5];
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; ++i) {
      uint64_t t = bc[(i + 4) % 5] ^ rol(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi
    uint64_t t = st[1];
    static constexpr int PI[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                   8,  21, 24, 4,  15, 23, 19, 13,
                                   12, 2,  20, 14, 22, 9,  6,  1};
    static constexpr int ROT[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                    45, 55, 2,  14, 27, 41, 56, 8,
                                    25, 43, 62, 18, 39, 61, 20, 44};
    for (int i = 0; i < 24; ++i) {
      uint64_t tmp = st[PI[i]];
      st[PI[i]] = rol(t, ROT[i]);
      t = tmp;
    }
    // chi
    for (int j = 0; j < 25; j += 5) {
      uint64_t row[5];
      for (int i = 0; i < 5; ++i) row[i] = st[j + i];
      for (int i = 0; i < 5; ++i)
        st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
    }
    // iota
    st[0] ^= RC[round];
  }
}

constexpr uint64_t RATE = 136;  // 1088-bit rate for Keccak-256

void keccak256(const uint8_t* in, uint64_t len, uint8_t out[32]) {
  uint64_t st[25] = {0};
  uint8_t block[RATE];
  while (len >= RATE) {
    for (unsigned i = 0; i < RATE / 8; ++i) {
      uint64_t w;
      std::memcpy(&w, in + 8 * i, 8);  // little-endian hosts only
      st[i] ^= w;
    }
    keccak_f(st);
    in += RATE;
    len -= RATE;
  }
  std::memset(block, 0, RATE);
  std::memcpy(block, in, len);
  block[len] = 0x01;  // pre-NIST (Ethereum) domain padding
  block[RATE - 1] |= 0x80;
  for (unsigned i = 0; i < RATE / 8; ++i) {
    uint64_t w;
    std::memcpy(&w, block + 8 * i, 8);
    st[i] ^= w;
  }
  keccak_f(st);
  std::memcpy(out, st, 32);
}

}  // namespace

extern "C" {

void mbtpu_keccak256(const uint8_t* in, uint64_t len, uint8_t* out) {
  keccak256(in, len, out);
}

// offsets: n+1 cumulative byte offsets into `in` (offsets[0] == 0).
void mbtpu_keccak256_batch(const uint8_t* in, const uint64_t* offsets,
                           uint64_t n, uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    keccak256(in + offsets[i], offsets[i + 1] - offsets[i], out + 32 * i);
}

// Full binary Merkle tree over n 32-byte leaves (n a power of two),
// keccak256(left || right) combine — the Aligned batch-commitment shape
// (bridge/aligned.py). Output: n-1 internal nodes, level by level from
// the widest (n/2 nodes) down to the root (last 32 bytes).
void mbtpu_merkle_levels(const uint8_t* leaves, uint64_t n, uint8_t* out) {
  const uint8_t* level = leaves;
  uint64_t width = n;
  uint8_t* cursor = out;
  while (width > 1) {
    for (uint64_t i = 0; i < width / 2; ++i)
      keccak256(level + 64 * i, 64, cursor + 32 * i);
    level = cursor;
    cursor += 32 * (width / 2);
    width /= 2;
  }
}

}  // extern "C"
