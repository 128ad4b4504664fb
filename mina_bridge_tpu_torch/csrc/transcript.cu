// K2: a whole Poseidon transcript schedule in one launch.
//
// Replaces mina_bridge_tpu/hash/transcript_kernel.py::transcript_blocks
// (body _permute_body, grid (T,) carrying the sponge state in VMEM
// scratch). Each of T blocks adds RATE = 2 words into the width-3 state
// and runs the 55-round permutation (x^7 sbox, 3x3 MDS, round constants);
// the state after every block is written out, canonical.
//
// Bound on this card: the latency of one dependent chain, issued by one
// warp. The T blocks of a transcript are sequential by construction and
// the batch is only B <= 32 transcripts, so four warps hold all the work
// and nothing hides their latency; the bytes (a few hundred KB) and the
// card's throughput do not matter. The dependent path of a round is three
// products deep in the sbox plus one MDS row and its reduction: about four
// 256-bit Montgomery products a round, 220 a block. Each product is a run
// of ~270 carry-chained multiply-adds that one warp issues nearly back to
// back, so what bounds a round is the instructions its warp must issue in
// order, and whether the round's code stays in the instruction cache.
// Design:
//   * a group of four lanes per transcript, one per state word and one
//     idle (it shadows word 2 and never stores): eight transcripts a warp,
//     one warp a block, so B = 32 runs on four SMs. Each lane computes the
//     sbox of its own word and takes the other two with __shfl_sync;
//   * the sbox as x^2 -> (x^4, x^3) -> x^7, three products deep, run
//     through one product body to keep the round's code small (below);
//   * each lane's MDS row as three unreduced 512-bit products, summed and
//     reduced once (fld::mds_row), then + rc: 3 reductions a round, not 9;
//   * every product is fld::mul32, 32-bit limbs with PTX carry chains;
//   * the round constants and the MDS matrix (Montgomery words from the
//     wrapper) are copied to shared memory once per block.
// Lanes past B run the loop on a zero state with their loads and stores
// predicated off: none returns early, since every lane takes part in the
// shuffles.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int WIDTH = 3;
constexpr int RATE = 2;
constexpr int GROUP = 4;                // lanes per transcript
constexpr int PER_WARP = 32 / GROUP;    // transcripts per block (one warp)

__device__ __forceinline__ fld::Fe shfl(const fld::Fe& a, int src) {
  fld::Fe r;
#pragma unroll
  for (int k = 0; k < 4; k++)
    r.w[k] = __shfl_sync(0xffffffffu, (unsigned long long)a.w[k], src);
  return r;
}

// x^7 as x^2 -> (x^4 = (x^2)^2, x^3 = x^2 x) -> x^4 x^3: three products
// deep. The four products run one after the other through a single
// inlined product body (a loop that is not unrolled), so the round's code
// stays small enough for the instruction cache: on the card this beat the
// straight-line form, where x^4 and x^3 may overlap but the round's code
// holds four product bodies.
template <int F>
__device__ __forceinline__ fld::Fe sbox(const fld::Fe& x) {
  fld::Fe a = x, b = x, x2 = x, x4 = x;
#pragma unroll 1
  for (int i = 0; i < 4; i++) {
    const fld::Fe r = fld::mul32<F>(a, b);  // x^2, x^4, x^3, x^7
    if (i == 0) {
      x2 = a = b = r;
    } else if (i == 1) {
      x4 = r;
      a = x2;
      b = x;
    } else if (i == 2) {
      a = x4;
      b = r;
    } else {
      a = r;
    }
  }
  return a;
}

template <int F>
__global__ void __launch_bounds__(32) transcript_kernel(
    const int64_t* __restrict__ state0, const int64_t* __restrict__ adds, int64_t* __restrict__ out,
    const int64_t* __restrict__ rc, const int64_t* __restrict__ mds, int nrounds, int T, int B) {
  extern __shared__ fld::Fe consts[];  // rc (nrounds x 3), then mds (3 x 3)
  const int L = fld::REP_LIMBS;
  const int lane = threadIdx.x;
  const int nrc = nrounds * WIDTH;
  {
    uint64_t* words = reinterpret_cast<uint64_t*>(consts);
    for (int i = lane; i < (nrc + WIDTH * WIDTH) * 4; i += 32)
      words[i] = (uint64_t)(i < nrc * 4 ? rc[i] : mds[i - nrc * 4]);
  }
  __syncthreads();
  const fld::Fe* rc_sh = consts;
  const fld::Fe* mds_sh = consts + nrc;

  const int slot = lane % GROUP;
  const int k = slot < WIDTH ? slot : WIDTH - 1;  // this lane's state word
  const int k1 = (k + 1) % WIDTH, k2 = (k + 2) % WIDTH;
  const int base = lane - slot;
  const int b = blockIdx.x * PER_WARP + lane / GROUP;
  const bool valid = b < B;
  const bool stores = valid && slot < WIDTH;
  const fld::Fe m0 = mds_sh[k * WIDTH + k], m1 = mds_sh[k * WIDTH + k1], m2 = mds_sh[k * WIDTH + k2];

  fld::Fe st = fld::zero<F>();
  if (valid) st = fld::from_limbs<F>(state0 + ((int64_t)b * WIDTH + k) * L, 1);
  for (int t = 0; t < T; t++) {
    if (valid && k < RATE)
      st = fld::add<F>(st, fld::from_limbs<F>(adds + (((int64_t)t * RATE + k) * B + b) * L, 1));
    for (int r = 0; r < nrounds; r++) {
      const fld::Fe s = sbox<F>(st);
      const fld::Fe s1 = shfl(s, base + k1);
      const fld::Fe s2 = shfl(s, base + k2);
      st = fld::add<F>(fld::mds_row<F>(m0, s, m1, s1, m2, s2), rc_sh[r * WIDTH + k]);
    }
    if (stores) fld::to_limbs<F>(st, out + (((int64_t)t * B + b) * WIDTH + k) * L, 1);
  }
}

}  // namespace

// state0: (B, 3, 22); adds: (T, 2, B, 22); out: (T, B, 3, 22), all int64
// limbs. rc: (nrounds, 3, 4) and mds: (3, 3, 4) Montgomery words stored
// as int64. Returns cudaGetLastError().
extern "C" int mbt_transcript(int field, const int64_t* state0, const int64_t* adds, int64_t* out,
                              const int64_t* rc, const int64_t* mds, int nrounds, int T, int B,
                              void* stream) {
  if (T > 0 && B > 0) {
    const unsigned blocks = (unsigned)((B + PER_WARP - 1) / PER_WARP);
    const size_t shmem = (size_t)(nrounds * WIDTH + WIDTH * WIDTH) * sizeof(fld::Fe);
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
      transcript_kernel<0><<<blocks, 32, shmem, s>>>(state0, adds, out, rc, mds, nrounds, T, B);
    else
      transcript_kernel<1><<<blocks, 32, shmem, s>>>(state0, adds, out, rc, mds, nrounds, T, B);
  }
  return (int)cudaGetLastError();
}
