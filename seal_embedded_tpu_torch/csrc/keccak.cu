// Kernel KK: SHAKE-256 squeeze of (seed || counter_le8) streams.
//
// Replaces seal_embedded_tpu/ops/kernels/keccak.py: _squeeze_call / _kernel
// (K1, a multi-block squeeze, the uniform sampler's base draw) and
// _squeeze_call_1blk / _kernel_1blk (K2, single-block streams that emit
// only their first `nwords` rate words: the rejection queue and the CBD
// error).  One kernel computes both.
//
// Bound on the H100: integer issue.  A permutation is 24 rounds of about
// 100 64-bit xor/and-not/rotate operations (each two 32-bit instructions)
// and yields at most 136 bytes, so a stream spends tens of integer
// instructions per byte it writes: far above the card's ratio of integer
// throughput to memory bandwidth.
// Design: one thread per stream keeps its 25-lane state in 64-bit
// registers (every state index is a compile-time constant after
// unrolling, so nothing spills to local memory), absorbs the one padded
// 72-byte block without a permutation of its own, and writes each
// squeezed block straight out.  The output is stream-major, as the
// reference wrapper returns it, so neighbouring threads write 136 bytes
// apart: uncoalesced, and left for a later change to make word-major.

#include <cuda_runtime.h>
#include <stdint.h>

static __constant__ uint64_t kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

namespace {

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  // r is in [1, 63] for every call below.
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ void keccak_f1600(uint64_t st[25]) {
  // rho offsets and pi lane order along the pi cycle starting at lane 1.
  const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                        27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  uint64_t bc[5];
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    // theta
#pragma unroll
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int j = piln[i];
      const uint64_t tmp = st[j];
      st[j] = rotl64(t, rotc[i]);
      t = tmp;
    }
    // chi
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
#pragma unroll
      for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
#pragma unroll
      for (int i = 0; i < 5; ++i)
        st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
    }
    // iota
    st[0] ^= kRoundConstants[round];
  }
}

__global__ void keccak_squeeze_kernel(const uint32_t* __restrict__ seeds,
                                      const uint32_t* __restrict__ ctrs,
                                      uint32_t* __restrict__ out,
                                      long long nstreams, int nblocks,
                                      int out_words) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nstreams) return;

  // Absorb: words 0..15 seed, 16..17 counter, pad word 18 ^= 0x1F and
  // word 33 ^= 0x80000000 (ops/keccak.py absorb72); lane k = words 2k, 2k+1.
  uint64_t st[25];
  const uint32_t* sw = seeds + s * 16;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    st[k] = (uint64_t)sw[2 * k] | ((uint64_t)sw[2 * k + 1] << 32);
  st[8] = (uint64_t)ctrs[2 * s] | ((uint64_t)ctrs[2 * s + 1] << 32);
  st[9] = 0x1FULL;
#pragma unroll
  for (int k = 10; k < 25; ++k) st[k] = 0;
  st[16] = 0x8000000000000000ULL;

  uint32_t* o = out + s * out_words;
  for (int b = 0; b < nblocks; ++b) {
    keccak_f1600(st);
    const int base = b * 34;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      if (base + 2 * k < out_words) o[base + 2 * k] = (uint32_t)st[k];
      if (base + 2 * k + 1 < out_words)
        o[base + 2 * k + 1] = (uint32_t)(st[k] >> 32);
    }
  }
}

}  // namespace

// seeds (nstreams, 16) and ctrs (nstreams, 2) u32 -> out (nstreams,
// out_words) u32, out_words = nblocks * 34, or fewer when nblocks == 1.
extern "C" int sek_keccak_squeeze(const void* seeds, const void* ctrs,
                                  void* out, long long nstreams, int nblocks,
                                  int out_words, void* stream) {
  if (nstreams <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const long long grid = (nstreams + threads - 1) / threads;
  keccak_squeeze_kernel<<<(unsigned)grid, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)seeds, (const uint32_t*)ctrs, (uint32_t*)out,
      nstreams, nblocks, out_words);
  return (int)cudaGetLastError();
}
