// Kernel KN: forward negacyclic NTT per (limb, batch row), with an optional
// fused symmetric-encryption epilogue.
//
// Replaces seal_embedded_tpu/ops/kernels/ntt.py: _pallas_ntt_call (K3,
// ntt_coeff_major) and _pallas_ntt_fused_sym_call (K4,
// ntt_coeff_major_fused_sym, epilogue at :211-223).
//
// Bound on the H100: shared-memory traffic and the __syncthreads between
// stages.  A row of n u32 is read and written once in device memory
// (8 bytes per coefficient, plus 8 more for the fused epilogue's a and
// table reads), while each of the logn stages reads and writes every
// coefficient in shared memory and ends on a block-wide barrier.
// Design: one thread block per (limb, row) holds the row in dynamic
// shared memory (16 KB at n = 4096, 64 KB at n = 16384, the latter past
// the 48 KB default and so raised with cudaFuncSetAttribute), runs the
// Harvey butterflies of ops/ntt.py with lazy Shoup products in [0, 4q)
// using __umulhi, reduces to [0, q) and, when fused, combines
// c0 = -a * ntt(s) + ntt(x) mod q before the one store.  Tables are the
// plain (L, n) ones; the reads of a stage's roots are broadcast within a
// warp for early stages and served by L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kFused>
__global__ void ntt_kernel(const uint32_t* __restrict__ x,
                           const uint32_t* __restrict__ op,
                           const uint32_t* __restrict__ quot,
                           const uint32_t* __restrict__ qs,
                           const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ s_op,
                           const uint32_t* __restrict__ s_quot,
                           uint32_t* __restrict__ out, int B, int logn) {
  extern __shared__ uint32_t v[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int l = blockIdx.y;
  const size_t row = ((size_t)l * B + blockIdx.x) * (size_t)n;
  const uint32_t* opl = op + (size_t)l * n;
  const uint32_t* quotl = quot + (size_t)l * n;
  const uint32_t q = qs[l];
  const uint32_t two_q = 2 * q;

  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = x[row + i];
  __syncthreads();

  // Stage s: h = 2^s groups of 2 * tt, root table[h + j] for group j.
  for (int s = 0; s < logn; ++s) {
    const int log_tt = logn - 1 - s;
    const int tt = 1 << log_tt;
    const int h = 1 << s;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int j = k >> log_tt;
      const int ui = (j << (log_tt + 1)) + (k & (tt - 1));
      const int wi = ui + tt;
      const uint32_t r_op = opl[h + j];
      const uint32_t r_quot = quotl[h + j];
      uint32_t u = v[ui];
      if (u >= two_q) u -= two_q;
      const uint32_t w = v[wi];
      const uint32_t t = w * r_op - __umulhi(w, r_quot) * q;
      v[ui] = u + t;
      v[wi] = u + two_q - t;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t r = v[i];
    if (r >= two_q) r -= two_q;
    if (r >= q) r -= q;
    if (kFused) {
      const uint32_t av = a[row + i];
      const size_t si = (size_t)l * n + i;
      uint32_t t = av * s_op[si] - __umulhi(av, s_quot[si]) * q;
      if (t >= q) t -= q;
      t = (t == 0) ? 0u : q - t;
      r = t + r;
      if (r >= q) r -= q;
    }
    out[row + i] = r;
  }
}

template <bool kFused>
cudaError_t launch(const void* x, const void* op, const void* quot,
                   const void* qs, const void* a, const void* s_op,
                   const void* s_quot, void* out, int L, int B, int logn,
                   cudaStream_t stream) {
  const int n = 1 << logn;
  const size_t smem = (size_t)n * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = (n / 2) < 512 ? (n / 2) : 512;
  const dim3 grid((unsigned)B, (unsigned)L);
  ntt_kernel<kFused><<<grid, threads, smem, stream>>>(
      (const uint32_t*)x, (const uint32_t*)op, (const uint32_t*)quot,
      (const uint32_t*)qs, (const uint32_t*)a, (const uint32_t*)s_op,
      (const uint32_t*)s_quot, (uint32_t*)out, B, logn);
  return cudaGetLastError();
}

}  // namespace

// x, out: (L, B, n) u32; op, quot: (L, n) forward root tables; qs: (L,).
// With a non-null `a` (L, B, n) and s_op/s_quot (L, n) (the Shoup pair of
// ntt(s)), out = -a * ntt(s) + ntt(x) mod q.
extern "C" int sek_ntt_fwd(const void* x, const void* op, const void* quot,
                           const void* qs, const void* a, const void* s_op,
                           const void* s_quot, void* out, int L, int B,
                           int logn, void* stream) {
  if (L <= 0 || B <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      a != nullptr
          ? launch<true>(x, op, quot, qs, a, s_op, s_quot, out, L, B, logn, st)
          : launch<false>(x, op, quot, qs, a, s_op, s_quot, out, L, B, logn,
                          st);
  return (int)err;
}
