// Kernels KN and KA: forward negacyclic NTTs per (limb, batch row) in
// shared memory, sharing one row transform (ntt_row).
//
// KN: one NTT per row, with an optional fused symmetric-encryption
// epilogue.  Replaces seal_embedded_tpu/ops/kernels/ntt.py:
// _pallas_ntt_call (K3, ntt_coeff_major) and _pallas_ntt_fused_sym_call
// (K4, ntt_coeff_major_fused_sym, epilogue at :211-223).
//
// KA: the asymmetric per-limb step, three NTTs and the public-key combine
//   c1 = pk1 * ntt(u) + ntt(e1),  c0 = pk0 * ntt(u) + ntt(pte)  mod q.
// Replaces ntt_coeff_major_fused_asym (K6, kernels/ntt.py:301-387).
//
// Bound on the H100: shared-memory traffic and the __syncthreads between
// stages.  A row of n u32 is read and written once in device memory,
// while each of the logn stages reads and writes every coefficient in
// shared memory and ends on a block-wide barrier (logn stages per KN
// block, 3 * logn per KA block).
// Design: one thread block per (limb, row) holds the row in dynamic
// shared memory and runs the Harvey butterflies of ops/ntt.py with lazy
// Shoup products in [0, 4q) using __umulhi (inputs may equal q, as
// reduce_pte's output can), then reduces to [0, q).  KN, when fused,
// combines c0 = -a * ntt(s) + ntt(x) mod q before the one store, so
// ntt(x) is never stored on its own.  KA keeps two rows: ntt(u) stays in
// buffer A while ntt(e1) and then ntt(pte) pass through buffer B, so
// none of the three transforms is ever stored to device memory.  Shared
// memory per block: KN 4n bytes, KA 8n (32 KB at n = 4096, 128 KB at
// n = 16384); above the 48 KB default it is raised with
// cudaFuncSetAttribute.  Tables are the plain (L, n) ones; the reads of a
// stage's roots are broadcast within a warp for early stages and served
// by L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Forward NTT of the row v (n = 2^logn values below 4q, in shared memory,
// visible to the whole block), left lazily in [0, 4q).  Stage s has
// h = 2^s groups of 2 * tt with root table[h + j] for group j; every stage
// ends on a barrier, so the caller may read any element afterwards.
__device__ __forceinline__ void ntt_row(uint32_t* v,
                                        const uint32_t* __restrict__ opl,
                                        const uint32_t* __restrict__ quotl,
                                        uint32_t q, int logn) {
  const int half = 1 << (logn - 1);
  const uint32_t two_q = 2 * q;
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
}

// Final correction [0, 4q) -> [0, q).
__device__ __forceinline__ uint32_t reduce_4q(uint32_t r, uint32_t q) {
  if (r >= 2 * q) r -= 2 * q;
  if (r >= q) r -= q;
  return r;
}

// x * y mod q in [0, q) by Shoup's method: y < q, y_quot = floor(y 2^32 / q).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t y_op,
                                              uint32_t y_quot, uint32_t q) {
  const uint32_t t = x * y_op - __umulhi(x, y_quot) * q;
  return t >= q ? t - q : t;
}

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
  const int l = blockIdx.y;
  const size_t row = ((size_t)l * B + blockIdx.x) * (size_t)n;
  const uint32_t q = qs[l];

  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = x[row + i];
  __syncthreads();
  ntt_row(v, op + (size_t)l * n, quot + (size_t)l * n, q, logn);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t r = reduce_4q(v[i], q);
    if (kFused) {
      const size_t si = (size_t)l * n + i;
      uint32_t t = shoup_mul(a[row + i], s_op[si], s_quot[si], q);
      t = (t == 0) ? 0u : q - t;
      r = t + r;
      if (r >= q) r -= q;
    }
    out[row + i] = r;
  }
}

// One block per (row, limb); buffer A = ntt(u), buffer B = ntt(e1), then
// ntt(pte).  The loops over i give each thread the same indices in every
// pass, so A's in-place reduction is read back by the thread that wrote it.
__global__ void ntt_asym_kernel(const uint32_t* __restrict__ u,
                                const uint32_t* __restrict__ e1,
                                const uint32_t* __restrict__ pte,
                                const uint32_t* __restrict__ op,
                                const uint32_t* __restrict__ quot,
                                const uint32_t* __restrict__ qs,
                                const uint32_t* __restrict__ p0_op,
                                const uint32_t* __restrict__ p0_quot,
                                const uint32_t* __restrict__ p1_op,
                                const uint32_t* __restrict__ p1_quot,
                                uint32_t* __restrict__ c0,
                                uint32_t* __restrict__ c1, int B, int logn) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  uint32_t* va = smem;
  uint32_t* vb = smem + n;
  const int l = blockIdx.y;
  const size_t row = ((size_t)l * B + blockIdx.x) * (size_t)n;
  const size_t lrow = (size_t)l * n;
  const uint32_t* opl = op + lrow;
  const uint32_t* quotl = quot + lrow;
  const uint32_t q = qs[l];

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    va[i] = u[row + i];
    vb[i] = e1[row + i];
  }
  __syncthreads();
  ntt_row(va, opl, quotl, q, logn);
  ntt_row(vb, opl, quotl, q, logn);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t nu = reduce_4q(va[i], q);
    va[i] = nu;
    const uint32_t r =
        shoup_mul(nu, p1_op[lrow + i], p1_quot[lrow + i], q) +
        reduce_4q(vb[i], q);
    c1[row + i] = r >= q ? r - q : r;
  }
  __syncthreads();  // every read of ntt(e1) is done before B is refilled

  for (int i = threadIdx.x; i < n; i += blockDim.x) vb[i] = pte[row + i];
  __syncthreads();
  ntt_row(vb, opl, quotl, q, logn);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t r =
        shoup_mul(va[i], p0_op[lrow + i], p0_quot[lrow + i], q) +
        reduce_4q(vb[i], q);
    c0[row + i] = r >= q ? r - q : r;
  }
}

// Raises a kernel's dynamic shared-memory limit when it needs more than
// the 48 KB default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int threads_for(int logn) {
  const int half = 1 << (logn - 1);
  return half < 512 ? half : 512;
}

template <bool kFused>
cudaError_t launch(const void* x, const void* op, const void* quot,
                   const void* qs, const void* a, const void* s_op,
                   const void* s_quot, void* out, int L, int B, int logn,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)1 << logn) * sizeof(uint32_t);
  const cudaError_t err = allow_smem(ntt_kernel<kFused>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)L);
  ntt_kernel<kFused><<<grid, threads_for(logn), smem, stream>>>(
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

// u, e1, pte, c0, c1: (L, B, n) u32, inputs below 4q; op, quot: (L, n)
// forward root tables; qs: (L,); p0_op/p0_quot and p1_op/p1_quot: (L, n)
// Shoup pairs of pk0 and pk1.
extern "C" int sek_ntt_asym(const void* u, const void* e1, const void* pte,
                            const void* op, const void* quot, const void* qs,
                            const void* p0_op, const void* p0_quot,
                            const void* p1_op, const void* p1_quot, void* c0,
                            void* c1, int L, int B, int logn, void* stream) {
  if (L <= 0 || B <= 0) return (int)cudaSuccess;
  const size_t smem = ((size_t)2 << logn) * sizeof(uint32_t);
  const cudaError_t err = allow_smem(ntt_asym_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)B, (unsigned)L);
  ntt_asym_kernel<<<grid, threads_for(logn), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)u, (const uint32_t*)e1, (const uint32_t*)pte,
      (const uint32_t*)op, (const uint32_t*)quot, (const uint32_t*)qs,
      (const uint32_t*)p0_op, (const uint32_t*)p0_quot,
      (const uint32_t*)p1_op, (const uint32_t*)p1_quot, (uint32_t*)c0,
      (uint32_t*)c1, B, logn);
  return (int)cudaGetLastError();
}
