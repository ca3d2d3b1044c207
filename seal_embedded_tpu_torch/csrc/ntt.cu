// Kernels KN and KA: forward negacyclic NTTs per (limb, batch row),
// sharing one row transform (ntt_regs).
//
// KN: one NTT per row, of rows already reduced mod q, or straight from
// the int64 plaintext + error and fused with the symmetric-encryption
// epilogue.  Replaces seal_embedded_tpu/ops/kernels/ntt.py:
// _pallas_ntt_call (K3, ntt_coeff_major) and _pallas_ntt_fused_sym_call
// (K4, ntt_coeff_major_fused_sym, epilogue at :211-223).
//
// KA: the asymmetric per-limb step, three NTTs and the public-key combine
//   c1 = pk1 * ntt(u) + ntt(e1),  c0 = pk0 * ntt(u) + ntt(pte)  mod q.
// Replaces ntt_coeff_major_fused_asym (K6, kernels/ntt.py:301-387).
//
// Bound on the H100.  KN from pte at (L, B, n) = (3, 1024, 4096) must
// read pte once (33.5 MB: any int64), read a and write c0 (50 MB each:
// values below q need 4 bytes): 134 MB, 0.040 ms at 3.35 TB/s.  Its 3 x
// 1024 x 2048 x 12 butterflies need at least 4 integer-pipe instructions
// each (the lazy correction and the two adds; the three products go to
// the FMA pipe): 0.018 ms at 64 per SM per clock, 132 SMs at 1.98 GHz.
// So it is bound by device memory, and the design keeps every
// intermediate (the reduced pte, ntt(pte)) on chip; it measured 0.18 ms
// alone on an H100 80GB HBM3 at 700 W.
//
// Design.  One block of T = min(n / 8, 512) threads per row; each thread
// holds R = n / T values in registers (8 at n <= 4096, 16 at 8192, 32 at
// 16384).  The 12 stages at n = 4096 run as 4 passes of 3: in a pass a
// thread owns sets of 8 elements {base + k * tt} that the pass's three
// stages close over, loads the pass's 7 twiddle pairs itself, and runs
// the three stages in registers.  Between passes the row goes through
// shared memory once (store, one barrier, load): 3 barriers per row at n
// = 4096 instead of the 12 of a barrier per stage.  A degree whose logn
// is not a multiple of 3 runs its first pass with 1 or 2 stages.  Every
// element meets the same Harvey butterflies (lazy Shoup products in [0,
// 4q) with __umulhi, ops/ntt.py) in the same stage order, so the bits do
// not change.  Shared memory holds one row with one pad word after every
// 8 (4.5n bytes: 18 KB at n = 4096, 72 KB at 16384), which puts the
// exchanges of every pass on distinct banks.  The first pass reads its
// elements from device memory (coalesced: thread t reads t + k n / 8),
// the last pass's elements are 8 consecutive coefficients per set, so
// the epilogue reads a, ntt(s) and writes c0 as 16-byte int64 pairs.
// KN reads and writes int64 (u32 values) as the callers hold them.  The
// from-pte entry reduces each int64 pte value per limb as it loads it
// (barrett_wide on |x|, |INT64_MIN| kept as 2^63, and the x < 0, |x| = 0
// mod q -> q quirk of reduce_pte), and one block runs all L limbs of its
// row, so the pte row is read from device memory once (later limbs hit
// L2) and (L, B, n) reduced values are never stored.
//
// KA keeps two padded rows in shared memory (8 x 1.125 n bytes, 144 KB at
// n = 16384): ntt(u) stays in A while ntt(e1) and then ntt(pte) pass
// through B.  Its rows go through ntt_row, the register transform between
// a shared-memory load and store.  Its I/O is u32 as before.  Above the
// 48 KB default a kernel's shared memory is raised with
// cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

// Shared-memory index of element i: one pad word after every 8.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 3); }

// Stages in the first pass: the rest come in passes of 3.
__host__ __device__ __forceinline__ int first_stages(int logn) {
  return logn - 3 * ((logn - 1) / 3);
}

// Element held in register j by thread t (of T) in a pass of P stages
// whose smallest butterfly distance is 2^lt.  Thread t owns the sets
// sigma = t + m T (m < R >> P), set sigma being the 2^P elements
// base + k 2^lt, base = (sigma >> lt) 2^(lt + P) + (sigma mod 2^lt).
__device__ __forceinline__ int pass_elem(int j, int P, int lt, int t, int T) {
  const int m = j >> P, k = j & ((1 << P) - 1);
  const int sigma = t + m * T;
  const int base = ((sigma >> lt) << (lt + P)) | (sigma & ((1 << lt) - 1));
  return base + (k << lt);
}

__device__ __forceinline__ uint32_t table_at(const uint32_t* p, int i) {
  return __ldg(p + i);
}
__device__ __forceinline__ uint32_t table_at(const long long* p, int i) {
  return (uint32_t)__ldg(p + i);
}

// Stages s0 .. s0 + P - 1 on the thread's sets, in registers.  At stage s
// = s0 + p, set sigma's group of 2^(P - p) elements g has root
// table[2^s + (sigma >> lt) 2^p + g] (ntt.c:89).
template <int R, int P, typename Tab>
__device__ __forceinline__ void pass_compute(uint32_t (&x)[R],
                                             const Tab* __restrict__ opl,
                                             const Tab* __restrict__ quotl,
                                             uint32_t q, int s0, int lt,
                                             int t, int T) {
  const uint32_t two_q = 2u * q;
#pragma unroll
  for (int m = 0; m < (R >> P); ++m) {
    const int G = (t + m * T) >> lt;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int half = 1 << (P - 1 - p);
#pragma unroll
      for (int g = 0; g < (1 << p); ++g) {
        const int root = (1 << (s0 + p)) + (G << p) + g;
        const uint32_t r_op = table_at(opl, root);
        const uint32_t r_quot = table_at(quotl, root);
#pragma unroll
        for (int k = 0; k < half; ++k) {
          const int i0 = (m << P) + 2 * half * g + k;
          const int i1 = i0 + half;
          uint32_t u = x[i0];
          if (u >= two_q) u -= two_q;
          const uint32_t w = x[i1];
          const uint32_t tw = w * r_op - __umulhi(w, r_quot) * q;
          x[i0] = u + tw;
          x[i1] = u + two_q - tw;
        }
      }
    }
  }
}

// Forward NTT of a row held in registers, values below 4q.  On entry x
// holds the first pass's elements (P = first_stages(logn), lt = logn -
// P); on exit the result, lazily in [0, 4q), at the last pass's (P = 3,
// lt = 0: register j = 8m + k holds element 8 (t + m T) + k).  v is the
// block's padded shared row; the caller must not let another transform
// write it before every thread has left this one.
template <int R, typename Tab>
__device__ __forceinline__ void ntt_regs(uint32_t (&x)[R], uint32_t* v,
                                         const Tab* __restrict__ opl,
                                         const Tab* __restrict__ quotl,
                                         uint32_t q, int logn) {
  const int t = threadIdx.x, T = blockDim.x;
  const int P0 = first_stages(logn);
  int P = P0, lt = logn - P0;
  if (P0 == 1)
    pass_compute<R, 1>(x, opl, quotl, q, 0, lt, t, T);
  else if (P0 == 2)
    pass_compute<R, 2>(x, opl, quotl, q, 0, lt, t, T);
  else
    pass_compute<R, 3>(x, opl, quotl, q, 0, lt, t, T);
  for (int s0 = P0; s0 < logn; s0 += 3) {
#pragma unroll
    for (int j = 0; j < R; ++j) v[sidx(pass_elem(j, P, lt, t, T))] = x[j];
    __syncthreads();
    P = 3;
    lt = logn - s0 - 3;
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = v[sidx(pass_elem(j, P, lt, t, T))];
    pass_compute<R, 3>(x, opl, quotl, q, s0, lt, t, T);
  }
}

// Forward NTT of the padded shared row v in place, left lazily in [0, 4q)
// and visible to the whole block on return.
template <int R, typename Tab>
__device__ __forceinline__ void ntt_row(uint32_t* v,
                                        const Tab* __restrict__ opl,
                                        const Tab* __restrict__ quotl,
                                        uint32_t q, int logn) {
  const int t = threadIdx.x, T = blockDim.x;
  const int P0 = first_stages(logn);
  uint32_t x[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    x[j] = v[sidx(pass_elem(j, P0, logn - P0, t, T))];
  ntt_regs<R>(x, v, opl, quotl, q, logn);
#pragma unroll
  for (int j = 0; j < R; ++j) v[sidx(pass_elem(j, 3, 0, t, T))] = x[j];
  __syncthreads();
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

// c0 = -a * ntt(s) + r mod q, r in [0, q) (kernels/ntt.py:217-223).
__device__ __forceinline__ uint32_t sym_combine(uint32_t r, uint32_t a,
                                                uint32_t s_op,
                                                uint32_t s_quot, uint32_t q) {
  uint32_t t = shoup_mul(a, s_op, s_quot, q);
  t = (t == 0) ? 0u : q - t;
  r = t + r;
  return r >= q ? r - q : r;
}

// reduce_pte (ckks_common.c:224-237) of one int64 value: barrett_wide
// (modulo.h:84-116) of |x| as a (lo, hi) u32 pair, |INT64_MIN| = 2^63,
// then q - r for x < 0, which gives q where |x| = 0 mod q.
__device__ __forceinline__ uint32_t reduce_pte(long long x, uint32_t q,
                                               uint32_t r0, uint32_t r1) {
  const bool neg = x < 0;
  const unsigned long long ab =
      neg ? 0ULL - (unsigned long long)x : (unsigned long long)x;
  const uint32_t lo = (uint32_t)ab, hi = (uint32_t)(ab >> 32);
  const uint32_t right_hw = __umulhi(lo, r0);
  const uint32_t middle_lw = right_hw + lo * r1;
  const uint32_t middle_hw = __umulhi(lo, r1) + (middle_lw < right_hw);
  const uint32_t middle2_lw = middle_lw + hi * r0;
  const uint32_t middle2_hw = __umulhi(hi, r0) + (middle2_lw < middle_lw);
  uint32_t tmp = hi * r1 + middle_hw + middle2_hw;
  tmp = lo - tmp * q;
  const uint32_t r = tmp >= q ? tmp - q : tmp;
  return neg ? q - r : r;
}

__device__ __forceinline__ void load2(const long long* p, uint32_t& a,
                                      uint32_t& b) {
  const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
  a = (uint32_t)v.x;
  b = (uint32_t)v.y;
}

// KN.  Row b of limb l: out (L, B, n) = ntt(x) in [0, q) from x (L, B, n)
// below 4q or, with kFromPte, -a * ntt(s) + ntt(reduce_pte(pte)) from pte
// (B, n) int64 reduced per limb on load.  Limbs l = blockIdx.y, +gridDim.y.
template <int R, bool kFromPte>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_kernel(const long long* __restrict__ x,
               const long long* __restrict__ op,
               const long long* __restrict__ quot,
               const long long* __restrict__ qs,
               const long long* __restrict__ r0s,
               const long long* __restrict__ r1s,
               const long long* __restrict__ a,
               const long long* __restrict__ s_op,
               const long long* __restrict__ s_quot,
               long long* __restrict__ out, int L, int B, int logn) {
  extern __shared__ uint32_t v[];
  const int n = 1 << logn, t = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x;
  const int P0 = first_stages(logn);
  for (int l = blockIdx.y; l < L; l += gridDim.y) {
    const uint32_t q = (uint32_t)qs[l];
    const size_t lrow = (size_t)l * n;
    const size_t row = ((size_t)l * B + b) * n;
    uint32_t xr[R];
    if (kFromPte) {
      const uint32_t r0 = (uint32_t)r0s[l], r1 = (uint32_t)r1s[l];
      const long long* src = x + (size_t)b * n;
#pragma unroll
      for (int j = 0; j < R; ++j)
        xr[j] = reduce_pte(__ldg(src + pass_elem(j, P0, logn - P0, t, T)),
                           q, r0, r1);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        xr[j] = (uint32_t)__ldg(x + row + pass_elem(j, P0, logn - P0, t, T));
    }
    ntt_regs<R>(xr, v, op + lrow, quot + lrow, q, logn);

#pragma unroll
    for (int m = 0; m < R / 8; ++m) {
      const int e0 = (t + m * T) << 3;
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const int e = e0 + k;
        uint32_t v0 = reduce_4q(xr[8 * m + k], q);
        uint32_t v1 = reduce_4q(xr[8 * m + k + 1], q);
        if (kFromPte) {
          uint32_t a0, a1, so0, so1, sq0, sq1;
          load2(a + row + e, a0, a1);
          load2(s_op + lrow + e, so0, so1);
          load2(s_quot + lrow + e, sq0, sq1);
          v0 = sym_combine(v0, a0, so0, sq0, q);
          v1 = sym_combine(v1, a1, so1, sq1, q);
        }
        longlong2 w;
        w.x = v0;
        w.y = v1;
        *reinterpret_cast<longlong2*>(out + row + e) = w;
      }
    }
    if (l + (int)gridDim.y < L) __syncthreads();  // v serves the next limb
  }
}

// KA.  One block per (row, limb); buffer A = ntt(u), buffer B = ntt(e1),
// then ntt(pte).  The loops over i give each thread the same indices in
// every pass, so A's in-place reduction is read back by the thread that
// wrote it.
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_asym_kernel(const uint32_t* __restrict__ u,
                    const uint32_t* __restrict__ e1,
                    const uint32_t* __restrict__ pte,
                    const uint32_t* __restrict__ op,
                    const uint32_t* __restrict__ quot,
                    const uint32_t* __restrict__ qs,
                    const uint32_t* __restrict__ p0_op,
                    const uint32_t* __restrict__ p0_quot,
                    const uint32_t* __restrict__ p1_op,
                    const uint32_t* __restrict__ p1_quot,
                    uint32_t* __restrict__ c0, uint32_t* __restrict__ c1,
                    int B, int logn) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  uint32_t* va = smem;
  uint32_t* vb = smem + n + n / 8;
  const int l = blockIdx.y;
  const size_t row = ((size_t)l * B + blockIdx.x) * (size_t)n;
  const size_t lrow = (size_t)l * n;
  const uint32_t* opl = op + lrow;
  const uint32_t* quotl = quot + lrow;
  const uint32_t q = qs[l];

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    va[sidx(i)] = u[row + i];
    vb[sidx(i)] = e1[row + i];
  }
  __syncthreads();
  ntt_row<R>(va, opl, quotl, q, logn);
  ntt_row<R>(vb, opl, quotl, q, logn);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t nu = reduce_4q(va[sidx(i)], q);
    va[sidx(i)] = nu;
    const uint32_t r =
        shoup_mul(nu, p1_op[lrow + i], p1_quot[lrow + i], q) +
        reduce_4q(vb[sidx(i)], q);
    c1[row + i] = r >= q ? r - q : r;
  }
  __syncthreads();  // every read of ntt(e1) is done before B is refilled

  for (int i = threadIdx.x; i < n; i += blockDim.x) vb[sidx(i)] = pte[row + i];
  __syncthreads();
  ntt_row<R>(vb, opl, quotl, q, logn);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t r =
        shoup_mul(va[sidx(i)], p0_op[lrow + i], p0_quot[lrow + i], q) +
        reduce_4q(vb[sidx(i)], q);
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

// Threads per row and the padded row's bytes; n = 2^logn in [8, 16384].
int threads_for(int logn) {
  const int eighth = 1 << (logn - 3);
  return eighth < kMaxThreads ? eighth : kMaxThreads;
}

size_t row_bytes(int logn) {
  const size_t n = (size_t)1 << logn;
  return (n + n / 8) * sizeof(uint32_t);
}

template <int R, bool kFromPte>
cudaError_t launch_kn(const long long* x, const long long* op,
                      const long long* quot, const long long* qs,
                      const long long* r0s, const long long* r1s,
                      const long long* a, const long long* s_op,
                      const long long* s_quot, long long* out, int L, int B,
                      int logn, cudaStream_t stream) {
  const size_t smem = row_bytes(logn);
  const cudaError_t err = allow_smem(ntt_kernel<R, kFromPte>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, kFromPte ? 1u : (unsigned)L);
  ntt_kernel<R, kFromPte><<<grid, threads_for(logn), smem, stream>>>(
      x, op, quot, qs, r0s, r1s, a, s_op, s_quot, out, L, B, logn);
  return cudaGetLastError();
}

template <bool kFromPte>
cudaError_t dispatch_kn(const void* x, const void* op, const void* quot,
                        const void* qs, const void* r0s, const void* r1s,
                        const void* a, const void* s_op, const void* s_quot,
                        void* out, int L, int B, int logn,
                        cudaStream_t stream) {
  if (logn < 3 || logn > 14) return cudaErrorInvalidValue;
  const int R = (1 << logn) / threads_for(logn);
  const auto args = [&](auto launch) {
    return launch((const long long*)x, (const long long*)op,
                  (const long long*)quot, (const long long*)qs,
                  (const long long*)r0s, (const long long*)r1s,
                  (const long long*)a, (const long long*)s_op,
                  (const long long*)s_quot, (long long*)out, L, B, logn,
                  stream);
  };
  if (R == 8) return args(launch_kn<8, kFromPte>);
  if (R == 16) return args(launch_kn<16, kFromPte>);
  return args(launch_kn<32, kFromPte>);
}

template <int R>
cudaError_t launch_ka(const void* u, const void* e1, const void* pte,
                      const void* op, const void* quot, const void* qs,
                      const void* p0_op, const void* p0_quot,
                      const void* p1_op, const void* p1_quot, void* c0,
                      void* c1, int L, int B, int logn, cudaStream_t stream) {
  const size_t smem = 2 * row_bytes(logn);
  const cudaError_t err = allow_smem(ntt_asym_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)L);
  ntt_asym_kernel<R><<<grid, threads_for(logn), smem, stream>>>(
      (const uint32_t*)u, (const uint32_t*)e1, (const uint32_t*)pte,
      (const uint32_t*)op, (const uint32_t*)quot, (const uint32_t*)qs,
      (const uint32_t*)p0_op, (const uint32_t*)p0_quot,
      (const uint32_t*)p1_op, (const uint32_t*)p1_quot, (uint32_t*)c0,
      (uint32_t*)c1, B, logn);
  return cudaGetLastError();
}

}  // namespace

// x, out: (L, B, n) int64 u32 values, x below 4q; op, quot: (L, n) int64
// forward root tables; qs: (L,) int64.  out = ntt(x) mod q, n = 2^logn in
// [8, 16384].
extern "C" int sek_ntt_fwd(const void* x, const void* op, const void* quot,
                           const void* qs, void* out, int L, int B, int logn,
                           void* stream) {
  if (L <= 0 || B <= 0) return (int)cudaSuccess;
  return (int)dispatch_kn<false>(x, op, quot, qs, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, out, L, B, logn,
                                 (cudaStream_t)stream);
}

// pte: (B, n) int64 plaintext + error; a, out: (L, B, n) int64 u32 values;
// op, quot, s_op, s_quot: (L, n) int64; qs, r0s, r1s: (L,) int64, the
// moduli and the low and high words of floor(2^64 / q).
// out = -a * ntt(s) + ntt(reduce_pte(pte)) mod q, per limb.
extern "C" int sek_ntt_from_pte(const void* pte, const void* op,
                                const void* quot, const void* qs,
                                const void* r0s, const void* r1s,
                                const void* a, const void* s_op,
                                const void* s_quot, void* out, int L, int B,
                                int logn, void* stream) {
  if (L <= 0 || B <= 0) return (int)cudaSuccess;
  return (int)dispatch_kn<true>(pte, op, quot, qs, r0s, r1s, a, s_op, s_quot,
                                out, L, B, logn, (cudaStream_t)stream);
}

// u, e1, pte, c0, c1: (L, B, n) u32, inputs below 4q; op, quot: (L, n)
// forward root tables; qs: (L,); p0_op/p0_quot and p1_op/p1_quot: (L, n)
// Shoup pairs of pk0 and pk1.  n = 2^logn in [8, 16384].
extern "C" int sek_ntt_asym(const void* u, const void* e1, const void* pte,
                            const void* op, const void* quot, const void* qs,
                            const void* p0_op, const void* p0_quot,
                            const void* p1_op, const void* p1_quot, void* c0,
                            void* c1, int L, int B, int logn, void* stream) {
  if (L <= 0 || B <= 0) return (int)cudaSuccess;
  if (logn < 3 || logn > 14) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int R = (1 << logn) / threads_for(logn);
  const cudaError_t err =
      R == 8 ? launch_ka<8>(u, e1, pte, op, quot, qs, p0_op, p0_quot, p1_op,
                            p1_quot, c0, c1, L, B, logn, st)
      : R == 16 ? launch_ka<16>(u, e1, pte, op, quot, qs, p0_op, p0_quot,
                                p1_op, p1_quot, c0, c1, L, B, logn, st)
                : launch_ka<32>(u, e1, pte, op, quot, qs, p0_op, p0_quot,
                                p1_op, p1_quot, c0, c1, L, B, logn, st);
  return (int)err;
}
