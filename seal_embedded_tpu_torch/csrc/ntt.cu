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
//   c1 = pk1 * ntt(u) + ntt(e1),  c0 = pk0 * ntt(u) + ntt(pte)  mod q,
// from the signed u, e1 and the int64 pte.  Replaces
// ntt_coeff_major_fused_asym (K6, kernels/ntt.py:301-387) and the mapping
// and reduce_pte_i64 passes the JAX package runs before it.
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
// KA works as KN's from-pte entry does: one block per batch row runs all
// L limbs, and reads the caller's int64 rows as they are.  Per limb it
// maps the signed u and e1 on load (x < 0 -> x + q), reduces pte on load
// with reduce_pte, and runs the three NTTs through ntt_regs.  At n <= 4096
// (R = 8) the three run in lockstep: each pass loads its twiddles once for
// the three rows, and the three exchange through three padded shared rows
// (13.5 n bytes, 54 KB at n = 4096) behind one barrier; ntt(u), reduced
// to [0, q), stays in registers for the combine.  Three register sets of
// R = 16 or 32 would spill, so at n = 8192 and 16384 the transforms run
// one after the other through one row, and each thread keeps its n / T
// words of ntt(u) in shared memory after the row (8.5 n bytes: 68 KB at
// n = 8192, 136 KB at 16384).  The epilogue works in the last pass's
// layout: c1 = pk1 * ntt(u) + ntt(e1), then c0 = pk0 * ntt(u) + ntt(pte),
// the pk Shoup pairs loaded and the results stored as 16-byte int64
// pairs.  No (L, B, n) input is stored: the signed rows are read from
// device memory once and later limbs hit L2.  Its bound at (3, 1024,
// 4096): 226.5 M butterflies x 4 integer-pipe instructions, 0.054 ms;
// its bytes (u and e1 1 byte a value, pte 8, c0 and c1 4) 142.6 MB,
// 0.043 ms.
//
// Above the 48 KB default a kernel's shared memory is raised with
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

// Stages s0 .. s0 + P - 1 on the thread's sets of K rows, in registers.
// At stage s = s0 + p, set sigma's group of 2^(P - p) elements g has root
// table[2^s + (sigma >> lt) 2^p + g] (ntt.c:89); the K rows share it.
template <int R, int P, int K>
__device__ __forceinline__ void pass_compute(
    uint32_t (&x)[K][R], const long long* __restrict__ opl,
    const long long* __restrict__ quotl, uint32_t q, int s0, int lt, int t,
    int T) {
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
        const uint32_t r_op = (uint32_t)__ldg(opl + root);
        const uint32_t r_quot = (uint32_t)__ldg(quotl + root);
#pragma unroll
        for (int c = 0; c < K; ++c) {
#pragma unroll
          for (int k = 0; k < half; ++k) {
            const int i0 = (m << P) + 2 * half * g + k;
            const int i1 = i0 + half;
            uint32_t u = x[c][i0];
            if (u >= two_q) u -= two_q;
            const uint32_t w = x[c][i1];
            const uint32_t tw = w * r_op - __umulhi(w, r_quot) * q;
            x[c][i0] = u + tw;
            x[c][i1] = u + two_q - tw;
          }
        }
      }
    }
  }
}

// Forward NTTs of K rows of one modulus held in registers, values below
// 4q, in lockstep.  On entry x holds the first pass's elements (P =
// first_stages(logn), lt = logn - P); on exit the result, lazily in [0,
// 4q), at the last pass's (P = 3, lt = 0: register j = 8m + k holds
// element 8 (t + m T) + k).  v holds the block's K padded shared rows,
// row c at c (n + n / 8); the caller must not let another transform write
// them before every thread has left this one.
template <int R, int K>
__device__ __forceinline__ void ntt_regs(uint32_t (&x)[K][R], uint32_t* v,
                                         const long long* __restrict__ opl,
                                         const long long* __restrict__ quotl,
                                         uint32_t q, int logn) {
  const int t = threadIdx.x, T = blockDim.x;
  const int stride = (1 << logn) + (1 << (logn - 3));
  const int P0 = first_stages(logn);
  int P = P0, lt = logn - P0;
  if (P0 == 1)
    pass_compute<R, 1, K>(x, opl, quotl, q, 0, lt, t, T);
  else if (P0 == 2)
    pass_compute<R, 2, K>(x, opl, quotl, q, 0, lt, t, T);
  else
    pass_compute<R, 3, K>(x, opl, quotl, q, 0, lt, t, T);
  for (int s0 = P0; s0 < logn; s0 += 3) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[c * stride + sidx(pass_elem(j, P, lt, t, T))] = x[c][j];
    }
    __syncthreads();
    P = 3;
    lt = logn - s0 - 3;
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        x[c][j] = v[c * stride + sidx(pass_elem(j, P, lt, t, T))];
    }
    pass_compute<R, 3, K>(x, opl, quotl, q, s0, lt, t, T);
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
    uint32_t xr[1][R];
    if (kFromPte) {
      const uint32_t r0 = (uint32_t)r0s[l], r1 = (uint32_t)r1s[l];
      const long long* src = x + (size_t)b * n;
#pragma unroll
      for (int j = 0; j < R; ++j)
        xr[0][j] = reduce_pte(
            __ldg(src + pass_elem(j, P0, logn - P0, t, T)), q, r0, r1);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        xr[0][j] =
            (uint32_t)__ldg(x + row + pass_elem(j, P0, logn - P0, t, T));
    }
    ntt_regs<R, 1>(xr, v, op + lrow, quot + lrow, q, logn);

#pragma unroll
    for (int m = 0; m < R / 8; ++m) {
      const int e0 = (t + m * T) << 3;
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const int e = e0 + k;
        uint32_t v0 = reduce_4q(xr[0][8 * m + k], q);
        uint32_t v1 = reduce_4q(xr[0][8 * m + k + 1], q);
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

// c = pk * nu + x mod q in Shoup form, nu in [0, q), x below 4q: the
// combine of the JAX fused-asym kernel (kernels/ntt.py:328-334).
__device__ __forceinline__ uint32_t asym_combine(uint32_t nu, uint32_t x,
                                                 uint32_t p_op,
                                                 uint32_t p_quot, uint32_t q) {
  const uint32_t r = shoup_mul(nu, p_op, p_quot, q) + reduce_4q(x, q);
  return r >= q ? r - q : r;
}

// x < 0 -> x + q for the small signed u and e1 (ternary_to_modq_any).
__device__ __forceinline__ uint32_t signed_to_modq(long long x, uint32_t q) {
  return (uint32_t)(x < 0 ? x + (long long)q : x);
}

// KA's three transforms of a limb run in lockstep at R = 8; at R = 16 and
// 32 three register sets would spill, so they run one after the other and
// each thread keeps its own ntt(u) in shared memory, word j at j T + t.
template <int R>
constexpr bool kNuShared = R > 8;

// out = pk * ntt(u) + x per element, in the last pass's layout (register
// j = 8m + k holds element 8 (t + m T) + k), as 16-byte int64 pairs;
// ntt(u) from nu or, with kNuShared, from nus.
template <int R>
__device__ __forceinline__ void asym_store(
    const uint32_t (&nu)[R], const uint32_t* nus, const uint32_t (&x)[R],
    const long long* __restrict__ p_op, const long long* __restrict__ p_quot,
    long long* __restrict__ out, uint32_t q) {
  const int t = threadIdx.x, T = blockDim.x;
#pragma unroll
  for (int m = 0; m < R / 8; ++m) {
    const int e0 = (t + m * T) << 3;
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const int e = e0 + k, j = 8 * m + k;
      const uint32_t n0 = kNuShared<R> ? nus[j * T + t] : nu[j];
      const uint32_t n1 = kNuShared<R> ? nus[(j + 1) * T + t] : nu[j + 1];
      uint32_t o0, o1, h0, h1;
      load2(p_op + e, o0, o1);
      load2(p_quot + e, h0, h1);
      longlong2 w;
      w.x = asym_combine(n0, x[j], o0, h0, q);
      w.y = asym_combine(n1, x[j + 1], o1, h1, q);
      *reinterpret_cast<longlong2*>(out + e) = w;
    }
  }
}

// KA.  Row b of every limb: c1 = pk1 * ntt(u) + ntt(e1) and c0 = pk0 *
// ntt(u) + ntt(pte) mod q, from the signed (B, n) u, e1 and the int64
// (B, n) pte, mapped or reduced per limb as they are loaded.  A barrier
// separates two transforms on the shared rows (ntt_regs's contract); nus,
// after the rows, is each thread's own, so it needs none.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, kNuShared<R> ? 1 : 2)
    ntt_asym_kernel(const long long* __restrict__ u,
                    const long long* __restrict__ e1,
                    const long long* __restrict__ pte,
                    const long long* __restrict__ op,
                    const long long* __restrict__ quot,
                    const long long* __restrict__ qs,
                    const long long* __restrict__ r0s,
                    const long long* __restrict__ r1s,
                    const long long* __restrict__ p0_op,
                    const long long* __restrict__ p0_quot,
                    const long long* __restrict__ p1_op,
                    const long long* __restrict__ p1_quot,
                    long long* __restrict__ c0, long long* __restrict__ c1,
                    int L, int B, int logn) {
  extern __shared__ uint32_t v[];
  const int n = 1 << logn, t = threadIdx.x, T = blockDim.x;
  uint32_t* nus = v + n + n / 8;
  const int P0 = first_stages(logn);
  const size_t brow = (size_t)blockIdx.x * n;
  for (int l = 0; l < L; ++l) {
    const uint32_t q = (uint32_t)qs[l];
    const uint32_t r0 = (uint32_t)r0s[l], r1 = (uint32_t)r1s[l];
    const size_t lrow = (size_t)l * n;
    const size_t row = ((size_t)l * B + blockIdx.x) * n;
    // Element j of the rows as the first pass holds it, mapped or reduced.
    const auto load = [&](int w, int j) {
      const long long s = __ldg((w == 0 ? u : w == 1 ? e1 : pte) + brow +
                                pass_elem(j, P0, logn - P0, t, T));
      return w == 2 ? reduce_pte(s, q, r0, r1) : signed_to_modq(s, q);
    };
    uint32_t nu[R];
    if constexpr (!kNuShared<R>) {
      uint32_t x[3][R];
#pragma unroll
      for (int w = 0; w < 3; ++w) {
#pragma unroll
        for (int j = 0; j < R; ++j) x[w][j] = load(w, j);
      }
      ntt_regs<R, 3>(x, v, op + lrow, quot + lrow, q, logn);
#pragma unroll
      for (int j = 0; j < R; ++j) nu[j] = reduce_4q(x[0][j], q);
      asym_store<R>(nu, nus, x[1], p1_op + lrow, p1_quot + lrow, c1 + row,
                    q);
      asym_store<R>(nu, nus, x[2], p0_op + lrow, p0_quot + lrow, c0 + row,
                    q);
      __syncthreads();  // v serves the next limb
    } else {
#pragma unroll 1
      for (int w = 0; w < 3; ++w) {
        uint32_t x[1][R];
#pragma unroll
        for (int j = 0; j < R; ++j) x[0][j] = load(w, j);
        ntt_regs<R, 1>(x, v, op + lrow, quot + lrow, q, logn);
        if (w == 0) {
#pragma unroll
          for (int j = 0; j < R; ++j) nus[j * T + t] = reduce_4q(x[0][j], q);
        } else {
          asym_store<R>(nu, nus, x[0], (w == 1 ? p1_op : p0_op) + lrow,
                        (w == 1 ? p1_quot : p0_quot) + lrow,
                        (w == 1 ? c1 : c0) + row, q);
        }
        __syncthreads();  // v serves the next transform
      }
    }
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
cudaError_t launch_ka(const long long* u, const long long* e1,
                      const long long* pte, const long long* op,
                      const long long* quot, const long long* qs,
                      const long long* r0s, const long long* r1s,
                      const long long* p0_op, const long long* p0_quot,
                      const long long* p1_op, const long long* p1_quot,
                      long long* c0, long long* c1, int L, int B, int logn,
                      cudaStream_t stream) {
  const size_t smem = kNuShared<R> ? row_bytes(logn) + ((size_t)4 << logn)
                                   : 3 * row_bytes(logn);
  const cudaError_t err = allow_smem(ntt_asym_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  ntt_asym_kernel<R><<<(unsigned)B, threads_for(logn), smem, stream>>>(
      u, e1, pte, op, quot, qs, r0s, r1s, p0_op, p0_quot, p1_op, p1_quot, c0,
      c1, L, B, logn);
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

// u, e1, pte: (B, n) int64, u in {-1, 0, 1}, e1 in [-63, 63], pte any
// value; op, quot, p0_op/p0_quot, p1_op/p1_quot: (L, n) int64, the
// forward root tables and the Shoup pairs of pk0 and pk1; qs, r0s, r1s:
// (L,) int64; c0, c1: (L, B, n) int64 in [0, q).  n = 2^logn in [8,
// 16384].
extern "C" int sek_ntt_asym_from_signed(
    const void* u, const void* e1, const void* pte, const void* op,
    const void* quot, const void* qs, const void* r0s, const void* r1s,
    const void* p0_op, const void* p0_quot, const void* p1_op,
    const void* p1_quot, void* c0, void* c1, int L, int B, int logn,
    void* stream) {
  if (L <= 0 || B <= 0) return (int)cudaSuccess;
  if (logn < 3 || logn > 14) return (int)cudaErrorInvalidValue;
  const int R = (1 << logn) / threads_for(logn);
  const auto args = [&](auto launch) {
    return launch((const long long*)u, (const long long*)e1,
                  (const long long*)pte, (const long long*)op,
                  (const long long*)quot, (const long long*)qs,
                  (const long long*)r0s, (const long long*)r1s,
                  (const long long*)p0_op, (const long long*)p0_quot,
                  (const long long*)p1_op, (const long long*)p1_quot,
                  (long long*)c0, (long long*)c1, L, B, logn,
                  (cudaStream_t)stream);
  };
  if (R == 8) return (int)args(launch_ka<8>);
  if (R == 16) return (int)args(launch_ka<16>);
  return (int)args(launch_ka<32>);
}
