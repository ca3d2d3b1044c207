// Kernel KE: bit-exact CKKS encode in IEEE f64.
//
// Replaces seal_embedded_tpu/ops/kernels/encode2.py: _encode_call (K5,
// encode_sf_fused), which runs the same IFFT in software binary64 because
// the TPU has no f64.  The H100 has native IEEE f64, so this kernel is the
// plain algorithm of ops/encode.py:104-149 (ckks_common.c:105-215 +
// fft.c:117-144): place values and conjugates through the index map, run
// logn rounds u' = u + w, w' = (u - w) * s, multiply by scale/n, round half
// away from zero, flag |coeff| > 2^63.
//
// Bit-exactness: every f64 operation goes through __dadd_rn / __dsub_rn /
// __dmul_rn, which the compiler never contracts into an FMA, in the
// operation order of ops/encode.py (the library is also built with
// -fmad=false).  Rounding is x < 0 ? -floor(-x + 0.5) : floor(x + 0.5).
//
// Bound on the H100, the larger of two terms.  Bytes: the f32 values (4 per
// slot) in, the int64 coefficients (8 per coefficient) out, the tables
// cached: 42.0 MB at B = 1024, n = 4096, 0.0125 ms at 3.35 TB/s.  f64
// operations: 10 a butterfly (logn n / 2 butterflies a row) and 2 a
// coefficient for the scaling and rounding, 260 M at B = 1024, n = 4096:
// 0.0156 ms at 64 f64 results per SM per clock, 132 SMs at 1.98 GHz.  So
// it is bound by f64 operations.
//
// Design.  One block of T = min(n_c / 8, 512) threads per row (n_c the
// coefficients a block holds); each thread holds R = n_c / T complex
// values (8 or 16) in registers.  Round r pairs elements 2^r apart, so a
// pass of 3 rounds r0 .. r0 + 2 closes over sets of 8 elements {base + k
// 2^r0} (the indexing of ntt.cu's pass_elem): the 12 rounds at n = 4096
// run as 4 passes, each in registers with its twiddles loaded by the
// thread (__ldg), and the row goes through shared memory once between
// passes (store, one barrier, load): 3 exchanges and 3 barriers where a
// barrier per round took 12.  A count of rounds that is not a multiple of
// 3 runs its first pass with 1 or 2.  Shared memory holds the row as
// (re, im) pairs with one pad pair after every 8 (18 n_c bytes), which
// keeps every pass's 16-byte accesses on distinct banks.  The values are
// scattered into it through the index map (a permutation, so no two
// values land on one slot); the first pass reads re from it and starts
// with im = 0; the last pass's elements {t + k n_c / 8} go from the
// registers straight to the coefficients, coalesced.
//
// n = 16384 needs 288 KB, above the 227 KB a block may have, so a row runs
// in a cluster of 2 CTAs, and so does n = 8192 (that measured a little
// faster than one block a row on an H100: PERF.md).  Rounds 0 .. logn
// - 2 pair indices that differ only in bits below logn - 1, so CTA c runs
// them on half c of the row, all in its own shared memory.  After
// cluster.sync(), the last round (the pairs (i, i + n / 2), one twiddle)
// reads both operands through distributed shared memory, CTA c taking
// pairs [c n / 4, (c + 1) n / 4), and writes the rounded coefficients;
// the row's ok is the AND of both CTAs' flags, gathered in CTA 0's shared
// memory.  Shared memory per block: 36 KB at n = 2048, 72 KB at 4096,
// 72 KB at 8192 (2 CTAs), 144 KB at 16384 (2 CTAs).  One launch at every
// degree, no scratch in device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;

// |coeff| bound: double(0x7FFFFFFFFFFFFFFF) == 2^63 (ops/encode.py:148).
constexpr double kI64Bound = 9223372036854775808.0;

__device__ __forceinline__ double round_half_away(double x) {
  return x < 0.0 ? -floor(__dadd_rn(-x, 0.5)) : floor(__dadd_rn(x, 0.5));
}

// Shared-memory index of element i: one pad pair after every 8.
__device__ __forceinline__ int sidx(int i) { return i + (i >> 3); }

// Rounds in the first pass: the rest come in passes of 3.
__host__ __device__ __forceinline__ int first_rounds(int nrounds) {
  return nrounds - 3 * ((nrounds - 1) / 3);
}

// Element held in register j by thread t (of T) in a pass of P rounds
// whose smallest butterfly distance is 2^r0: thread t owns the sets sigma =
// t + m T (m < R >> P), set sigma being the 2^P elements base + k 2^r0,
// base = (sigma >> r0) 2^(r0 + P) + (sigma mod 2^r0).
__device__ __forceinline__ int pass_elem(int j, int P, int r0, int t, int T) {
  const int m = j >> P, k = j & ((1 << P) - 1);
  const int sigma = t + m * T;
  const int base = ((sigma >> r0) << (r0 + P)) | (sigma & ((1 << r0) - 1));
  return base + (k << r0);
}

// u' = u + w, w' = (u - w) * s, in the operation order of ops/encode.py.
__device__ __forceinline__ void butterfly(double& ure, double& uim,
                                          double& wre, double& wim,
                                          double sre, double sim) {
  const double dre = __dsub_rn(ure, wre);
  const double dim = __dsub_rn(uim, wim);
  ure = __dadd_rn(ure, wre);
  uim = __dadd_rn(uim, wim);
  wre = __dsub_rn(__dmul_rn(dre, sre), __dmul_rn(dim, sim));
  wim = __dadd_rn(__dmul_rn(dre, sim), __dmul_rn(dim, sre));
}

// Rounds r0 .. r0 + P - 1 on the thread's sets, in registers.  Round r's
// twiddles sit at offset n - (n >> r) of the flattened tables, one per
// group of 2^(r + 1) elements; the block's first element is `first`, so
// set sigma's group g at round r0 + p is group (first >> (r + 1)) +
// (sigma >> r0) 2^(P - 1 - p) + g of the row.
template <int R, int P>
__device__ __forceinline__ void pass_compute(double (&xr)[R], double (&xi)[R],
                                             const double* __restrict__ tw_re,
                                             const double* __restrict__ tw_im,
                                             int n, int first, int r0, int t,
                                             int T) {
#pragma unroll
  for (int m = 0; m < (R >> P); ++m) {
    const int G = (t + m * T) >> r0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = r0 + p;
      const int off =
          n - (n >> r) + (first >> (r + 1)) + (G << (P - 1 - p));
#pragma unroll
      for (int g = 0; g < (1 << (P - 1 - p)); ++g) {
        const double sre = __ldg(tw_re + off + g);
        const double sim = __ldg(tw_im + off + g);
#pragma unroll
        for (int k = 0; k < (1 << p); ++k) {
          const int i0 = (m << P) + (g << (p + 1)) + k;
          const int i1 = i0 + (1 << p);
          butterfly(xr[i0], xi[i0], xr[i1], xi[i1], sre, sim);
        }
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void first_pass(double (&xr)[R], double (&xi)[R],
                                           const double* __restrict__ tw_re,
                                           const double* __restrict__ tw_im,
                                           int n, int first, int P0, int t,
                                           int T) {
  if (P0 == 1)
    pass_compute<R, 1>(xr, xi, tw_re, tw_im, n, first, 0, t, T);
  else if (P0 == 2)
    pass_compute<R, 2>(xr, xi, tw_re, tw_im, n, first, 0, t, T);
  else
    pass_compute<R, 3>(xr, xi, tw_re, tw_im, n, first, 0, t, T);
}

// One row per kCtas CTAs (a cluster when kCtas == 2): CTA c holds the
// n / kCtas coefficients from c n / kCtas and runs the rounds that stay
// inside them; with kCtas == 2 the last round crosses the pair.
template <int R, int kCtas>
__global__ void __launch_bounds__(kMaxThreads)
    encode_kernel(const float* __restrict__ values, int vlen,
                  const int* __restrict__ imap,
                  const double* __restrict__ tw_re,
                  const double* __restrict__ tw_im, double scale_over_n,
                  int logn, long long* __restrict__ coeff,
                  int* __restrict__ ok) {
  extern __shared__ double2 plane[];
  const int n = 1 << logn;
  const int nrounds = kCtas == 2 ? logn - 1 : logn;  // inside the block
  const int nc = 1 << nrounds;
  const int t = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x / kCtas;
  const int c = blockIdx.x % kCtas;  // the cluster rank when kCtas == 2
  const int first = c << nrounds;

  for (int i = t; i < nc; i += T) plane[sidx(i)].x = 0.0;
  __syncthreads();
  const float* vrow = values + (size_t)b * vlen;
  for (int i = t; i < vlen; i += T) {
    const double v = (double)vrow[i];
    const unsigned t0 = (unsigned)(__ldg(imap + i) - first);
    const unsigned t1 = (unsigned)(__ldg(imap + (n >> 1) + i) - first);
    if (t0 < (unsigned)nc) plane[sidx(t0)].x = v;
    if (t1 < (unsigned)nc) plane[sidx(t1)].x = v;
  }
  __syncthreads();

  const int P0 = first_rounds(nrounds);
  double xr[R], xi[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    xr[j] = plane[sidx(pass_elem(j, P0, 0, t, T))].x;
    xi[j] = 0.0;
  }
  first_pass<R>(xr, xi, tw_re, tw_im, n, first, P0, t, T);
  int P = P0, lt = 0;
  for (int r0 = P0; r0 < nrounds; r0 += 3) {
    // Each thread stores the elements it loaded, so only the loads of the
    // new layout wait for the barrier.
#pragma unroll
    for (int j = 0; j < R; ++j)
      plane[sidx(pass_elem(j, P, lt, t, T))] = make_double2(xr[j], xi[j]);
    __syncthreads();
    P = 3;
    lt = r0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const double2 z = plane[sidx(pass_elem(j, P, lt, t, T))];
      xr[j] = z.x;
      xi[j] = z.y;
    }
    pass_compute<R, 3>(xr, xi, tw_re, tw_im, n, first, lt, t, T);
  }

  long long* crow = coeff + (size_t)b * n;
  int row_ok = 1;
  if constexpr (kCtas == 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const double x = round_half_away(__dmul_rn(xr[j], scale_over_n));
      row_ok &= fabs(x) <= kI64Bound;
      crow[pass_elem(j, P, lt, t, T)] = (long long)x;
    }
    row_ok = __syncthreads_and(row_ok);
    if (t == 0) ok[b] = row_ok;
    return;
  }

  // The last round (tt = n / 2, one group, twiddle at offset n - 2)
  // across the cluster: u from CTA 0, w from CTA 1, at the same index.
  __shared__ int flags[2];
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int j = 0; j < R; ++j)
    plane[sidx(pass_elem(j, P, lt, t, T))] = make_double2(xr[j], xi[j]);
  cluster.sync();
  const double2* pu = cluster.map_shared_rank(plane, 0);
  const double2* pw = cluster.map_shared_rank(plane, 1);
  const double sre = __ldg(tw_re + n - 2), sim = __ldg(tw_im + n - 2);
  const int quarter = n >> 2;
  for (int i = c * quarter + t; i < (c + 1) * quarter; i += T) {
    const double2 u = pu[sidx(i)], w = pw[sidx(i)];
    const double dre = __dsub_rn(u.x, w.x);
    const double dim = __dsub_rn(u.y, w.y);
    const double cu = round_half_away(
        __dmul_rn(__dadd_rn(u.x, w.x), scale_over_n));
    const double cw = round_half_away(__dmul_rn(
        __dsub_rn(__dmul_rn(dre, sre), __dmul_rn(dim, sim)), scale_over_n));
    row_ok &= (fabs(cu) <= kI64Bound) & (fabs(cw) <= kI64Bound);
    crow[i] = (long long)cu;
    crow[i + (n >> 1)] = (long long)cw;
  }
  row_ok = __syncthreads_and(row_ok);
  if (t == 0) cluster.map_shared_rank(flags, 0)[c] = row_ok;
  cluster.sync();  // also keeps each CTA's planes alive for its partner
  if (c == 0 && t == 0) ok[b] = flags[0] & flags[1];
}

template <int R, int kCtas>
cudaError_t launch_ke(const float* values, int B, int vlen, const int* imap,
                      const double* tw_re, const double* tw_im,
                      double scale_over_n, int logn, long long* coeff,
                      int* ok, cudaStream_t stream) {
  const int nc = 1 << (logn - (kCtas - 1));
  const size_t smem = (size_t)(nc + nc / 8) * sizeof(double2);
  const auto kernel = encode_kernel<R, kCtas>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * kCtas);
  cfg.blockDim = dim3((unsigned)(nc / R));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCtas;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = kCtas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, values, vlen, imap, tw_re, tw_im, scale_over_n, logn,
      coeff, ok);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// values (B, vlen) f32; imap (n,) i32; tw_re/tw_im (n - 1,) f64, round r at
// offset n - (n >> r); -> coeff (B, n) i64, ok (B,) i32.  n from 8 to 16384:
// one CTA a row below n = 8192, a cluster of 2 from it.
extern "C" int sek_encode_f64(const void* values, int B, int vlen,
                              const void* imap, const void* tw_re,
                              const void* tw_im, double scale_over_n,
                              int logn, void* coeff, void* ok, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (logn < 3 || logn > 14) return (int)cudaErrorInvalidValue;
  const auto args = [&](auto launch) {
    return launch((const float*)values, B, vlen, (const int*)imap,
                  (const double*)tw_re, (const double*)tw_im, scale_over_n,
                  logn, (long long*)coeff, (int*)ok, (cudaStream_t)stream);
  };
  // R = 8 up to 4096 coefficients a CTA, 16 at 8192 (n = 16384).
  cudaError_t err;
  if (logn < 13)
    err = args(launch_ke<8, 1>);
  else
    err = logn == 13 ? args(launch_ke<8, 2>) : args(launch_ke<16, 2>);
  return (int)err;
}
