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
// Bound on the H100: shared-memory traffic and the per-round barriers;
// f64 arithmetic is 10 operations per butterfly, well inside the card's
// f64 rate.  Device memory sees only the values (4 bytes per slot), the
// twiddles (cached) and the i64 output (8 bytes per coefficient).
// Design: one thread block per batch row keeps the re and im planes in
// dynamic shared memory (64 KB at n = 4096, 128 KB at n = 8192).  At
// n = 16384 the planes need 256 KB, above the 227 KB a block may have.
// Rounds 0..logn-2 pair indices that differ only in bits below logn-1, so
// the two halves of the row stay independent until the last round: one
// block per (row, half) runs those rounds in 128 KB and writes its half
// to scratch, and a second kernel runs the last round, the scaling and
// the rounding elementwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// |coeff| bound: double(0x7FFFFFFFFFFFFFFF) == 2^63 (ops/encode.py:148).
constexpr double kI64Bound = 9223372036854775808.0;

__device__ __forceinline__ double round_half_away(double x) {
  return x < 0.0 ? -floor(__dadd_rn(-x, 0.5)) : floor(__dadd_rn(x, 0.5));
}

// Rounds [0, nrounds) on segment `seg` (of 2^seg_log entries) of row
// blockIdx.x; with nrounds == logn (one segment) it also finishes the row.
__global__ void encode_rounds_kernel(
    const float* __restrict__ values, int vlen, const int* __restrict__ imap,
    const double* __restrict__ tw_re, const double* __restrict__ tw_im,
    double scale_over_n, int logn, int seg_log, int nrounds,
    long long* __restrict__ coeff, int* __restrict__ ok,
    double* __restrict__ scratch_re, double* __restrict__ scratch_im) {
  extern __shared__ double smem[];
  const int n = 1 << logn;
  const int seg_n = 1 << seg_log;
  double* re = smem;
  double* im = smem + seg_n;
  const int b = blockIdx.x;
  const int seg = blockIdx.y;
  const int seg_base = seg << seg_log;

  for (int i = threadIdx.x; i < seg_n; i += blockDim.x) {
    re[i] = 0.0;
    im[i] = 0.0;
  }
  __syncthreads();
  // imap is a permutation of [0, n): the two targets of every value, and
  // all targets of all values, are distinct.
  const float* vrow = values + (size_t)b * vlen;
  for (int i = threadIdx.x; i < vlen; i += blockDim.x) {
    const double v = (double)vrow[i];
    const int t0 = imap[i];
    const int t1 = imap[(n >> 1) + i];
    if ((t0 >> seg_log) == seg) re[t0 - seg_base] = v;
    if ((t1 >> seg_log) == seg) re[t1 - seg_base] = v;
  }
  __syncthreads();

  // Round r: tt = 2^r, h = n >> (r + 1) groups of 2 * tt; group j's
  // twiddle sits at offset n - (n >> r) + j of the flattened tables.
  for (int r = 0; r < nrounds; ++r) {
    const int tt = 1 << r;
    const int tw_off = n - (n >> r);
    const int gbase = seg_base >> (r + 1);
    for (int k = threadIdx.x; k < (seg_n >> 1); k += blockDim.x) {
      const int jl = k >> r;
      const int ui = (jl << (r + 1)) + (k & (tt - 1));
      const int wi = ui + tt;
      const double sre = tw_re[tw_off + gbase + jl];
      const double sim = tw_im[tw_off + gbase + jl];
      const double ure = re[ui], uim = im[ui];
      const double wre = re[wi], wim = im[wi];
      const double dre = __dsub_rn(ure, wre);
      const double dim = __dsub_rn(uim, wim);
      re[ui] = __dadd_rn(ure, wre);
      im[ui] = __dadd_rn(uim, wim);
      re[wi] = __dsub_rn(__dmul_rn(dre, sre), __dmul_rn(dim, sim));
      im[wi] = __dadd_rn(__dmul_rn(dre, sim), __dmul_rn(dim, sre));
    }
    __syncthreads();
  }

  if (nrounds < logn) {
    double* srow_re = scratch_re + (size_t)b * n + seg_base;
    double* srow_im = scratch_im + (size_t)b * n + seg_base;
    for (int i = threadIdx.x; i < seg_n; i += blockDim.x) {
      srow_re[i] = re[i];
      srow_im[i] = im[i];
    }
    return;
  }
  int row_ok = 1;
  long long* crow = coeff + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double c = round_half_away(__dmul_rn(re[i], scale_over_n));
    row_ok &= fabs(c) <= kI64Bound;
    crow[i] = (long long)c;
  }
  row_ok = __syncthreads_and(row_ok);
  if (threadIdx.x == 0) ok[b] = row_ok;
}

// The last round (tt = n/2, one group, twiddle at offset n - 2) plus the
// scaling and rounding, from the two halves written by the rounds kernel.
__global__ void encode_last_round_kernel(
    const double* __restrict__ scratch_re,
    const double* __restrict__ scratch_im, const double* __restrict__ tw_re,
    const double* __restrict__ tw_im, double scale_over_n, int logn,
    long long* __restrict__ coeff, int* __restrict__ ok) {
  const int n = 1 << logn;
  const int half = n >> 1;
  const int b = blockIdx.x;
  const double sre = tw_re[n - 2];
  const double sim = tw_im[n - 2];
  const double* rrow = scratch_re + (size_t)b * n;
  const double* irow = scratch_im + (size_t)b * n;
  long long* crow = coeff + (size_t)b * n;
  int row_ok = 1;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const double ure = rrow[i], uim = irow[i];
    const double wre = rrow[i + half], wim = irow[i + half];
    const double dre = __dsub_rn(ure, wre);
    const double dim = __dsub_rn(uim, wim);
    const double out_u = __dadd_rn(ure, wre);
    const double out_w = __dsub_rn(__dmul_rn(dre, sre), __dmul_rn(dim, sim));
    const double cu = round_half_away(__dmul_rn(out_u, scale_over_n));
    const double cw = round_half_away(__dmul_rn(out_w, scale_over_n));
    row_ok &= (fabs(cu) <= kI64Bound) & (fabs(cw) <= kI64Bound);
    crow[i] = (long long)cu;
    crow[i + half] = (long long)cw;
  }
  row_ok = __syncthreads_and(row_ok);
  if (threadIdx.x == 0) ok[b] = row_ok;
}

}  // namespace

// values (B, vlen) f32; imap (n,) i32; tw_re/tw_im (n - 1,) f64, round r at
// offset n - (n >> r); -> coeff (B, n) i64, ok (B,) i32.  nseg is 1, or 2
// when the row's planes exceed a block's shared memory; then scratch_re and
// scratch_im are (B, n) f64 buffers.
extern "C" int sek_encode_f64(const void* values, int B, int vlen,
                              const void* imap, const void* tw_re,
                              const void* tw_im, double scale_over_n,
                              int logn, int nseg, void* coeff, void* ok,
                              void* scratch_re, void* scratch_im,
                              void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if ((nseg != 1 && nseg != 2) || (nseg == 2 && !(scratch_re && scratch_im)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int seg_log = nseg == 1 ? logn : logn - 1;
  const int nrounds = nseg == 1 ? logn : logn - 1;
  const size_t smem = (2 * sizeof(double)) << seg_log;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int seg_half = 1 << (seg_log - 1);
  const int threads = seg_half < 512 ? seg_half : 512;
  encode_rounds_kernel<<<dim3((unsigned)B, (unsigned)nseg), threads, smem,
                         st>>>(
      (const float*)values, vlen, (const int*)imap, (const double*)tw_re,
      (const double*)tw_im, scale_over_n, logn, seg_log, nrounds,
      (long long*)coeff, (int*)ok, (double*)scratch_re, (double*)scratch_im);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 1) return (int)err;
  encode_last_round_kernel<<<(unsigned)B, 512, 0, st>>>(
      (const double*)scratch_re, (const double*)scratch_im,
      (const double*)tw_re, (const double*)tw_im, scale_over_n, logn,
      (long long*)coeff, (int*)ok);
  return (int)cudaGetLastError();
}
