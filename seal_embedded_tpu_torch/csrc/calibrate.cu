// Kernel KC: op-mix calibration loops, the measured ceilings that the
// other kernels' roofline shares are taken against.
//
// Replaces seal_embedded_tpu/ops/kernels/calibrate.py:94 _calib_call (K7),
// reached through run_mix.  Each lane runs NCHAIN independent u32 chains
// through a long loop kept in registers; two mixes:
//
//   keccak (calibrate.py:45-63), per chain i with b = c[i+1], c = c[i+2]
//   (indices mod NCHAIN):  t = rol(a, (7i+1) % 31 + 1) ^ b;
//                          t ^= ~b & c;  t ^= 0x9E3779B9
//   ntt (calibrate.py:66-90), per pair (u, w), q = 1053818881:
//                          u = u >= 2q ? u - 2q : u;  hi = mulhi(w, u);
//                          t = w*u - hi*q;  (u, w) <- (u + t, u + 2q - t)
//
// Every iteration builds its new chains from the old ones, as the JAX
// body builds a new list: the keccak mix keeps the old set in `c` and
// writes `nxt`, then copies (the compiler renames the registers).
//
// Bound on the H100: the integer issue rate of the SM, nothing else; the
// loop touches memory once before and once after.  Design: one thread per
// lane, 1024 threads per block (one TPU tile of (8, 128) lanes per block),
// two blocks resident per SM (__launch_bounds__), so a grid of 264 or more
// tiles keeps 2048 threads on each of the 132 SMs.  The rotate is
// __funnelshift_l and mulhi is __umulhi, the instructions KK and KN
// compile to, so the ceiling is that of the code those kernels run.  The
// trip count arrives at run time and the body is unrolled 8 times, as the
// JAX kernel unrolls by hand.  Layout: x, out are (tiles, NCHAIN, 1024)
// u32, lane-fastest, so each chain load and store is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 1024;
constexpr uint32_t kQ = 1053818881u;
constexpr uint32_t kTwoQ = 2u * 1053818881u;
constexpr uint32_t kSalt = 0x9E3779B9u;

template <int NCH>
__device__ __forceinline__ void keccak_step(uint32_t (&c)[NCH]) {
  uint32_t nxt[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const uint32_t a = c[i];
    const uint32_t b = c[(i + 1) % NCH];
    const uint32_t d = c[(i + 2) % NCH];
    uint32_t t = __funnelshift_l(a, a, (i * 7 + 1) % 31 + 1) ^ b;
    t ^= ~b & d;
    nxt[i] = t ^ kSalt;
  }
#pragma unroll
  for (int i = 0; i < NCH; ++i) c[i] = nxt[i];
}

template <int NCH>
__device__ __forceinline__ void ntt_step(uint32_t (&c)[NCH]) {
#pragma unroll
  for (int p = 0; p < NCH / 2; ++p) {
    uint32_t u = c[2 * p];
    const uint32_t w = c[2 * p + 1];
    u = u >= kTwoQ ? u - kTwoQ : u;
    const uint32_t hi = __umulhi(w, u);
    const uint32_t t = w * u - hi * kQ;
    c[2 * p] = u + t;
    c[2 * p + 1] = u + kTwoQ - t;
  }
}

template <int NCH, bool kNtt>
__global__ void __launch_bounds__(kLanes, 2)
    calib_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int iters) {
  const size_t base = (size_t)blockIdx.x * NCH * kLanes + threadIdx.x;
  uint32_t c[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) c[i] = x[base + (size_t)i * kLanes];
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
    if (kNtt) {
      ntt_step<NCH>(c);
    } else {
      keccak_step<NCH>(c);
    }
  }
#pragma unroll
  for (int i = 0; i < NCH; ++i) out[base + (size_t)i * kLanes] = c[i];
}

template <int NCH, bool kNtt>
cudaError_t launch(const void* x, void* out, int tiles, int iters,
                   cudaStream_t stream) {
  calib_kernel<NCH, kNtt><<<tiles, kLanes, 0, stream>>>(
      (const uint32_t*)x, (uint32_t*)out, iters);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, void*, int, int, cudaStream_t);

// Instantiations by chain count: keccak 1..16, ntt the even 2..16 (null
// for an odd count, whose last chain would have no pair).
#define KC_ODD(n) {launch<n, false>, nullptr}
#define KC_EVEN(n) {launch<n, false>, launch<n, true>}
constexpr int kMaxChains = 16;
const Launch kTable[kMaxChains][2] = {
    KC_ODD(1),  KC_EVEN(2),  KC_ODD(3),  KC_EVEN(4),  KC_ODD(5),  KC_EVEN(6),
    KC_ODD(7),  KC_EVEN(8),  KC_ODD(9),  KC_EVEN(10), KC_ODD(11), KC_EVEN(12),
    KC_ODD(13), KC_EVEN(14), KC_ODD(15), KC_EVEN(16)};
#undef KC_ODD
#undef KC_EVEN

}  // namespace

// x, out: (tiles, nchain, 1024) u32; mix 0 = keccak, 1 = ntt; iters a
// multiple of 8.  Returns cudaErrorInvalidValue for a chain count outside
// the instantiated set (the wrapper checks first).
extern "C" int sek_calib_mix(const void* x, void* out, int mix, int nchain,
                             int tiles, int iters, void* stream) {
  if (nchain < 1 || nchain > kMaxChains || (mix != 0 && mix != 1))
    return (int)cudaErrorInvalidValue;
  const Launch fn = kTable[nchain - 1][mix];
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (tiles <= 0) return (int)cudaSuccess;
  return (int)fn(x, out, tiles, iters, (cudaStream_t)stream);
}
