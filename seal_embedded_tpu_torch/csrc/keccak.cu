// Kernel KK: SHAKE-256 squeezes of (seed || counter_le8) streams, and the
// CBD error values, the uniform draw and the ternary draw drawn from them.
//
// Replaces seal_embedded_tpu/ops/kernels/keccak.py: _squeeze_call / _kernel
// (K1, a multi-block squeeze, the uniform sampler's base draw) and
// _squeeze_call_1blk / _kernel_1blk (K2, single-block streams that emit
// only their first `nwords` rate words: the rejection queues, the ternary
// blocks and the CBD error).  The uniform role (keccak_uniform_kernel,
// below) runs K1's squeeze with the rank-select and barrett32 of the
// sampler around it; the ternary role (keccak_ternary_kernel) squeezes
// windows of one stream's counters and walks its blocks over them.  Every
// entry reads the caller's int64 seeds and counters (u32 values, low 32
// bits used) and writes int64 u32 words or values, so the wrapper copies
// nothing.
//
// Streams.  Seed s (of S) has `per_seed` streams; stream j of seed s
// absorbs counter c_s + start + j mod 2^64 (the sampler's counter
// offsets, carried across 2^32 and 2^64 in the 64-bit add), so a queue or
// a CBD draw passes its (S, 16) seeds and (S, 2) counters as they are,
// with no expanded seed copy or counter tensor.  per_seed = 1, start = 0
// is the explicit-counter form.
//
// Bound on the H100: integer instruction rate.  One permutation on 32-bit
// halves needs at least 4,152 logic and funnel-shift instructions (173 a
// round: theta 75, rho 47, chi 50, iota 1; chip_smoke.py), and the SMs
// run 64 a clock each: 16.7 Tinstr/s on 132 SMs at 1980 MHz.  So 1024
// streams x 121 blocks (the uniform base draw at n = 4096) need 0.031
// ms; their 16.9 MB of u32 words need 0.005 ms at 3.35 TB/s.
//
// Multi-block design (nblocks > 1): one warp per stream, lane t = x + 5y
// of the state in thread t (threads 25..31 of the warp only shuffle).  A
// stream's 121 x 24 rounds are one dependent chain; with one thread per
// stream a round is 150 to 200 instructions run one after another
// (0.25 to 0.3 ms for the chain at 1024 threads on 8 SMs).  Split over
// 25 threads a round is, per thread:
//   theta  4 shuffles for the column parity C[x], 2 for C[x-1] and
//          C[x+1], then 3 xors and a rotate;
//   rho    one rotate by the lane's own offset (2 selects, 2 funnel
//          shifts);
//   pi+chi 3 shuffles: B[x,y], B[x+1,y] and B[x+2,y] straight from the
//          lanes pi moves there, then one and-not/xor;
//   iota   one xor with the round constant in thread 0.
// That is 9 64-bit shuffles (18 SHFL) and about 25 ALU instructions in 3
// dependent shuffle stages, against about 175 instructions for a whole
// state in one thread, and 1024 streams fill 1024 warps on all 132 SMs.
// If an SM runs one warp-wide SHFL a clock, that rate bounds it at
// 7.75 warps x 18 SHFL = 140 clocks a round per SM, about 0.2 ms; it
// measured 0.35 to 0.37 ms on the H100 above (about 240 clocks a round),
// so the latency of the 3 dependent shuffle stages at 2 warps per
// scheduler is what sets it, 1.8 times faster than a thread per stream.
// The 17 rate lanes of a squeezed block sit in threads 0..16, so each
// block is one contiguous 272-byte int64 run per stream: coalesced stores
// in the stream-major layout the callers read.  A 5-threads-per-stream split
// (one row each, chi local) needs fewer shuffles per stream but exchanges
// 5 lanes per thread for theta and pi, needs per-thread lane selects for
// pi, and leaves 1.3 warps per SM at 1024 streams: latency-bound again.
//
// Single-block design (nblocks == 1, and the CBD values): one thread per
// stream with its 25-lane state in 64-bit registers (every index a
// compile-time constant after unrolling).  These roles have 8 to 262,144
// streams, so threads are plenty, and a whole state per thread runs the
// fewest instructions per permutation: queue and CBD values ran at 0.79
// to 0.82 of the bound above.  The CBD role turns each stream's first 96 bytes
// into its 16 error values with __popc (sample.c:311-321) and writes them
// as int64 through a shared-memory tile, so a block's 128 x 16 values
// leave as one contiguous run.

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

// Rho offsets by lane t = x + 5y (FIPS 202).
static __constant__ int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                                    20, 3,  10, 43, 25, 39, 41, 45, 15,
                                    21, 8,  18, 2,  61, 56, 14};

namespace {

constexpr int kRateWords = 34;
constexpr int kCbdBlock = 128;  // streams per block of the CBD role

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  // r is in [1, 63] for every call below.
  return (x << r) | (x >> (64 - r));
}

// Rotate left by a per-thread amount r in [0, 63]: swap the halves when
// r >= 32, then two 32-bit funnel shifts by r mod 32.
__device__ __forceinline__ uint64_t rotl64_var(uint64_t x, int r) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (r & 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  const uint32_t nlo = __funnelshift_l(hi, lo, r);
  const uint32_t nhi = __funnelshift_l(lo, hi, r);
  return ((uint64_t)nhi << 32) | nlo;
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

__device__ __forceinline__ uint64_t lane_of(const long long* w) {
  return (uint64_t)(uint32_t)w[0] | ((uint64_t)(uint32_t)w[1] << 32);
}

// Absorb: words 0..15 seed, 16..17 counter, pad word 18 ^= 0x1F and word
// 33 ^= 0x80000000 (ops/keccak.py absorb72); lane k = words 2k, 2k+1.
__device__ __forceinline__ void absorb(uint64_t st[25], const long long* sw,
                                       uint64_t ctr) {
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = lane_of(sw + 2 * k);
  st[8] = ctr;
  st[9] = 0x1FULL;
#pragma unroll
  for (int k = 10; k < 25; ++k) st[k] = 0;
  st[16] = 0x8000000000000000ULL;
}

// Stream g of the (S x per_seed) grid: its seed row and its counter.
__device__ __forceinline__ uint64_t stream_counter(const long long* ctrs,
                                                  long long s,
                                                  unsigned long long off) {
  return lane_of(ctrs + 2 * s) + off;
}

// A stream's state spread over one warp: thread t holds lane t = x + 5y
// (threads 25..31 mirror lane 0 and store nothing), with the shuffle
// sources of its rounds, fixed for the whole stream.
struct WarpLanes {
  int col[4], c_prev, c_next, rho, src[3];
  uint64_t rc_mask;

  __device__ explicit WarpLanes(int t) {
    const int me = t < 25 ? t : 0;
    const int x = me % 5, y = me / 5;
#pragma unroll
    for (int k = 0; k < 4; ++k) col[k] = x + 5 * ((y + 1 + k) % 5);
    c_prev = (x + 4) % 5 + 5 * y;
    c_next = (x + 1) % 5 + 5 * y;
    rho = kRho[me];
    // pi moves lane (x', y') to (y', 2x' + 3y'): B[X, Y] comes from lane
    // ((X + 3Y) % 5) + 5X.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int X = (x + k) % 5;
      src[k] = (X + 3 * y) % 5 + 5 * X;
    }
    rc_mask = t == 0 ? ~0ULL : 0ULL;
  }

  // Thread t's lane after the absorb of (seed || ctr) (absorb() above).
  __device__ static uint64_t absorbed(int t, const long long* seed,
                                      uint64_t ctr) {
    const int me = t < 25 ? t : 0;
    if (me < 8) return lane_of(seed + 2 * me);
    if (me == 8) return ctr;
    if (me == 9) return 0x1FULL;
    if (me == 16) return 0x8000000000000000ULL;
    return 0;
  }

  __device__ void permute(uint64_t& a) const {
    const unsigned full = 0xffffffffu;
#pragma unroll 1
    for (int round = 0; round < 24; ++round) {
      // theta
      uint64_t c = a;
#pragma unroll
      for (int k = 0; k < 4; ++k) c ^= __shfl_sync(full, a, col[k]);
      const uint64_t cp = __shfl_sync(full, c, c_prev);
      const uint64_t cn = __shfl_sync(full, c, c_next);
      a ^= cp ^ rotl64(cn, 1);
      // rho in place, then pi + chi from the three source lanes
      a = rotl64_var(a, rho);
      const uint64_t b0 = __shfl_sync(full, a, src[0]);
      const uint64_t b1 = __shfl_sync(full, a, src[1]);
      const uint64_t b2 = __shfl_sync(full, a, src[2]);
      a = b0 ^ (~b1 & b2);
      // iota
      a ^= kRoundConstants[round] & rc_mask;
    }
  }
};

// One warp per stream, nblocks permutations, every rate word written.
__global__ void keccak_lanes_kernel(const long long* __restrict__ seeds,
                                    const long long* __restrict__ ctrs,
                                    long long* __restrict__ out,
                                    long long nseeds, int per_seed,
                                    unsigned long long start, int nblocks) {
  const int t = threadIdx.x & 31;
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (g >= nseeds * per_seed) return;  // whole warps leave together
  const long long s = g / per_seed;
  const long long j = g - s * per_seed;
  const WarpLanes lanes(t);
  uint64_t a = WarpLanes::absorbed(
      t, seeds + s * 16,
      stream_counter(ctrs, s, start + (unsigned long long)j));

  const int out_words = nblocks * kRateWords;
  long long* o = out + g * out_words + 2 * t;
  for (int b = 0; b < nblocks; ++b) {
    lanes.permute(a);
    if (t < 17) {
      longlong2 w;
      w.x = (long long)(uint32_t)a;
      w.y = (long long)(uint32_t)(a >> 32);
      *reinterpret_cast<longlong2*>(o + b * kRateWords) = w;
    }
  }
}

// x mod q for a u32 x and q < 2^31, r1 the high word of floor(2^64 / q)
// (ops/modarith.py barrett32, modulo.h:43-75).
__device__ __forceinline__ uint32_t barrett32(uint32_t x, uint32_t q,
                                              uint32_t r1) {
  const uint32_t t = x - __umulhi(x, r1) * q;
  return t >= q ? t - q : t;
}

// The warp's queue in shared memory, accepted draws first, each group in
// queue order (the rank-select's stable sort); returns the accepted count.
__device__ int compact_queue(const long long* __restrict__ qrow,
                             uint32_t* acc, int cap, uint32_t mm, int t) {
  const unsigned full = 0xffffffffu, below = (1u << t) - 1;
  int nacc = 0;
  for (int base = 0; base < cap; base += 32) {
    const int j = base + t;
    nacc += __popc(__ballot_sync(full, j < cap && (uint32_t)qrow[j] < mm));
  }
  int na = 0, nr = 0;
  for (int base = 0; base < cap; base += 32) {
    const int j = base + t;
    const uint32_t v = j < cap ? (uint32_t)qrow[j] : 0;
    const bool is_acc = j < cap && v < mm, is_rej = j < cap && v >= mm;
    const unsigned ba = __ballot_sync(full, is_acc);
    const unsigned br = __ballot_sync(full, is_rej);
    if (is_acc) acc[na + __popc(ba & below)] = v;
    if (is_rej) acc[nacc + nr + __popc(br & below)] = v;
    na += __popc(ba);
    nr += __popc(br);
  }
  __syncwarp();
  return nacc;
}

// The uniform draw of one limb (sample_poly_uniform, sample.c:39-57), one
// warp per stream.  Replaces the JAX package's sample_uniform
// (seal_embedded_tpu/ops/sampling.py:277) with its _rank_select (:211) and
// _rejected_positions (:169), and ops/modarith.py barrett32, which the port
// ran as KK's base squeeze plus some 40 torch passes over the (S, n) int64
// words: at n = 16384, 1024 streams, 134 MB a pass.
//
// Per stream: the n u32 words of SHAKE-256(seed || c); the r-th rejected
// word (>= max_multiple) that the chunk rule keeps takes the r-th entry of
// the queue (the one-block draws at c + 1 .. c + cap, KK's queue launch),
// accepted draws first, then the rejected ones, each in queue order;
// every word reduced by barrett32 and written as int64 `a` in [0, q),
// with the next counter c + 1 + consumed and ok.  The chunk rule
// (ops/sampling.py _chunk_k): within each chunk of chunk_n words only the
// first chunk_k rejections are kept, a chunk with more clears ok, and the
// words it leaves out keep their base values; the kept positions, in
// position order, take the queue's entries while their rank is below cap.
// consumed is the queue index of the row's num_rejected-th accepted draw
// plus 1 (0 with no rejection); where the queue accepts fewer draws than
// the row rejects, ok is false and consumed is cap + 1.
//
// Bound on the H100: as the base squeeze, the integer rate (ceil(n / 34)
// permutations a stream, 0.123 ms for 1024 streams at n = 16384) against
// 134 MB of int64 `a` (0.040 ms at 3.35 TB/s); what holds it is the
// latency of the warp's dependent rounds, as in keccak_lanes_kernel.  So
// the design adds nothing to the rounds and no pass over memory: after
// each permutation lanes 0..16 hold the block's 34 words, two ballots of
// their rejection flags give each rejected word its rank (the running
// counts before the block plus a __popc prefix; a chunk boundary falls
// between two lanes, 4096 and 34 b being even), and a second pair the
// ranks of the kept ones.  The default chains reject 1% to 2% of the
// words, so a third to a half of the blocks take that path, a few dozen
// instructions against the permutation's thousands; a block with no
// rejection skips it.  The queue is compacted into shared memory at the
// row's first rejection (a row without one never reads it); barrett32
// runs in registers with __umulhi, and `a` leaves as one 16-byte store a
// lane, coalesced.
__global__ void keccak_uniform_kernel(
    const long long* __restrict__ seeds, const long long* __restrict__ ctrs,
    const long long* __restrict__ queue, long long* __restrict__ a_out,
    long long* __restrict__ next_ctr, bool* __restrict__ ok_out,
    long long nseeds, int n, uint32_t q, uint32_t r1, uint32_t mm, int cap,
    int chunk_n, int chunk_k) {
  extern __shared__ uint32_t shared_queue[];
  const int t = threadIdx.x & 31;
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (g >= nseeds) return;  // whole warps leave together
  uint32_t* acc = shared_queue + (threadIdx.x >> 5) * cap;
  const long long* qrow = queue + g * cap;
  const unsigned full = 0xffffffffu, below = (1u << t) - 1;
  const uint64_t c = lane_of(ctrs + 2 * g);
  const WarpLanes lanes(t);
  uint64_t a = WarpLanes::absorbed(t, seeds + g * 16, c);

  // Warp-uniform walk state: rejections so far, kept ones so far, the
  // open chunk's rejections and its end, the queue's accepted count once
  // compacted (-1 before).
  int rejected = 0, kept = 0, in_chunk = 0, chunk_end = chunk_n, nacc = -1;
  bool ok = true;
  const int nblocks = (n + kRateWords - 1) / kRateWords;
  long long* o = a_out + g * n;
  for (int b = 0; b < nblocks; ++b) {
    lanes.permute(a);
    const int first = b * kRateWords;
    const int i0 = first + 2 * t;
    const bool valid = t < 17 && i0 < n;  // n even: both words or none
    uint32_t w0 = (uint32_t)a, w1 = (uint32_t)(a >> 32);
    const bool r0 = valid && w0 >= mm, r1w = valid && w1 >= mm;
    const unsigned b0 = __ballot_sync(full, r0);
    const unsigned b1 = __ballot_sync(full, r1w);
    // The open chunk ends in this block: lanes below tb lie in it.
    const bool closes = chunk_end - first <= kRateWords;
    const int tb = closes ? (chunk_end - first) / 2 : 32;
    const unsigned open = tb >= 32 ? full : (1u << tb) - 1;
    int before = 0, here = 0;
    if (b0 | b1) {
      if (nacc < 0) nacc = compact_queue(qrow, acc, cap, mm, t);
      const int rank0 =
          t < tb ? in_chunk + __popc(b0 & below) + __popc(b1 & below)
                 : __popc(b0 & below & ~open) + __popc(b1 & below & ~open);
      const int rank1 = rank0 + r0;
      const bool k0 = r0 && rank0 < chunk_k, k1 = r1w && rank1 < chunk_k;
      const unsigned kb0 = __ballot_sync(full, k0);
      const unsigned kb1 = __ballot_sync(full, k1);
      const int m0 = kept + __popc(kb0 & below) + __popc(kb1 & below);
      const int m1 = m0 + k0;
      if (k0 && m0 < cap) w0 = acc[m0];
      if (k1 && m1 < cap) w1 = acc[m1];
      kept += __popc(kb0) + __popc(kb1);
      here = __popc(b0) + __popc(b1);
      before = __popc(b0 & open) + __popc(b1 & open);
      rejected += here;
    }
    if (closes) {
      ok = ok && in_chunk + before <= chunk_k;
      in_chunk = here - before;
      chunk_end += chunk_n;
    } else {
      in_chunk += here;
    }
    if (valid) {
      longlong2 v;
      v.x = (long long)barrett32(w0, q, r1);
      v.y = (long long)barrett32(w1, q, r1);
      *reinterpret_cast<longlong2*>(o + i0) = v;
    }
  }

  // consumed: the queue index of the rejected-th accepted draw, plus 1.
  unsigned long long consumed = 0;
  if (rejected > 0 && rejected <= nacc) {
    for (int base = 0, run = 0;; base += 32) {
      const int j = base + t;
      const bool in = j < cap && (uint32_t)qrow[j] < mm;
      const unsigned ba = __ballot_sync(full, in);
      if (run + __popc(ba) >= rejected) {
        const bool hit = in && run + __popc(ba & below) + 1 == rejected;
        consumed = base + __ffs(__ballot_sync(full, hit));
        break;
      }
      run += __popc(ba);
    }
  } else if (rejected > 0) {
    ok = false;
    consumed = (unsigned long long)cap + 1;
  }
  if (t == 0) {
    const uint64_t next = c + 1 + consumed;
    next_ctr[2 * g] = (long long)(uint32_t)next;
    next_ctr[2 * g + 1] = (long long)(uint32_t)(next >> 32);
    ok_out[g] = ok;
  }
}

// One thread per stream, one permutation, the first nwords words.
__global__ void keccak_1blk_kernel(const long long* __restrict__ seeds,
                                   const long long* __restrict__ ctrs,
                                   long long* __restrict__ out,
                                   long long nseeds, int per_seed,
                                   unsigned long long start, int nwords) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseeds * per_seed) return;
  const long long s = g / per_seed;
  const long long j = g - s * per_seed;
  uint64_t st[25];
  absorb(st, seeds + s * 16,
         stream_counter(ctrs, s, start + (unsigned long long)j));
  keccak_f1600(st);
  long long* o = out + g * nwords;
#pragma unroll
  for (int k = 0; k < 17; ++k) {
    if (2 * k < nwords) o[2 * k] = (long long)(uint32_t)st[k];
    if (2 * k + 1 < nwords) o[2 * k + 1] = (long long)(uint32_t)(st[k] >> 32);
  }
}

// CBD error: stream f of seed s (counter c_s + f) gives values 16f ..
// 16f + 15 of row s.  Value i reads bytes 6i .. 6i + 5 of the stream:
// hw(b0) + hw(b1) + hw(b2 & 0x1F) - hw(b3) - hw(b4) - hw(b5 & 0x1F), i.e.
// the popcounts of the 21-bit fields at bits 48i and 48i + 24.
__global__ void keccak_cbd_kernel(const long long* __restrict__ seeds,
                                  const long long* __restrict__ ctrs,
                                  long long* __restrict__ out,
                                  long long nseeds, int nfills) {
  __shared__ int tile[kCbdBlock * 17];  // 16 values + 1 pad per stream
  const long long g0 = (long long)blockIdx.x * kCbdBlock;
  const long long g = g0 + threadIdx.x;
  const long long total = nseeds * nfills;
  if (g < total) {
    const long long s = g / nfills;
    const long long f = g - s * nfills;
    uint64_t st[25];
    absorb(st, seeds + s * 16, stream_counter(ctrs, s, (uint64_t)f));
    keccak_f1600(st);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int bit = 48 * i, m = bit >> 6, sh = bit & 63;
      uint64_t chunk = st[m] >> sh;
      if (sh > 16) chunk |= st[m + 1] << (64 - sh);
      const int pos = __popcll(chunk & 0x1FFFFFULL);
      const int neg = __popcll((chunk >> 24) & 0x1FFFFFULL);
      tile[threadIdx.x * 17 + i] = pos - neg;
    }
  }
  __syncthreads();
  // Row s, fill f starts at value 16 (s * nfills + f) = 16 g: the block's
  // values are one contiguous run.
  const long long nvals = 16 * (total - g0 < kCbdBlock ? total - g0
                                                       : (long long)kCbdBlock);
  for (int e = threadIdx.x; e < nvals; e += kCbdBlock)
    out[16 * g0 + e] = tile[(e >> 4) * 17 + (e & 15)];
}

// The ternary draw of one stream (sample_small_poly_ternary_prng_96,
// sample.c:218-242), one CTA a stream.  Replaces the JAX package's
// sample_ternary (seal_embedded_tpu/ops/sampling.py:330) with its
// _ternary_block (:309) and _rank_select (:211), which the port ran as
// 171 dependent blocks at n = 16384, each two K2 launches (the block and
// its 8 one-byte refills) and some 15 torch passes of the rank-select.
//
// The draw consumes consecutive counters c0, c0 + 1, ..., each a block's
// base (its 96 bytes) or a refill (its first byte): block k's refills are
// the counters after its base, taken in order, rejected ones included, and
// the next block's base is the first counter its refills left.  So every
// permutation the draw needs is independent of the others, and only the
// walk that decides which counter is a base is sequential.  The CTA
// squeezes a window of `window` consecutive counters at once, one thread a
// permutation in registers as keccak_1blk_kernel (the single-block roles
// ran at 0.82 of the integer bound), keeping each one's 24 words in a ring
// of window + 32 slots in shared memory; then warp 0 walks the blocks:
// lane t holds bytes 3t .. 3t + 2 of the base, three ballots rank its
// rejected bytes (>= 0xFE, within the first `here` bytes of a tail block),
// lane t reads the first byte of refill q + t, a ballot ranks the accepted
// ones (< 0xFE), and the j-th rejected byte takes the j-th accepted refill
// through `taken`, 32 refills a step until the block has them all.  The
// next base is the counter after the last refill taken.  A block starts
// only with 33 counters squeezed from its base on, a refill step only with
// 32; otherwise the walk stops (a block in the middle of its refills keeps
// its bytes in registers), the CTA squeezes the next `window` counters
// into the slots the walk has left, and the walk goes on.  So the redraw
// has no bound, as in the C loop, and no host read: one launch, capturable
// in a graph.  Nothing leaves the chip but the values and the next counter.
//
// Bound on the H100: the integer rate, for the permutations the draw
// consumes (ceil(n / 96) + n r / (1 - r) a stream expected, r = 2/256:
// about 300 at n = 16384, 512 streams 0.037 ms), against 8 bytes a value
// written.  The window computes the consumed ones and up to window minus
// them more (the wrapper sizes it at 8 sigma above the mean plus the
// walk's 32 of look-ahead), so the work is about 1.4 times the count; the
// walk's 171 steps at n = 16384, a few hundred cycles each, overlap other
// CTAs' squeezes.
constexpr int kTernaryBytes = 96;
constexpr int kTernaryLook = 32;  // refills a walk step reads

__global__ void __launch_bounds__(512)
    keccak_ternary_kernel(const long long* __restrict__ seeds,
                          const long long* __restrict__ ctrs,
                          long long* __restrict__ u_out,
                          long long* __restrict__ next_ctr, int n,
                          int window) {
  extern __shared__ uint32_t ring[];  // word k of slot i: ring[k * slots + i]
  __shared__ int taken[kTernaryBytes];
  __shared__ bool done;
  const long long s = blockIdx.x;
  const int slots = window + kTernaryLook;
  const long long* seed = seeds + s * 16;
  long long* u = u_out + s * n;
  const int nblocks = (n + kTernaryBytes - 1) / kTernaryBytes;
  const int tail = n - (nblocks - 1) * kTernaryBytes;
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x & 31;
  const unsigned below = (1u << t) - 1;

  // Offsets from c0: [0, filled) squeezed; the walk (warp 0, uniform over
  // it) is at block b whose base is at p, and in its refills (mid) at q,
  // with `got` of its `need` rejected bytes given.  Lane t's bytes v and,
  // where rejected, their ranks.
  unsigned long long filled = 0, p = 0, q = 0;
  int b = 0, need = 0, got = 0;
  bool mid = false;
  uint32_t v[3];
  int rank[3];
  for (;;) {
    for (int i = threadIdx.x; i < window; i += blockDim.x) {
      const unsigned long long off = filled + i;
      uint64_t st[25];
      absorb(st, seed, stream_counter(ctrs, s, off));
      keccak_f1600(st);
      uint32_t* w = ring + (int)(off % slots);
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        w[(2 * k) * slots] = (uint32_t)st[k];
        w[(2 * k + 1) * slots] = (uint32_t)(st[k] >> 32);
      }
    }
    filled += window;
    __syncthreads();
    if (threadIdx.x < 32) {
      for (;;) {
        const int here = b == nblocks - 1 ? tail : kTernaryBytes;
        if (!mid) {
          if (b == nblocks || filled - p < kTernaryLook + 1) break;
          const uint32_t* base = ring + (int)(p % slots);
          bool rej[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int j = 3 * t + i;
            v[i] = (base[(j >> 2) * slots] >> (8 * (j & 3))) & 0xFF;
            rej[i] = j < here && v[i] >= 0xFE;
          }
          const unsigned b0 = __ballot_sync(full, rej[0]);
          const unsigned b1 = __ballot_sync(full, rej[1]);
          const unsigned b2 = __ballot_sync(full, rej[2]);
          const int r = __popc(b0 & below) + __popc(b1 & below) +
                        __popc(b2 & below);
          rank[0] = rej[0] ? r : -1;
          rank[1] = rej[1] ? r + rej[0] : -1;
          rank[2] = rej[2] ? r + rej[0] + rej[1] : -1;
          need = __popc(b0) + __popc(b1) + __popc(b2);
          got = 0;
          q = p + 1;
          mid = need > 0;
        }
        if (mid) {
          if (filled - q < kTernaryLook) break;
          const uint32_t x = ring[(int)((q + t) % slots)] & 0xFF;
          const bool acc = x < 0xFE;
          const unsigned a = __ballot_sync(full, acc);
          const int k = got + __popc(a & below);
          if (acc && k < need) taken[k] = (int)x;
          __syncwarp();
          const int upto = min(need, got + __popc(a));
#pragma unroll
          for (int i = 0; i < 3; ++i)
            if (rank[i] >= got && rank[i] < upto) v[i] = taken[rank[i]];
          __syncwarp();
          if (upto < need) {
            got = upto;
            q += kTernaryLook;
            continue;
          }
          // The refill of rank need - 1 ends the block.
          p = q + __ffs(__ballot_sync(full, acc && k == need - 1));
          mid = false;
        } else {
          p += 1;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int j = 3 * t + i;
          if (j < here) u[b * kTernaryBytes + j] = (long long)(v[i] % 3) - 1;
        }
        ++b;
      }
      if (t == 0) done = b == nblocks;
    }
    __syncthreads();
    if (done) break;
  }
  if (threadIdx.x == 0) {
    const uint64_t next = stream_counter(ctrs, s, p);
    next_ctr[2 * s] = (long long)(uint32_t)next;
    next_ctr[2 * s + 1] = (long long)(uint32_t)(next >> 32);
  }
}

}  // namespace

// seeds (S, 16), ctrs (S, 2) int64 u32 values -> out (S * per_seed,
// out_words) int64 u32 words; stream j of seed s absorbs c_s + start + j.
// out_words = nblocks * 34, or 1..34 when nblocks == 1.
extern "C" int sek_keccak_squeeze(const void* seeds, const void* ctrs,
                                  void* out, long long nseeds, int per_seed,
                                  unsigned long long start, int nblocks,
                                  int out_words, void* stream) {
  const long long nstreams = nseeds * per_seed;
  if (nstreams <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* sd = (const long long*)seeds;
  const long long* ct = (const long long*)ctrs;
  long long* o = (long long*)out;
  if (nblocks > 1) {
    const int warps = 4;
    const long long grid = (nstreams + warps - 1) / warps;
    keccak_lanes_kernel<<<(unsigned)grid, 32 * warps, 0, st>>>(
        sd, ct, o, nseeds, per_seed, start, nblocks);
  } else {
    const int threads = 128;
    const long long grid = (nstreams + threads - 1) / threads;
    keccak_1blk_kernel<<<(unsigned)grid, threads, 0, st>>>(
        sd, ct, o, nseeds, per_seed, start, out_words);
  }
  return (int)cudaGetLastError();
}

// seeds (S, 16), ctrs (S, 2) int64 u32 values -> out (S, 16 * nfills)
// int64 CBD values in [-21, 21]; stream f of seed s absorbs c_s + f.
extern "C" int sek_keccak_cbd(const void* seeds, const void* ctrs, void* out,
                              long long nseeds, int nfills, void* stream) {
  const long long total = nseeds * nfills;
  if (total <= 0) return (int)cudaSuccess;
  const long long grid = (total + kCbdBlock - 1) / kCbdBlock;
  keccak_cbd_kernel<<<(unsigned)grid, kCbdBlock, 0, (cudaStream_t)stream>>>(
      (const long long*)seeds, (const long long*)ctrs, (long long*)out,
      nseeds, nfills);
  return (int)cudaGetLastError();
}

// The uniform draw of one limb for S streams: seeds (S, 16), ctrs (S, 2)
// and the queue (S, cap) int64 u32 values -> a (S, n) int64 in [0, q),
// next_ctr (S, 2) int64 u32 pairs, ok (S,) bool.  The queue of each warp
// lives in shared memory: 4 warps a block while 4 queues fit in 48 KiB,
// fewer above (the wrapper takes cap <= 12288, one queue in 48 KiB).
extern "C" int sek_keccak_uniform(const void* seeds, const void* ctrs,
                                  const void* queue, void* a, void* next_ctr,
                                  void* ok, long long nseeds, int n,
                                  unsigned q, unsigned r1, unsigned mm,
                                  int cap, int chunk_n, int chunk_k,
                                  void* stream) {
  if (nseeds <= 0) return (int)cudaSuccess;
  int warps = 4;
  while (warps > 1 && (size_t)warps * cap * 4 > 48 * 1024) warps /= 2;
  const size_t smem = (size_t)warps * cap * 4;
  const long long grid = (nseeds + warps - 1) / warps;
  keccak_uniform_kernel<<<(unsigned)grid, 32 * warps, smem,
                          (cudaStream_t)stream>>>(
      (const long long*)seeds, (const long long*)ctrs,
      (const long long*)queue, (long long*)a, (long long*)next_ctr,
      (bool*)ok, nseeds, n, q, r1, mm, cap, chunk_n, chunk_k);
  return (int)cudaGetLastError();
}

// The ternary draw of S streams: seeds (S, 16), ctrs (S, 2) int64 u32
// values -> u (S, n) int64 in {-1, 0, 1}, next_ctr (S, 2) int64 u32 pairs.
// One CTA of `threads` a stream, its ring of window + 32 slots of 24 words
// in dynamic shared memory (the wrapper keeps it within 48 KiB).
extern "C" int sek_keccak_ternary(const void* seeds, const void* ctrs,
                                  void* u, void* next_ctr, long long nseeds,
                                  int n, int window, int threads,
                                  void* stream) {
  if (nseeds <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(window + kTernaryLook) * 24 * 4;
  keccak_ternary_kernel<<<(unsigned)nseeds, threads, smem,
                          (cudaStream_t)stream>>>(
      (const long long*)seeds, (const long long*)ctrs, (long long*)u,
      (long long*)next_ctr, n, window);
  return (int)cudaGetLastError();
}
