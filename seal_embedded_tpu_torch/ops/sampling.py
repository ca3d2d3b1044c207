"""Bit-exact batched samplers on torch tensors.

Port of ``seal_embedded_tpu/ops/sampling.py`` (the reference's samplers,
device/lib/sample.c), with the same PRNG byte-consumption pattern:

* The uniform sampler's rejection loop draws fresh PRNG calls (counters
  c+1, c+2, ...) in order.  The j-th rejected base position ends up with
  the j-th accepted queue draw, so one batched squeeze of a bounded queue
  plus a rank-select reproduces the loop with no sequential step.
* The ternary sampler does the same per 96-byte block, with 8 one-byte
  refills; its blocks run in sequence, since each block's counter
  depends on the rejections of the blocks before it.  Its exact form
  (``sample_ternary_exact``) has the C loop's unbounded redraw.
* Counters are u64 values carried as int64 (..., 2) (lo, hi) u32 pairs,
  with the carry into hi on every offset path.

On CUDA tensors the uniform draw is one KK role a limb
(``kernels.keccak.uniform_draw``: the base squeeze, the rank-select and
``barrett32`` in one launch, after KK's queue launch), and the exact
ternary draw one KK role a call (``kernels.keccak.ternary_draw``: every
block of every stream, the redraw unbounded, in one launch).  On CPU
tensors each runs the torch path below, the role's plain version: the
rank-select in torch ops (topk, stable sort, scatter), as the JAX package
left it to XLA.  The bounded ``sample_ternary`` stays torch ops on any
device.  Every SHAKE squeeze goes through kernel KK's wrapper.  All u32
values are int64 tensors in [0, 2^32).
"""

from __future__ import annotations

import torch

from .keccak import MASK32, align_seed, words_to_bytes
from .kernels import build
from .kernels.keccak import (cbd_values, keccak_squeeze, ternary_draw,
                             uniform_draw)
from .modarith import _q, as_mod, barrett32

# One-byte refills drawn per 96-byte ternary block (sample.c:228-233):
# a block that needs more (p = 1.53e-7 a block) only clears ok, unless
# the draw is exact (sample_ternary_exact).
TERNARY_QUEUE_CAP = 8


def uniform_queue_cap(n: int, p_max: float | None = None) -> int:
    """Queue bound for degree n: E + 8*sigma + 8, rounded up to a multiple
    of 8 (p_max = worst per-word rejection probability of the chain;
    0.02 when unknown).  The bound affects only the ok flag, never the
    output values."""
    if p_max is None:
        p_max = 0.02
    e = p_max * n
    cap = e + 8.0 * (e * (1.0 - p_max)) ** 0.5 + 8.0
    return max(24, int(-(-cap // 8)) * 8)


def chain_p_max(moduli) -> float:
    """Worst per-word uniform-sampler rejection probability of a chain."""
    return max((2.0 ** 32 - float((MASK32 - (MASK32 % int(q)) - 1)))
               / 2.0 ** 32 for q in moduli)


def queue_cap_for(n: int, moduli) -> int:
    """Chain-aware uniform queue bound: 160 at n=4096 on the 30-bit chain,
    where the chain-blind uniform_queue_cap(4096) is 168.

    Where the JAX package's bound exceeds the (n / _CHUNK_N) * _CHUNK_K
    rejected positions its chunked search keeps (a chain with a high
    rejection rate at n > 4096, where the JAX function raises), the bound
    is the queue draws the C loop itself uses, E + 8*sigma + 8 with
    E = n p / (1 - p) and sigma = sqrt(n p) / (1 - p): each rejected word
    is redrawn until a draw is accepted, and those redraws are rejected at
    the same rate.  The JAX bound leaves that out, which at p = 0.125
    (q = 536903681) would clear ok on about 0.3% of the rows at n = 8192
    and 12% at 16384 (a binomial model); the bound is 1,472 and 2,768
    there, against 1,272 and 2,400."""
    p = chain_p_max(moduli)
    cap = uniform_queue_cap(n, p)
    if n <= _CHUNK_N or cap <= (n // _CHUNK_N) * _CHUNK_K:
        return cap
    e = n * p / (1.0 - p)
    draws = e + 8.0 * (n * p) ** 0.5 / (1.0 - p) + 8.0
    return int(-(-draws // 8)) * 8


def _blocks_for_bytes(nbytes: int) -> int:
    return -(-nbytes // 136)


# --------------------------------------------------------------- counters

def counter_zero(batch_shape, device=None):
    """Fresh per-stream counter pairs, value 0 (prng_randomize_reset)."""
    return torch.zeros(tuple(batch_shape) + (2,), dtype=torch.int64,
                       device=device)


def counter_from_int(batch_shape, value: int, device=None):
    """Counter pairs starting at an arbitrary u64 value (the parallel
    layout's limb i starts at i * stride)."""
    # Filled on the device: a tensor made from a Python list is a blocking
    # copy, which would stall the limb loop that calls this per limb.
    c = torch.empty(tuple(batch_shape) + (2,), dtype=torch.int64,
                    device=device)
    c[..., 0] = value & MASK32
    c[..., 1] = (value >> 32) & MASK32
    return c


def counter_overflowed(before, after):
    """True where the u64 counter wrapped between two points of a stream
    (the reference's `counter == 0` check after its increment, rng.h:85)."""
    return ((after[..., 1] < before[..., 1])
            | ((after[..., 1] == before[..., 1])
               & (after[..., 0] < before[..., 0])))


def reseed_on_overflow(seed_words, before, after, fresh_seed_words):
    """The reference's reseed on a counter wrap (rng.h:85-91), at the API
    layer: where a stream's counter wrapped, take the fresh seed words and
    reset the counter to 0.

    seed_words, fresh_seed_words: (..., 16); before, after: (..., 2).
    Returns (seed_words, counters, reseeded mask)."""
    wrapped = counter_overflowed(before, after)
    seeds = torch.where(wrapped[..., None], fresh_seed_words, seed_words)
    ctr = torch.where(wrapped[..., None], torch.zeros_like(after), after)
    return seeds, ctr, wrapped


def _c_add(c, inc):
    """c (..., 2) + inc (int or int64 tensor < 2^32), carrying into hi."""
    lo = c[..., 0] + inc
    hi = (c[..., 1] + (lo >> 32)) & MASK32
    return torch.stack([lo & MASK32, hi], dim=-1)


def _flat_streams(seed_words, counter):
    """Seeds (..., 16) aligned to counter (..., 2), flattened into kernel
    KK's (S, 16) / (S, 2) without copying when the shapes already match."""
    batch = counter.shape[:-1]
    seeds = align_seed(seed_words, counter).expand(batch + (16,))
    return (seeds.reshape(-1, 16).contiguous(),
            counter.reshape(-1, 2).contiguous())


def _squeeze(seed_words, counter, nblocks: int, nwords: int | None = None,
             per_seed: int = 1, start: int = 0):
    """SHAKE words of seeds (..., 16) with counters (..., 2): (..., words),
    or with per_seed > 1 the streams at counter + start + j, j < per_seed,
    as (..., per_seed, words)."""
    out = keccak_squeeze(*_flat_streams(seed_words, counter), nblocks,
                         nwords, per_seed, start)
    extra = (per_seed,) if per_seed > 1 else ()
    return out.reshape(counter.shape[:-1] + extra + (out.shape[-1],))


# Chunk width of the rejected-position search for wide rows (a per-chunk
# top-k and one merge sort), as in the JAX package: the ok flag of a row
# depends on it (a chunk with more than _CHUNK_K rejections fails).
_CHUNK_N = 4096
_CHUNK_K = 160


def _chunk_k(nch: int, cap: int) -> int:
    """Per-chunk bound of the rejected-position search.  Where the
    chunks' nch * _CHUNK_K positions cover the cap (every default chain)
    it is _CHUNK_K, as in the JAX package, bits and ok alike.  Above that
    (a chain with a high rejection rate, e.g. q = 536903681 at n >= 8192,
    where the JAX function raises; queue_cap_for) it is min(cap, _CHUNK_N):
    no chunk is cut before the row's cap is, and a chunk with more than
    cap rejections already fails the row through num_rejected >
    num_accepted, so the per-chunk ok adds nothing there."""
    if nch * _CHUNK_K >= cap:
        return _CHUNK_K
    return min(cap, _CHUNK_N)


def _chunk_rule(n: int, cap: int) -> tuple[int, int]:
    """(chunk width, rejections kept a chunk) of the uniform draw at degree
    n with queue bound cap, as _rejected_positions applies them: one
    chunk of n with the first min(cap, n) kept up to _CHUNK_N (where the
    per-chunk flag adds nothing: a row with more than cap rejections
    fails through the queue), _CHUNK_N and _chunk_k above.  KK's uniform
    role takes them as its chunk_n and chunk_k."""
    if n <= _CHUNK_N:
        return n, min(cap, n)
    return _CHUNK_N, _chunk_k(n // _CHUNK_N, cap)


def _rejected_positions(rejected, cap: int):
    """Positions of the first `cap` rejected entries of each row, in
    position order (n where the rank is invalid).  Returns (positions
    (..., cap), num_rejected (...,), ok (...,))."""
    n = rejected.shape[-1]
    dev = rejected.device
    num_rejected = rejected.sum(dim=-1)
    if n <= _CHUNK_N:
        k = min(cap, n)
        keys = torch.where(rejected, n - torch.arange(n, device=dev),
                           torch.zeros((), dtype=torch.int64, device=dev))
        pos = n - torch.topk(keys, k, dim=-1).values
        if k < cap:
            pos = torch.cat([pos, torch.full(pos.shape[:-1] + (cap - k,), n,
                                             dtype=torch.int64, device=dev)],
                            dim=-1)
        return pos, num_rejected, torch.ones_like(num_rejected,
                                                  dtype=torch.bool)

    nch = n // _CHUNK_N
    k = _chunk_k(nch, cap)
    rch = rejected.reshape(rejected.shape[:-1] + (nch, _CHUNK_N))
    ok = (rch.sum(dim=-1) <= k).all(dim=-1)
    span = torch.arange(_CHUNK_N, device=dev)
    keys = torch.where(rch, _CHUNK_N - span,
                       torch.zeros((), dtype=torch.int64, device=dev))
    lpos = _CHUNK_N - torch.topk(keys, k, dim=-1).values
    cidx = torch.arange(nch, device=dev)[:, None]
    gpos = torch.where(lpos == _CHUNK_N, n, lpos + cidx * _CHUNK_N)
    flat = gpos.reshape(gpos.shape[:-2] + (nch * k,))
    return torch.sort(flat, dim=-1).values[..., :cap], num_rejected, ok


def _rank_select(base_vals, rejected, queue_vals, queue_acc):
    """Queue equivalence core: the (r+1)-th rejected base position takes
    the (r+1)-th accepted queue value.

    base_vals: (..., n) initial draws; rejected: their rejection mask;
    queue_vals / queue_acc: (..., cap) extra draws and their acceptance.
    Returns (final values, queue slots consumed, ok).
    """
    cap = queue_vals.shape[-1]
    n = base_vals.shape[-1]

    qrank = torch.cumsum(queue_acc.to(torch.int64), dim=-1)
    num_accepted = qrank[..., -1]
    # Accepted values first, in queue order (stable sort on rejection).
    order = torch.sort((~queue_acc).to(torch.int64), dim=-1,
                       stable=True).indices
    accepted_vals = torch.gather(queue_vals, -1, order)

    rej_pos, num_rejected, ok_pos = _rejected_positions(rejected, cap)
    # Invalid ranks point at column n: scatter into n + 1 columns and drop
    # the last (the JAX scatter's mode="drop").
    ext = torch.cat([base_vals, torch.zeros_like(base_vals[..., :1])], dim=-1)
    final = ext.scatter(-1, rej_pos, accepted_vals)[..., :n]

    # Slots consumed = queue position of the last needed accepted entry + 1.
    before_last = (qrank < num_rejected[..., None]).sum(dim=-1)
    consumed = torch.where(num_rejected > 0, before_last + 1,
                           torch.zeros_like(before_last))
    ok = (num_rejected <= num_accepted) & ok_pos
    return final, consumed, ok


def uniform_plain(seeds, counters, queue, n: int, q):
    """The plain version of KK's uniform role (kernels.keccak.uniform_draw)
    in torch passes: the base squeeze, the rank-select against the queue
    and barrett32.  seeds (S, 16), counters (S, 2), queue (S, cap) int64
    u32 words (draw j at counters + 1 + j).  Returns (a int64 (S, n) in
    [0, q), next counters (S, 2), ok (S,))."""
    m = as_mod(q)
    base = keccak_squeeze(seeds, counters, _blocks_for_bytes(4 * n))[:, :n]
    final, consumed, ok = _rank_select(base, base >= m.max_multiple, queue,
                                       queue < m.max_multiple)
    return barrett32(final, m), _c_add(counters, 1 + consumed), ok


def sample_uniform(seed_words, counter, n: int, q,
                   queue_cap: int | None = None):
    """sample_poly_uniform (sample.c:39-57), batched.

    seed_words: int64 (..., 16); counter: int64 (..., 2) u64 pair per
    stream; q: int modulus.  Returns (poly int64 (..., n) in [0, q),
    next_counter, ok).  KK's queue launch draws the one-block queue at
    c+1 .. c+cap; then on CUDA tensors KK's uniform role
    (kernels.keccak.uniform_draw), on CPU tensors its plain version.
    """
    m = as_mod(q)
    cap = queue_cap if queue_cap is not None else uniform_queue_cap(n)
    seeds, ctrs = _flat_streams(seed_words, counter)
    queue = keccak_squeeze(seeds, ctrs, 1, 1, cap, 1).reshape(-1, cap)
    if build.on_cpu("sample_uniform", seeds, ctrs):
        poly, nxt, ok = uniform_plain(seeds, ctrs, queue, n, m)
    else:
        poly, nxt, ok = uniform_draw(seeds, ctrs, queue, n, int(m.q),
                                     int(m.r1), int(m.max_multiple),
                                     *_chunk_rule(n, cap))
    batch = counter.shape[:-1]
    return (poly.reshape(batch + (n,)), nxt.reshape(batch + (2,)),
            ok.reshape(batch))


def sample_uniform_limbs(seed_words, moduli, n: int,
                         queue_cap: int | None = None,
                         counter_stride: int | None = None, first: int = 0):
    """One uniform polynomial per modulus, in the order of `moduli`.

    With counter_stride None the stream's counter chains from limb to limb
    (the reference, seal_embedded.c:145-213); otherwise limb i starts at
    counter (first + i) * counter_stride (the "parallel" layout; `first`
    is the chain index of moduli[0] when they are a part of the chain).
    seed_words: int64 (B, 16).  Returns (a int64 (L, B, n), ok (B,))."""
    B = seed_words.shape[0]
    dev = seed_words.device
    counter = counter_zero((B,), dev)
    ok = torch.ones((B,), dtype=torch.bool, device=dev)
    a = []
    for i, q in enumerate(moduli):
        if counter_stride is not None:
            counter = counter_from_int((B,), (first + i) * counter_stride,
                                       dev)
        a_l, counter, ok_u = sample_uniform(seed_words, counter, n, q,
                                            queue_cap=queue_cap)
        a.append(a_l)
        ok = ok & ok_u
    return torch.stack(a), ok


def _ternary_block(seed_words, counter, count_here: int,
                   cap: int | None = None):
    """One 96-byte ternary block + its rejection queue (sample.c:223-241):
    bytes >= 0xFE are redrawn from `cap` one-byte refills at counters
    c+1, c+2, ... (TERNARY_QUEUE_CAP when None).  Returns ({-1, 0, 1}
    int64 (..., 96), next_counter, ok)."""
    dev = counter.device
    base_bytes = words_to_bytes(_squeeze(seed_words, counter, 1, nwords=24))
    rejected = base_bytes >= 0xFE

    cap = cap or TERNARY_QUEUE_CAP
    # The first byte of each refill, (..., cap) (a cap of 1 included).
    qvals = _squeeze(seed_words, counter, 1, nwords=1, per_seed=cap,
                     start=1).reshape(counter.shape[:-1] + (cap,)) & 0xFF
    qacc = qvals < 0xFE

    # The reference touches only the first count_here bytes of a tail block
    # (sample.c:228), so later rejections consume nothing.
    if count_here < 96:
        rejected = rejected & (torch.arange(96, device=dev) < count_here)
    final, consumed, ok = _rank_select(base_bytes, rejected, qvals, qacc)
    return final % 3 - 1, _c_add(counter, 1 + consumed), ok


def _block_sizes(n: int) -> list[int]:
    """The ternary draw's blocks: n // 96 of 96 bytes, then n % 96."""
    nfull, tail = divmod(n, 96)
    return [96] * nfull + ([tail] if tail else [])


def sample_ternary(seed_words, counter, n: int):
    """sample_small_poly_ternary_prng_96 (sample.c:218-242), batched.

    n // 96 full blocks in sequence (each block's counter depends on the
    previous block's rejections), then a tail block of n % 96 bytes.
    Returns (signed {-1, 0, 1} int64 (..., n), next_counter, ok).
    """
    ok = torch.ones(counter.shape[:-1], dtype=torch.bool, device=counter.device)
    blocks = []
    for count_here in _block_sizes(n):
        vals, counter, ok_b = _ternary_block(seed_words, counter, count_here)
        blocks.append(vals[..., :count_here])
        ok = ok & ok_b
    return torch.cat(blocks, dim=-1), counter, ok


def sample_ternary_exact(seed_words, counter, n: int):
    """sample_ternary with the C loop's unbounded redraw, for B streams:
    seed_words (B, 16), counter (B, 2).  Returns (signed {-1, 0, 1} int64
    (B, n), next_counter), every stream drawn whole.

    On CUDA tensors it is KK's ternary role (kernels.keccak.ternary_draw),
    one launch with no host read.  On CPU tensors it runs the role's plain
    version, the loop below: a block whose TERNARY_QUEUE_CAP refills hold
    fewer accepted bytes than it rejected is drawn again, for those
    streams, with twice the refills, until every stream's block is whole;
    a block the cap held keeps its bits.  The host reads each block's
    flags."""
    seeds, ctrs = _flat_streams(seed_words, counter)
    if not build.on_cpu("sample_ternary_exact", seeds, ctrs):
        return ternary_draw(seeds, ctrs, n)
    blocks = []
    for count_here in _block_sizes(n):
        vals, after, ok = _ternary_block(seed_words, counter, count_here)
        cap = TERNARY_QUEUE_CAP
        while not bool(ok.all()):
            cap *= 2
            short = (~ok).nonzero()[:, 0]
            v, a, o = _ternary_block(seed_words[short], counter[short],
                                     count_here, cap)
            vals[short], after[short], ok[short] = v, a, o
        blocks.append(vals[..., :count_here])
        counter = after
    return torch.cat(blocks, dim=-1), counter


def ternary_to_modq_any(signed, q):
    """{-1, 0, 1} -> {q-1, 0, 1} (sample.c:98-111) for an int, a Mod, or
    an int64 tensor of moduli that broadcasts against `signed`.  Any small
    signed value x (CBD's [-63, 63] included) maps the same way, to x + q
    where x < 0."""
    return torch.where(signed < 0, signed + _q(q), signed)


ternary_to_modq = ternary_to_modq_any


def sample_cbd(seed_words, counter, n: int):
    """sample_poly_cbd_generic_prng_16 (sample.c:311-321), batched.

    n/16 fills of 96 bytes each at counters counter, counter + 1, ...,
    through KK's CBD role (its plain version is ``ops.keccak.cbd_values``).
    Returns (err int64 (..., n) in [-21, 21], next_counter).
    """
    err = cbd_values(*_flat_streams(seed_words, counter), n)
    return (err.reshape(counter.shape[:-1] + (n,)),
            _c_add(counter, -(-n // 16)))
