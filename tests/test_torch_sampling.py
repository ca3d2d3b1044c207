"""Port's samplers vs seal_embedded_tpu.ops.sampling: values, next
counters and ok flags, bit for bit, on the same numpy-made seeds and
counters (including counters about to carry across 2^32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.config import PRIMES_27BIT, PRIMES_30BIT
from seal_embedded_tpu.ops import sampling as jsp
from seal_embedded_tpu_torch.ops import keccak as tkc
from seal_embedded_tpu_torch.ops import sampling as tsp
from uniform_walk import kernel_walk

torch.set_num_threads(2)


def _seeds_counters(rng, B):
    seeds = rng.integers(0, 2 ** 32, (B, 16), dtype=np.int64)
    ctr = rng.integers(0, 2 ** 32, (B, 2), dtype=np.int64)
    ctr[0] = [2 ** 32 - 3, 5]              # the base draw's queue carries
    ctr[-1] = [2 ** 32 - 1, 2 ** 32 - 1]   # u64 wrap
    return seeds, ctr


def _j(a):
    return jnp.asarray(a.astype(np.uint32))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("n,q", [(1024, PRIMES_27BIT[0]),
                                 (4096, PRIMES_30BIT[0]),
                                 (8192, PRIMES_30BIT[3]),
                                 (16384, PRIMES_30BIT[12])])
def test_sample_uniform_vs_jax(n, q):
    """n = 8192 and 16384 run the chunked top-k of _rejected_positions."""
    seeds, ctr = _seeds_counters(np.random.default_rng(n), 2)
    cap = jsp.queue_cap_for(n, (q,))
    wpoly, wnext, wok = jax.jit(
        lambda s, c: jsp.sample_uniform(s, c, n, q, queue_cap=cap))(
            _j(seeds), _j(ctr))
    poly, nxt, ok = tsp.sample_uniform(torch.as_tensor(seeds),
                                       torch.as_tensor(ctr), n, q,
                                       queue_cap=cap)
    assert np.array_equal(poly.numpy(), _np(wpoly))
    assert np.array_equal(nxt.numpy(), _np(wnext))
    assert np.array_equal(ok.numpy(), np.asarray(wok))
    assert ok.all()


Q_HIGH = 536903681                     # rejects 12.5% of the words


@pytest.mark.parametrize("n,q,cap,ok", [
    (4096, PRIMES_30BIT[0], 160, [True] * 3),
    (16384, PRIMES_30BIT[12], 456, [True] * 3),
    (4096, PRIMES_30BIT[1], 8, [False] * 3),     # the queue falls short
    (8192, Q_HIGH, 300, [False] * 3),            # > 160 in a chunk
])
def test_sample_uniform_edges_vs_jax(n, q, cap, ok):
    """Counters at 2^32 - 1 and 2^64 - 1 (the next counter carries and
    wraps), and rows whose ok is false: ranks past the accepted count take
    the rejected queue values, consumed is cap + 1, and at n = 8192 on a
    prime near 2^29 every chunk holds more than its 160 kept rejections."""
    seeds, ctr = _seeds_counters(np.random.default_rng(n + cap), 3)
    ctr[0] = [2 ** 32 - 1, 0]
    wpoly, wnext, wok = jax.jit(
        lambda s, c: jsp.sample_uniform(s, c, n, q, queue_cap=cap))(
            _j(seeds), _j(ctr))
    poly, nxt, got_ok = tsp.sample_uniform(torch.as_tensor(seeds),
                                           torch.as_tensor(ctr), n, q,
                                           queue_cap=cap)
    assert np.array_equal(poly.numpy(), _np(wpoly))
    assert np.array_equal(nxt.numpy(), _np(wnext))
    assert np.array_equal(got_ok.numpy(), np.asarray(wok))
    assert got_ok.tolist() == ok
    assert nxt[0, 1] == 1 and nxt[-1, 1] == 0
    if not ok[0]:      # consumed cap + 1: 2^32 - 1 and 2^64 - 1, + cap + 2
        assert nxt[0].tolist() == [cap + 1, 1]
        assert nxt[-1].tolist() == [cap + 1, 0]


def _walk_case(n, p, cap, acc_p, seed):
    """Synthetic base words, rejection masks (rate p) and a queue
    (accepted at rate acc_p) of 4 rows: one with no rejection, one with
    the first 200 words rejected, two at random."""
    rng = np.random.default_rng(seed)
    rejected = rng.random((4, n)) < p
    rejected[0] = False
    rejected[1, :200] = True
    base = rng.integers(0, 2 ** 32, (4, n), dtype=np.int64)
    qvals = rng.integers(0, 2 ** 32, (4, cap), dtype=np.int64)
    qacc = rng.random((4, cap)) < acc_p
    return base, rejected, qvals, qacc


@pytest.mark.parametrize("n,p,cap,acc_p", [
    (64, 0.2, 24, 0.9), (1024, 0.02, 40, 0.97), (4096, 0.03, 168, 0.97),
    (4096, 0.05, 168, 0.5), (8192, 0.03, 168, 0.97), (8192, 0.05, 168, 0.97),
    (8192, 0.02, 1472, 0.9), (16384, 0.02, 456, 0.97),
    (16384, 0.13, 2768, 0.9)])
def test_kernel_walk_vs_rank_select(n, p, cap, acc_p):
    """The uniform role's walk (tests/uniform_walk.py) under the chunk
    rule it is launched with (_chunk_rule) gives the rank-select's final
    values, consumed counts and ok: chunks past 160 (p = 0.05 over 4096
    words), queues that fall short (acc_p = 0.5), wide caps."""
    base, rejected, qvals, qacc = _walk_case(n, p, cap, acc_p,
                                             n + int(100 * p) + cap)
    want = tsp._rank_select(*map(torch.as_tensor,
                                 (base, rejected, qvals, qacc)))
    got = kernel_walk(base, rejected, qvals, qacc, *tsp._chunk_rule(n, cap))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("n,cap,rule", [
    (1024, 40, (1024, 40)), (4096, 160, (4096, 160)), (64, 160, (64, 64)),
    (8192, 320, (4096, 160)), (16384, 456, (4096, 160)),
    (8192, 1472, (4096, 1472)), (16384, 2768, (4096, 2768)),
    (16384, 5000, (4096, 4096))])
def test_chunk_rule(n, cap, rule):
    """The chunk width and kept rejections the role is launched with."""
    assert tsp._chunk_rule(n, cap) == rule


def test_sample_cbd_vs_jax():
    n = 1024
    seeds, ctr = _seeds_counters(np.random.default_rng(11), 3)
    werr, wnext = jsp.sample_cbd(_j(seeds), _j(ctr), n)
    err, nxt = tsp.sample_cbd(torch.as_tensor(seeds), torch.as_tensor(ctr), n)
    assert np.array_equal(err.numpy(), _np(werr))
    assert np.array_equal(nxt.numpy(), _np(wnext))
    assert err.abs().max() <= 63


@pytest.mark.parametrize("n", [1024, 4096])
def test_cbd_values_role_vs_jax(n):
    """sample_cbd through KK's CBD-values wrapper (its plain version here),
    and the wrapper called directly, against the JAX sample_cbd, with
    counters at 2^32 - 1 and 2^64 - 1 so the fill counters carry."""
    from seal_embedded_tpu_torch.ops.kernels.keccak import cbd_values

    seeds, ctr = _seeds_counters(np.random.default_rng(n + 1), 4)
    ctr[1] = [2 ** 32 - 1, 0]
    werr, wnext = jsp.sample_cbd(_j(seeds), _j(ctr), n)
    s, c = torch.as_tensor(seeds), torch.as_tensor(ctr)
    err, nxt = tsp.sample_cbd(s, c, n)
    assert np.array_equal(err.numpy(), _np(werr))
    assert np.array_equal(nxt.numpy(), _np(wnext))
    assert torch.equal(cbd_values(s, c, n), err)
    assert nxt[-1, 1] == 0 and nxt[1, 1] == 1


def test_counter_offsets_carry_vs_jax():
    rng = np.random.default_rng(2)
    ctr = rng.integers(0, 2 ** 32, (4, 2), dtype=np.int64)
    ctr[0] = [2 ** 32 - 2, 0]
    ctr[1] = [2 ** 32 - 1, 2 ** 32 - 1]
    offs = np.arange(5, dtype=np.int64)
    inc = np.array([1, 2, 3, 2 ** 32 - 1], dtype=np.int64)
    assert np.array_equal(
        tkc.counter_offsets(torch.as_tensor(ctr),
                            torch.as_tensor(offs)).numpy(),
        _np(jsp._c_offsets(_j(ctr), _j(offs))))
    assert np.array_equal(
        tsp._c_add(torch.as_tensor(ctr), torch.as_tensor(inc)).numpy(),
        _np(jsp._c_add(_j(ctr), _j(inc))))


@pytest.mark.parametrize("n,p", [(4096, 0.03), (8192, 0.03), (8192, 0.05)])
def test_rejected_positions_and_rank_select_vs_jax(n, p):
    """Crafted rejection masks, including chunks with more than 160
    rejections (p = 0.05 over 4096 lanes): positions, counts, ok flags and
    the rank-select's final values and consumed counts."""
    rng = np.random.default_rng(int(p * 100) + n)
    B, cap = 3, 168
    rejected = rng.random((B, n)) < p
    rejected[0] = False
    base = rng.integers(0, 2 ** 32, (B, n), dtype=np.int64)
    qvals = rng.integers(0, 2 ** 32, (B, cap), dtype=np.int64)
    qacc = rng.random((B, cap)) < 0.97

    wpos, wnum, wok = jsp._rejected_positions(jnp.asarray(rejected), cap)
    pos, num, ok = tsp._rejected_positions(torch.as_tensor(rejected), cap)
    assert np.array_equal(pos.numpy(), _np(wpos))
    assert np.array_equal(num.numpy(), _np(wnum))
    assert np.array_equal(ok.numpy(), np.asarray(wok))

    wfinal, wcons, wok2 = jsp._rank_select(_j(base), jnp.asarray(rejected),
                                           _j(qvals), jnp.asarray(qacc))
    final, cons, ok2 = tsp._rank_select(
        torch.as_tensor(base), torch.as_tensor(rejected),
        torch.as_tensor(qvals), torch.as_tensor(qacc))
    assert np.array_equal(final.numpy(), _np(wfinal))
    assert np.array_equal(cons.numpy(), _np(wcons))
    assert np.array_equal(ok2.numpy(), np.asarray(wok2))


def test_queue_caps_equal_jax():
    for n in (1024, 2048, 4096, 8192, 16384):
        assert tsp.uniform_queue_cap(n) == jsp.uniform_queue_cap(n)
        for chain in (PRIMES_27BIT[:1], PRIMES_30BIT[:3], PRIMES_30BIT):
            assert tsp.queue_cap_for(n, chain) == jsp.queue_cap_for(n, chain)
    assert tsp.queue_cap_for(4096, PRIMES_30BIT[:3]) == 160


def _ternary_state(n_streams, seed):
    """Seeds and counters for the ternary sampler, with a counter whose
    queue offsets carry into hi (2^32 - 3) and one that wraps at 2^64."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 32, (n_streams, 16), dtype=np.int64)
    ctr = rng.integers(0, 2 ** 32, (n_streams, 2), dtype=np.int64)
    ctr[0] = [2 ** 32 - 3, 7]
    ctr[1] = [2 ** 32 - 2, 2 ** 32 - 1]
    return seeds, ctr


@pytest.mark.parametrize("n", [384, 1024])
def test_sample_ternary_vs_jax(n):
    """n = 384: four full blocks; n = 1024: ten blocks and a tail of 64."""
    seeds, ctr = _ternary_state(3, n)
    wvals, wnext, wok = jax.jit(
        lambda s, c: jsp.sample_ternary(s, c, n))(_j(seeds), _j(ctr))
    vals, nxt, ok = tsp.sample_ternary(torch.as_tensor(seeds),
                                       torch.as_tensor(ctr), n)
    assert vals.shape == (3, n)
    assert np.array_equal(vals.numpy(), _np(wvals))
    assert np.array_equal(nxt.numpy(), _np(wnext))
    assert np.array_equal(ok.numpy(), np.asarray(wok))
    assert ok.all() and set(np.unique(vals.numpy())) == {-1, 0, 1}
    # Every block consumed at least its own draw, and row 1 wrapped.
    blocks = -(-n // 96)
    assert nxt[1, 1] == 0 and nxt[1, 0] >= blocks - 2


@pytest.mark.parametrize("count_here", [96, 64, 32])
def test_ternary_block_vs_jax(count_here):
    """One block, with rejected bytes past count_here in some row, which
    a tail block must leave unreplaced and unconsumed."""
    seeds, ctr = _ternary_state(16, count_here)
    by = tkc.words_to_bytes(tsp._squeeze(torch.as_tensor(seeds),
                                         torch.as_tensor(ctr), 1, nwords=24))
    assert bool((by[:, 32:] >= 0xFE).any())
    wvals, wnext, wok = jsp._ternary_block(_j(seeds), _j(ctr), count_here)
    vals, nxt, ok = tsp._ternary_block(torch.as_tensor(seeds),
                                       torch.as_tensor(ctr), count_here)
    assert np.array_equal(vals.numpy(), _np(wvals))
    assert np.array_equal(nxt.numpy(), _np(wnext))
    assert np.array_equal(ok.numpy(), np.asarray(wok))


def test_ternary_to_modq_vs_jax():
    rng = np.random.default_rng(3)
    signed = rng.integers(-1, 2, (2, 64))
    q = int(PRIMES_30BIT[0])
    want = _np(jsp.ternary_to_modq(jnp.asarray(signed.astype(np.int32)), q))
    assert np.array_equal(tsp.ternary_to_modq(torch.as_tensor(signed), q)
                          .numpy(), want)
    qs = np.array(PRIMES_30BIT[:3], dtype=np.int64)[:, None, None]
    want = _np(jsp.ternary_to_modq_any(jnp.asarray(signed.astype(np.int32)),
                                       jnp.asarray(qs.astype(np.uint32))))
    got = tsp.ternary_to_modq_any(torch.as_tensor(signed)[None],
                                  torch.as_tensor(qs))
    assert got.shape == (3, 2, 64) and np.array_equal(got.numpy(), want)


def test_reseed_on_overflow_vs_jax():
    """The reseed on a u64 counter wrap (rng.h:85-91), after
    tests/test_ops.py's case: a wrapped stream takes the fresh seed words
    and counter 0, the others are untouched; the same as the JAX one."""
    before = np.array([[0xFFFFFFFF, 0xFFFFFFFF], [5, 0], [7, 3], [9, 3]])
    after = np.array([[2, 0], [9, 0], [7, 2], [1, 3]])
    seeds = np.arange(64).reshape(4, 16)
    fresh = np.full((4, 16), 77)
    want = jsp.reseed_on_overflow(_j(seeds), _j(before), _j(after),
                                  _j(fresh))
    got = tsp.reseed_on_overflow(*(torch.as_tensor(a) for a in (
        seeds, before, after, fresh)))
    assert got[2].tolist() == [True, False, True, True]
    assert tsp.counter_overflowed(torch.as_tensor(before),
                                  torch.as_tensor(after)).tolist() == \
        np.asarray(jsp.counter_overflowed(_j(before), _j(after))).tolist()
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    assert got[0][0].tolist() == [77] * 16 and got[1][0].tolist() == [0, 0]
    assert got[0][1].tolist() == list(range(16, 32))


@pytest.mark.parametrize("value", [(7 << 32) | 5, 2 ** 32 - 1, 2 ** 64 - 1,
                                   3 * (1 << 20)])
def test_counter_from_int_vs_jax(value):
    """u64 starting counters, and an offset carried across 2^32, after
    tests/test_ops.py's case."""
    got = tsp.counter_from_int((3,), value)
    assert got.shape == (3, 2) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(),
                          _np(jsp.counter_from_int((3,), value)))
    assert np.array_equal(tsp._c_add(got, 0xFFFFFFFB).numpy(),
                          _np(jsp._c_add(jsp.counter_from_int((3,), value),
                                         jnp.uint32(0xFFFFFFFB))))


def test_uniform_limbs_first_limb_index():
    """Limb i of a sub-chain starting at chain index `first` draws from
    counter (first + i) * stride: the tail of the whole chain's draws."""
    moduli = PRIMES_27BIT[:3]
    seeds = torch.as_tensor(np.random.default_rng(5).integers(
        0, 2 ** 32, (2, 16)))
    whole, ok = tsp.sample_uniform_limbs(seeds, moduli, 256, 40, 1 << 20)
    tail, ok_t = tsp.sample_uniform_limbs(seeds, moduli[1:], 256, 40,
                                          1 << 20, first=1)
    assert torch.equal(tail, whole[1:]) and bool(ok.all() and ok_t.all())
