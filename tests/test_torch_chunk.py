"""The uniform sampler's chunk rule for wide rows (n > 4096) on every prime
chain that Parms accepts.

On the default chains the port's queue bound and rejected-position search
are held bit for bit (positions, num_rejected, ok) against the JAX
package's.  On a chain
with a high rejection rate (q = 536903681 = 2^29 + 2^15 + 1, about 12.5%
of the words rejected) the JAX function raises, so the oracle there is
the C loop (seal_embedded_tpu/golden): the sampler, a symmetric encrypt,
the public key, an asymmetric encrypt under it and the per-prime stream,
all bit for bit."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.golden import ckks as gckks
from seal_embedded_tpu.golden.prng import Prng
from seal_embedded_tpu.golden.sampling import sample_poly_uniform
from seal_embedded_tpu.ops import sampling as jsp
from seal_embedded_tpu_torch.ckks.asym import AsymEncryptor, gen_pk_batch
from seal_embedded_tpu_torch.ckks.stream import sym_encrypt_stream
from seal_embedded_tpu_torch.ckks.sym import sym_encrypt_batch
from seal_embedded_tpu_torch.config import PRIMES_30BIT, Parms, default_parms
from seal_embedded_tpu_torch.convert import (asym_state_to_device,
                                             state_to_device)
from seal_embedded_tpu_torch.io.serialize import pack_ternary
from seal_embedded_tpu_torch.ops import sampling as tsp
from uniform_walk import kernel_walk

torch.set_num_threads(2)

Q_HIGH = 536903681                     # rejection rate 0.125
CHAIN = (Q_HIGH, PRIMES_30BIT[0], PRIMES_30BIT[1])


def _seed_bytes(words) -> bytes:
    return np.asarray(words, dtype="<u4").tobytes()


def _u64(pair) -> int:
    return int(pair[0]) | (int(pair[1]) << 32)


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_sample_uniform_high_rejection_vs_c_loop(n):
    """Values, next counters and ok against the C loop from the same seed
    and counter (one counter about to carry across 2^32)."""
    rng = np.random.default_rng(n + 5)
    seeds = rng.integers(0, 2 ** 32, (2, 16), dtype=np.int64)
    ctr = rng.integers(0, 2 ** 32, (2, 2), dtype=np.int64)
    ctr[1] = [2 ** 32 - 40, 3]
    cap = tsp.queue_cap_for(n, (Q_HIGH,))
    assert cap > (n // 4096) * 160
    poly, nxt, ok = tsp.sample_uniform(torch.as_tensor(seeds),
                                       torch.as_tensor(ctr), n, Q_HIGH,
                                       queue_cap=cap)
    assert ok.all()
    for b in range(2):
        prng = Prng(_seed_bytes(seeds[b]), _u64(ctr[b]))
        want = sample_poly_uniform(n, Q_HIGH, prng)
        assert np.array_equal(poly[b].numpy(), np.asarray(want)), b
        assert _u64(nxt[b]) == prng.counter, b
        # the row drew several hundred redraws: far past 160 a chunk
        assert prng.counter - _u64(ctr[b]) > (n // 4096) * 160


def test_queue_cap_rule():
    """Every default chain keeps the JAX package's bound; on the high
    rejection chain the bound covers the queue's own rejections (8 sigma
    of the redraws the C loop uses), past the chunks' 160 each."""
    for n in (1024, 2048, 4096, 8192, 16384):
        for nprimes in range(1, 14):
            try:
                chain = default_parms(n, nprimes).moduli
            except AssertionError:
                continue
            assert tsp.queue_cap_for(n, chain) == jsp.queue_cap_for(n, chain)
    assert tsp.queue_cap_for(4096, CHAIN) == jsp.queue_cap_for(4096, CHAIN)
    p = tsp.chain_p_max(CHAIN)
    for n, want in ((8192, 1472), (16384, 2768)):
        cap = tsp.queue_cap_for(n, CHAIN)
        assert cap == want and cap > (n // 4096) * 160
        margin = cap * (1 - p) - n * p
        assert margin >= 8 * (n * p * (1 - p) + cap * p * (1 - p)) ** 0.5


def test_sample_uniform_row_past_the_jax_bound():
    """Seeded so that row 1 rejects 2,078 base words while the first 2,400
    queue draws (the JAX package's bound at n = 16384) accept only 2,076:
    that bound clears ok, the port's covers the row as the C loop does."""
    n = 16384
    rng = np.random.default_rng(16393)
    seeds = rng.integers(0, 2 ** 32, (2, 16), dtype=np.int64)
    ctr = rng.integers(0, 2 ** 32, (2, 2), dtype=np.int64)
    s, c = torch.as_tensor(seeds), torch.as_tensor(ctr)
    jax_cap = tsp.uniform_queue_cap(n, tsp.chain_p_max(CHAIN))
    _, _, ok = tsp.sample_uniform(s, c, n, Q_HIGH, queue_cap=jax_cap)
    assert ok.tolist() == [True, False]
    poly, nxt, ok = tsp.sample_uniform(s, c, n, Q_HIGH,
                                       queue_cap=tsp.queue_cap_for(n, CHAIN))
    assert ok.all()
    for b in range(2):
        prng = Prng(_seed_bytes(seeds[b]), _u64(ctr[b]))
        assert np.array_equal(poly[b].numpy(),
                              np.asarray(sample_poly_uniform(n, Q_HIGH, prng)))
        assert _u64(nxt[b]) == prng.counter


def _masks(n, rng):
    """Rejection masks of a default chain's rows: typical (2% rejected),
    none, 160 in one chunk (ok), 161 in one chunk (ok False), every chunk
    full at 160, and 161 at the last chunk's end."""
    nch = n // 4096
    rows = [rng.random(n) < 0.02, np.zeros(n, bool)]
    for count, chunk in ((160, 0), (161, nch - 1)):
        m = np.zeros(n, bool)
        m[chunk * 4096 + rng.choice(4096, count, replace=False)] = True
        rows.append(m)
    full = np.zeros(n, bool)
    for c in range(nch):
        full[c * 4096 + rng.choice(4096, 160, replace=False)] = True
    tail = np.zeros(n, bool)
    tail[n - 161:] = True
    return np.stack(rows + [full, tail])


@pytest.mark.parametrize("n,nprimes", [(8192, 6), (16384, 13)])
def test_rejected_positions_default_chain_vs_jax(n, nprimes):
    """Where the chunks cover the cap, positions, num_rejected and ok are
    the JAX function's, the 161-in-a-chunk row failing in both."""
    cap = tsp.queue_cap_for(n, PRIMES_30BIT[:nprimes])
    assert cap <= (n // 4096) * 160
    masks = _masks(n, np.random.default_rng(n))
    got = tsp._rejected_positions(torch.as_tensor(masks), cap)
    want = jsp._rejected_positions(jnp.asarray(masks), cap)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    ok = got[2].numpy()
    assert ok.tolist() == [True, True, True, False, True, False]


@pytest.mark.parametrize("n", [8192, 16384])
def test_rejected_positions_wide_cap(n):
    """Where the cap exceeds the chunks' 160 each, a chunk with 1,000 or
    more rejections still gives the row's first `cap` positions; a chunk
    with more than cap clears ok, as the row's queue cannot fill it."""
    cap = tsp.queue_cap_for(n, (Q_HIGH,))
    rng = np.random.default_rng(n + 1)
    rows = []
    for dense in (1000, cap - 50, cap + 30):
        m = rng.random(n) < 0.01
        m[4096 + rng.choice(4096, dense, replace=False)] = True
        rows.append(m)
    masks = np.stack(rows)
    pos, num, ok = tsp._rejected_positions(torch.as_tensor(masks), cap)
    for r, m in enumerate(masks):
        want = np.flatnonzero(m)[:cap]
        want = np.concatenate([want, np.full(cap - want.size, n)])
        assert np.array_equal(pos[r].numpy(), want), r
        assert num[r] == m.sum()
    assert ok.tolist() == [True, True, False]


@pytest.mark.parametrize("n,nprimes", [(8192, 6), (16384, 13)])
def test_kernel_walk_default_chain_masks(n, nprimes):
    """The uniform role's walk (tests/uniform_walk.py) on _masks' rows
    (160 in a chunk, 161 in the last chunk, every chunk full, 161 at the
    row's end) gives the rank-select's values, consumed counts and ok."""
    cap = tsp.queue_cap_for(n, PRIMES_30BIT[:nprimes])
    rng = np.random.default_rng(n + nprimes)
    masks = _masks(n, rng)
    base = rng.integers(0, 2 ** 32, masks.shape, dtype=np.int64)
    qvals = rng.integers(0, 2 ** 32, (masks.shape[0], cap), dtype=np.int64)
    qacc = rng.random(qvals.shape) < 0.98
    want = tsp._rank_select(*map(torch.as_tensor,
                                 (base, masks, qvals, qacc)))
    got = kernel_walk(base, masks, qvals, qacc, *tsp._chunk_rule(n, cap))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert got[2].tolist() == [True, True, True, False, False, False]


@pytest.mark.parametrize("n", [8192, 16384])
def test_kernel_walk_wide_cap(n):
    """The walk at chain C's caps, a chunk holding 1,000, cap - 50 and
    cap + 30 rejections: the rank-select's values, consumed and ok."""
    cap = tsp.queue_cap_for(n, (Q_HIGH,))
    rng = np.random.default_rng(n + 2)
    rows = []
    for dense in (1000, cap - 50, cap + 30):
        m = rng.random(n) < 0.01
        m[4096 + rng.choice(4096, dense, replace=False)] = True
        rows.append(m)
    masks = np.stack(rows)
    base = rng.integers(0, 2 ** 32, masks.shape, dtype=np.int64)
    qvals = rng.integers(0, 2 ** 32, (3, cap), dtype=np.int64)
    qacc = rng.random(qvals.shape) < 0.9
    want = tsp._rank_select(*map(torch.as_tensor,
                                 (base, masks, qvals, qacc)))
    got = kernel_walk(base, masks, qvals, qacc, *tsp._chunk_rule(n, cap))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("n", [8192, 16384])
def test_sample_uniform_chunk_overflow_vs_jax(n):
    """On the high-rejection prime with the default chains' bound (cap
    within the chunks' 160 each, where the JAX function runs), every
    chunk rejects far more than 160 words: values, next counters and ok
    (false) equal to the JAX sample_uniform's, counters at 2^32 - 1 and
    2^64 - 1."""
    cap = tsp.queue_cap_for(n, PRIMES_30BIT[:13])
    assert cap <= (n // 4096) * 160
    rng = np.random.default_rng(n + 7)
    seeds = rng.integers(0, 2 ** 32, (3, 16), dtype=np.int64)
    ctr = np.array([[2 ** 32 - 1, 0], [2 ** 32 - 1, 2 ** 32 - 1], [5, 9]])
    j = [jnp.asarray(a.astype(np.uint32)) for a in (seeds, ctr)]
    wpoly, wnext, wok = jsp.sample_uniform(*j, n, Q_HIGH, queue_cap=cap)
    poly, nxt, ok = tsp.sample_uniform(torch.as_tensor(seeds),
                                       torch.as_tensor(ctr), n, Q_HIGH,
                                       queue_cap=cap)
    assert np.array_equal(poly.numpy(), np.asarray(wpoly).astype(np.int64))
    assert np.array_equal(nxt.numpy(), np.asarray(wnext).astype(np.int64))
    assert ok.tolist() == np.asarray(wok).tolist() == [False] * 3


N_SYM, B_SYM = 8192, 2


@lru_cache(maxsize=None)
def _sym_case():
    parms = Parms(N_SYM, CHAIN, 2.0 ** 25)
    rng = np.random.default_rng(31)
    values = rng.uniform(-1, 1, (B_SYM, N_SYM // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, N_SYM) - 1).astype(np.int32)
    share = rng.integers(0, 2 ** 32, (B_SYM, 16)).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B_SYM, 16)).astype(np.uint32)
    args = state_to_device(values, sk, share, err, device="cpu")
    out = sym_encrypt_batch(*args, parms=parms)
    return parms, (values, sk, share, err), args, out


def test_sym_encrypt_high_rejection_chain_vs_c_loop():
    parms, (values, sk, share, err), _, out = _sym_case()
    assert out["ok"].all()
    packed = pack_ternary((sk + 1).tolist())
    for b in range(B_SYM):
        ct = gckks.sym_encrypt(parms, values[b], packed,
                               _seed_bytes(share[b]), _seed_bytes(err[b]))
        assert np.array_equal(out["pt"][b].numpy(), ct.conj_vals_int), b
        assert np.array_equal(out["pte"][b].numpy(), ct.pte), b
        for i, (c0, c1) in enumerate(ct.components):
            assert np.array_equal(out["c0"][i, b].numpy(), c0), (b, i)
            assert np.array_equal(out["c1"][i, b].numpy(), c1), (b, i)


def test_sym_stream_high_rejection_chain_equals_batch():
    parms, _, args, out = _sym_case()
    limbs = list(sym_encrypt_stream(*args, parms=parms))
    assert [l["prime_idx"] for l in limbs] == [0, 1, 2]
    for l in limbs:
        i = l["prime_idx"]
        assert l["q"] == CHAIN[i]
        assert np.array_equal(l["c0"], out["c0"][i].numpy()), i
        assert np.array_equal(l["c1"], out["c1"][i].numpy()), i
        assert l["ok"] is True


@lru_cache(maxsize=None)
def _pk_case():
    parms = Parms(N_SYM, CHAIN, 2.0 ** 25)
    rng = np.random.default_rng(32)
    sk = (rng.integers(0, 3, N_SYM) - 1).astype(np.int32)
    ep = rng.integers(-20, 21, N_SYM).astype(np.int32)
    seed = rng.integers(0, 2 ** 32, 16, dtype=np.int64)
    pk0, pk1 = gen_pk_batch(torch.as_tensor(sk), torch.as_tensor(seed),
                            torch.as_tensor(ep), parms)
    pk = gckks.gen_pk(parms, pack_ternary((sk + 1).tolist()),
                      _seed_bytes(seed), ep=ep.tolist())
    return parms, pk0, pk1, pk


def test_gen_pk_high_rejection_chain_vs_c_loop():
    _, pk0, pk1, pk = _pk_case()
    for i, (w0, w1) in enumerate(pk.components):
        assert np.array_equal(pk0[i].numpy(), w0), i
        assert np.array_equal(pk1[i].numpy(), w1), i


def test_asym_encrypt_high_rejection_chain_vs_c_loop():
    """AsymEncryptor under gen_pk_batch's key, against the C loop's
    asym_encrypt under gen_pk's."""
    parms, pk0, pk1, pk = _pk_case()
    rng = np.random.default_rng(33)
    values = rng.uniform(-1, 1, (B_SYM, N_SYM // 2)).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, (B_SYM, 16)).astype(np.uint32)
    v, s = asym_state_to_device(values, seeds, device="cpu")
    out = AsymEncryptor(parms, pk0, pk1, device="cpu")(v, s)
    assert out["ok"].all()
    for b in range(B_SYM):
        ct = gckks.asym_encrypt(parms, values[b], pk, _seed_bytes(seeds[b]))
        assert np.array_equal(out["pt"][b].numpy(), ct.conj_vals_int), b
        assert np.array_equal(out["pte"][b].numpy(), ct.pte), b
        for i, (c0, c1) in enumerate(ct.components):
            assert np.array_equal(out["c0"][i, b].numpy(), c0), (b, i)
            assert np.array_equal(out["c1"][i, b].numpy(), c1), (b, i)
