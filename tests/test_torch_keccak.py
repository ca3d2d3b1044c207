"""Port's plain SHAKE-256 (the CPU path of kernel KK) vs
seal_embedded_tpu.ops.keccak.shake256_words(impl="jnp") and hashlib."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.ops import keccak as jkc
from seal_embedded_tpu_torch.ops import keccak as tkc
from seal_embedded_tpu_torch.ops.kernels.keccak import (cbd_values,
                                                        keccak_squeeze)

torch.set_num_threads(2)

WRAP_COUNTERS = (0, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1)


def _inputs(rng, batch, extra=()):
    seeds = rng.integers(0, 2 ** 32, batch + (16,), dtype=np.int64)
    ctr = rng.integers(0, 2 ** 32, batch + extra + (2,), dtype=np.int64)
    flat = ctr.reshape(-1, 2)
    for i, c in enumerate(WRAP_COUNTERS[:flat.shape[0]]):
        flat[i] = [c & 0xFFFFFFFF, c >> 32]
    return seeds, flat.reshape(ctr.shape)


def _both(seeds, ctr, nblocks, nwords=None):
    want = np.asarray(jkc.shake256_words(
        jnp.asarray(seeds.astype(np.uint32)), jnp.asarray(ctr.astype(np.uint32)),
        nblocks, impl="jnp", nwords=nwords)).astype(np.int64)
    got = tkc.shake256_words(torch.as_tensor(seeds), torch.as_tensor(ctr),
                             nblocks, nwords).numpy()
    return got, want


@pytest.mark.parametrize("nblocks", [1, 3, 121])
def test_shake256_words_vs_jax(nblocks):
    seeds, ctr = _inputs(np.random.default_rng(nblocks), (4,))
    got, want = _both(seeds, ctr, nblocks)
    assert got.shape == (4, nblocks * 34)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nwords", [1, 24])
def test_shake256_words_nwords_broadcast_vs_jax(nwords):
    """Seeds (B, 16) broadcast against counters (B, K, 2), as the queue and
    CBD draws use them."""
    seeds, ctr = _inputs(np.random.default_rng(100 + nwords), (3,), (5,))
    got, want = _both(seeds, ctr, 1, nwords)
    assert got.shape == (3, 5, nwords)
    assert np.array_equal(got, want)


def test_shake256_words_vs_hashlib():
    rng = np.random.default_rng(7)
    seeds, ctr = _inputs(rng, (len(WRAP_COUNTERS) + 2,))
    seeds[-1] = tkc.seed_to_words(bytes((2 + i) & 0xFF for i in range(64)))
    words = tkc.shake256_words(torch.as_tensor(seeds), torch.as_tensor(ctr),
                               2).numpy()
    for i in range(seeds.shape[0]):
        c = int(ctr[i, 0]) | (int(ctr[i, 1]) << 32)
        msg = seeds[i].astype("<u4").tobytes() + c.to_bytes(8, "little")
        assert tkc.words_to_bytes_np(words[i]) == \
            hashlib.shake_256(msg).digest(272), i


def test_keccak_f1600_vs_jax():
    rng = np.random.default_rng(13)
    lo = rng.integers(0, 2 ** 32, (6, 25), dtype=np.int64)
    hi = rng.integers(0, 2 ** 32, (6, 25), dtype=np.int64)
    jlo, jhi = jkc.keccak_f1600(jnp.asarray(lo.astype(np.uint32)),
                                jnp.asarray(hi.astype(np.uint32)))
    state = torch.as_tensor(lo | (hi << 32))
    got = tkc.keccak_f1600(state)
    assert np.array_equal((got & 0xFFFFFFFF).numpy(), np.asarray(jlo))
    assert np.array_equal(((got >> 32) & 0xFFFFFFFF).numpy(), np.asarray(jhi))


def test_absorb72_vs_jax():
    seeds, ctr = _inputs(np.random.default_rng(3), (2,), (3,))
    jlo, jhi = jkc.absorb72(jnp.asarray(seeds.astype(np.uint32)),
                            jnp.asarray(ctr.astype(np.uint32)))
    st = tkc.absorb72(torch.as_tensor(seeds), torch.as_tensor(ctr))
    assert np.array_equal((st & 0xFFFFFFFF).numpy(), np.asarray(jlo))
    assert np.array_equal(((st >> 32) & 0xFFFFFFFF).numpy(), np.asarray(jhi))


def test_kernel_wrapper_cpu_path_and_checks():
    """On CPU tensors the KK wrapper is the plain version; it rejects
    malformed arguments and devices it cannot serve."""
    seeds, ctr = _inputs(np.random.default_rng(9), (5,))
    s, c = torch.as_tensor(seeds), torch.as_tensor(ctr)
    assert torch.equal(keccak_squeeze(s, c, 1, 24),
                       tkc.shake256_words(s, c, 1, 24))
    with pytest.raises(ValueError):
        keccak_squeeze(s.to(torch.int32), c, 1)
    with pytest.raises(ValueError):
        keccak_squeeze(s, c, 2, nwords=5)
    with pytest.raises(ValueError):
        keccak_squeeze(s.to("meta"), c.to("meta"), 1)


@pytest.mark.parametrize("nblocks,nwords,per_seed,start", [
    (1, 1, 160, 1),     # the uniform queue at n = 4096
    (1, 1, 8, 1),       # the ternary refills
    (1, 24, 256, 0),    # the CBD fills at n = 4096
    (3, None, 2, 5)])
def test_seed_broadcast_vs_explicit_counters(nblocks, nwords, per_seed,
                                             start):
    """KK's seed-broadcast form (per_seed streams per seed at counter +
    start + j) against the explicit-counter form on expanded seeds and
    counters, with counters whose offsets carry across 2^32 and wrap at
    2^64; and the explicit form against the JAX squeeze."""
    seeds, ctr = _inputs(np.random.default_rng(per_seed + start), (6,))
    ctr[4] = [2 ** 32 - start - per_seed // 2, 2 ** 32 - 1]  # carry, wrap
    s, c = torch.as_tensor(seeds), torch.as_tensor(ctr)
    got = keccak_squeeze(s, c, nblocks, nwords, per_seed=per_seed,
                         start=start)
    offs = torch.arange(start, start + per_seed)
    ec = tkc.counter_offsets(c, offs).reshape(-1, 2)
    es = s[:, None, :].expand(6, per_seed, 16).reshape(-1, 16)
    want = keccak_squeeze(es, ec, nblocks, nwords)
    words = nblocks * 34 if nwords is None else nwords
    assert got.shape == (6 * per_seed, words)
    assert torch.equal(got, want)
    jw, _ = _both(es.numpy()[:64], ec.numpy()[:64], nblocks, nwords)
    assert np.array_equal(want[:64].numpy(), jw)
    # Row 4's streams cross 2^32 and then 2^64.
    assert set(ec[4 * per_seed:5 * per_seed, 1].tolist()) == {2 ** 32 - 1, 0}


def test_cbd_values_wrapper_cpu_path_and_checks():
    """KK's CBD role on CPU tensors is its plain version; argument checks."""
    seeds, ctr = _inputs(np.random.default_rng(11), (3,))
    s, c = torch.as_tensor(seeds), torch.as_tensor(ctr)
    got = cbd_values(s, c, 64)
    assert got.shape == (3, 64) and torch.equal(got, tkc.cbd_values(s, c, 64))
    assert int(got.abs().max()) <= 21
    with pytest.raises(ValueError):
        cbd_values(s.to(torch.int32), c, 64)
    with pytest.raises(ValueError):
        cbd_values(s, c[:2], 64)
    with pytest.raises(ValueError):
        keccak_squeeze(s, c, 1, 1, per_seed=0)
    with pytest.raises(ValueError):
        keccak_squeeze(s, c, 1, 1, per_seed=4, start=2 ** 32 - 2)
