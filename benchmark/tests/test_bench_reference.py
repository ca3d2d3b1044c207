"""The frozen reference against the C reference's own vectors
(tests/golden_{sym,asym}_*.npz: six messages each, the secret key, the
seeds of tags 2, 3 and 4, and for asym the public key with its error)."""

import pathlib

import numpy as np
import pytest

from benchmark import check
from benchmark.catalog import Catalog
from benchmark.reference import ckks, sampling
from benchmark.reference.params import from_config

GOLDEN = pathlib.Path(__file__).resolve().parents[2] / "tests"


def seed_bytes(tag: int) -> bytes:
    return bytes((tag + i) & 0xFF for i in range(64))


def unpack_sk(packed, n):
    """The C reference's 2-bit packed ternary key as {-1, 0, 1}."""
    idx = np.arange(n)
    b = np.asarray(packed, dtype=np.uint8)
    return ((b[idx // 4] >> (6 - 2 * (idx % 4))) & 3).astype(np.int64) - 1


def golden(kind, config):
    p = from_config(Catalog().config(config))
    n, L = p.degree, p.nprimes
    d = np.load(GOLDEN / f"golden_{kind}_{n}_{L}.npz")
    G = sum(1 for k in d.files if k.startswith("v_"))
    want = {key: np.stack([np.stack([d[f"{key}_{L * t + i}"]
                                     for t in range(G)]) for i in range(L)])
            for key in ("c0", "c1")}
    return p, d, G, unpack_sk(d["sk_packed_0"], n), \
        np.stack([d[f"v_{t}"] for t in range(G)]), want


@pytest.mark.parametrize("config", ["seal-default-n4096", "seal-n16384-L13"])
def test_sym_matches_c_reference(config):
    p, d, G, sk, v, want = golden("sym", config)
    c0, c1 = ckks.sym_encrypt(p, sk, v, [seed_bytes(2)] * G,
                              [seed_bytes(3)] * G)
    assert np.array_equal(c0, want["c0"])
    assert np.array_equal(c1, want["c1"])


@pytest.mark.parametrize("config", ["seal-default-n4096", "seal-n16384-L13"])
def test_asym_and_public_key_match_c_reference(config):
    p, d, G, sk, v, want = golden("asym", config)
    pk0, pk1 = ckks.public_key(p, sk, seed_bytes(4),
                               ep=d["pk_ep"].astype(np.int64))
    L = p.nprimes
    assert np.array_equal(pk0, np.stack([d[f"pk0_{i}"] for i in range(L)]))
    assert np.array_equal(pk1, np.stack([d[f"pk1_{i}"] for i in range(L)]))
    c0, c1 = ckks.asym_encrypt(p, pk0, pk1, v, [seed_bytes(3)] * G)
    assert np.array_equal(c0, want["c0"])
    assert np.array_equal(c1, want["c1"])


def test_encode_matches_c_reference_plaintext():
    p, d, G, sk, v, want = golden("sym", "seal-default-n4096")
    from benchmark.reference.encode import encode
    pt = np.stack([d[f"pt_{t}"] for t in range(G)])
    assert np.array_equal(encode(p, v), pt)


def test_public_key_error_follows_the_pk_seed_rule():
    """ep = CBD(prng(SHAKE-256(pk_seed || "ep"))), the program's rule."""
    import hashlib
    seed = seed_bytes(9)
    ep = ckks.public_key_error(seed, 64)
    prng = sampling.Prng(hashlib.shake_256(seed + b"ep").digest(64))
    assert np.array_equal(ep, sampling.cbd(prng, 64))


def test_uniform_redraws_rejected_words_in_order():
    """A word at or above max_multiple takes the next accepted 4-byte fill,
    the counter stepping once a fill (sample.c:39-57)."""
    q = 1053818881
    limit = sampling.max_multiple(q)
    for s in range(64):
        prng = sampling.Prng(bytes([s]) * 64)
        got = sampling.uniform(prng, 1024, q)
        ref = sampling.Prng(bytes([s]) * 64)
        words = np.frombuffer(ref.fill(4096), dtype="<u4").astype(np.int64)
        for i, w in enumerate(words):
            while w >= limit:
                w = int.from_bytes(ref.fill(4), "little")
            words[i] = w
        assert np.array_equal(got, words % q)
        assert prng.counter == ref.counter


def test_control_precision_changes_every_c0():
    """The encode one precision lower changes the ciphertexts: the check's
    control reads not correct."""
    p, d, G, sk, v, want = golden("sym", "seal-default-n4096")
    v = np.random.default_rng(0).uniform(-1, 1, v.shape).astype(np.float32)
    seeds = [seed_bytes(2)] * G, [seed_bytes(3)] * G
    f64 = check.reference_rows(p, "sym", sk, None,
                               list(zip(v, *seeds)))
    f32 = check.reference_rows(p, "sym", sk, None,
                               list(zip(v, *seeds)), np.float32)
    assert np.array_equal(f64[1], f32[1])
    assert np.count_nonzero(f64[0] != f32[0]) > 0.99 * f64[0].size
