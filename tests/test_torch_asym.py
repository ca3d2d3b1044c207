"""The port's public-key slice on its CPU path: gen_pk_batch,
asym_encrypt_fused and asym_encrypt_batch against
seal_embedded_tpu.ckks.asym on the same numpy inputs, and against the
C-reference asym golden vectors (pk, u, e1, pt, pte, c0, c1), bit for
bit."""

import pathlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks import asym as jasym
from seal_embedded_tpu.ops import keccak as jkc
from seal_embedded_tpu_torch import config as tcfg
from seal_embedded_tpu_torch.ckks import asym as tasym
from seal_embedded_tpu_torch.convert import (asym_state_to_device,
                                             parms_from_jax, pk_to_device,
                                             unpack_sk, unpack_ternary)
from seal_embedded_tpu_torch.ops import modarith as tma
from seal_embedded_tpu_torch.ops import sampling as tsp

from conftest import seed_bytes

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
P1K = jcfg.Parms(degree=1024, moduli=jcfg.PRIMES_27BIT[:2], scale=2.0 ** 20)


def _key_material(n, seed):
    """sk in {-1, 0, 1}, a shareable seed (1, 16) and ep in [-63, 63]."""
    rng = np.random.default_rng(seed)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    pk_seed = rng.integers(0, 2 ** 32, (1, 16)).astype(np.uint32)
    ep = rng.integers(-63, 64, n).astype(np.int32)
    return sk, pk_seed, ep


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_signed_to_modq_vs_jax():
    """The port's one fold of small signed values, ternary_to_modq_any
    (what KA applies to e1 on load), against the JAX _signed_to_modq."""
    rng = np.random.default_rng(4)
    x = rng.integers(-63, 64, (3, 50)).astype(np.int32)
    for q in (int(jcfg.PRIMES_27BIT[0]), int(jcfg.PRIMES_30BIT[2])):
        want = np.asarray(jasym._signed_to_modq(jnp.asarray(x), q))
        assert np.array_equal(tsp.ternary_to_modq_any(_t(x), q).numpy(),
                              want.astype(np.int64))
    qs = torch.tensor(jcfg.PRIMES_30BIT[:3], dtype=torch.int64)[:, None, None]
    got = tsp.ternary_to_modq_any(_t(x)[None], qs)
    assert got.shape == (3, 3, 50)
    for l in range(3):
        want = np.asarray(jasym._signed_to_modq(jnp.asarray(x),
                                                int(jcfg.PRIMES_30BIT[l])))
        assert np.array_equal(got[l].numpy(), want.astype(np.int64)), l


def test_gen_pk_vs_jax():
    sk, pk_seed, ep = _key_material(P1K.degree, 1)
    w0, w1 = jax.jit(partial(jasym.gen_pk_batch, parms=P1K))(
        jnp.asarray(sk), jnp.asarray(pk_seed), jnp.asarray(ep))
    pk0, pk1 = tasym.gen_pk_batch(_t(sk), _t(pk_seed), _t(ep),
                                  parms_from_jax(P1K))
    assert pk0.shape == pk1.shape == (2, P1K.degree)
    assert np.array_equal(pk0.numpy(), np.asarray(w0).astype(np.int64))
    assert np.array_equal(pk1.numpy(), np.asarray(w1).astype(np.int64))


@pytest.fixture(scope="module")
def jax_asym_case():
    """Inputs at n=1024 on two 27-bit primes and the JAX
    asym_encrypt_batch's outputs for them."""
    rng = np.random.default_rng(7)
    B, n = 3, P1K.degree
    values = rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)
    pk0, pk1 = (np.stack([rng.integers(0, q, n) for q in P1K.moduli])
                .astype(np.uint32) for _ in range(2))
    seeds = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    want = jax.jit(partial(jasym.asym_encrypt_batch, parms=P1K,
                           encode_mode="f64"))(
        *(jnp.asarray(a) for a in (values, pk0, pk1, seeds)))
    return (values, pk0, pk1, seeds), want


@pytest.mark.parametrize("entry", ["asym_encrypt_fused", "asym_encrypt_batch"])
def test_asym_encrypt_vs_jax(jax_asym_case, entry):
    (values, pk0, pk1, seeds), want = jax_asym_case
    v, s = asym_state_to_device(values, seeds, device="cpu")
    got = getattr(tasym, entry)(v, *pk_to_device(pk0, pk1, device="cpu"), s,
                                parms_from_jax(P1K), encode_mode="f64")
    assert bool(np.asarray(want["ok"]).all())
    assert np.array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    for k in ("c0", "c1", "pt", "pte"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(np.int64)), k


@pytest.mark.parametrize("factory", ["make_asym_encryptor",
                                     "make_fused_asym_encryptor"])
def test_asym_factories_vs_jax(jax_asym_case, factory):
    """The factories with the JAX call signature fn(values, pk0, pk1,
    seed_words): one function per (parms, device), pk per call (numpy
    uint32 here), two keys in turn through the same encryptor."""
    (values, pk0, pk1, seeds), want = jax_asym_case
    parms = parms_from_jax(P1K)
    fn = getattr(tasym, factory)(parms, "f64", device="cpu")
    assert getattr(tasym, factory)(parms, "sf", device="cpu") is fn
    v, s = asym_state_to_device(values, seeds, device="cpu")
    got = fn(v, pk0, pk1, s)
    for k in ("c0", "c1", "pt", "pte", "ok"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(got[k].numpy().dtype))
    enc = fn.encryptor
    other = fn(v, pk1, pk0, s)
    assert fn.encryptor is enc
    assert not torch.equal(other["c0"], got["c0"])
    again = fn(v, *pk_to_device(pk0, pk1, device="cpu"), s)
    for k in ("c0", "c1", "pt", "pte", "ok"):
        assert torch.equal(again[k], got[k]), k
    with pytest.raises(ValueError):
        getattr(tasym, factory)(parms, "fast", device="cpu")


@pytest.mark.parametrize("factory", ["make_asym_encryptor",
                                     "make_fused_asym_encryptor"])
def test_asym_factory_key_changed_in_place(jax_asym_case, factory):
    """A key tensor the caller refreshes with copy_ between two calls is a
    new key: the second call matches the JAX output for the new key."""
    (values, pk0, pk1, seeds), want = jax_asym_case
    fn = getattr(tasym, factory)(parms_from_jax(P1K), device="cpu")
    v, s = asym_state_to_device(values, seeds, device="cpu")
    t0, t1 = pk_to_device(pk1, pk0, device="cpu")
    old = fn(v, t0, t1, s)
    new0, new1 = pk_to_device(pk0, pk1, device="cpu")
    t0.copy_(new0)
    t1.copy_(new1)
    got = fn(v, t0, t1, s)
    assert not torch.equal(old["c0"], got["c0"])
    for k in ("c0", "c1", "pt", "pte", "ok"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(got[k].numpy().dtype))


def test_asym_encryptor_buffers_and_modes(jax_asym_case):
    (values, pk0, pk1, seeds), _ = jax_asym_case
    parms = parms_from_jax(P1K)
    t0, t1 = pk_to_device(pk0, pk1, device="cpu")
    enc = tasym.AsymEncryptor(parms, t0, t1, device="cpu")
    q = torch.tensor(P1K.moduli, dtype=torch.int64)[:, None]
    assert torch.equal(enc.pk0, t0) and torch.equal(enc.pk1, t1)
    assert enc.pk0.data_ptr() != t0.data_ptr()   # its own copy
    assert torch.equal(enc.pk0_quot, tma.shoup_quotient(t0, q))
    assert torch.equal(enc.pk1_quot, tma.shoup_quotient(t1, q))
    assert {"pk0", "pk0_quot", "pk1", "pk1_quot", "ntt_op"} <= dict(
        enc.named_buffers()).keys()
    v, s = asym_state_to_device(values, seeds, device="cpu")
    with pytest.raises(ValueError):
        tasym.asym_encrypt_fused(v, t0, t1, s, parms, encode_mode="fast")


def _load_asym_golden(n, nprimes):
    d = np.load(REPO / "tests" / f"golden_asym_{n}_{nprimes}.npz")
    G = sum(1 for k in d.files if k.startswith("v_"))
    return d, G


@pytest.mark.parametrize("n,nprimes", [(4096, 3), (8192, 6), (16384, 13)])
def test_asym_golden(n, nprimes):
    """gen_pk from the golden sk, pk seed (tag 4) and ep; u through the
    ternary sampler and e1 through the third draw of the private stream
    (tag 3); then the encryptor's pt, pte, c0 and c1."""
    d, G = _load_asym_golden(n, nprimes)
    parms = tcfg.default_parms(n, nprimes)
    sk = unpack_sk(d["sk_packed_0"], n)
    pk0, pk1 = tasym.gen_pk_batch(
        _t(sk), _t(jkc.seed_to_words(seed_bytes(4))), _t(d["pk_ep"]), parms)
    for i in range(nprimes):
        assert np.array_equal(pk0[i].numpy(), d[f"pk0_{i}"]), i
        assert np.array_equal(pk1[i].numpy(), d[f"pk1_{i}"]), i

    values, seeds = asym_state_to_device(
        np.stack([d[f"v_{t}"] for t in range(G)]),
        np.tile(jkc.seed_to_words(seed_bytes(3)), (G, 1)), device="cpu")
    u, ctr, ok = tsp.sample_ternary(seeds, tsp.counter_zero((G,)), n)
    _, ctr = tsp.sample_cbd(seeds, ctr, n)
    e1, _ = tsp.sample_cbd(seeds, ctr, n)
    assert ok.all()
    for t in range(G):
        assert np.array_equal(u[t].numpy(),
                              unpack_ternary(d[f"u_packed_{t}"], n)), t
        assert np.array_equal(e1[t].numpy(), d[f"e1_{t}"]), t

    out = tasym.AsymEncryptor(parms, pk0, pk1, device="cpu")(values, seeds)
    assert out["ok"].all()
    for t in range(G):
        assert np.array_equal(out["pt"][t].numpy(), d[f"pt_{t}"]), t
        assert np.array_equal(out["pte"][t].numpy(), d[f"pte_{t}"]), t
        for i in range(nprimes):
            assert np.array_equal(out["c0"][i, t].numpy(),
                                  d[f"c0_{nprimes * t + i}"]), (t, i)
            assert np.array_equal(out["c1"][i, t].numpy(),
                                  d[f"c1_{nprimes * t + i}"]), (t, i)


def test_asym_convert_helpers():
    d, _ = _load_asym_golden(4096, 3)
    assert unpack_sk is unpack_ternary
    packed = bytes(d["u_packed_0"].tolist())
    want = np.array([((packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1
                     for i in range(4096)], dtype=np.int32)
    assert np.array_equal(unpack_ternary(d["u_packed_0"], 4096), want)
    pk0 = np.stack([d[f"pk0_{i}"] for i in range(3)])
    t0, t1 = pk_to_device(pk0, pk0, device="cpu")
    assert t0.dtype == torch.int64 and t0.shape == (3, 4096)
    assert np.array_equal(t1.numpy(), pk0.astype(np.int64))
    v, s = asym_state_to_device(np.zeros((2, 8)),
                                np.full((2, 16), 2 ** 32 - 1), device="cpu")
    assert v.dtype == torch.float32 and s.dtype == torch.int64
    assert int(s.max()) == 2 ** 32 - 1
