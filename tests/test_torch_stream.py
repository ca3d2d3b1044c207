"""The port's per-prime streaming (ckks/stream.py) on its CPU path, and its
compiled streams through the fake capture of test_torch_chain.py, against
seal_embedded_tpu.ckks.stream on the same numpy inputs, limb by limb and
byte for byte."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import api as japi
from seal_embedded_tpu.ckks import stream as jstream
from seal_embedded_tpu.ckks.asym import gen_pk_batch
from seal_embedded_tpu.config import PRIMES_27BIT, PRIMES_30BIT, Parms
from seal_embedded_tpu.io import network as jnet
from seal_embedded_tpu.ops import modarith as jma
from seal_embedded_tpu.ops.kernels.ntt import ntt_coeff_major_fused_sym
from seal_embedded_tpu.ops.keccak import seed_to_words
from seal_embedded_tpu_torch import graphs
from seal_embedded_tpu_torch.ckks import stream as tstream
from seal_embedded_tpu_torch.ckks.asym import AsymEncryptor
from seal_embedded_tpu_torch.ckks.limbwise import LimbscanEncryptor
from seal_embedded_tpu_torch.convert import (context_from_jax, parms_from_jax,
                                             pk_to_device, state_to_device)
from seal_embedded_tpu_torch.io import network as tnet

from conftest import seed_bytes
from test_torch_chain import _fetched, faked, run_chain

torch.set_num_threads(2)

P = Parms(degree=1024, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)
B = 2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = P.degree
    values = rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    return values, sk, share, err


@lru_cache(maxsize=None)
def _jax_pk():
    rng = np.random.default_rng(7)
    n = P.degree
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    ep = rng.integers(-20, 21, n).astype(np.int32)
    pk_seed = seed_to_words(seed_bytes(4))[None, :]
    pk0, pk1 = gen_pk_batch(jnp.asarray(sk), jnp.asarray(pk_seed),
                            jnp.asarray(ep), P)
    return sk, np.asarray(pk0), np.asarray(pk1)


def _check_limbs(got, want, order):
    walk = [0, 1] if order == "forward" else [1, 0]
    assert [l["prime_idx"] for l in got] == walk
    assert [l["prime_idx"] for l in want] == walk
    for g, w in zip(got, want):
        assert g["q"] == w["q"] and g["ok"] is True
        for k in ("c0", "c1"):
            assert g[k].dtype == np.uint32 and g[k].shape == (B, P.degree)
            assert np.array_equal(g[k], w[k]), (order, g["prime_idx"], k)
    # Every yielded array owns its memory.
    arrays = [l[k] for l in got for k in ("c0", "c1")]
    assert not any(np.shares_memory(a, b) for i, a in enumerate(arrays)
                   for b in arrays[i + 1:])


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_sym_encrypt_stream_vs_jax(order):
    values, sk, share, err = _inputs(0)
    want = list(jstream.sym_encrypt_stream(
        *(jnp.asarray(a) for a in (values, sk, share, err)), P, "f64", order))
    got = list(tstream.sym_encrypt_stream(
        *state_to_device(values, sk, share, err, device="cpu"), parms_from_jax(P), "f64",
        order))
    _check_limbs(got, want, order)
    assert all(l["wait_ms"] == 0.0 for l in got)
    # The limb-scan encryptor of the same walk gives the same limbs.
    ref = LimbscanEncryptor(parms_from_jax(P), "reference", order, device="cpu")(
        *state_to_device(values, sk, share, err, device="cpu"))
    for j, l in enumerate(got):
        assert np.array_equal(l["c0"], ref["c0"][j].numpy())


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_asym_encrypt_stream_vs_jax(order):
    _, pk0, pk1 = _jax_pk()
    values, _, _, err = _inputs(1)
    want = list(jstream.asym_encrypt_stream(
        jnp.asarray(values), jnp.asarray(pk0), jnp.asarray(pk1),
        jnp.asarray(err), P, "f64", order))
    tpk = pk_to_device(pk0, pk1, device="cpu")
    got = list(tstream.asym_encrypt_stream(
        torch.as_tensor(values), *tpk, torch.as_tensor(err.astype(np.int64)),
        parms_from_jax(P), "f64", order))
    _check_limbs(got, want, order)
    batch = AsymEncryptor(parms_from_jax(P), *tpk, device="cpu")(
        torch.as_tensor(values), torch.as_tensor(err.astype(np.int64)))
    for l in got:
        assert np.array_equal(l["c1"], batch["c1"][l["prime_idx"]].numpy())


@pytest.mark.parametrize("kind", ["sym", "asym"])
@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_se_encrypt_streaming_sent_bytes_vs_jax(kind, order):
    values, sk, _, _ = _inputs(2)
    if kind == "asym":
        sk, pk0, pk1 = _jax_pk()
        jctx = japi.SEContext(parms=P, encrypt_type=japi.ASYM,
                              sk_signed=sk, pk0=pk0, pk1=pk1)
    else:
        jctx = japi.SEContext(parms=P, encrypt_type=japi.SYM, sk_signed=sk)
    share = [seed_bytes(10 + b) for b in range(B)]
    err = [seed_bytes(20 + b) for b in range(B)]
    jsend, jstore = jnet.collecting_sender()
    jout = jstream.se_encrypt_streaming(jctx, values, share, err, jsend, order)
    tsend, tstore = tnet.collecting_sender()
    tout = tstream.se_encrypt_streaming(context_from_jax(jctx, "cpu"), values,
                                        share, err, tsend, order)
    assert len(tstore) == 2 * B * P.nprimes and tstore == jstore
    _check_limbs(tout, jout, order)


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_sym_stream_limb_step_vs_pallas_interpret(order):
    """The sym stream's per-limb step, KN from pte at (1, B, n) on the
    limb's own q, r0, r1 and tables (reversed buffers in reverse order),
    against the JAX reduce_pte_i64 + fused-sym kernel in interpret mode
    for that limb's prime, on edge pte values; n = 256, B = 128."""
    from test_torch_ntt import edge_pte

    tp = Parms(degree=256, moduli=PRIMES_27BIT[:3], scale=2.0 ** 20)
    enc = LimbscanEncryptor(parms_from_jax(tp), "reference", order,
                            device="cpu")
    walk = list(tp.moduli[::-1] if order == "reverse" else tp.moduli)
    assert list(enc.moduli) == walk
    rng = np.random.default_rng(31)
    B, n = 128, tp.degree
    pte = edge_pte(rng, walk, B, n)
    for j, q in enumerate(walk):
        a = rng.integers(0, q, (B, n), dtype=np.int64)
        ntt_s = rng.integers(0, q, (1, n), dtype=np.int64)
        got = enc.c0_from_pte(torch.as_tensor(pte), torch.as_tensor(a)[None],
                              torch.as_tensor(ntt_s), slice(j, j + 1))
        red = np.asarray(jma.reduce_pte_i64(jnp.asarray(pte), q))
        want = ntt_coeff_major_fused_sym(
            jnp.asarray(red.T[None].astype(np.uint32)),
            jnp.asarray(a.T[None].astype(np.uint32)),
            jnp.asarray(ntt_s.astype(np.uint32)), (q,), interpret=True)
        assert got.shape == (1, B, n)
        assert np.array_equal(got[0].numpy(),
                              np.asarray(want)[0].T.astype(np.int64)), (j, q)


def test_se_encrypt_streaming_missing_seeds_raise_valueerror():
    """R3: the JAX function dies with a TypeError inside its seed
    conversion when a seed list is left at None; the port names it."""
    values, sk, _, _ = _inputs(3)
    jctx = japi.SEContext(parms=P, encrypt_type=japi.SYM, sk_signed=sk)
    with pytest.raises(TypeError):
        jstream.se_encrypt_streaming(jctx, values)
    ctx = context_from_jax(jctx, "cpu")
    with pytest.raises(ValueError, match="err_seeds"):
        tstream.se_encrypt_streaming(ctx, values)
    with pytest.raises(ValueError, match="share_seeds"):
        tstream.se_encrypt_streaming(ctx, values,
                                     err_seeds=[seed_bytes(1)] * B)


def test_stream_argument_checks():
    values, sk, share, err = _inputs(4)
    args = state_to_device(values, sk, share, err, device="cpu")
    tp = parms_from_jax(P)
    with pytest.raises(ValueError, match="order"):
        tstream.sym_encrypt_stream(*args, tp, "f64", "sideways")
    with pytest.raises(ValueError, match="encode mode"):
        tstream.sym_encrypt_stream(*args, tp, "fp16")


# 13 limbs at n = 64: every prime of PRIMES_30BIT is 1 mod 65536, so the
# chain is valid at n = 64, where the JAX stream is cheap; the compiled
# stream's ring of two slots wraps six times.
RING_P = Parms(degree=64, moduli=PRIMES_30BIT[:13], scale=2.0 ** 25)
RING_B = 3


def _ring_inputs(seed=8):
    rng = np.random.default_rng(seed)
    n = RING_P.degree
    return (rng.uniform(-1, 1, (RING_B, n // 2)).astype(np.float32),
            (rng.integers(0, 3, n) - 1).astype(np.int32),
            rng.integers(0, 2 ** 32, (RING_B, 16)).astype(np.uint32),
            rng.integers(0, 2 ** 32, (RING_B, 16)).astype(np.uint32),
            *(np.stack([rng.integers(0, q, n) for q in RING_P.moduli])
              .astype(np.uint32) for _ in range(2)))


def _ring_case(kind, order):
    """(the JAX stream's limbs as (prime_idx, c0, c1), the port's compiled
    stream, its CPU arguments) on _ring_inputs()."""
    values, sk, share, err, pk0, pk1 = _ring_inputs()
    tp = parms_from_jax(RING_P)
    if kind == "sym":
        jgen = jstream.sym_encrypt_stream(
            *map(jnp.asarray, (values, sk, share, err)), RING_P, "f64", order)
        s = tstream.sym_stream(tp, order, "cpu")
        args = state_to_device(values, sk, share, err, device="cpu")
    else:
        jgen = jstream.asym_encrypt_stream(
            *map(jnp.asarray, (values, pk0, pk1, err)), RING_P, "f64", order)
        s = tstream.asym_stream(tp, order, "cpu")
        args = (torch.as_tensor(values), *pk_to_device(pk0, pk1, device="cpu"),
                torch.as_tensor(err.astype(np.int64)))
    want = [(l["prime_idx"], np.asarray(l["c0"]), np.asarray(l["c1"]))
            for l in jgen]
    return want, s, args


def _require_ring_limbs(limbs, want, rows=slice(None)):
    assert [l["prime_idx"] for l in limbs] == [w[0] for w in want]
    for l, (_, c0, c1) in zip(limbs, want):
        assert l["ok"] is True and l["c0"].dtype == np.uint32
        assert np.array_equal(l["c0"], c0[rows])
        assert np.array_equal(l["c1"], c1[rows])


@pytest.mark.parametrize("kind", ["sym", "asym"])
@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_compiled_stream_wraps_the_ring_vs_jax(kind, order):
    """13 limbs at n = 64 through the compiled stream's fake capture (two
    ring slots, each written six or seven times a run): the capture, a
    replay, and two runs interleaved limb by limb (the second on the
    rows reversed, which reverses the JAX stream's rows), each limb
    bit-equal to the JAX stream's; the eager CPU stream too."""
    want, s, args = _ring_case(kind, order)
    _require_ring_limbs(list(s(*args)), want)
    chain = faked(graphs.Chain(s.chain.prologue, s.chain.step,
                               s.chain.nsteps, torch.device("cpu")))
    for _ in range(2):
        _require_ring_limbs(list(map(tstream._fetch, run_chain(
            chain, *args, start=_fetched(s)))), want)
    flipped = tuple(t.flip(0) if t.dim() == 2 and t.shape[0] == RING_B
                    else t for t in args)
    runs = [map(tstream._fetch, run_chain(chain, *a, start=_fetched(s)))
            for a in (args, flipped)]
    got = [[], []]
    for _ in range(13):
        for k, run in enumerate(runs):
            got[k].append(next(run))
    _require_ring_limbs(got[0], want)
    _require_ring_limbs(got[1], want, slice(None, None, -1))
    entry, = chain.entries.values()
    assert len(entry.outputs) == graphs.RING_SLOTS
    # No slot is a hand-off (asym hands its ok on), which the next run's
    # prologue rewrites while the last limbs' copies may still read.
    handoffs = []
    graphs.map_tensors(entry.carry, lambda t: handoffs.append(t.data_ptr()))
    assert not {t.data_ptr() for out in entry.outputs for t in out} & set(
        handoffs)
