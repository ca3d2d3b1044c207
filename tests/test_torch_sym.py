"""The port's per-prime symmetric pipeline and decrypt oracle (ckks/sym.py)
on their CPU path against seal_embedded_tpu.ckks.sym on the same numpy
inputs, bit for bit."""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks import sym as jsym
from seal_embedded_tpu.io import serialize as jser
from seal_embedded_tpu.ops.encode import (ifft_root_tables_from_file,
                                          index_map_np)
from seal_embedded_tpu_torch.ckks import limbwise as tlw
from seal_embedded_tpu_torch.ckks import sym as tsym
from seal_embedded_tpu_torch.ckks.fast import SymEncryptor
from seal_embedded_tpu_torch.convert import parms_from_jax, state_to_device

torch.set_num_threads(2)

P = jcfg.Parms(degree=256, moduli=jcfg.PRIMES_27BIT[:2], scale=2.0 ** 20)


def _inputs(B, n, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    return values, sk, share, err


def _loaded_tables(tmp_path, n):
    """IFFT roots and index map written in the adapter's file format and
    read back by the JAX package's loaders (SE_IFFT_LOAD_FULL,
    SE_INDEX_MAP_LOAD)."""
    roots = str(tmp_path / f"ifft_roots_{n}.dat")
    jser.write_ifft_roots(roots, n, n.bit_length() - 1)
    imap_path = str(tmp_path / f"index_map_{n}.dat")
    jser.write_index_map(imap_path, index_map_np(n))
    return (ifft_root_tables_from_file(roots, n),
            jser.read_index_map(imap_path, n))


@lru_cache(maxsize=None)
def _jax_batch(variant):
    """The JAX sym_encrypt_batch outputs on _inputs(2, n, seed=7), as numpy.
    Its computed tables equal the loaded ones (tests/test_stream_io.py), so
    one JAX run is the oracle for both."""
    out = jax.jit(partial(jsym.sym_encrypt_batch, parms=P,
                          ntt_variant=variant))(
        *(jnp.asarray(a) for a in _inputs(2, P.degree, seed=7)))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("variant", ["table", "otf"])
@pytest.mark.parametrize("loaded", [False, True])
def test_sym_encrypt_batch_vs_jax(variant, loaded, tmp_path):
    tables, imap = (_loaded_tables(tmp_path, P.degree) if loaded
                    else (None, None))
    want = _jax_batch(variant)
    assert bool(want["ok"].all())
    args = state_to_device(*_inputs(2, P.degree, seed=7), device="cpu")
    got = tsym.sym_encrypt_batch(*args, parms_from_jax(P), variant,
                                 root_tables=tables, imap=imap)
    assert np.array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    for k in ("c0", "c1", "pt", "pte"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(np.int64)), k
    # sym.py:68-84 chains the share counter as the reference layout does.
    fused = SymEncryptor(parms_from_jax(P), device="cpu")(*args)
    for k in ("c0", "c1", "pt", "pte", "ok"):
        assert torch.equal(got[k], fused[k]), k
    if loaded:   # the loaded tables are the ones read: a changed root shows
        bent = [(re, im.copy()) for re, im in tables]
        bent[0][1][0] *= 0.5
        other = tsym.sym_encrypt_batch(*args, parms_from_jax(P), variant,
                                       root_tables=bent, imap=imap)
        assert not torch.equal(other["pt"], got["pt"])


@pytest.mark.parametrize("impl", ["canonical", "lazy"])
def test_decrypt_batch_vs_jax(impl):
    """Decrypt of a reference-layout ciphertext gives pte back, and equals
    the JAX decrypt; the lazy INTT reads the reference's file-order fast
    tables (loaded for the first prime, computed for the second)."""
    values, sk, share, err = _inputs(2, P.degree, seed=8)
    args = state_to_device(values, sk, share, err, device="cpu")
    out = tsym.make_sym_encryptor(parms_from_jax(P), device="cpu")(*args)
    q0 = int(P.moduli[0])
    pairs = jser.intt_fast_root_table(P.degree, P.logn, q0, P.ntt_root(q0))
    loaded = {q0: (pairs[0::2], pairs[1::2])} if impl == "lazy" else None
    want = jax.jit(partial(jsym.decrypt_batch, parms=P, intt_impl=impl,
                           loaded_intt=loaded))(
        jnp.asarray(out["c0"].numpy().astype(np.uint32)),
        jnp.asarray(out["c1"].numpy().astype(np.uint32)), jnp.asarray(sk))
    got = tsym.make_decryptor(parms_from_jax(P), impl, loaded, "cpu")(
        out["c0"], out["c1"], args[1])
    assert np.array_equal(got.numpy(), np.asarray(want))
    for i in range(len(P.moduli)):
        assert torch.equal(got[i], out["pte"])


def test_reverse_and_parallel_decrypt():
    """A reverse walk decrypts under the reversed chain, and the parallel
    layout under the forward one, canonical and lazy alike."""
    values, sk, share, err = _inputs(2, P.degree, seed=9)
    args = state_to_device(values, sk, share, err, device="cpu")
    tp = parms_from_jax(P)
    rev_parms = jcfg.Parms(degree=P.degree, moduli=P.moduli[::-1],
                           scale=P.scale)
    for parms, layout, order in ((rev_parms, "reference", "reverse"),
                                 (P, "parallel", "forward")):
        out = tlw.LimbscanEncryptor(tp, layout, order, device="cpu")(*args)
        for impl in ("canonical", "lazy"):
            cen = tsym.decrypt_batch(out["c0"], out["c1"], args[1],
                                     parms_from_jax(parms), impl)
            assert all(torch.equal(c, out["pte"]) for c in cen), \
                (layout, order, impl)


def test_ntt_s_and_argument_checks():
    _, sk, _, _ = _inputs(1, P.degree, seed=10)
    q = int(P.moduli[1])
    want = jax.jit(jsym._ntt_s_for_prime, static_argnums=1)(jnp.asarray(sk), q)
    got = tsym._ntt_s_for_prime(torch.as_tensor(sk), q)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    args = state_to_device(*_inputs(1, P.degree), device="cpu")
    with pytest.raises(ValueError):
        tsym.sym_encrypt_batch(*args, parms_from_jax(P), "fft")
    with pytest.raises(ValueError):
        tsym.decrypt_batch(torch.zeros((2, 1, P.degree), dtype=torch.int64),
                           torch.zeros((2, 1, P.degree), dtype=torch.int64),
                           args[1], parms_from_jax(P), "fast")
