"""The port's limb-scan pipeline (ckks/limbwise.py) on its CPU path against
seal_embedded_tpu.ckks.limbwise on the same numpy inputs, and against the
C-reference golden vectors, bit for bit."""

import pathlib
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks import limbwise as jlw
from seal_embedded_tpu.ops import keccak as jkc
from seal_embedded_tpu_torch import config as tcfg
from seal_embedded_tpu_torch.ckks import limbwise as tlw
from seal_embedded_tpu_torch.ckks.fast import SymEncryptor
from seal_embedded_tpu_torch.convert import (parms_from_jax, state_to_device,
                                             unpack_sk)

from conftest import seed_bytes

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
# Three limbs whose Barrett constants all differ, so a reverse walk that
# kept the forward r0/r1 would give other c0 bits.
P = jcfg.Parms(degree=256, moduli=jcfg.PRIMES_27BIT[:3], scale=2.0 ** 20)


def _inputs(B, n, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    return values, sk, share, err


def _np(x):
    return np.asarray(x).astype(np.int64)


def _assert_out_equal(got, want, keys=("c0", "c1", "pte", "pt")):
    assert np.array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    for k in keys:
        assert np.array_equal(got[k].numpy(), _np(want[k])), k


@lru_cache(maxsize=None)
def _jax_limbscan(layout, order):
    """The JAX limb-scan outputs on _inputs(2, n, seed=1), as numpy."""
    args = _inputs(2, P.degree, seed=1)
    out = jax.jit(partial(jlw.sym_encrypt_limbscan, parms=P, layout=layout,
                          encode_mode="f64", order=order))(
        *(jnp.asarray(a) for a in args))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("layout", ["reference", "parallel"])
@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_limbscan_vs_jax(layout, order):
    want = _jax_limbscan(layout, order)
    assert bool(want["ok"].all())
    enc = tlw.make_limbscan_encryptor(parms_from_jax(P), layout, "f64", order,
                                      device="cpu")
    got = enc(*state_to_device(*_inputs(2, P.degree, seed=1), device="cpu"))
    _assert_out_equal(got, want)
    if order == "reverse":      # the compiled function's LimbscanEncryptor
        assert enc.fn.moduli == tuple(reversed(P.moduli))
        assert enc.fn.r0.tolist() == [jcfg.const_ratio(q)[0]
                                   for q in reversed(P.moduli)]


def test_expand_c1_reference_vs_jax():
    _, _, share, _ = _inputs(3, P.degree, seed=2)
    pt = parms_from_jax(P)
    for order in ("forward", "reverse"):
        want_c1, want_ok = jlw.make_c1_expander(P, "reference", order)(
            jnp.asarray(share))
        got_c1, got_ok = tlw.make_c1_expander(pt, "reference", order, device="cpu")(
            torch.as_tensor(share.astype(np.int64)))
        assert np.array_equal(got_c1.numpy(), _np(want_c1)), order
        assert np.array_equal(got_ok.numpy(), np.asarray(want_ok)), order


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_expand_c1_parallel_vs_jax_encryptor(order):
    """The JAX expand_c1(parallel) raises NameError (it reads an undefined
    qcap); its oracle is the c1 of the JAX parallel encryptor, the same
    draws."""
    share = _inputs(2, P.degree, seed=1)[2]
    with pytest.raises(NameError):
        jlw.expand_c1(jnp.asarray(share), P, "parallel", order)
    want = _jax_limbscan("parallel", order)
    c1, ok = tlw.expand_c1(torch.as_tensor(share.astype(np.int64)),
                           parms_from_jax(P), "parallel", order)
    assert np.array_equal(c1.numpy(), _np(want["c1"]))
    assert bool(ok.all())


def test_add_cbd_error_vs_jax():
    """The JAX add_cbd_error passes a (B,) counter where the sampler takes
    (B, 2) pairs, so it runs only at B = 1; there it is the oracle, and at
    B > 1 the JAX sampler with counter_zero((B,)) is."""
    from seal_embedded_tpu.ops import sampling as jsp
    _, _, _, err = _inputs(3, P.degree, seed=4)
    pt = np.random.default_rng(5).integers(-2 ** 40, 2 ** 40, (3, P.degree))
    got = tlw.add_cbd_error(torch.as_tensor(pt),
                            torch.as_tensor(err.astype(np.int64)), P.degree)
    want1 = jlw.add_cbd_error(jnp.asarray(pt[:1]), jnp.asarray(err[:1]),
                              P.degree)
    assert np.array_equal(got[:1].numpy(), np.asarray(want1))
    e, _ = jax.jit(partial(jsp.sample_cbd, n=P.degree))(
        jnp.asarray(err), jsp.counter_zero((3,)))
    assert np.array_equal(got.numpy(), pt + np.asarray(e).astype(np.int64))


def test_from_pte_vs_jax():
    _, sk, share, err = _inputs(2, P.degree, seed=4)
    pt = np.random.default_rng(5).integers(-2 ** 40, 2 ** 40, (2, P.degree))
    got_pte = tlw.add_cbd_error(torch.as_tensor(pt),
                                torch.as_tensor(err.astype(np.int64)),
                                P.degree)
    ok_in = np.array([True, False])
    want = jlw.make_from_pte_encryptor(P, "reference")(
        jnp.asarray(got_pte.numpy()), jnp.asarray(sk), jnp.asarray(share),
        ok_in=jnp.asarray(ok_in))
    args = (got_pte, torch.as_tensor(sk.astype(np.int64)),
            torch.as_tensor(share.astype(np.int64)))
    got = tlw.make_from_pte_encryptor(parms_from_jax(P), "reference", device="cpu")(
        *args, torch.as_tensor(ok_in))
    _assert_out_equal(got, want, ("c0", "c1", "pte"))
    direct = tlw.sym_encrypt_from_pte(*args, parms_from_jax(P))
    assert torch.equal(direct["c0"], got["c0"]) and bool(direct["ok"].all())


def test_limbscan_argument_checks():
    pt = parms_from_jax(P)
    with pytest.raises(ValueError):
        tlw.LimbscanEncryptor(pt, layout="sharded", device="cpu")
    with pytest.raises(ValueError):
        tlw.LimbscanEncryptor(pt, order="backward", device="cpu")
    with pytest.raises(ValueError):
        tlw.make_limbscan_encryptor(pt, encode_mode="f16", device="cpu")
    with pytest.raises(ValueError):
        tlw.expand_c1(torch.zeros((1, 16), dtype=torch.int64), pt, "x")


@pytest.mark.parametrize("n,nprimes", [(1024, 1), (4096, 3)])
def test_limbscan_golden(n, nprimes):
    """The reference layout reproduces the C reference's c0/c1/pt/pte, and
    expand_c1 its c1; the module equals SymEncryptor."""
    data = np.load(REPO / "tests" / f"golden_sym_{n}_{nprimes}.npz")
    G = 2
    vs = np.stack([data[f"v_{t}"] for t in range(G)])
    sk = unpack_sk(data["sk_packed_0"], n)
    share = np.tile(jkc.seed_to_words(seed_bytes(2)), (G, 1))
    err = np.tile(jkc.seed_to_words(seed_bytes(3)), (G, 1))
    parms = tcfg.default_parms(n, nprimes)
    args = state_to_device(vs, sk, share, err, device="cpu")
    out = tlw.make_limbscan_encryptor(parms, "reference", "sf", device="cpu")(*args)
    assert out["ok"].all()
    c1, ok = tlw.expand_c1(args[2], parms)
    assert bool(ok.all()) and torch.equal(c1, out["c1"])
    for t in range(G):
        assert np.array_equal(out["pt"][t].numpy(), data[f"pt_{t}"]), t
        assert np.array_equal(out["pte"][t].numpy(), data[f"pte_{t}"]), t
        for i in range(nprimes):
            assert np.array_equal(out["c0"][i, t].numpy(),
                                  data[f"c0_{nprimes * t + i}"]), (t, i)
            assert np.array_equal(out["c1"][i, t].numpy(),
                                  data[f"c1_{nprimes * t + i}"]), (t, i)
    fused = SymEncryptor(parms, device="cpu")(*args)
    for k in ("c0", "c1", "pt", "pte", "ok"):
        assert torch.equal(out[k], fused[k]), k
