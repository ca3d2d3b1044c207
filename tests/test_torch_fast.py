"""The port's symmetric encode + encrypt slice on its CPU path: against
seal_embedded_tpu.ckks.fast.sym_encrypt_fused on the same numpy inputs,
against the C-reference golden vectors, and the package boundary (config
equal to the JAX package's; no jax imported)."""

import dataclasses
import pathlib
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks.fast import sym_encrypt_fused as jax_sym
from seal_embedded_tpu.ops import keccak as jkc
from seal_embedded_tpu_torch import config as tcfg
from seal_embedded_tpu_torch.ckks.fast import SymEncryptor, sym_encrypt_fused
from seal_embedded_tpu_torch.convert import (parms_from_jax, state_to_device,
                                             unpack_sk)

from conftest import seed_bytes

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
P1K = jcfg.Parms(degree=1024, moduli=jcfg.PRIMES_27BIT[:2], scale=2.0 ** 20)


def _inputs(B, n, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, (B, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32)
    return values, sk, share, err


def test_sym_encrypt_matches_jax_fused():
    values, sk, share, err = _inputs(3, P1K.degree)
    want = jax.jit(partial(jax_sym, parms=P1K, encode_mode="f64"))(
        *(jnp.asarray(a) for a in (values, sk, share, err)))
    got = sym_encrypt_fused(*state_to_device(values, sk, share, err, device="cpu"),
                            parms_from_jax(P1K), encode_mode="f64")
    assert bool(np.asarray(want["ok"]).all())
    assert np.array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    for k in ("c0", "c1", "pte", "pt"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(np.int64)), k


def test_make_fused_encryptor_vs_jax():
    """The factory with the JAX call signature: one SymEncryptor per
    (parms, device) for every encode mode, equal to the JAX factory's
    jitted function."""
    from seal_embedded_tpu.ckks.fast import make_fused_encryptor as jax_make
    from seal_embedded_tpu_torch.ckks.fast import make_fused_encryptor

    values, sk, share, err = _inputs(3, P1K.degree, seed=5)
    want = jax_make(P1K, "f64")(*(jnp.asarray(a)
                                  for a in (values, sk, share, err)))
    p = parms_from_jax(P1K)
    fn = make_fused_encryptor(p, "f64", device="cpu")
    assert make_fused_encryptor(p, device="cpu") is fn
    got = fn(*state_to_device(values, sk, share, err, device="cpu"))
    for k in ("c0", "c1", "pte", "pt", "ok"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(got[k].numpy().dtype))
    with pytest.raises(ValueError):
        make_fused_encryptor(p, "fast", device="cpu")


@pytest.mark.parametrize("n,nprimes", [(1024, 1), (2048, 1), (4096, 3)])
def test_sym_encryptor_golden(n, nprimes):
    data = np.load(REPO / "tests" / f"golden_sym_{n}_{nprimes}.npz")
    G = sum(1 for k in data.files if k.startswith("v_"))
    vs = np.stack([data[f"v_{t}"] for t in range(G)])
    sk = unpack_sk(data["sk_packed_0"], n)
    share = np.tile(jkc.seed_to_words(seed_bytes(2)), (G, 1))
    err = np.tile(jkc.seed_to_words(seed_bytes(3)), (G, 1))
    out = SymEncryptor(tcfg.default_parms(n, nprimes), device="cpu")(
        *state_to_device(vs, sk, share, err, device="cpu"))
    assert out["ok"].all()
    for t in range(G):
        assert np.array_equal(out["pt"][t].numpy(), data[f"pt_{t}"]), t
        assert np.array_equal(out["pte"][t].numpy(), data[f"pte_{t}"]), t
        for i in range(nprimes):
            assert np.array_equal(out["c0"][i, t].numpy(),
                                  data[f"c0_{nprimes * t + i}"]), (t, i)
            assert np.array_equal(out["c1"][i, t].numpy(),
                                  data[f"c1_{nprimes * t + i}"]), (t, i)


def test_config_equals_jax_package():
    assert tcfg.PRIMES_27BIT == jcfg.PRIMES_27BIT
    assert tcfg.PRIMES_30BIT == jcfg.PRIMES_30BIT
    assert tcfg.NTT_ROOTS == jcfg.NTT_ROOTS
    for degree, nprimes in ((1024, 1), (2048, 1), (4096, 3), (8192, 6),
                            (16384, 13)):
        assert (dataclasses.astuple(tcfg.default_parms(degree, nprimes))
                == dataclasses.astuple(jcfg.default_parms(degree, nprimes)))
    for n, q in ((64, jcfg.PRIMES_27BIT[0]), (512, jcfg.PRIMES_30BIT[5])):
        assert tcfg.find_ntt_root(n, q) == jcfg.find_ntt_root(n, q)
    for q in jcfg.PRIMES_27BIT + jcfg.PRIMES_30BIT:
        assert tcfg.const_ratio(q) == jcfg.const_ratio(q)
        assert tcfg.barrett_quotient(q - 1, q) == jcfg.barrett_quotient(q - 1, q)
    assert [tcfg.bitrev(i, 9) for i in range(512)] == \
        [jcfg.bitrev(i, 9) for i in range(512)]


def test_convert_helpers():
    data = np.load(REPO / "tests" / "golden_sym_1024_1.npz")
    packed = bytes(data["sk_packed_0"].tolist())
    want = np.array([((packed[i // 4] >> (6 - (i % 4) * 2)) & 3) - 1
                     for i in range(1024)], dtype=np.int32)
    assert np.array_equal(unpack_sk(data["sk_packed_0"], 1024), want)
    p = parms_from_jax(P1K)
    assert isinstance(p, tcfg.Parms)
    assert dataclasses.astuple(p) == dataclasses.astuple(P1K)
    values, sk, share, err = _inputs(2, 64)
    tv, tsk, tshare, terr = state_to_device(values, sk, share, err,
                                             device="cpu")
    assert tv.dtype == torch.float32 and tsk.dtype == torch.int64
    assert terr.dtype == torch.int64
    assert np.array_equal(tshare.numpy(), share.astype(np.int64))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax or
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import seal_embedded_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('seal_embedded_tpu.')\n"
        "       or m == 'seal_embedded_tpu']\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
