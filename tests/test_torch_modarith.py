"""Port's modular arithmetic vs seal_embedded_tpu.ops.modarith, bit for bit.

Inputs are numpy arrays from a seeded generator, handed to both sides:
random u32 values plus the edges 0, 1, q-1, q, q+1, 2q-1, 4q-1, 2^31 and
2^32-1, and for reduce_pte_i64 signed values around multiples of q."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.config import PRIMES_27BIT, PRIMES_30BIT, barrett_quotient
from seal_embedded_tpu.ops import modarith as jma
from seal_embedded_tpu_torch.ops import modarith as tma

torch.set_num_threads(2)

MODULI = (PRIMES_27BIT[0], PRIMES_30BIT[0], PRIMES_30BIT[12])
SIZE = 4096


def _u32(rng, q, size=SIZE):
    x = rng.integers(0, 2 ** 32, size, dtype=np.int64)
    edges = [0, 1, q - 1, q, q + 1, 2 * q - 1, 4 * q - 1, 2 ** 31, 2 ** 32 - 1]
    x[:len(edges)] = edges
    return x


def _below(rng, bound, size=SIZE):
    x = rng.integers(0, bound, size, dtype=np.int64)
    x[:3] = [0, 1, bound - 1]
    return x


def _jax(fn, *args):
    return np.asarray(fn(*(jnp.asarray(a.astype(np.uint32))
                           if isinstance(a, np.ndarray) else a
                           for a in args))).astype(np.int64)


def _torch(fn, *args):
    return fn(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                for a in args)).numpy()


@pytest.mark.parametrize("q", MODULI)
def test_mullo_mulhi(q):
    rng = np.random.default_rng(q)
    a, b = _u32(rng, q), _u32(rng, q)[::-1].copy()
    assert np.array_equal(_torch(tma.mullo, a, b), _jax(jma.mullo, a, b))
    assert np.array_equal(_torch(tma.mulhi, a, b), _jax(jma.mulhi, a, b))


@pytest.mark.parametrize("q", MODULI)
def test_barrett32_and_wide(q):
    rng = np.random.default_rng(q + 1)
    x = _u32(rng, q)
    assert np.array_equal(_torch(tma.barrett32, x, q),
                          _jax(jma.barrett32, x, q))
    lo, hi = _u32(rng, q), _u32(rng, q)
    assert np.array_equal(_torch(tma.barrett_wide, lo, hi, q),
                          _jax(jma.barrett_wide, lo, hi, q))


@pytest.mark.parametrize("q", MODULI)
def test_mul_add_neg_sub_mod(q):
    rng = np.random.default_rng(q + 2)
    a, b = _u32(rng, q), _u32(rng, q)[::-1].copy()
    assert np.array_equal(_torch(tma.mul_mod, a, b, q),
                          _jax(jma.mul_mod, a, b, q))
    ra, rb = _below(rng, q), _below(rng, q)[::-1].copy()
    assert np.array_equal(_torch(tma.add_mod, ra, rb, q),
                          _jax(jma.add_mod, ra, rb, q))
    na = _below(rng, q + 1)     # neg_mod takes a <= q
    assert np.array_equal(_torch(tma.neg_mod, na, q), _jax(jma.neg_mod, na, q))
    assert np.array_equal(_torch(tma.sub_mod, ra, na, q),
                          _jax(jma.sub_mod, ra, na, q))


@pytest.mark.parametrize("q", MODULI)
def test_mul_mod_shoup(q):
    rng = np.random.default_rng(q + 3)
    x = _u32(rng, q)
    y = _below(rng, q)
    yq = np.array([barrett_quotient(int(v), q) & 0xFFFFFFFF for v in y],
                  dtype=np.int64)
    assert np.array_equal(_torch(tma.mul_mod_shoup_lazy, x, y, yq, q),
                          _jax(jma.mul_mod_shoup_lazy, x, y, yq, q))
    assert np.array_equal(_torch(tma.mul_mod_shoup, x, y, yq, q),
                          _jax(jma.mul_mod_shoup, x, y, yq, q))
    assert np.array_equal(_torch(tma.shoup_quotient, y, q), yq)


def _pte_values(rng, q):
    x = rng.integers(-2 ** 62, 2 ** 62, SIZE, dtype=np.int64)
    k = rng.integers(-2 ** 20, 2 ** 20, 64, dtype=np.int64)
    edges = np.concatenate([
        [0, 1, -1, q, -q, 2 * q, -2 * q, q - 1, -(q - 1),
         np.iinfo(np.int64).max, np.iinfo(np.int64).min + 1,
         np.iinfo(np.int64).min],
        k * q, -(k * q) - 1])
    x[:edges.size] = edges
    return x


@pytest.mark.parametrize("q", MODULI)
def test_reduce_pte_i64(q):
    """Including the reference's quirk: x < 0 with |x| % q == 0 gives q."""
    x = _pte_values(np.random.default_rng(q + 4), q)
    want = np.asarray(jma.reduce_pte_i64(jnp.asarray(x), q)).astype(np.int64)
    got = tma.reduce_pte_i64(torch.as_tensor(x), q).numpy()
    assert np.array_equal(got, want)
    assert (got == q).any()


def test_reduce_pte_i64_per_limb_mod():
    """Per-limb constants as (L, 1, 1) tensors, as SymEncryptor uses them."""
    x = _pte_values(np.random.default_rng(5), MODULI[1]).reshape(1, 4, -1)
    mods = tma.modpack(MODULI)
    mods_b = tma.Mod(*(f[:, None, None] for f in mods))
    got = tma.reduce_pte_i64(torch.as_tensor(x), mods_b).numpy()
    for i, q in enumerate(MODULI):
        want = np.asarray(jma.reduce_pte_i64(jnp.asarray(x[0]), q))
        assert np.array_equal(got[i], want.astype(np.int64)), q
    jm = jma.modpack(MODULI)
    for f in tma.Mod._fields:
        assert np.array_equal(getattr(mods, f).numpy(),
                              getattr(jm, f).astype(np.int64)), f
