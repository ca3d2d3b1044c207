"""Port's plain encode (the CPU path of kernel KE) vs the JAX package's
IEEE f64 encode and its software-f64 encode_sf, bit for bit, plus the
index map and twiddle tables."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.config import PRIMES_27BIT, Parms, default_parms
from seal_embedded_tpu.golden import encode as golden_encode
from seal_embedded_tpu.ops import encode as jenc
from seal_embedded_tpu_torch.convert import parms_from_jax
from seal_embedded_tpu_torch.ops import encode as tenc
from seal_embedded_tpu_torch.ops.kernels.encode import encode_f64

torch.set_num_threads(2)


def _values(n, rows, seed):
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, (rows, n // 2)).astype(np.float32)
    values[0, :4] = [0.0, -0.0, 1e-44, -1e-38]   # zero / f32-subnormal
    values[1] = -0.0
    return values


@pytest.mark.parametrize("n", [256, 1024, 4096, 8192, 16384])
def test_encode_vs_jax_f64_and_sf(n):
    """Three rows at each degree, 8192 and 16384 included (the degrees KE
    runs in one block per row and as a cluster of two)."""
    moduli = PRIMES_27BIT[:2] if n <= 4096 else default_parms(n, 2).moduli
    jparms = Parms(degree=n, moduli=moduli, scale=2.0 ** 20)
    parms = parms_from_jax(jparms)
    values = _values(n, 3, n)
    got, ok = tenc.encode(torch.as_tensor(values), parms)
    want, wok = jax.jit(partial(jenc.encode, parms=jparms))(
        jnp.asarray(values))
    assert ok.all() and bool(np.asarray(wok).all())
    assert np.array_equal(got.numpy(), np.asarray(want))
    sf, sok = jax.jit(partial(jenc.encode_sf, parms=jparms))(
        jnp.asarray(values))
    assert bool(np.asarray(sok).all())
    assert np.array_equal(got.numpy(), np.asarray(sf))


def test_encode_vs_golden_model_partial_vector():
    """Fewer values than slots, against the numpy oracle of golden/."""
    jparms = Parms(degree=1024, moduli=PRIMES_27BIT[:1], scale=2.0 ** 20)
    vals = np.random.default_rng(5).uniform(-3, 3, 300).astype(np.float32)
    got, ok = tenc.encode(torch.as_tensor(vals[None]), parms_from_jax(jparms))
    assert ok.all()
    assert np.array_equal(got[0].numpy(),
                          golden_encode.encode_base(jparms, vals))


def test_encode_overflow_flag_vs_jax():
    """Rows past |coeff| <= 2^63 are flagged on both sides; values are
    compared only where ok holds (the cast of an overflowed row is not
    defined)."""
    jparms = Parms(degree=256, moduli=PRIMES_27BIT[:1], scale=2.0 ** 40)
    values = _values(256, 4, 3)
    values[2] *= np.float32(1e25)
    values[3] *= np.float32(3e38)
    got, ok = tenc.encode(torch.as_tensor(values), parms_from_jax(jparms))
    want, wok = jax.jit(partial(jenc.encode, parms=jparms))(
        jnp.asarray(values))
    assert np.array_equal(ok.numpy(), np.asarray(wok))
    assert ok.tolist() == [True, True, False, False]
    assert np.array_equal(got[:2].numpy(), np.asarray(want)[:2])


@pytest.mark.parametrize("n", [16, 1024, 16384])
def test_index_map_and_twiddles_vs_jax(n):
    assert np.array_equal(tenc.calc_index_map(n, n.bit_length() - 1),
                          golden_encode.calc_index_map(n, n.bit_length() - 1))
    assert np.array_equal(tenc.index_map_np(n), jenc.index_map_np(n))
    mine, theirs = tenc.ifft_root_tables(n), jenc.ifft_root_tables(n)
    assert len(mine) == len(theirs)
    for (re, im), (jre, jim) in zip(mine, theirs):
        assert re.tobytes() == jre.tobytes() and im.tobytes() == jim.tobytes()
    flat_re, flat_im = tenc.ifft_tables_flat(n)
    for r, (re, im) in enumerate(theirs):
        off = n - (n >> r)
        assert flat_re[off:off + re.size].tobytes() == re.tobytes()
        assert flat_im[off:off + im.size].tobytes() == im.tobytes()


def test_encode_any_modes_and_wrapper_checks():
    parms = parms_from_jax(Parms(degree=256, moduli=PRIMES_27BIT[:1],
                                 scale=2.0 ** 20))
    v = torch.as_tensor(_values(256, 2, 1))
    ref, _ = tenc.encode(v, parms)
    for mode in tenc.ENCODE_MODES:
        got, ok = tenc.encode_any(v, parms, mode)
        assert ok.all() and torch.equal(got, ref)
    with pytest.raises(ValueError):
        tenc.encode_any(v, parms, "f32")
    imap, tw_re, tw_im = tenc.table_tensors(256)
    sn = tenc.scale_over_n(parms)
    got, ok = encode_f64(v, imap, tw_re, tw_im, sn)
    assert ok.all() and torch.equal(got, ref)
    with pytest.raises(ValueError):
        encode_f64(v.double(), imap, tw_re, tw_im, 1.0)
    with pytest.raises(ValueError):
        encode_f64(torch.zeros((1, 129)), imap, tw_re, tw_im, 1.0)
    with pytest.raises(ValueError):
        encode_f64(v, imap.long(), tw_re, tw_im, 1.0)
    with pytest.raises(ValueError):
        encode_f64(v, imap, tw_re[:-1], tw_im, 1.0)
