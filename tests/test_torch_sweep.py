"""The port's config-matrix sweep (seal_embedded_tpu_torch.sweep, the
port of sweep_configs.py) on the CPU: its quick matrix at degree 256,
batch 3 passes, its baseline is the JAX sym_encrypt_limbscan's
ciphertext on the same inputs, and every config specified bit-exact
equals that baseline."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.ckks.limbwise import sym_encrypt_limbscan
from seal_embedded_tpu.config import Parms as JParms
from seal_embedded_tpu_torch.sweep import run_sweep, sweep_inputs, sweep_parms

torch.set_num_threads(2)

BIT_EXACT = ("fused", "stream order=forward", "batch ntt=table",
             "batch ntt=otf", "batch data=loaded(index_map,ifft_roots)",
             "asym batch==stream", "decrypt intt=lazy(loaded fast tables)")


@pytest.fixture(scope="module")
def sweep():
    return run_sweep(degree=256, batch=3, quick=True, device="cpu")


def test_quick_sweep_passes(sweep):
    assert sweep.ok
    assert len(sweep.results) == 3 + len(BIT_EXACT)


def test_baseline_is_jax_limbscan(sweep):
    p = sweep_parms(256)
    args = sweep_inputs(p, 3, np.random.default_rng(0))
    want = jax.jit(partial(sym_encrypt_limbscan, parms=JParms(
        degree=p.degree, moduli=p.moduli, scale=p.scale),
        layout="reference", encode_mode="f64"))(
        *(jnp.asarray(a) for a in args))
    for got, key in zip(sweep.baseline, ("c0", "c1")):
        assert np.array_equal(got, np.asarray(want[key]).astype(np.int64))


@pytest.mark.parametrize("name", BIT_EXACT)
def test_bit_exact_config(sweep, name):
    [(_, passed, worst, match)] = [r for r in sweep.results if r[0] == name]
    assert passed and match is True and worst < 0.1
