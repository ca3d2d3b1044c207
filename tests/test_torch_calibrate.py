"""The port's op-mix calibration loops (the CPU path of kernel KC) against
seal_embedded_tpu.ops.kernels.calibrate.run_mix, the K7 Pallas kernel in
interpret mode, bit for bit."""

import numpy as np
import pytest
import torch

from seal_embedded_tpu.ops.kernels import calibrate as jcal
from seal_embedded_tpu_torch.ops import calibrate as tcal
from seal_embedded_tpu_torch.ops.kernels import calibrate as kcal

torch.set_num_threads(2)


@pytest.mark.parametrize("mix", ["keccak", "ntt"])
@pytest.mark.parametrize("iters", [8, 64])
@pytest.mark.parametrize("nchain", [8, 4])
def test_mix_vs_jax_interpret(mix, iters, nchain):
    """Tile 0 of the port's input is the JAX input, so tile 0 of the
    output is the JAX output; mix_plain and the KC wrapper's CPU path
    agree on every tile."""
    want = np.asarray(jcal.run_mix(mix, iters, nchain=nchain)())
    x = kcal.mix_input(nchain, tiles=2, device="cpu")
    got = kcal.run_mix(mix, iters, nchain=nchain, tiles=2, device="cpu")()
    assert got.shape == (2, nchain, 1024)
    assert np.array_equal(got[0].numpy(),
                          want.reshape(nchain, 1024).astype(np.int64))
    assert torch.equal(got, tcal.mix_plain(x, mix, iters))
    assert not torch.equal(got[0], got[1])


def test_mix_input_tile0_is_jax_input():
    jx = np.random.default_rng(0).integers(0, 2 ** 31, (8, 8, 128))
    x = kcal.mix_input(8, tiles=3, device="cpu")
    assert x.dtype == torch.int64 and x.shape == (3, 8, 1024)
    assert np.array_equal(x[0].numpy(), jx.reshape(8, 1024))


def test_ops_per_iter():
    assert tcal.ops_per_iter("keccak") == jcal.ops_per_iter("keccak") == 64
    assert tcal.ops_per_iter("ntt") == jcal.ops_per_iter("ntt") == 80
    for nchain in (1, 3, 16):
        assert tcal.ops_per_iter("keccak", nchain) == \
            jcal.ops_per_iter("keccak", nchain)
    for nchain in (2, 4, 16):
        assert tcal.ops_per_iter("ntt", nchain) == \
            jcal.ops_per_iter("ntt", nchain)


def test_bad_mix_arguments_raise():
    for nchain in (1, 3, 7):
        with pytest.raises(ValueError):
            tcal.ops_per_iter("ntt", nchain)
        with pytest.raises(ValueError):
            kcal.run_mix("ntt", 8, nchain=nchain)
    with pytest.raises(ValueError):
        tcal.ops_per_iter("fft")
    x = kcal.mix_input(8, device="cpu")
    with pytest.raises(ValueError):
        kcal.calib_mix(x, "keccak", 12)           # not a multiple of 8
    with pytest.raises(ValueError):
        kcal.calib_mix(kcal.mix_input(17, device="cpu"), "keccak",
                       8)                                 # > 16 chains
    with pytest.raises(ValueError):
        kcal.calib_mix(x.to(torch.int32), "keccak", 8)
    with pytest.raises(ValueError):
        kcal.calib_mix(x[:, :, :512], "keccak", 8)


def test_share_reckoning():
    """bench.py's conventions: 20 source ops per butterfly, 10.3e3 per
    Keccak-f permutation."""
    # 1 NTT of (1, 1, 4096): 2048 * 12 butterflies in 1 ms against a
    # ceiling of exactly that many butterflies per second.
    bfly = 2048 * 12
    assert kcal.ntt_butterflies(1, 1, 4096) == bfly
    assert kcal.ntt_butterflies(3, 2, 4096, ntts=3) == 18 * bfly
    assert kcal.ntt_share(bfly, 1.0, bfly * 1e3 * 20) == pytest.approx(1.0)
    assert kcal.ntt_share(3 * bfly, 1.0, bfly * 1e3 * 20) == \
        pytest.approx(3.0)
    assert kcal.keccak_share(1000, 1.0, 1e6 * 10.3e3) == pytest.approx(1.0)
