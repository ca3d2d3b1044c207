"""KK's ternary role (``ops/kernels/keccak.py`` ``ternary_draw``) on the
CPU: its walk (``tests/ternary_walk.py``, the kernel's indexing in
sequence) against the role's plain version
(``ops.sampling.sample_ternary_exact``'s loop), the C loop's NumPy
reference (``benchmark/reference``) and the JAX package's bounded
``sample_ternary`` where its ok is true; windows forced down to 1
counter, counters that carry across 2^32 and wrap at 2^64, and made-up
bytes whose blocks need more than 32 refills.  The kernel itself runs
only on the card (``chip_smoke.py``'s ternary role check)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import sampling as rsp
from seal_embedded_tpu.ops import sampling as jsp
from seal_embedded_tpu_torch.ops import keccak as kc
from seal_embedded_tpu_torch.ops import sampling as tsp
from seal_embedded_tpu_torch.ops.kernels import keccak as kk
from ternary_walk import MASK32, c_loop, kernel_walk, shake_squeeze

torch.set_num_threads(2)

PLANTED = (8337867, 2647653)    # > 8 refills in their first block
CARRY, WRAP = 2 ** 32 - 3, 2 ** 64 - 3


def _seeds(n_random: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return ([v.to_bytes(8, "little").ljust(64, b"\x00") for v in PLANTED]
            + [rng.bytes(64) for _ in range(n_random)])


def _words(seeds) -> np.ndarray:
    return np.stack([kc.seed_to_words(s) for s in seeds]).astype(np.int64)


def _pairs(counters) -> np.ndarray:
    return np.array([[c & MASK32, c >> 32] for c in counters],
                    dtype=np.int64)


def _value(pair) -> int:
    return int(pair[0]) | int(pair[1]) << 32


def _walks(seeds, counters, n, window):
    words = _words(seeds)
    return [kernel_walk(shake_squeeze(w), n, c, window)
            for w, c in zip(words, counters)]


@pytest.mark.parametrize("n", [96, 160, 4096, 8192, 16384])
def test_the_walk_equals_the_plain_version_and_the_c_loop(n):
    """Both planted seeds and two more, at counters 0, 2^32 - 3 (the
    carry into hi) and 2^64 - 3 (the wrap), under the window ternary_shape
    gives: every value and next counter of the walk equals
    sample_ternary_exact's loop and the C loop's reference (tails 0, 64,
    64, 32 and 64)."""
    seeds = _seeds(2, n)
    counters = [0, CARRY, WRAP, 7]
    window = kk.ternary_shape(n, len(seeds))[0]
    u, after = tsp.sample_ternary_exact(torch.as_tensor(_words(seeds)),
                                        torch.as_tensor(_pairs(counters)), n)
    for i, (got, nxt, squeezed) in enumerate(_walks(seeds, counters, n,
                                                    window)):
        assert np.array_equal(got, u[i].numpy()), i
        assert nxt == _value(after[i]), i
        prng = rsp.Prng(seeds[i], counters[i])
        assert np.array_equal(got, rsp.ternary(prng, n)), i
        assert nxt == prng.counter, i
        assert squeezed == window, i     # one window held the draw


@pytest.mark.parametrize("n", [96, 160, 4096, 8192, 16384])
def test_the_walk_equals_jax_where_its_ok_holds(n):
    """The JAX package bounds the refills at 8 a block: where its ok is
    true (every row but the planted seeds' at n >= 96) the walk gives its
    values and next counter."""
    seeds = _seeds(3, n + 1)
    counters = [0, 0, CARRY, WRAP, 11]
    words, pairs = _words(seeds), _pairs(counters)
    vals, nxt, ok = jax.jit(lambda s, c: jsp.sample_ternary(s, c, n))(
        jnp.asarray(words.astype(np.uint32)),
        jnp.asarray(pairs.astype(np.uint32)))
    vals, nxt, ok = (np.asarray(x).astype(np.int64) for x in (vals, nxt, ok))
    assert ok.tolist() == [False, False, True, True, True]
    window = kk.ternary_shape(n, len(seeds))[0]
    for i, (got, after, _) in enumerate(_walks(seeds, counters, n, window)):
        if ok[i]:
            assert np.array_equal(got, vals[i]), i
            assert after == _value(nxt[i]), i


@pytest.mark.parametrize("window", [1, 2, 33, 97])
def test_forced_windows_squeeze_again_and_change_nothing(window):
    """A window far below the draw's counters: the walk stops at the
    window's end, in a block's refills too, and the CTA squeezes again;
    the bits and the next counter stay the C loop's, the counters
    carrying and wrapping inside the draw."""
    n = 4096
    seeds = _seeds(1, window)
    counters = [CARRY - 5, WRAP - 4, 3]
    for i, (got, nxt, squeezed) in enumerate(_walks(seeds, counters, n,
                                                    window)):
        prng = rsp.Prng(seeds[i], counters[i])
        assert np.array_equal(got, rsp.ternary(prng, n)), i
        assert nxt == prng.counter, i
        assert squeezed > window and squeezed % window == 0, i
        assert squeezed - ((nxt - counters[i]) % 2 ** 64) <= window + 32, i


def _made_up(stream: int, reject_share: float):
    """squeeze(counters) of made-up bytes: each byte of a counter's block
    0xFE or 0xFF with probability reject_share, from a generator seeded by
    the stream and the counter."""
    def squeeze(counters):
        out = np.empty((len(counters), 24), dtype=np.int64)
        for k, c in enumerate(counters):
            rng = np.random.default_rng([stream, c & MASK32, c >> 32])
            by = rng.integers(0, 0xFE, 96)
            hit = rng.random(96) < reject_share
            by[hit] = 0xFE + rng.integers(0, 2, int(hit.sum()))
            out[k] = by.reshape(24, 4) @ (1 << (8 * np.arange(4)))
        return out
    return squeeze


@pytest.mark.parametrize("window", [1, 33, 97, 425])
@pytest.mark.parametrize("n", [300, 1000])
def test_blocks_that_need_more_than_32_refills(n, window):
    """Half of the bytes rejected, base and refills alike: a block needs
    about 96 refills, so the walk takes several 32-refill steps a block
    and stops in the middle of a block's refills.  Values and next
    counter equal the C loop's over the same bytes."""
    for stream, c0 in ((1, 0), (2, WRAP - 40)):
        squeeze = _made_up(stream, 0.5)
        got, nxt, _ = kernel_walk(squeeze, n, c0, window)
        want, after, most = c_loop(squeeze, n, c0)
        assert np.array_equal(got, want)
        assert nxt == after
        assert most > 2 * 32


@pytest.mark.parametrize("n", [96, 1024, 4096, 16384, 32768])
@pytest.mark.parametrize("streams", [1, 16, 512, 1024])
def test_the_role_shape(n, streams):
    """The window covers the bases, the refills' mean plus 8 spreads and
    the walk's look-ahead (up to the largest ring shared memory holds),
    is odd, and its ring fits 48 KiB; threads are whole warps, at most
    512, and never more than a window needs."""
    window, threads = kk.ternary_shape(n, streams)
    r = 2 / 256
    need = (-(-n // 96) + n * r / (1 - r)
            + 8 * math.sqrt(n * r) / (1 - r) + 32)
    assert window % 2 == 1 and window <= kk.TERNARY_MAX_WINDOW
    assert window >= min(need, kk.TERNARY_MAX_WINDOW)
    assert (window + 32) * 96 + 400 <= 48 * 1024
    assert threads % 32 == 0 and 32 <= threads <= 512
    assert threads <= 32 * -(-window // 32)
    if streams >= 512:
        assert threads == min(128, 32 * -(-window // 32))


def test_ternary_draw_is_cuda_only():
    seeds = torch.zeros((2, 16), dtype=torch.int64)
    counters = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kk.ternary_draw(seeds, counters, 96)
    with pytest.raises(ValueError, match="window"):
        kk.ternary_launch(seeds, counters, 96, kk.TERNARY_MAX_WINDOW + 1,
                          128)
