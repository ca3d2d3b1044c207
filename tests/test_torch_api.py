"""The port's public API (api.py) on the CPU against seal_embedded_tpu.api
on the same seeds and values: keys, ciphertexts and sent bytes bit for
bit, decode within a stated tolerance; plus the three API faults of the
JAX package (ROADMAP R3) that the port does not copy."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import api as japi
from seal_embedded_tpu.io import network as jnet
from seal_embedded_tpu.io import serialize as jser
from seal_embedded_tpu.ops.encode import decode as jdecode
from seal_embedded_tpu_torch import api as tapi
from seal_embedded_tpu_torch import graphs
from seal_embedded_tpu_torch.ckks.fast import SymEncryptor
from seal_embedded_tpu_torch.ckks.limbwise import expand_c1
from seal_embedded_tpu_torch.ckks.sym import decrypt_batch
from seal_embedded_tpu_torch.config import default_parms
from seal_embedded_tpu_torch.convert import context_from_jax, unpack_sk
from seal_embedded_tpu_torch.io import network as tnet
from seal_embedded_tpu_torch.io import serialize as tser
from seal_embedded_tpu_torch.ops import keccak as kc
from seal_embedded_tpu_torch.ops.encode import decode as tdecode

from conftest import GOLDEN_DIR, seed_bytes

torch.set_num_threads(2)

N, L, SCALE = 1024, 1, 2.0 ** 20
B = 2
CPU = torch.device("cpu")


def _values(seed=0, width=N // 2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, width)).astype(np.float32)


@lru_cache(maxsize=None)
def _contexts(kind):
    """(JAX context, port context) made by se_setup_custom from the same
    seeds: sym from sk_seed, asym from sk_seed + pk_seed."""
    kw = {"sk_seed": seed_bytes(1)}
    if kind == tapi.ASYM:
        kw["pk_seed"] = seed_bytes(4)
    return (japi.se_setup_custom(N, L, SCALE, kind, **kw),
            tapi.se_setup_custom(N, L, SCALE, kind, device=CPU, **kw))


def _assert_out_equal(got, want):
    for k in ("c0", "c1", "pt", "pte", "ok"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(
                                  got[k].numpy().dtype)), k


# ------------------------------------------------------------------ setup

def test_setup_from_sk_seed_and_sk_path(tmp_path):
    jctx, ctx = _contexts(tapi.SYM)
    assert ctx.sk_signed.dtype == np.int32
    assert np.array_equal(ctx.sk_signed, jctx.sk_signed)
    assert torch.equal(ctx._sk, torch.as_tensor(jctx.sk_signed.astype(np.int64)))
    assert np.array_equal(tapi.sample_sk_from_seed(ctx.parms, seed_bytes(9)),
                          japi.sample_sk_from_seed(jctx.parms, seed_bytes(9)))
    path = tmp_path / f"sk_{N}.dat"
    tser.write_sk(str(path), tser.pack_ternary(
        tser.signed_to_file_ternary(ctx.sk_signed)))
    from_file = tapi.se_setup_custom(N, L, SCALE, tapi.SYM, sk_path=str(path),
                                     device=CPU)
    jfrom_file = japi.se_setup_custom(N, L, SCALE, japi.SYM, sk_path=str(path))
    assert np.array_equal(from_file.sk_signed, jfrom_file.sk_signed)
    assert np.array_equal(from_file.sk_signed, ctx.sk_signed)
    assert isinstance(from_file._sym_fn.fn, SymEncryptor)
    assert from_file._asym_fn is None and from_file._pk is None


def test_setup_asym_from_pk_seed_and_pk_dir(tmp_path):
    jctx, ctx = _contexts(tapi.ASYM)
    for k in ("pk0", "pk1"):
        got = getattr(ctx, k)
        assert got.dtype == np.uint32 and got.shape == (L, N)
        assert np.array_equal(got, getattr(jctx, k)), k
    # The context holds the pk on its device; the encryptor takes it per
    # call, with its Shoup quotients.
    assert torch.equal(ctx._pk[0], torch.as_tensor(ctx.pk0.astype(np.int64)))
    assert ctx._asym_fn.encryptor.pk1_quot.shape == (L, N)
    jser.write_pk(str(tmp_path), jctx.parms,
                  list(zip(jctx.pk0, jctx.pk1)))
    loaded = tapi.se_setup_custom(N, L, SCALE, tapi.ASYM, pk_dir=str(tmp_path),
                                  device=CPU)
    assert loaded.sk_signed is None and loaded._sk is None
    assert np.array_equal(loaded.pk0, jctx.pk0)
    assert np.array_equal(loaded.pk1, jctx.pk1)
    with pytest.raises(ValueError, match="need sk"):
        tapi.se_setup_custom(N, L, SCALE, tapi.ASYM, device=CPU)


def test_setup_defaults_and_context_from_jax():
    ctx = tapi.se_setup(1024, 1, device="cpu", sk_seed=seed_bytes(1))
    assert ctx.parms == default_parms(1024, 1) and ctx.degree == N
    assert ctx.device == CPU and ctx.encrypt_type == tapi.SYM
    jctx = _contexts(tapi.ASYM)[0]
    conv = context_from_jax(jctx, "cpu")
    assert conv.parms == _contexts(tapi.ASYM)[1].parms
    assert conv.encrypt_type == tapi.ASYM and conv.encode_mode == "auto"
    for k in ("sk_signed", "pk0", "pk1"):
        assert np.array_equal(getattr(conv, k), getattr(jctx, k))
        assert not np.shares_memory(getattr(conv, k), getattr(jctx, k))


def test_setup_default_device_is_cuda():
    """The default device is cuda, with no CPU switch: set-up raises where
    there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tapi.SEContext(default_parms(4096, 3), tapi.SYM).device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        tapi.se_setup_default(tapi.SYM, sk_seed=seed_bytes(1))


# ---------------------------------------------------------------- encrypt

@pytest.mark.parametrize("kind,send_mode", [
    (tapi.SYM, "none"), (tapi.SYM, "send"), (tapi.SYM, "seed_only"),
    (tapi.ASYM, "none"), (tapi.ASYM, "send")])
def test_se_encrypt_seeded_vs_jax(kind, send_mode):
    jctx, ctx = _contexts(kind)
    values = _values(1, width=300)     # padded to n/2 by both
    share = [seed_bytes(10 + b) for b in range(B)]
    seeds = [seed_bytes(20 + b) for b in range(B)]
    jsend, jstore = jnet.collecting_sender()
    tsend, tstore = tnet.collecting_sender()
    kw = {"send_seed_only": send_mode == "seed_only"}
    want = japi.se_encrypt_seeded(jctx, values, share, seeds,
                                  send=jsend if send_mode != "none" else None,
                                  **kw)
    got = tapi.se_encrypt_seeded(ctx, values, share, seeds,
                                 send=tsend if send_mode != "none" else None,
                                 **kw)
    _assert_out_equal(got, want)
    assert bool(got["ok"].all())
    assert tstore == jstore
    if send_mode == "send":
        assert len(tstore) == 2 * L * B
        for b in range(B):
            assert np.array_equal(tser.ct_component_from_bytes(tstore[2 * b]),
                                  got["c0"][0, b].numpy())
    if send_mode == "seed_only":
        assert len(tstore) == B
        for b in range(B):
            seed, c0 = tser.seeded_ct_parse(tstore[b])
            assert seed == share[b]
            words = torch.as_tensor(kc.seed_to_words(seed)[None].astype(np.int64))
            c1, ok = expand_c1(words, ctx.parms)
            assert bool(ok.all())
            assert torch.equal(c1[:, 0], got["c1"][:, b])
            cen = decrypt_batch(torch.as_tensor(c0.astype(np.int64))[:, None],
                                c1, ctx._sk, ctx.parms)
            assert torch.equal(cen[0, 0], got["pte"][b])


def test_se_encrypt_random_seeds_and_checks():
    _, ctx = _contexts(tapi.SYM)
    values = _values(2)
    out = tapi.se_encrypt(ctx, values)
    assert bool(out["ok"].all()) and out["c0"].shape == (L, B, N)
    assert np.abs(tapi.se_decrypt_decode(ctx, out) - values).max() < 1e-3
    with pytest.raises(ValueError, match="n/2"):
        tapi.se_encrypt(ctx, np.zeros((1, N // 2 + 1), np.float32))
    with pytest.raises(ValueError, match="symmetric"):
        tapi.se_encrypt_seeded(_contexts(tapi.ASYM)[1], values,
                               send=lambda d: len(d), send_seed_only=True)
    q = int(ctx.parms.moduli[0])
    c = torch.zeros((L, 1, N), dtype=torch.int64)
    check = tapi._canon_check(ctx.parms)
    assert bool(check(c, c))
    c[0, 0, 7] = q
    assert not bool(check(c, torch.zeros_like(c)))
    assert not bool(check(torch.zeros_like(c), c))


# ------------------------------------------------- input packing, uploads

def _per_seed_words(seeds):
    """The seed words seed by seed: the packing's reference."""
    return np.stack([kc.seed_to_words(s) for s in seeds]).astype(np.int64)


def _outcome(fn, *args):
    """fn's result, or its exception's type and message."""
    try:
        return fn(*args)
    except Exception as e:      # noqa: BLE001 (compared, not handled)
        return type(e), str(e)


def _seed_list(case):
    rng = np.random.default_rng(7)
    seeds = {"b1": 1, "b16": 16, "b1024": 1024}
    if case in seeds:
        return [rng.bytes(64) for _ in range(seeds[case])]
    return {"short_mixed": [rng.bytes(64), rng.bytes(10), b"", rng.bytes(64)],
            "long_65": [rng.bytes(65)],
            "long_68_mixed": [rng.bytes(68), rng.bytes(64)],
            "long_68_all": [rng.bytes(68), rng.bytes(68)],
            "empty": []}[case]


@pytest.mark.parametrize("case", ["b1", "b16", "b1024", "short_mixed",
                                  "long_65", "long_68_mixed", "long_68_all",
                                  "empty"])
def test_seed_words_equal_the_per_seed_stack(case):
    """The packing gives np.stack of seed_to_words bit for bit, in dtype
    and shape, or raises what it raises: from one view of the seeds' join
    where every seed is 64 bytes, seed by seed otherwise."""
    seeds = _seed_list(case)
    want = _outcome(_per_seed_words, seeds)
    got = _outcome(kc.seed_words, seeds)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype == np.int64
        assert got.shape == want.shape and np.array_equal(got, want)
        dev = graphs.to_device(kc.seed_words(seeds), CPU)
        assert dev.dtype == torch.int64
        assert np.array_equal(dev.numpy(), want)
    else:
        assert got == want


def count_pins(monkeypatch) -> list:
    """Every pin_memory() call from here on, in a list (the tensor's
    shape each); a "pinned" tensor is a fresh host copy, as torch's
    caching host allocator hands out a block no pending copy reads."""
    pins = []

    def pin(t):
        pins.append(tuple(t.shape))
        return t.clone()
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    return pins


def fake_pinned(monkeypatch) -> list:
    """The card's upload path (graphs.to_device) on the CPU: every device
    stages through pinned memory.  Returns count_pins's list."""
    monkeypatch.setattr(graphs, "_pinned", lambda device: True)
    return count_pins(monkeypatch)


@pytest.mark.parametrize("seeds,device,paths", [
    ("b16", "cpu", {"seeds.joined": 1}),
    ("short_mixed", "cpu", {"seeds.per_seed": 1}),
    ("long_68_all", "cpu", {"seeds.per_seed": 1}),
    ("b16", "staged", {"seeds.joined": 1}),
    ("short_mixed", "staged", {"seeds.per_seed": 1})])
def test_input_paths_count_each_path(monkeypatch, seeds, device, paths):
    """keccak.input_paths counts a batch of 64-byte seeds as joined and
    any other as seed by seed; their upload stages through pinned memory
    where the device stages (a card) and not on the CPU."""
    pins = (fake_pinned if device == "staged" else count_pins)(monkeypatch)
    seeds = _seed_list(seeds)
    before = kc.input_paths.copy()
    words = graphs.to_device(kc.seed_words(seeds), CPU)
    assert dict(kc.input_paths - before) == paths
    assert pins == ([(len(seeds), 16)] if device == "staged" else [])
    assert np.array_equal(words.numpy(), _per_seed_words(seeds))


@pytest.mark.parametrize("kind,upload", [
    (tapi.SYM, "direct"), (tapi.SYM, "staged"), (tapi.ASYM, "staged")])
def test_back_to_back_streaming_calls_equal_fresh_ones(monkeypatch, kind,
                                                       upload):
    """Three se_encrypt_streaming calls in a row on one context, each with
    its own values and seeds, give the limbs the same calls give one by
    one in fresh contexts: no call reads another's inputs."""
    from seal_embedded_tpu_torch.ckks import stream as tstream
    pins = (fake_pinned if upload == "staged" else count_pins)(monkeypatch)
    kw = {"sk_seed": seed_bytes(1)}
    if kind == tapi.ASYM:
        kw["pk_seed"] = seed_bytes(4)
    rng = np.random.default_rng(11)
    calls = [(_values(60 + k), [rng.bytes(64) for _ in range(B)],
              [rng.bytes(64) for _ in range(B)]) for k in range(3)]
    ctx = tapi.se_setup_custom(N, L, SCALE, kind, device=CPU, **kw)
    before = len(pins)
    together = [tstream.se_encrypt_streaming(ctx, v, share, err)
                for v, share, err in calls]
    uploads = (3 if kind == tapi.SYM else 2) * len(calls)
    assert len(pins) - before == (uploads if upload == "staged" else 0)
    for (v, share, err), got in zip(calls, together):
        fresh = tapi.se_setup_custom(N, L, SCALE, kind, device=CPU, **kw)
        want = tstream.se_encrypt_streaming(fresh, v.copy(), list(share),
                                            list(err))
        assert len(got) == len(want) == L
        for g, w in zip(got, want):
            assert np.array_equal(g["c0"], w["c0"])
            assert np.array_equal(g["c1"], w["c1"])
    assert not all(np.array_equal(together[0][0]["c0"], t[0]["c0"])
                   for t in together[1:])


# ----------------------------------------------------------------- decode

@pytest.mark.parametrize("kind", [tapi.SYM, tapi.ASYM])
def test_se_decrypt_decode_vs_jax(kind):
    """Within atol 1e-9 of the JAX package's decrypt + decode.  Not bit
    for bit: the JAX function runs decode under jit, and XLA's CPU code
    fuses the f64 butterflies and rounds some of them differently (last
    place bits).  Run eagerly, the JAX decode is bit-equal to the port's
    (test_decode_vs_jax)."""
    jctx, ctx = _contexts(kind)
    values = _values(3)
    seeds = [seed_bytes(30 + b) for b in range(B)]
    share = [seed_bytes(40 + b) for b in range(B)]
    want = japi.se_decrypt_decode(jctx, japi.se_encrypt_seeded(
        jctx, values, share, seeds))
    got = tapi.se_decrypt_decode(ctx, tapi.se_encrypt_seeded(
        ctx, values, share, seeds))
    assert got.dtype == np.float64 and got.shape == (B, N // 2)
    assert np.allclose(got, want, rtol=0, atol=1e-9)
    # The asym noise (pk error times u, plus e0 and e1) is larger than the
    # sym CBD error: 0.018 here at scale 2^20.
    assert np.abs(got - values).max() < (1e-3 if kind == tapi.SYM else 0.05)


def test_decode_vs_jax():
    """ops.encode.decode against the JAX decode run eagerly on the same
    signed coefficients (a batch and a single row), bit for bit: the same
    f64 operations in the same order, each rounded once."""
    parms = default_parms(N, L)
    rng = np.random.default_rng(5)
    pte = rng.integers(-2 ** 40, 2 ** 40, (3, N))
    want = np.asarray(jdecode(jnp.asarray(pte), parms))
    got = tdecode(torch.as_tensor(pte), parms).numpy()
    assert np.allclose(got, want, rtol=0, atol=1e-9)
    assert np.array_equal(got, want)
    assert np.array_equal(tdecode(torch.as_tensor(pte[1]), parms).numpy(),
                          want[1])


# ----------------------------------------------------------- banner, R3

def test_print_config_vs_jax(capsys):
    for kind in (tapi.SYM, tapi.ASYM):
        jctx, ctx = _contexts(kind)
        banner = tapi.print_config(ctx)
        jbanner = japi.print_config(jctx)
        lines, jlines = banner.splitlines(), jbanner.splitlines()
        assert lines[0] == "seal_embedded_tpu_torch configuration"
        assert lines[1] == f"  device           : cpu (torch {torch.__version__})"
        assert lines[2:] == jlines[2:]
        assert banner in capsys.readouterr().out


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_encode_mode_is_bit_exact_f64(device):
    """R3: the JAX package resolves 'auto' to 'dd' on a TPU (not
    bit-exact); the port resolves it to 'f64' on every device, and every
    mode is the one bit-exact encode."""
    ctx = tapi.SEContext(default_parms(4096, 3), tapi.SYM,
                         device=torch.device(device))
    assert ctx.resolved_encode_mode() == "f64"
    for mode in ("sf", "f64", "dd"):
        ctx.encode_mode = mode
        assert ctx.resolved_encode_mode() == mode
    ctx.encode_mode = "fp32"
    with pytest.raises(ValueError):
        ctx.resolved_encode_mode()
    with pytest.raises(ValueError):
        tapi.se_setup_custom(N, L, SCALE, tapi.SYM, sk_seed=seed_bytes(1),
                             encode_mode="fp32", device="cpu")


def test_se_cleanup_zeroes_only_own_copies():
    """R3: the JAX se_cleanup zeroes the sk array the caller passed in;
    the port's context holds copies, and cleanup zeroes those (host and
    device) and drops them."""
    sk = tapi.sample_sk_from_seed(default_parms(N, L), seed_bytes(1))
    keep = sk.copy()
    jctx = japi.se_setup_custom(N, L, SCALE, japi.SYM, sk=sk)
    japi.se_cleanup(jctx)
    assert not sk.any() and keep.any()      # the JAX fault
    sk = keep.copy()
    ctx = tapi.se_setup_custom(N, L, SCALE, tapi.SYM, sk=sk, device=CPU)
    host, dev = ctx.sk_signed, ctx._sk
    tapi.se_cleanup(ctx)
    assert np.array_equal(sk, keep)
    assert not host.any() and not bool(dev.any())
    for k in ("sk_signed", "pk0", "pk1", "_sk", "_pk", "_sym_fn", "_asym_fn"):
        assert getattr(ctx, k) is None, k
    actx = tapi.se_setup_custom(N, L, SCALE, tapi.ASYM, sk=sk,
                                pk_seed=seed_bytes(4), device=CPU)
    tapi.se_encrypt(actx, _values())
    enc, pk0, dev_pk = actx._asym_fn.encryptor, actx.pk0, actx._pk
    tapi.se_cleanup(actx)
    assert not pk0.any() and actx.pk0 is None and actx._asym_fn is None
    assert actx._pk is None and not any(bool(t.any()) for t in dev_pk)
    assert not any(bool(getattr(enc, k).any())
                   for k in ("pk0", "pk1", "pk0_quot", "pk1_quot"))
    assert np.array_equal(sk, keep)
    with pytest.raises(ValueError):
        tapi.se_encrypt(ctx, _values())


# ----------------------------------------------------------------- golden

def test_golden_sym_4096_3_through_api():
    """The C reference's golden rows through se_setup_custom and
    se_encrypt_seeded at n = 4096, L = 3 on the CPU path (no JAX run)."""
    d = np.load(GOLDEN_DIR / "golden_sym_4096_3.npz")
    G = sum(1 for k in d.files if k.startswith("v_"))
    ctx = tapi.se_setup_custom(4096, 3, 2.0 ** 25, tapi.SYM,
                               sk=unpack_sk(d["sk_packed_0"], 4096),
                               device=CPU)
    values = np.stack([d[f"v_{t}"] for t in range(G)])
    out = tapi.se_encrypt_seeded(ctx, values, [seed_bytes(2)] * G,
                                 [seed_bytes(3)] * G)
    assert bool(out["ok"].all())
    for t in range(G):
        for key in ("pt", "pte"):
            assert np.array_equal(out[key][t].numpy(), d[f"{key}_{t}"])
        for i in range(3):
            for key in ("c0", "c1"):
                assert np.array_equal(out[key][i, t].numpy(),
                                      d[f"{key}_{3 * t + i}"]), (t, i, key)
    assert np.abs(tapi.se_decrypt_decode(ctx, out) - values).max() < 1e-3
