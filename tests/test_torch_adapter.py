"""The port's host-side adapter (adapter.py) against
seal_embedded_tpu.adapter: byte-identical key and table files for the
same seeds, and the CRT verify of the port's own ciphertexts."""

from functools import lru_cache

import numpy as np
import pytest
import torch

from seal_embedded_tpu import adapter as jadapter
from seal_embedded_tpu_torch import adapter as tadapter
from seal_embedded_tpu_torch import api as tapi
from seal_embedded_tpu_torch.config import default_parms
from seal_embedded_tpu_torch.golden.prng import Prng
from seal_embedded_tpu_torch.golden.sampling import sample_small_poly_ternary_96
from seal_embedded_tpu_torch.io import sealstream as tss
from seal_embedded_tpu_torch.io import serialize as tser

from conftest import seed_bytes

torch.set_num_threads(2)


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


def test_gen_save_all_byte_identical(tmp_path):
    """Two port runs and the JAX adapter, same seeds (n = 1024, 1 prime):
    the same file set, byte for byte."""
    kw = {"degree": 1024, "nprimes": 1, "sk_seed": seed_bytes(1),
          "pk_seed": seed_bytes(41)}
    dirs = {k: tmp_path / k for k in ("a", "b", "jax")}
    outs = [tadapter.gen_save_all(str(dirs["a"]), **kw),
            tadapter.gen_save_all(str(dirs["b"]), **kw)]
    jadapter.gen_save_all(str(dirs["jax"]), **kw)
    files = _files(dirs["a"])
    assert files == _files(dirs["b"]) == _files(dirs["jax"])
    assert {"sk_1024.dat", "pk0_ntt_1024_134012929.dat", "index_map_1024.dat",
            "ifft_roots_1024.dat", "fft_roots_1024.dat",
            "intt_fast_roots_1024_134012929.dat", "str_sk_1024.h",
            "str_pk_addr_array.h", "sk_seal_1024.dat",
            "pk_seal_1024.dat"} <= set(files)
    assert outs[0]["sk_packed"] == files["sk_1024.dat"]
    # The SEAL streams load back under the key context.
    parms = outs[0]["parms"]
    pk0, _ = tss.load_public_key(parms, files["pk_seal_1024.dat"])
    assert np.array_equal(pk0[0].astype(np.uint32), tser.read_pk_component(
        str(dirs["a"]), 0, 1024, parms.moduli[0]))


def test_write_seal_streams_special_prime(tmp_path):
    """n = 2048 has a special key prime: its pk row extends the shareable
    stream by one 64-bit uniform draw (_sample_uniform_u64), as in the
    JAX adapter."""
    kw = {"degree": 2048, "nprimes": 1, "sk_seed": seed_bytes(2),
          "pk_seed": seed_bytes(42)}
    for name, mod in (("port", tadapter), ("jax", jadapter)):
        mod._write_seal_streams(str(tmp_path), *_seal_inputs(kw))
        (tmp_path / "pk_seal_2048.dat").rename(tmp_path / f"{name}.pk")
        (tmp_path / "sk_seal_2048.dat").rename(tmp_path / f"{name}.sk")
    for ext in ("pk", "sk"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes())
    prng = Prng(seed_bytes(5))
    sp = tss.key_context_moduli(default_parms(2048, 1))[1]
    draws = tadapter._sample_uniform_u64(prng, 64, sp)
    assert draws == jadapter._sample_uniform_u64(Prng(seed_bytes(5)), 64, sp)
    assert max(draws) < sp


def _seal_inputs(kw):
    from seal_embedded_tpu_torch.golden.ckks import gen_pk
    parms = default_parms(kw["degree"], kw["nprimes"])
    packed = sample_small_poly_ternary_96(kw["degree"], Prng(kw["sk_seed"]))
    return parms, packed, gen_pk(parms, packed, seed=kw["pk_seed"]), \
        kw["pk_seed"]


@lru_cache(maxsize=None)
def _ciphertexts():
    """Two messages encrypted by the port's API at n = 4096, L = 3 on the
    CPU path, with the secret key's file bytes and the values."""
    n = 4096
    packed = sample_small_poly_ternary_96(n, Prng(seed_bytes(1)))
    ctx = tapi.se_setup_default(tapi.SYM, sk_seed=seed_bytes(1), device="cpu")
    vals = np.random.default_rng(9).uniform(-1, 1, (2, n // 2)).astype(
        np.float32)
    out = tapi.se_encrypt_seeded(
        ctx, vals, share_seeds=[seed_bytes(30 + i) for i in range(2)],
        seeds=[seed_bytes(40 + i) for i in range(2)])
    assert bool(out["ok"].all())
    return packed, vals, out["c0"].numpy(), out["c1"].numpy()


def _dump(path, vals, c0, c1):
    with open(path, "w") as f:
        for b in range(vals.shape[0]):
            f.write(tser.format_poly("v", np.asarray(vals[b], np.float64)))
            for i in range(c0.shape[0]):
                f.write(tser.format_poly(f"c0 (t{b} p{i})", c0[i, b]))
                f.write(tser.format_poly(f"c1 (t{b} p{i})", c1[i, b]))


@pytest.mark.parametrize("corrupt", [None, 1, 2])
def test_verify_ciphertexts(corrupt, tmp_path):
    """The port's ciphertexts pass the CRT verify; one flipped coefficient
    bit of prime 1 or 2 fails it.  The JAX adapter gives the same
    verdict on the same files."""
    packed, vals, c0, c1 = _ciphertexts()
    sk_path = tmp_path / "sk_4096.dat"
    tser.write_sk(str(sk_path), packed)
    c0 = c0.copy()
    if corrupt is not None:
        c0[corrupt, 0, 5] ^= 1
    ct_path = tmp_path / "cts"
    _dump(ct_path, vals, c0, c1)
    ok = tadapter.verify_ciphertexts(str(ct_path), str(sk_path))
    assert ok is (corrupt is None)
    assert jadapter.verify_ciphertexts(str(ct_path), str(sk_path)) is ok


def test_main_commands(tmp_path, capsys):
    assert tadapter.main(["verify-seal"]) == 2
    assert "NOT AVAILABLE" in capsys.readouterr().out
    out = tmp_path / "keys"
    assert tadapter.main(["generate", "--out", str(out), "--degree", "1024",
                          "--nprimes", "1", "--sk-seed", seed_bytes(1).hex(),
                          "--pk-seed", seed_bytes(41).hex()]) == 0
    assert (out / "sk_1024.dat").is_file()
    # verify on a 1024-degree dump made by the API from the same sk file.
    ctx = tapi.se_setup_custom(1024, 1, 2.0 ** 20, tapi.SYM,
                               sk_path=str(out / "sk_1024.dat"), device="cpu")
    vals = np.random.default_rng(3).uniform(-1, 1, (1, 512)).astype(
        np.float32)
    res = tapi.se_encrypt_seeded(ctx, vals, [seed_bytes(7)], [seed_bytes(8)])
    _dump(tmp_path / "cts", vals, res["c0"].numpy(), res["c1"].numpy())
    (tmp_path / "vals").write_text(tser.format_poly(
        "v", vals[0].astype(np.float64)))
    args = [str(tmp_path / "cts"), "--sk", str(out / "sk_1024.dat"),
            "--degree", "1024", "--nprimes", "1"]
    assert tadapter.main(["verify", *args]) == 0
    assert tadapter.main(["verify", *args,
                          "--values", str(tmp_path / "vals")]) == 0
    (tmp_path / "vals").write_text(tser.format_poly(
        "v", vals[0].astype(np.float64) + 1.0))
    assert tadapter.main(["verify", *args,
                          "--values", str(tmp_path / "vals")]) == 1
    assert "VERIFY FAILED" in capsys.readouterr().out
