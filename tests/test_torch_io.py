"""The port's host-side I/O (io/serialize.py, io/network.py, io/native.py,
io/sealstream.py) and its copy of the golden model, against the JAX
package's originals on the same seeded inputs: files and byte strings
byte for byte, arrays with np.array_equal."""

import socket
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.golden import ckks as jgckks
from seal_embedded_tpu.golden import encode as jgenc
from seal_embedded_tpu.golden import keccak as jgkec
from seal_embedded_tpu.golden import ntt as jgntt
from seal_embedded_tpu.golden import prng as jgprng
from seal_embedded_tpu.golden import sampling as jgsamp
from seal_embedded_tpu.io import network as jnet
from seal_embedded_tpu.io import sealstream as jss
from seal_embedded_tpu.io import serialize as jser
from seal_embedded_tpu.ops.encode import index_map_np
from seal_embedded_tpu_torch import config as tcfg
from seal_embedded_tpu_torch.golden import ckks as tgckks
from seal_embedded_tpu_torch.golden import encode as tgenc
from seal_embedded_tpu_torch.golden import keccak as tgkec
from seal_embedded_tpu_torch.golden import ntt as tgntt
from seal_embedded_tpu_torch.golden import prng as tgprng
from seal_embedded_tpu_torch.golden import sampling as tgsamp
from seal_embedded_tpu_torch.io import native as tnat
from seal_embedded_tpu_torch.io import network as tnet
from seal_embedded_tpu_torch.io import sealstream as tss
from seal_embedded_tpu_torch.io import serialize as tser
from seal_embedded_tpu_torch.ops.kernels.build import BUILD_ROOT

from conftest import seed_bytes

N = 1024
JP = jcfg.Parms(degree=N, moduli=jcfg.PRIMES_27BIT[:2], scale=2.0 ** 20)
TP = tcfg.Parms(degree=N, moduli=tcfg.PRIMES_27BIT[:2], scale=2.0 ** 20)
# The golden model's pure-Python NTTs at a small degree.
GN = 256
JG = jcfg.Parms(degree=GN, moduli=jcfg.PRIMES_27BIT[:2], scale=2.0 ** 20)
TG = tcfg.Parms(degree=GN, moduli=tcfg.PRIMES_27BIT[:2], scale=2.0 ** 20)


def _pk_components(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, q, N).astype(np.uint32),
             rng.integers(0, q, N).astype(np.uint32)) for q in JP.moduli]


def _sk_packed(seed=1):
    return jgsamp.sample_small_poly_ternary_96(N, jgprng.Prng(seed_bytes(seed)))


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ------------------------------------------------------------- serialize

WRITERS = {
    "sk": lambda m, d, P: m.write_sk(str(d / f"sk_{N}.dat"), _sk_packed()),
    "pk": lambda m, d, P: m.write_pk(str(d), P, _pk_components()),
    "index_map": lambda m, d, P: m.write_index_map(
        str(d / f"index_map_{N}.dat"), index_map_np(N)),
    "ifft_roots": lambda m, d, P: m.write_ifft_roots(
        str(d / f"ifft_roots_{N}.dat"), N, P.logn),
    "fft_roots": lambda m, d, P: m.write_fft_roots(
        str(d / f"fft_roots_{N}.dat"), N, P.logn),
    "ntt_roots": lambda m, d, P: m.write_ntt_roots(str(d), P, fast=False),
    "ntt_fast_roots": lambda m, d, P: m.write_ntt_roots(str(d), P, fast=True),
    "intt_roots": lambda m, d, P: m.write_intt_roots(str(d), P, fast=False),
    "intt_fast_roots": lambda m, d, P: m.write_intt_roots(str(d), P,
                                                          fast=True),
    "str_header": lambda m, d, P: m.write_str_header(
        str(d / "str_blob.h"), "blob", bytes(range(200))),
    "sk_str_header": lambda m, d, P: m.write_sk_str_header(
        str(d / f"str_sk_{N}.h"), N, _sk_packed()),
    "pk_str_headers": lambda m, d, P: m.write_pk_str_headers(
        str(d), P, _pk_components()),
}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_serialize_writers_byte_identical(kind, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    WRITERS[kind](jser, tmp_path / "jax", JP)
    WRITERS[kind](tser, tmp_path / "port", TP)
    want = _files(tmp_path / "jax")
    assert want and _files(tmp_path / "port") == want


def test_serialize_byte_strings_identical():
    rng = np.random.default_rng(2)
    comp = rng.integers(0, 2 ** 30, N).astype(np.uint32)
    c0 = rng.integers(0, 2 ** 30, (2, N)).astype(np.uint32)
    ints = rng.integers(0, 2 ** 30, 64).astype(np.uint32)
    floats = rng.uniform(-1, 1, 64).astype(np.float64)
    signed = rng.integers(-1, 2, N)
    for fn, args in (("ct_component_bytes", (comp,)),
                     ("seeded_ct_bytes", (seed_bytes(5), c0)),
                     ("format_poly", ("c0 (t0 p1)", ints)),
                     ("format_poly", ("v (cleartext)", floats)),
                     ("signed_to_file_ternary", (signed,)),
                     ("pack_ternary", (jser.signed_to_file_ternary(signed),)),
                     ("unpack_ternary", (_sk_packed(), N))):
        assert getattr(tser, fn)(*args) == getattr(jser, fn)(*args), fn


def test_serialize_readers_round_trip(tmp_path):
    n, logn = N, TP.logn
    packed = _sk_packed()
    tser.write_sk(str(tmp_path / "sk.dat"), packed)
    assert tser.read_sk(str(tmp_path / "sk.dat"), n) == packed
    pk = _pk_components()
    tser.write_pk(str(tmp_path), TP, pk)
    for i, q in enumerate(TP.moduli):
        for j in (0, 1):
            assert np.array_equal(
                tser.read_pk_component(str(tmp_path), j, n, q), pk[i][j])
    imap = index_map_np(n)
    tser.write_index_map(str(tmp_path / "imap.dat"), imap)
    assert np.array_equal(tser.read_index_map(str(tmp_path / "imap.dat"), n),
                          imap)
    tser.write_ifft_roots(str(tmp_path / "ifft.dat"), n, logn)
    assert np.array_equal(tser.read_ifft_roots(str(tmp_path / "ifft.dat"), n),
                          np.fromfile(tmp_path / "ifft.dat", dtype="<f8"))
    for fast in (False, True):
        tser.write_ntt_roots(str(tmp_path), TP, fast=fast)
        q = TP.moduli[1]
        name = f"ntt_{'fast_' if fast else ''}roots_{n}_{q}.dat"
        got = tser.read_ntt_roots(str(tmp_path / name), n, fast=fast)
        want = (tser.ntt_fast_root_table(n, logn, q, TP.ntt_root(q))
                if fast else tser.ntt_root_table(n, logn, q, TP.ntt_root(q)))
        assert np.array_equal(got.reshape(-1), want)
    # text polys, ct bytes and the seed-expandable ct
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2 ** 30, 32).astype(np.uint32)
    line = tser.format_poly("c1 (t2 p0)", vals)
    assert tser.parse_poly_line(line) == ("c1 (t2 p0)", vals.tolist())
    stream = ["garbage\n", line, tser.format_poly("v", np.ones(4) / 3)]
    parsed = tser.parse_poly_stream(stream)
    assert [p[0] for p in parsed] == ["c1 (t2 p0)", "v"]
    assert np.allclose(parsed[1][1], np.ones(4) / 3, rtol=1e-9, atol=0)
    assert np.array_equal(
        tser.ct_component_from_bytes(tser.ct_component_bytes(vals)), vals)
    c0 = rng.integers(0, 2 ** 30, (3, 64)).astype(np.uint32)
    seed, back = tser.seeded_ct_parse(tser.seeded_ct_bytes(seed_bytes(6), c0))
    assert seed == seed_bytes(6) and np.array_equal(back, c0)
    assert [v - 1 for v in tser.unpack_ternary(packed, n)] == \
        tgsamp.ternary_signed(packed, n)


# --------------------------------------------------------------- network

def test_network_collecting_and_file_sink(tmp_path):
    comps = [np.arange(i, i + 16, dtype="<u4").tobytes() for i in range(3)]
    send, store = tnet.collecting_sender()
    assert [send(c) for c in comps] == [64, 64, 64] and store == comps
    paths = {}
    for name, mod in (("jax", jnet), ("port", tnet)):
        paths[name] = tmp_path / f"{name}.bin"
        sink = mod.file_sink(str(paths[name]))
        for c in comps + [b"tail"]:
            sink(c)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert tnet.read_components(str(paths["port"])) == comps + [b"tail"]


def _serve_frames(srv, want, received):
    conn, _ = srv.accept()
    buf = b""
    while len(received) < want:
        data = conn.recv(65536)
        if not data:
            break
        buf += data
        while len(buf) >= 4:
            ln = int.from_bytes(buf[:4], "little")
            if len(buf) < 4 + ln:
                break
            received.append(buf[4:4 + ln])
            buf = buf[4 + ln:]
    conn.close()


def test_network_tcp_sender():
    srv = socket.create_server(("127.0.0.1", 0))
    received = []
    th = threading.Thread(target=_serve_frames,
                          args=(srv, 2, received))
    th.start()
    send = tnet.tcp_sender("127.0.0.1", srv.getsockname()[1])
    payload = np.arange(32, dtype="<u4").tobytes()
    assert send(payload) == len(payload)
    assert send(b"hello") == 5
    th.join(timeout=10)
    srv.close()
    assert not th.is_alive()
    assert received == [payload, b"hello"]


def test_network_http_sender():
    received = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            received.append(self.rfile.read(int(self.headers["Content-Length"])))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        send = tnet.http_sender(f"http://127.0.0.1:{srv.server_port}/ct")
        payload = np.arange(16, dtype="<u4").tobytes()
        assert send(payload) == len(payload)
        assert send(b"second") == 6
    finally:
        srv.shutdown()
        srv.server_close()
    assert received == [payload, b"second"]


# ---------------------------------------------------------------- native

def test_native_built_from_source_into_build_dir():
    so = tnat.build()
    assert so.is_file() and BUILD_ROOT in so.parents
    assert so == tnat.library_path()
    assert tnat.SOURCE.name == "sealtpu_io.cpp" and tnat.SOURCE.is_file()


def test_native_matches_serialize():
    rng = np.random.default_rng(0)
    signed = (rng.integers(0, 3, 4096) - 1).astype(np.int8)
    packed = tnat.pack_ternary_signed(signed)
    assert packed == tser.pack_ternary(tser.signed_to_file_ternary(signed))
    assert np.array_equal(tnat.unpack_ternary_signed(packed, 4096), signed)
    q = 1053818881
    got = tnat.expand_ternary_modq(packed, 4096, q)
    assert np.array_equal(got, tgsamp.expand_poly_ternary(packed, 4096, q))
    with pytest.raises(ValueError):
        tnat.unpack_ternary_signed(packed[:10], 4096)
    c = rng.integers(0, 2 ** 30, (3, 256)).astype(np.uint32)
    assert tnat.ct_to_bytes(c) == b"".join(tser.ct_component_bytes(r)
                                           for r in c)
    vals = rng.integers(0, 2 ** 30, 64).astype(np.uint32)
    line = tnat.format_poly("c0 (t0 p0)", vals)
    assert line.strip() == tser.format_poly("c0 (t0 p0)", vals).strip()
    assert np.array_equal(tnat.parse_poly(line), vals)
    with pytest.raises(ValueError):
        tnat.parse_poly("no poly here")


def test_native_stream_file_and_tcp(tmp_path):
    rng = np.random.default_rng(1)
    comps = rng.integers(0, 2 ** 32, (4, 64)).astype(np.uint32)
    with tnat.NativeStream.to_file(str(tmp_path / "native.bin")) as st:
        assert st.send_components(comps) == comps.size * 4
        st(b"trailing-blob")
    send = tnet.file_sink(str(tmp_path / "py.bin"))
    for c in comps:
        send(tser.ct_component_bytes(c))
    send(b"trailing-blob")
    assert ((tmp_path / "native.bin").read_bytes()
            == (tmp_path / "py.bin").read_bytes())

    srv = socket.create_server(("127.0.0.1", 0))
    received = []
    th = threading.Thread(target=_serve_frames, args=(srv, 2, received))
    th.start()
    with tnat.NativeStream.to_tcp("127.0.0.1", srv.getsockname()[1]) as st:
        st.send_components(comps[:1])
        st(b"hello")
    th.join(timeout=10)
    srv.close()
    assert not th.is_alive()
    assert np.array_equal(np.frombuffer(received[0], dtype="<u4"), comps[0])
    assert received[1] == b"hello"


# ------------------------------------------------------------ sealstream

def test_sealstream_bytes_equal_jax():
    P4 = jcfg.default_parms(4096, 3)
    T4 = tcfg.default_parms(4096, 3)
    kmods = jss.key_context_moduli(P4)
    assert tss.key_context_moduli(T4) == kmods
    assert tss.parms_id(4096, kmods) == jss.parms_id(4096, kmods)
    for data, ln in ((b"", 32), (b"seal", 31), (bytes(range(256)), 200)):
        assert tss.blake2xb(data, ln) == jss.blake2xb(data, ln)
    assert tss.SEALHeader(0, 77).pack() == jss.SEALHeader(0, 77).pack()
    rng = np.random.default_rng(4)
    sk = np.stack([rng.integers(0, q, 4096).astype(np.uint64) for q in kmods])
    pk = [np.stack([rng.integers(0, q, 4096).astype(np.uint64)
                    for q in kmods]) for _ in range(2)]
    ct = [np.stack([rng.integers(0, q, 4096).astype(np.uint32)
                    for q in P4.moduli]) for _ in range(2)]
    for blob_t, blob_j, load, want in (
            (tss.save_secret_key(T4, sk), jss.save_secret_key(P4, sk),
             tss.load_secret_key, (sk,)),
            (tss.save_public_key(T4, *pk), jss.save_public_key(P4, *pk),
             tss.load_public_key, pk),
            (tss.save_ciphertext(T4, *ct), jss.save_ciphertext(P4, *ct),
             tss.load_ciphertext, ct)):
        assert blob_t == blob_j
        got = load(T4, blob_t)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.astype(np.uint64))
    with pytest.raises(AssertionError, match="parms_id"):
        tss.load_ciphertext(tcfg.default_parms(4096, 2),
                            tss.save_ciphertext(T4, *ct))


# ---------------------------------------------------------------- golden

def _golden_case(name, gk, gn, genc, gckks, gsamp, gprng, P):
    """One golden function on seeded inputs, through the JAX package's
    modules or the port's (the same call on either set)."""
    rng = np.random.default_rng(11)
    n, q = P.degree, int(P.moduli[0])
    w = P.ntt_root(q)
    packed = gsamp.sample_small_poly_ternary_96(n, gprng.Prng(seed_bytes(1)))
    vals = rng.uniform(-1, 1, n // 2).astype(np.float32)
    if name == "prng_fill":
        p = gprng.Prng(seed_bytes(7), counter=2 ** 32 - 1)
        return [p.fill(136), p.fill(300), p.fill(1), p.counter]
    if name == "shake256":
        return [gk.shake256(seed_bytes(8) + bytes(ln), 200)
                for ln in (0, 64, 150)]
    if name == "keccak_f1600":
        return gk.keccak_f1600(list(range(25)))
    if name == "uniform":
        return gsamp.sample_poly_uniform(n, q, gprng.Prng(seed_bytes(2)))
    if name == "ternary":
        return [packed, gsamp.expand_poly_ternary(packed, n, q),
                gsamp.ternary_signed(packed, n)]
    if name == "cbd":
        prng = gprng.Prng(seed_bytes(3))
        return [gsamp.sample_poly_cbd_16(n, prng),
                gsamp.sample_add_poly_cbd_16(list(range(n)), prng)]
    if name == "ntt":
        x = rng.integers(0, q, n).tolist()
        fwd = gn.ntt_inpl(x, n, P.logn, q, w)
        return [fwd, gn.intt_inpl(fwd, n, P.logn, q, w),
                gn.poly_mult_sb_negacyclic(x[:64], x[64:128], q)]
    if name == "encode":
        pt = genc.encode_base(P, vals)
        return [genc.calc_index_map(n, P.logn), pt,
                genc.c_round(np.array([-2.5, -0.5, 0.5, 2.5, 0.49999999999999994])),
                genc.ifft_inpl(pt.astype(np.complex128), n, P.logn),
                genc.fft_inpl(pt.astype(np.complex128), n, P.logn)]
    if name == "decode":
        return genc.decode(P, genc.encode_base(P, vals))
    if name == "gen_pk":
        return gckks.gen_pk(P, packed, seed=seed_bytes(4)).components
    if name == "sym_encrypt":
        ct = gckks.sym_encrypt(P, vals, packed, seed_bytes(2), seed_bytes(3))
        return [ct.components, ct.pte,
                gckks.decrypt_decode(P, ct, packed, 1),
                gckks.decrypt_crt(P, ct.components, packed)]
    if name == "asym_encrypt":
        pk = gckks.gen_pk(P, packed, seed=seed_bytes(4))
        ct = gckks.asym_encrypt(P, vals, pk, seed_bytes(3))
        return [ct.components, ct.pte, ct.conj_vals_int]
    if name == "reduce":
        x = rng.integers(-2 ** 62, 2 ** 62, 64).tolist() + [-q, -2 * q, 0]
        return [gckks.reduce_pte(x, q), gckks.reduce_e_small([-3, 0, 5], q)]
    raise KeyError(name)


GOLDEN_CASES = ("prng_fill", "shake256", "keccak_f1600", "uniform", "ternary",
                "cbd", "ntt", "encode", "decode", "gen_pk", "sym_encrypt",
                "asym_encrypt", "reduce")


def _same(a, b):
    if isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_golden_copy_equals_original(name):
    want = _golden_case(name, jgkec, jgntt, jgenc, jgckks, jgsamp, jgprng,
                        JG)
    got = _golden_case(name, tgkec, tgntt, tgenc, tgckks, tgsamp, tgprng,
                       TG)
    assert _same(got, want), name
