"""ctypes binding for the native serialization runtime (native/sealtpu_io.cpp).

Port of ``seal_embedded_tpu/io/native.py``.  At first use ``g++``
compiles ``native/sealtpu_io.cpp`` with the flags of ``native/Makefile``
into ``build/seal_embedded_tpu_torch/native-<hash>/libsealtpu_io.so``,
keyed by a hash of the source and the flags, as ``ops/kernels/build.py``
does for the CUDA sources; the library committed under ``native/`` is
never loaded.  A failed build raises with the compiler's output.  There
is no pure-Python fallback: ``io.serialize`` and ``io.network`` are the
Python implementations, and ``tests/test_torch_io.py`` holds the two
byte-equal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from ..ops.kernels.build import BUILD_ROOT

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "sealtpu_io.cpp"
LIB_NAME = "libsealtpu_io.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_LIB = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> pathlib.Path:
    """Compile the library unless one for this source and these flags
    exists; the result is renamed into place, so a concurrent build never
    leaves a half-written file behind."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({res.returncode}) building "
                           f"{SOURCE}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.se_pack_ternary.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.se_pack_ternary.restype = None
    lib.se_unpack_ternary.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.se_unpack_ternary.restype = None
    lib.se_expand_ternary_modq.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32, ctypes.c_void_p]
    lib.se_expand_ternary_modq.restype = None
    lib.se_ct_to_bytes.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p]
    lib.se_ct_to_bytes.restype = None
    lib.se_format_poly.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    lib.se_format_poly.restype = ctypes.c_size_t
    lib.se_parse_poly.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.se_parse_poly.restype = ctypes.c_size_t
    lib.se_stream_open_file.argtypes = [ctypes.c_char_p]
    lib.se_stream_open_file.restype = ctypes.c_int64
    lib.se_stream_open_tcp.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.se_stream_open_tcp.restype = ctypes.c_int64
    lib.se_stream_send.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_size_t]
    lib.se_stream_send.restype = ctypes.c_int64
    lib.se_stream_send_components.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t]
    lib.se_stream_send_components.restype = ctypes.c_int64
    lib.se_stream_close.argtypes = [ctypes.c_int64]
    lib.se_stream_close.restype = ctypes.c_int
    _LIB = lib
    return lib


def pack_ternary_signed(signed_vals: np.ndarray) -> bytes:
    """{-1,0,1} int8 -> 2-bit packed bytes."""
    lib = _load()
    sv = np.ascontiguousarray(signed_vals, dtype=np.int8)
    n = sv.size
    out = np.zeros((n + 3) // 4, dtype=np.uint8)
    lib.se_pack_ternary(sv.ctypes.data, n, out.ctypes.data)
    return out.tobytes()


def _packed_array(packed: bytes, n: int) -> np.ndarray:
    pk = np.frombuffer(packed, dtype=np.uint8)
    if pk.size < (n + 3) // 4:
        raise ValueError(f"{pk.size} packed bytes hold fewer than {n} "
                         "coefficients")
    return pk


def unpack_ternary_signed(packed: bytes, n: int) -> np.ndarray:
    lib = _load()
    pk = _packed_array(packed, n)
    out = np.zeros(n, dtype=np.int8)
    lib.se_unpack_ternary(pk.ctypes.data, n, out.ctypes.data)
    return out


def expand_ternary_modq(packed: bytes, n: int, q: int) -> np.ndarray:
    lib = _load()
    pk = _packed_array(packed, n)
    out = np.zeros(n, dtype=np.uint32)
    lib.se_expand_ternary_modq(pk.ctypes.data, n, q, out.ctypes.data)
    return out


def ct_to_bytes(components: np.ndarray) -> bytes:
    """(count, n) or (n,) u32 -> LE bytes."""
    lib = _load()
    c = np.ascontiguousarray(np.atleast_2d(components), dtype=np.uint32)
    count, n = c.shape
    out = np.zeros(count * n * 4, dtype=np.uint8)
    lib.se_ct_to_bytes(c.ctypes.data, count, n, out.ctypes.data)
    return out.tobytes()


def format_poly(name: str, vals: np.ndarray) -> str:
    lib = _load()
    v = np.ascontiguousarray(vals, dtype=np.uint32)
    need = lib.se_format_poly(name.encode(), v.ctypes.data, v.size, None, 0)
    buf = ctypes.create_string_buffer(need + 1)
    lib.se_format_poly(name.encode(), v.ctypes.data, v.size, buf, need + 1)
    return buf.value.decode()


def parse_poly(line: str, cap: int = 1 << 20) -> np.ndarray:
    lib = _load()
    out = np.zeros(cap, dtype=np.uint32)
    got = lib.se_parse_poly(line.encode(), out.ctypes.data, cap)
    if got == ctypes.c_size_t(-1).value:
        raise ValueError("not a poly line")
    return out[:got].copy()


# --------------------------------------------------------- streaming senders
#
# The reference streams every RNS component through native code
# (device/lib/network.c curl POST / SEND_FNCT_PTR, seal_embedded.c:180-204).
# These wrap the C++ handles in native/sealtpu_io.cpp: 4-byte LE length
# framing over a file or TCP socket (the same wire format as
# io.network.file_sink / tcp_sender), plus a batched per-prime sender that
# frames and writes a whole (count, n) u32 block in one native call.


class NativeStream:
    """A native framed-component stream (file or TCP).

    Usable directly as api.se_encrypt_seeded's ``send=`` callback, and as a
    batched per-prime sender via send_components.  ``close`` releases the
    handle; the stream is also a context manager.
    """

    def __init__(self, handle: int):
        if handle < 0:
            raise OSError("native stream open failed")
        self._h = handle

    @classmethod
    def to_file(cls, path: str) -> "NativeStream":
        return cls(_load().se_stream_open_file(str(path).encode()))

    @classmethod
    def to_tcp(cls, host: str, port: int) -> "NativeStream":
        return cls(_load().se_stream_open_tcp(host.encode(), port))

    def __call__(self, data: bytes) -> int:
        got = _load().se_stream_send(self._h, data, len(data))
        if got < 0:
            raise OSError("native stream send failed")
        return int(got)

    def send_components(self, components: np.ndarray) -> int:
        """Frame+write a (count, n) u32 block in one native call — the
        reference's per-prime send loop without per-component FFI."""
        c = np.ascontiguousarray(np.atleast_2d(components), dtype=np.uint32)
        count, n = c.shape
        got = _load().se_stream_send_components(self._h, c.ctypes.data,
                                                count, n)
        if got < 0:
            raise OSError("native stream send failed")
        return int(got)

    def close(self) -> None:
        _load().se_stream_close(self._h)

    def __enter__(self) -> "NativeStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
