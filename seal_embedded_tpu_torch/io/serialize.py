"""Serialization: SEAL-Embedded wire/file formats.

Byte-compatible with the reference's data contracts so that keys and
ciphertexts interoperate with the reference device library and its SEAL
adapter (reference: device/lib/fileops.{h,c}, adapter/fileops.{h,cpp},
device/lib/util_print.h:478-519).

Formats:
  sk_<n>.dat            n/4 bytes, 2-bit packed ternary, big-endian in byte
                        (value v of coeff i at bits [6-2*(i%4)] of byte i/4);
                        stored {0,1,2} maps to {q-1, 0, 1} on expansion
  pk<j>_ntt_<n>_<q>.dat n uint32 little-endian words, NTT form, per prime
  index_map_<n>.dat     n uint16 little-endian
  ifft_roots_<n>.dat    2n f64 little-endian (re, im interleaved)
  ntt_roots_<n>_<q>.dat n uint32 LE: w^bitrev(i) table
  ntt_fast_roots_...    2n uint32 LE: (operand, quotient) MUMO pairs
  text polys            "name : { v0, v1, ..., vlast }" lines (print_poly_full)

A copy of ``seal_embedded_tpu/io/serialize.py`` (host code; the JAX
package cannot be imported without jax).  ``tests/test_torch_io.py``
holds every writer byte-identical to the original and every reader to a
round trip.  The str_*.h headers keep the original's banner text, so the
two packages write the same bytes.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from ..config import Parms, barrett_quotient, bitrev


# ---------------------------------------------------------------- secret key

def pack_ternary(values) -> bytes:
    """Pack coeffs given as file-encoded {0,1,2} values, 4 per byte."""
    values = list(values)
    n = len(values)
    out = bytearray((n + 3) // 4)
    for i, v in enumerate(values):
        assert 0 <= v <= 2
        out[i // 4] |= v << (6 - (i % 4) * 2)
    return bytes(out)


def unpack_ternary(data: bytes, n: int) -> list[int]:
    return [(data[i // 4] >> (6 - (i % 4) * 2)) & 0x3 for i in range(n)]


def signed_to_file_ternary(signed) -> list[int]:
    """{-1,0,1} -> file encoding {0,1,2} (adapter fileops.cpp:70-73:
    q-1 -> 0, 0 -> 1, 1 -> 2)."""
    return [int(v) + 1 for v in signed]


def write_sk(path: str, sk_packed: bytes) -> None:
    with open(path, "wb") as f:
        f.write(sk_packed)


def read_sk(path: str, n: int) -> bytes:
    with open(path, "rb") as f:
        data = f.read(n // 4)
    assert len(data) == n // 4
    return data


def unpack_ternary_signed(packed, n: int) -> np.ndarray:
    """2-bit packed ternary polynomial (4 coefficients per byte, most
    significant pair first, value + 1), as the reference stores the secret
    key and u -> signed int32 (n,) in {-1, 0, 1}."""
    packed = np.frombuffer(bytes(packed), dtype=np.uint8)
    i = np.arange(n)
    shift = (6 - (i % 4) * 2).astype(np.uint8)
    return (((packed[i // 4] >> shift) & 3).astype(np.int32) - 1)


# ---------------------------------------------------------------- public key

def write_pk(dirpath: str, parms: Parms, pk_components) -> None:
    """pk_components: per prime (pk0, pk1) lists, NTT form
    (adapter fileops.cpp:173-304 file naming)."""
    n = parms.degree
    for idx, q in enumerate(parms.moduli):
        pk0, pk1 = pk_components[idx]
        for j, pk in ((0, pk0), (1, pk1)):
            path = os.path.join(dirpath, f"pk{j}_ntt_{n}_{q}.dat")
            np.asarray(pk, dtype=np.uint32).astype("<u4").tofile(path)


def read_pk_component(dirpath: str, j: int, n: int, q: int) -> np.ndarray:
    path = os.path.join(dirpath, f"pk{j}_ntt_{n}_{q}.dat")
    return np.fromfile(path, dtype="<u4", count=n)


# ------------------------------------------------------------- precompute data

def write_index_map(path: str, index_map) -> None:
    np.asarray(index_map, dtype=np.uint16).astype("<u2").tofile(path)


def write_ifft_roots(path: str, n: int, logn: int) -> None:
    """IFFT root table in the adapter's order (generate.cpp:119-198):
    roots[i] = conj(W^(bitrev(i-1, logn) + 1)), raw f64 bit patterns."""
    import math
    m = 2 * n
    out = np.zeros(2 * n, dtype=np.float64)
    for i in range(n):
        k = (bitrev((i - 1) & (n - 1), logn) + 1) & (m - 1)
        ang = 2 * math.pi * k / m
        out[2 * i] = math.cos(ang)
        out[2 * i + 1] = -math.sin(ang)
    out.astype("<f8").tofile(path)


def ntt_root_table(n: int, logn: int, q: int, w: int) -> np.ndarray:
    """Regular forward table: table[i] = w^bitrev(i, logn) (ntt.c:40-52)."""
    tbl = np.zeros(n, dtype=np.uint64)
    power = 1
    tbl[0] = 1
    for i in range(1, n):
        power = (power * w) % q
        tbl[bitrev(i, logn)] = power
    return tbl.astype(np.uint32)


def ntt_fast_root_table(n: int, logn: int, q: int, w: int) -> np.ndarray:
    """MUMO (operand, quotient) pairs (adapter generate.cpp:253-445)."""
    ops = ntt_root_table(n, logn, q, w)
    out = np.zeros(2 * n, dtype=np.uint32)
    for i in range(n):
        op = int(ops[i])
        out[2 * i] = op
        out[2 * i + 1] = barrett_quotient(op, q) & 0xFFFFFFFF
    return out


def write_ntt_roots(dirpath: str, parms: Parms, fast: bool = False) -> None:
    n, logn = parms.degree, parms.logn
    for q in parms.moduli:
        w = parms.ntt_root(q)
        if fast:
            tbl = ntt_fast_root_table(n, logn, q, w)
            path = os.path.join(dirpath, f"ntt_fast_roots_{n}_{q}.dat")
        else:
            tbl = ntt_root_table(n, logn, q, w)
            path = os.path.join(dirpath, f"ntt_roots_{n}_{q}.dat")
        tbl.astype("<u4").tofile(path)


def intt_root_table(n: int, logn: int, q: int, w: int) -> np.ndarray:
    """Inverse-root table in the reference's INTT order (intt.c:30-56):
    table[bitrev(i-1, logn) + 1] = inv_w^i, table[0] = 1."""
    inv_w = pow(w, q - 2, q)
    tbl = np.zeros(n, dtype=np.uint64)
    tbl[0] = 1
    power = inv_w
    for i in range(1, n):
        tbl[bitrev(i - 1, logn) + 1] = power
        power = (power * inv_w) % q
    return tbl.astype(np.uint32)


def intt_fast_root_table(n: int, logn: int, q: int, w: int) -> np.ndarray:
    """INTT MUMO (operand, quotient) pairs (adapter generate.cpp inverse
    path)."""
    ops = intt_root_table(n, logn, q, w)
    out = np.zeros(2 * n, dtype=np.uint32)
    for i in range(n):
        op = int(ops[i])
        out[2 * i] = op
        out[2 * i + 1] = barrett_quotient(op, q) & 0xFFFFFFFF
    return out


def write_intt_roots(dirpath: str, parms: Parms, fast: bool = False) -> None:
    n, logn = parms.degree, parms.logn
    for q in parms.moduli:
        w = parms.ntt_root(q)
        if fast:
            tbl = intt_fast_root_table(n, logn, q, w)
            path = os.path.join(dirpath, f"intt_fast_roots_{n}_{q}.dat")
        else:
            tbl = intt_root_table(n, logn, q, w)
            path = os.path.join(dirpath, f"intt_roots_{n}_{q}.dat")
        tbl.astype("<u4").tofile(path)


# ------------------------------------------------- load side (fileops.c parity)

def read_index_map(path: str, n: int) -> np.ndarray:
    """load_index_map (fileops.c:208-225)."""
    out = np.fromfile(path, dtype="<u2", count=n)
    assert out.size == n
    return out.astype(np.int32)


def read_ifft_roots(path: str, n: int) -> np.ndarray:
    """load_ifft_roots (fileops.c:226-255): 2n f64 (re, im interleaved)."""
    out = np.fromfile(path, dtype="<f8", count=2 * n)
    assert out.size == 2 * n
    return out


def read_ntt_roots(path: str, n: int, fast: bool = False) -> np.ndarray:
    """load_ntt_roots / load_ntt_fast_roots (fileops.c:307-392).
    Regular: (n,) u32 operands.  Fast: (n, 2) u32 (operand, quotient)."""
    count = 2 * n if fast else n
    out = np.fromfile(path, dtype="<u4", count=count)
    assert out.size == count
    return out.reshape(n, 2) if fast else out


# ------------------------------------------------------------- text poly format

def format_poly(name: str, values) -> str:
    """print_poly_full text format (util_print.h:499-507).  Integer dtypes
    print as decimal ints; floats at 9 significant digits (round-trips
    float32, like the flpt printers with a full-precision format)."""
    vals = np.asarray(values)
    if np.issubdtype(vals.dtype, np.floating):
        body = ", ".join(f"{float(v):.9g}" for v in vals)
    else:
        body = ", ".join(str(int(v)) for v in vals)
    return f"{name} : {{ {body} }}\n"


_POLY_RE = re.compile(r"^\s*(.+?)\s*:\s*\{\s*(.*?)\s*,?\s*\}\s*$")


def parse_poly_line(line: str) -> tuple[str, list]:
    """Parse one 'name : { v0, v1, ... }' line; values as int when possible,
    else float (matches adapter fileops.h:221-300 parsing)."""
    m = _POLY_RE.match(line)
    if not m:
        raise ValueError(f"not a poly line: {line[:80]!r}")
    name, body = m.group(1), m.group(2)
    vals = []
    if body:
        for tok in body.split(","):
            tok = tok.strip()
            if not tok:
                continue
            try:
                vals.append(int(tok))
            except ValueError:
                vals.append(float(tok))
    return name, vals


def parse_poly_stream(lines) -> list[tuple[str, list]]:
    out = []
    for line in lines:
        if ":" in line and "{" in line and "}" in line:
            try:
                out.append(parse_poly_line(line))
            except ValueError:
                pass
    return out


def write_fft_roots(path: str, n: int, logn: int) -> None:
    """Forward (decode-direction) FFT root table, same indexing as the
    IFFT table but unconjugated (fileops.c:283 load_fft_roots;
    generate.cpp forward variant)."""
    import math
    m = 2 * n
    out = np.zeros(2 * n, dtype=np.float64)
    for i in range(n):
        k = (bitrev((i - 1) & (n - 1), logn) + 1) & (m - 1)
        ang = 2 * math.pi * k / m
        out[2 * i] = math.cos(ang)
        out[2 * i + 1] = math.sin(ang)
    out.astype("<f8").tofile(path)


# ------------------------------------------------- str_*.h header generation

def _bytes_as_c_array(name: str, data: bytes, per_line: int = 12) -> str:
    lines = [f"uint8_t {name}[{len(data)}] = {{"]
    for i in range(0, len(data), per_line):
        chunk = ", ".join(f"0x{b:02x}" for b in data[i:i + per_line])
        lines.append("    " + chunk + ",")
    lines.append("};")
    return "\n".join(lines) + "\n"


def write_str_header(path: str, name: str, data: bytes) -> None:
    """C-header form of a binary blob — the reference's
    SE_DATA_FROM_CODE_COPY consumption format (`str_*.h` files the adapter
    emits next to each .dat, adapter/fileops.cpp:173-304)."""
    guard = os.path.basename(path).upper().replace(".", "_").replace("-", "_")
    with open(path, "w") as f:
        f.write(f"#pragma once\n#include <stdint.h>\n"
                f"// generated by seal_embedded_tpu ({guard})\n")
        f.write(_bytes_as_c_array(name, data))


def write_sk_str_header(path: str, n: int, sk_packed: bytes) -> None:
    """`str_sk_<n>.h` in the adapter's exact emitted structure
    (adapter/fileops.cpp:86-161): decimal 2-bit-packed bytes in a
    `uint8_t secret_key[n/4]` array behind the SE_DATA_FROM_CODE guards."""
    nbytes = n // 4
    assert len(sk_packed) == nbytes
    with open(path, "w") as f:
        f.write('#pragma once\n\n#include "defines.h"\n\n')
        f.write("#if defined(SE_DATA_FROM_CODE_COPY) || "
                "defined(SE_DATA_FROM_CODE_DIRECT)\n")
        f.write("\n#include <stdint.h>\n\n")
        f.write("#ifdef SE_DATA_FROM_CODE_COPY\nconst\n#endif\n")
        f.write(f"// -- Secret key for polynomial ring degree = {n}\n")
        f.write(f"uint8_t secret_key[{nbytes}] = {{ ")
        parts = []
        for i in range(0, n, 4):
            byte = sk_packed[i // 4]
            pad = "  " if byte < 10 else (" " if byte < 100 else "")
            nl = "\n" if (i % 64) == 0 else ""
            sep = ", " if (i + 4) < n else "};\n"
            parts.append(f"{pad}{byte}{sep}{nl}")
        f.write("".join(parts))
        f.write("#endif\n")


def write_pk_str_headers(dirpath: str, parms: Parms, pk_components) -> None:
    """The adapter's full pk header set (adapter/fileops.cpp:173-304):
    per-prime `str_pk<k>_ntt_<n>_<q>.h` files declaring
    `ZZ pk<k>_prime<t>[n] = {0x..., ...}` plus the address-array header
    `str_pk_addr_array.h` with `ZZ* pk_prime_addr[L][2]` that the device
    indexes per prime under SE_DATA_FROM_CODE (fileops.c load_pki)."""
    n = parms.degree
    L = parms.nprimes
    addr_path = os.path.join(dirpath, "str_pk_addr_array.h")
    with open(addr_path, "w") as f3:
        f3.write('#pragma once\n\n#include "defines.h"\n\n')
        f3.write("#if defined(SE_DATA_FROM_CODE_COPY) || "
                 "defined(SE_DATA_FROM_CODE_DIRECT)\n\n")
        includes = []
        addr_rows = []
        for t, q in enumerate(parms.moduli):
            q = int(q)
            for k in (0, 1):
                common = f"pk{k}_ntt_{n}_{q}"
                includes.append(f'   #include "str_{common}.h"\n')
                vals = np.asarray(pk_components[t][k], dtype=np.uint64)
                with open(os.path.join(dirpath, f"str_{common}.h"),
                          "w") as f2:
                    f2.write('#pragma once\n\n#include "defines.h"\n\n')
                    f2.write("#if defined(SE_DATA_FROM_CODE_COPY) || "
                             "defined(SE_DATA_FROM_CODE_DIRECT)\n")
                    f2.write("#ifdef SE_DATA_FROM_CODE_COPY\nconst\n#endif\n")
                    f2.write(f"ZZ pk{k}_prime{t}[{n}] = {{ \n")
                    parts = []
                    for i, v in enumerate(vals):
                        sep = ", " if (i + 1) < n else "};\n"
                        nl = "\n" if (i % 8) == 0 else ""
                        parts.append(f"0x{int(v) & 0xFFFFFFFF:x}{sep}{nl}")
                    f2.write("".join(parts))
                    f2.write("#endif\n")
            addr_rows.append(f"    {{&(pk0_prime{t}[0]),"
                             f" &(pk1_prime{t}[0])}}")
        f3.write("".join(includes))
        f3.write("\n")
        f3.write(f"ZZ* pk_prime_addr[{L}][2] = \n{{\n")
        f3.write(",\n".join(addr_rows) + "\n};\n")
        f3.write("#endif\n")


# ------------------------------------------------------------- ciphertext bytes

def ct_component_bytes(component) -> bytes:
    """One RNS component (list/array of n coeffs) -> n*4 LE bytes — the
    payload the reference streams per prime (seal_embedded.c:196-203)."""
    return np.asarray(component, dtype=np.uint32).astype("<u4").tobytes()


def ct_component_from_bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype="<u4")


# ------------------------------------------------- seed-expandable sym ct

SEED_CT_MAGIC = b"SETPU1\x00\x00"


def seeded_ct_bytes(share_seed: bytes, c0_components) -> bytes:
    """Compressed symmetric ciphertext: (magic, n, L, 64-byte shareable
    seed, c0 per prime).  c1 regenerates from the seed on the receiver
    (ckks.limbwise.expand_c1) — the SE_ENABLE_SYM_SEED_CT capability
    (seal_embedded.c:184-194)."""
    c0 = np.asarray(c0_components, dtype=np.uint32)
    L, n = c0.shape
    head = SEED_CT_MAGIC + struct.pack("<II", n, L) + share_seed.ljust(64, b"\x00")
    return head + c0.astype("<u4").tobytes()


def seeded_ct_parse(data: bytes) -> tuple[bytes, np.ndarray]:
    """Inverse of seeded_ct_bytes: returns (share_seed, c0 (L, n))."""
    assert data[:8] == SEED_CT_MAGIC, "bad magic"
    n, L = struct.unpack("<II", data[8:16])
    seed = data[16:80]
    c0 = np.frombuffer(data[80:80 + 4 * n * L], dtype="<u4").reshape(L, n)
    return seed, c0
