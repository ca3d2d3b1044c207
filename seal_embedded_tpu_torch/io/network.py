"""Ciphertext streaming (reference: device/lib/network.{h,c}).

The reference POSTs each ciphertext component to a URL via curl on the
Sphere A7 and otherwise delegates to a SEND_FNCT_PTR callback
(seal_embedded.h:61-65).  Here: a callback seam (api.se_encrypt_seeded's
`send=`), plus ready-made senders — HTTP POST (urllib), a raw TCP sender,
and a file sink — all host-side (streaming is not perf-critical; the device
side only produces the bytes).  A copy of
``seal_embedded_tpu/io/network.py``.
"""

from __future__ import annotations

import io
import os
import socket
import urllib.request
from typing import Callable

SendFn = Callable[[bytes], int]


def http_sender(url: str, timeout: float = 10.0) -> SendFn:
    """POST each component to `url` (network.c:66-122 equivalent)."""
    def send(data: bytes) -> int:
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            resp.read()
        return len(data)
    return send


def tcp_sender(host: str, port: int) -> SendFn:
    """Raw TCP sender with a 4-byte LE length prefix per component."""
    sock = socket.create_connection((host, port))

    def send(data: bytes) -> int:
        sock.sendall(len(data).to_bytes(4, "little") + data)
        return len(data)
    return send


def file_sink(path: str) -> SendFn:
    """Append components to a file (each with 4-byte LE length prefix)."""
    f = open(path, "ab")

    def send(data: bytes) -> int:
        f.write(len(data).to_bytes(4, "little") + data)
        f.flush()
        return len(data)
    return send


def read_components(path: str) -> list[bytes]:
    """Inverse of file_sink."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            ln = int.from_bytes(hdr, "little")
            out.append(f.read(ln))
    return out


def collecting_sender() -> tuple[SendFn, list[bytes]]:
    """Fake network callback for tests (api_tests.c:30-42 equivalent)."""
    store: list[bytes] = []

    def send(data: bytes) -> int:
        store.append(data)
        return len(data)
    return send, store
