"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``seal_embedded_tpu_torch/csrc/*.cu``
for Hopper (``sm_90a``), one process per source, all at once, and links
them into one shared library with a plain C interface, which ``ctypes``
loads.  Each entry point takes its pointers and the CUDA
stream as ``void*`` and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.

The library lands in ``build/seal_embedded_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  ``nvcc``'s report (with
``-Xptxas -v``: registers, shared memory, spills per kernel) is kept there
as ``nvcc.log``.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

from ...utils import timing

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "seal_embedded_tpu_torch")
LIB_NAME = "libseal_kernels.so"

# -fmad=false: no FMA contraction anywhere, so KE's f64 rounding matches
# the IEEE reference (encode.cu also uses the _rn intrinsics).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_lib = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the nvcc commands side by side; return their logs, or raise
    with the first failure's stderr once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return logs


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, all started together, then one link."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [so.with_name(f"{src.stem}.{tag}.o") for src in sources()]
    tmp = so.with_name(f"{LIB_NAME}.{tag}.tmp")
    try:
        logs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(sources(), objs)])
        _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    (so.parent / "nvcc.log").write_text("".join(logs))
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first call (a ``kernels.load``
    span, the build included)."""
    global _lib
    if _lib is None:
        with timing.span("kernels.load"):
            loaded = ctypes.CDLL(str(build()))
            loaded.sek_error_string.argtypes = [ctypes.c_int]
            loaded.sek_error_string.restype = ctypes.c_char_p
            _lib = loaded
    return _lib


def entry(name: str, argtypes: list):
    """A C entry point of the library, with its argument types declared."""
    fn = getattr(lib(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, name: str) -> None:
    """Raise if an entry point returned a CUDA error."""
    if code != 0:
        msg = lib().sek_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def require(cond: bool, msg: str) -> None:
    """Argument check of a kernel wrapper."""
    if not cond:
        raise ValueError(msg)


def on_cpu(name: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version), False when all lie on one CUDA device (it launches the
    kernel); raises on anything else.  Also requires contiguity."""
    devices = {t.device for t in tensors}
    require(len(devices) == 1, f"{name}: tensors on several devices "
            f"{sorted(map(str, devices))}")
    dev = devices.pop()
    require(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    require(all(t.is_contiguous() for t in tensors),
            f"{name}: inputs must be contiguous")
    return dev.type == "cpu"


def stream(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on t's device, for a launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
