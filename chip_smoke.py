#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

The main path is symmetric CKKS encode + encrypt (``SymEncryptor``, the
port of ``ckks/fast.py:sym_encrypt_fused``) with bit-exact encode at
n = 4096, L = 3, B = 1024.  Phases, one line each:

1. device: the card, its power limit, nvcc's version;
2. build: the kernels from ``seal_embedded_tpu_torch/csrc/`` (sm_90a);
3. each kernel (KK Keccak, KN NTT, KE encode) against its plain torch
   version at the main path's shapes, bit for bit, and timed beside it;
4. the port on the card against all seven C-reference golden files;
5. the headline batch with rows 0..5 set to golden vectors: verified,
   timed with CUDA events, peak memory;
6. the launch counters of that one headline run.

Imports no jax and nothing of the JAX package.  Any failure raises and
exits non-zero; there is no CPU fallback.  The last line is one JSON
object with "ok" and the device; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from seal_embedded_tpu_torch.ckks.fast import SymEncryptor
from seal_embedded_tpu_torch.config import default_parms
from seal_embedded_tpu_torch.convert import state_to_device, unpack_sk
from seal_embedded_tpu_torch.ops import encode as enc
from seal_embedded_tpu_torch.ops import keccak as kc
from seal_embedded_tpu_torch.ops import modarith as ma
from seal_embedded_tpu_torch.ops import ntt as ntt_ops
from seal_embedded_tpu_torch.ops import sampling as sp
from seal_embedded_tpu_torch.ops.kernels import build
from seal_embedded_tpu_torch.ops.kernels import encode as k_encode
from seal_embedded_tpu_torch.ops.kernels import keccak as k_keccak
from seal_embedded_tpu_torch.ops.kernels import ntt as k_ntt
from seal_embedded_tpu_torch.utils.timing import cuda_time_ms

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests"
GOLDEN_CONFIGS = ((1024, 1), (2048, 1), (4096, 3), (8192, 3), (8192, 6),
                  (16384, 3), (16384, 13))
N, L, B = 4096, 3, 1024
TIME_ITERS = 10

TPU = "seal_embedded_tpu/ops/kernels/"
K1 = TPU + "keccak.py:362 _squeeze_call"
K2 = TPU + "keccak.py:243 _squeeze_call_1blk"
K3 = TPU + "ntt.py:241 _pallas_ntt_call"
K4 = TPU + "ntt.py:269 _pallas_ntt_fused_sym_call"
K5 = TPU + "encode2.py:584 _encode_call"


def seed_bytes(tag: int) -> bytes:
    return bytes((tag + i) & 0xFF for i in range(64))


def u32(rng, shape, dev):
    return torch.as_tensor(rng.integers(0, 2 ** 32, shape, dtype=np.int64),
                           device=dev)


def max_abs_err(got, want) -> int:
    return int((got.cpu() - want.cpu()).abs().max())


def require_equal(name, got, want):
    err = max_abs_err(got, want)
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {nvcc[-1]}")
    print(smi)
    return smi


def phase_build():
    t0 = time.perf_counter()
    so = build.build()
    build.lib()
    secs = time.perf_counter() - t0
    # ptxas -v: per entry function, its spill line and its register line.
    report, name = [], None
    for ln in (so.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("spill" in ln or "Used" in ln):
            report.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    print(f"[2 build] {len(build.sources())} sources -> {so.name} in "
          f"{secs:.1f} s; ptxas: {' | '.join(report)}")


def timed_pair(kernel_fn, plain_fn):
    return cuda_time_ms(kernel_fn, TIME_ITERS), cuda_time_ms(plain_fn, 3, 1)


def phase_kernels(dev):
    rng = np.random.default_rng(1)
    rows = []

    def row(name, source, replaces, counter, err, ms, plain_ms, shape):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "counter": counter,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "shape": shape})

    # KK: the uniform base draw (121 blocks), the queue (nwords=1, 168 per
    # stream) and the CBD fills (nwords=24, 256 per stream), with counters
    # at 2^32 - 1 and 2^64 - 1 so the carry paths run.
    seeds = u32(rng, (B, 16), dev)
    ctr = u32(rng, (B, 2), dev)
    ctr[0] = torch.tensor([2 ** 32 - 1, 0])
    ctr[1] = torch.tensor([2 ** 32 - 1, 2 ** 32 - 1])
    ctr[2] = torch.tensor([2 ** 32 - 170, 7])
    nblocks = -(-4 * N // 136)
    cap = sp.queue_cap_for(N, default_parms(N, L).moduli)
    kk = "seal_embedded_tpu_torch/csrc/keccak.cu"
    cases = (("base", nblocks, None, ctr, K1),
             ("queue", 1, 1, sp._c_offsets(ctr, 1 + torch.arange(cap, device=dev)), K2),
             ("cbd", 1, 24, sp._c_offsets(ctr, torch.arange(N // 16, device=dev)), K2))
    for role, nb, nw, c, replaces in cases:
        s = kc.align_seed(seeds, c).expand(c.shape[:-1] + (16,))
        s = s.reshape(-1, 16).contiguous()
        c = c.reshape(-1, 2).contiguous()
        got = k_keccak.keccak_squeeze(s, c, nb, nw)
        want = kc.shake256_words(s, c, nb, nw)
        err = require_equal(f"KK {role}", got, want)
        ms, pms = timed_pair(lambda: k_keccak.keccak_squeeze(s, c, nb, nw),
                             lambda: kc.shake256_words(s, c, nb, nw))
        row(f"keccak_squeeze {role}", kk, replaces, "keccak", err, ms, pms,
            f"{s.shape[0]} streams x {nb} blocks, nwords={nw}")

    # KN at the main path's shapes: the fused c0 NTT (3, 1024, 4096) with
    # inputs that include q, and ntt(s) (3, 1, 4096); then one n = 16384 row.
    kn = "seal_embedded_tpu_torch/csrc/ntt.cu"
    for n, lim, batch, fused, replaces in ((N, L, B, True, K4),
                                           (N, L, 1, False, K3),
                                           (16384, 3, 1, False, K3),
                                           (16384, 3, 1, True, K4)):
        moduli = default_parms(n, lim).moduli
        op, quot = (torch.as_tensor(t.astype(np.int64), device=dev)
                    for t in ntt_ops.ntt_tables_stacked(n, moduli))
        q = torch.tensor(moduli, dtype=torch.int64, device=dev)
        qv = q[:, None, None]
        x = u32(rng, (lim, batch, n), dev) % (qv + 1)
        x[:, :, :8] = qv
        extra = {}
        if fused:
            a = u32(rng, (lim, batch, n), dev) % qv
            s_op = u32(rng, (lim, n), dev) % q[:, None]
            extra = {"a": a, "s_op": s_op,
                     "s_quot": ma.shoup_quotient(s_op, q[:, None])}
        got = k_ntt.ntt_fwd(x, op, quot, q, **extra)
        want = ntt_ops.ntt_limbs(x, op, quot, q)
        if fused:
            want = ntt_ops.sym_epilogue(want, extra["a"], extra["s_op"],
                                        extra["s_quot"], q)
        tag = "fused c0" if fused else "ntt"
        err = require_equal(f"KN {tag} n={n} B={batch}", got, want)
        if n == N:
            ms, pms = timed_pair(
                lambda: k_ntt.ntt_fwd(x, op, quot, q, **extra),
                lambda: (ntt_ops.sym_epilogue(
                    ntt_ops.ntt_limbs(x, op, quot, q), extra["a"],
                    extra["s_op"], extra["s_quot"], q) if fused
                    else ntt_ops.ntt_limbs(x, op, quot, q)))
            row(f"ntt_fwd {tag}", kn, replaces, "ntt", err, ms, pms,
                f"(L, B, n) = ({lim}, {batch}, {n})")
        else:
            print(f"[3 kernels] KN {tag} n={n} B={batch}: bit-equal")

    # KE at (1024, 2048) -> n = 4096 with edge rows: +0.0, -0.0, f32
    # subnormals, and magnitudes around the 2^63 overflow bound.  The
    # reference is the plain encode on CPU copies.
    parms = default_parms(N, L)
    vals = rng.uniform(-1, 1, (B, N // 2)).astype(np.float32)
    vals[0] = 0.0
    vals[1] = -0.0
    vals[2] = rng.choice(np.array([1e-45, -1e-45, 1e-40, -3e-39, 1.1e-38],
                                  dtype=np.float32), N // 2)
    vals[3, ::2] = 0.0
    for r, mag in enumerate((1e12, 8.0e12, 8.5e12, 1e13, 3e38)):
        vals[4 + r] *= np.float32(mag)
    v = torch.as_tensor(vals, device=dev)
    imap, tw_re, tw_im = enc.table_tensors(N, dev)
    sn = enc.scale_over_n(parms)
    coeff, ok = k_encode.encode_f64(v, imap, tw_re, tw_im, sn)
    want_c, want_ok = enc.encode_tables(v.cpu(), imap.cpu(), tw_re.cpu(),
                                        tw_im.cpu(), sn)
    if not torch.equal(ok.cpu(), want_ok):
        raise AssertionError("KE: ok flags differ from the plain version")
    if not (bool(want_ok[:5].all()) and not bool(want_ok[7:9].any())):
        raise AssertionError("KE: edge rows did not straddle the bound")
    err = require_equal("KE", coeff.cpu()[want_ok], want_c[want_ok])
    ms, pms = timed_pair(
        lambda: k_encode.encode_f64(v, imap, tw_re, tw_im, sn),
        lambda: enc.encode_tables(v, imap, tw_re, tw_im, sn))
    row("encode_f64", "seal_embedded_tpu_torch/csrc/encode.cu", K5, "encode",
        err, ms, pms, f"(B, vlen) = ({B}, {N // 2}), n = {N}; "
        f"{int((~want_ok).sum())} overflow rows")
    for r in rows:
        print(f"[3 kernels] {r['name']} {r['shape']}: bit-equal; "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms")
    return rows


def load_golden(n, nprimes):
    d = np.load(GOLDEN / f"golden_sym_{n}_{nprimes}.npz")
    G = sum(1 for k in d.files if k.startswith("v_"))
    return {
        "sk": unpack_sk(d["sk_packed_0"], n),
        "v": np.stack([d[f"v_{t}"] for t in range(G)]),
        "pte": np.stack([d[f"pte_{t}"] for t in range(G)]),
        "c0": np.stack([np.stack([d[f"c0_{nprimes * t + i}"]
                                  for t in range(G)]) for i in range(nprimes)]),
        "c1": np.stack([np.stack([d[f"c1_{nprimes * t + i}"]
                                  for t in range(G)]) for i in range(nprimes)]),
    }


def check_golden_rows(out, gold, name):
    G = gold["v"].shape[0]
    for key in ("c0", "c1"):
        got = out[key][:, :G].cpu().numpy()
        if not np.array_equal(got, gold[key]):
            raise AssertionError(f"{name}: {key} differs from the golden file")
    if not np.array_equal(out["pte"][:G].cpu().numpy(), gold["pte"]):
        raise AssertionError(f"{name}: pte differs from the golden file")
    if not bool(out["ok"].all()):
        raise AssertionError(f"{name}: ok is False")


def golden_seeds(G):
    return (np.tile(kc.seed_to_words(seed_bytes(2)), (G, 1)),
            np.tile(kc.seed_to_words(seed_bytes(3)), (G, 1)))


def phase_golden(dev):
    for n, nprimes in GOLDEN_CONFIGS:
        gold = load_golden(n, nprimes)
        G = gold["v"].shape[0]
        args = state_to_device(gold["v"], gold["sk"], *golden_seeds(G), dev)
        out = SymEncryptor(default_parms(n, nprimes), dev)(*args)
        check_golden_rows(out, gold, f"golden_sym_{n}_{nprimes}")
        print(f"[4 golden] golden_sym_{n}_{nprimes}.npz: {G} x {nprimes} "
              f"c0/c1/pte bit-exact on {dev}")


def phase_headline(dev, smi, kernel_rows):
    parms = default_parms(N, L)
    gold = load_golden(N, L)
    G = gold["v"].shape[0]
    rng = np.random.default_rng(0)
    values = rng.uniform(-1, 1, (B, N // 2)).astype(np.float32)
    share = rng.integers(0, 2 ** 32, (B, 16), dtype=np.int64).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B, 16), dtype=np.int64).astype(np.uint32)
    values[:G] = gold["v"]
    share[:G], err[:G] = golden_seeds(G)
    args = state_to_device(values, gold["sk"], share, err, dev)
    encryptor = SymEncryptor(parms, dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k_keccak.launches = k_ntt.launches = k_encode.launches = 0
    out = encryptor(*args)
    torch.cuda.synchronize()
    counts = {"keccak": k_keccak.launches, "ntt": k_ntt.launches,
              "encode": k_encode.launches}
    peak = torch.cuda.max_memory_allocated()
    check_golden_rows(out, gold, "headline batch")

    ms = cuda_time_ms(lambda: encryptor(*args), TIME_ITERS)
    print(f"[5 headline] n={N} L={L} B={B}: rows 0..{G - 1} golden-bitexact "
          f"({G}x{L}), ok for all {B}; {B / ms * 1e3:.1f} enc/s, "
          f"{ms:.3f} ms/batch (median of {TIME_ITERS}), peak "
          f"{peak / 2 ** 20:.1f} MiB; {torch.cuda.get_device_name(0)}, {smi}")
    for r in kernel_rows:
        print(f"[5 headline] kernel {r['name']} ({r['shape']}): "
              f"{r['ms']:.4f} ms, plain torch {r['plain_ms']:.4f} ms")
    return counts


def main():
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    phase_golden(dev)
    counts = phase_headline(dev, smi, rows)
    missing = [k for k, c in counts.items() if c < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    print(f"[6 launches] headline run: {counts}")
    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"],
                "replaces": r["replaces"], "launches": counts[r["counter"]],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]} for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
