#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

The paths it drives, each with bit-exact encode at n = 4096, L = 3,
B = 1024: symmetric CKKS encode + encrypt (``SymEncryptor``, the port of
``ckks/fast.py:sym_encrypt_fused``); public-key generation plus
asymmetric encode + encrypt (``gen_pk_batch`` and ``AsymEncryptor``, the
port of ``ckks/asym.py``); the limb-scan encryptor in its reference,
parallel and reverse-order forms (``ckks/limbwise.py``) and the per-prime
``sym_encrypt_batch`` (``ckks/sym.py``), with ``expand_c1`` and
``decrypt_batch`` as their checks; the public API (``api.py``) and the
per-prime streams (``ckks/stream.py``, each compiled as one graph)
on the same inputs; the compiled factories (``graphs.py``: each captured
as a CUDA graph per input signature and replayed), the scale-out ones
with their NCCL collectives; the compiled fused sym and asym factories
at the JAX package's deep chains and batches up to 10240; and the op-mix
calibration that gives every kernel its measured ceiling.  Phases, one
line each:

1. device: the card, its power limit, nvcc's version;
2. build: the kernels from ``seal_embedded_tpu_torch/csrc/`` (sm_90a);
3. each kernel (KK Keccak in its base, queue, CBD, ternary roles, with
   explicit counters and seed-broadcast, and its CBD-values role; KN NTT
   unfused and fused from the int64 pte on edge values; KA asym NTT from
   the signed u, e1 and edge pte values at (3, 1024, 4096), (1, 1024,
   4096) and n = 16384; KE encode with edge rows at n = 4096 (one block a
   row), 8192 and 16384 (a 2-CTA cluster a row)) against its plain torch
   version at the main path's shapes, bit for bit, and timed beside it
   through its wrapper and alone (the profiler's kernel time);
3b. calibrate: KC (both op mixes) against its plain version, bit for
   bit, and timed beside it; the measured keccak and ntt ceilings at a
   full-card tile count; each row's bound (its bytes at 3.35 TB/s, its
   integer instructions at the SMs' integer rate, or its f64 operations
   at their f64 rate, the largest), which its time alone may not beat,
   its roofline share, and each KK, KN and KA row's
   sol_frac_calibrated through the wrapper and alone;
4. the port on the card against all seven sym and all three asym
   C-reference golden files (pk generation included), the sym goldens
   also through the limb-scan encryptor, sym_encrypt_batch and expand_c1;
4b. the ternary draw's unbounded redraw: two seeds whose first block
   needs more than 8 refills, planted in a B = 512 batch at 4096/3 and
   16384/13, through ``se_encrypt_streaming`` asym: no call raises, no
   row is run again (KK's ternary role draws them exact), the public key
   and the rows bit-equal to the NumPy reference
   (``benchmark/reference``); the call's time with and without the
   planted seeds;
5. the headline batches (sym, asym, limb-scan reference, parallel and
   reverse, sym_encrypt_batch), rows 0..5 golden where the layout is the
   reference's, the others checked by expand_c1 and decrypt_batch: timed
   with CUDA events, peak memory; sym and asym also on the host clock;
5b. api + stream, on the sym headline's inputs: ``se_setup_custom`` +
   ``se_encrypt_seeded`` sym (golden rows, torch.equal to
   ``SymEncryptor``, the sent bytes on 16 messages, the seed-only blobs
   through ``expand_c1`` and ``decrypt_batch``, ``se_decrypt_decode``) and
   asym from a pk directory written by ``io.serialize`` (golden rows);
   the compiled streams (``graphs.Chain``: the prologue's graph and one
   a limb in one pool, the limbs written into a ring of two slots, an
   event after each limb, one entry per signature) through
   ``sym_encrypt_stream`` forward and reverse and ``asym_encrypt_stream``:
   the first call's capture and the memory it leaves reserved, every limb
   equal to the eager batch's, launches per stream those one call must
   make (``stream_launches``), a stream abandoned after its first limb and
   a whole one after it, no capture after the first call, timed beside the
   compiled batch plus its fetch (rotated rounds), host waits per limb,
   the footprint (pool resident plus the peak above the inputs; a sym
   stream's may not exceed the compiled batch's); two asym
   streams of different B and keys, limb by limb in turn, each equal to its
   batch; ``se_encrypt_streaming`` sym and asym twice each, the second call
   replaying the context's cached stream, and ``se_cleanup`` zeroing the
   stream's copy of the key; the compiled sym stream at n = 16384, L = 13,
   B = 64 (13 limb graphs and events, KE's 2-CTA clusters in its
   prologue), golden rows limb by limb, the launches one call must make, a
   second call that captures nothing; the adapter's CRT verify of two of the card's
   ciphertexts, whole and with one coefficient of prime 2 flipped;
6. the launch counters of each headline run, each 5b run, each phase 7
   and phase 8 run and of the calibration;
7. scale-out at world size 1 (one NCCL rank, ``parallel/``), at the
   headline's shape, every sharded function compiled (``graphed``, its
   NCCL collectives inside the graph): the limb-sharded sym encryptor on
   a (1, 1) mesh (equal to the limb-scan parallel layout, decrypted), the
   limb-sharded asym one (golden rows, equal to ``AsymEncryptor``),
   ``sym_encrypt_sharded`` (equal to ``sym_encrypt_batch``) and the
   multi-host encryptor on (1, 1, 1), each against its eager run (bits,
   ``Shards.index``, launches and ``comm.counts`` per replay) and timed
   beside it and its single-device path (alternated pairs, host clock,
   device busy, idle share, peak above the inputs, first call), and the
   sym path's two collectives alone; the limb-sharded sym at n = 16384,
   L = 13; the compiled coefficient-sharded NTT in both plans at n =
   4096 and 16384 against KN and its eager run; the config sweep at
   degree 4096 on the card; a ``CheckpointedRunner`` restart of the sym
   headline, bit-exact.

8. compiled entry points (``graphs.py``), at the headline's shape: every
   compiled factory (the fused sym encryptor, the limb-scan encryptor in
   its four forms, the from-pte encryptor, the c1 expander, the asym
   encryptor with the key among the graph's inputs, the decryptor
   canonical and lazy, the decoder, the API's range check) against its
   eager module on the same inputs (golden rows where the layout is the
   reference's), a second call on other inputs (another key for asym)
   that leaves the first call's outputs unchanged, a B = 512 call that
   captures a second graph; launches per replay against eager's per call
   (counters), the graph's kernel nodes against the kernels an eager call
   runs and the port's kernels a replay runs (profiler); compiled against
   eager in alternated pairs (CUDA events, host clock, device busy, idle
   share, peak above the inputs) and the first call's time; KE's 2-CTA
   cluster launch inside a graph (n = 16384, L = 13, golden rows); the
   API's compiled functions replayed in phase 5b.

9. depth: the JAX package's own tracked sizes through the compiled fused
   factories (``make_fused_encryptor``, ``make_fused_asym_encryptor``
   with the pk from ``gen_pk_batch``), in order: sym n = 8192, L = 6 and
   n = 16384, L = 13 at B = 1024, asym 8192/6 at B = 1024 and 16384/13
   at B = 512 (``bench.py``'s deep rows), and the n = 4096, L = 3 batch
   sweep at B = 1024, 2048, 4096, 8192 and 10240 (``bsweep``, and
   ``BASELINE.json``'s 10k+); each batch with the golden rows at both
   ends, bit-exact and ok for all, a first call that captures (its time
   and the memory it leaves reserved), one eager call of the same module
   equal bit for bit with the same launches, eight middle rows as a
   batch of 8 (a second signature) equal to the large batch's rows, CUDA
   events and host clock, device busy and idle share, the peak above the
   inputs and the footprint, and memory_reserved before and after; every
   signature's graph is kept, and the phase states what they hold of the
   card.  At the deep shapes, on the batches' own tensors, KK's base
   squeeze (13 x 1024 streams of 482 blocks) and its queue and CBD roles
   at B = 10240, KN's ntt(s) at (13, 1, 16384), KN from pte at (13,
   1024, 16384), KA at (13, 512, 16384) and KE at (1024, 16384) (2-CTA
   clusters) and (10240, 4096), each against the batch's output and its
   plain version, timed through its wrapper, alone and against its bound.

10. custom chain: the chain (536903681, 1053818881, 1054015489), scale
   2^25, which Parms accepts and whose first prime rejects 12.5% of the
   uniform sampler's words (queue caps 1,472 at n = 8192 and 2,768 at
   16384, the C loop's redraws: beyond the 160 a 4096-wide chunk the
   default chains fit in),
   at n = 8192 and 16384: the compiled fused sym factory at B = 1024 and
   the compiled fused asym one (pk from gen_pk_batch) at B = 1024 and
   512, ok for every row, rows 0, 1 and B-1 and the pk bit-exact against
   the C loop (golden/ckks.py sym_encrypt, gen_pk, asym_encrypt); the
   limb-scan reference layout and the compiled sym stream (every limb)
   equal to the fused batch; the world-size-1 limb-sharded sym on a B =
   8 slice equal to the single-device parallel layout and decrypted; KK's
   queue at per_seed 1,472 and 2,768, KN from pte at (3, 1024, n) and KA
   at (3, 1024, 8192) and (3, 512, 16384) against their plain versions
   on the batches' tensors, timed alone against their bounds; each batch
   timed beside the default chain's at the same (n, L = 3) (CUDA events
   in alternated pairs, enc/s, busy, idle share, footprint; the default
   sym batch's golden rows at both ends); the rank-select and KK's queue
   of one limb alone on both chains; KK's uniform role (the base squeeze,
   rank-select and barrett32 of a limb in one launch) bit-equal to its
   plain version on 1024 streams (counters at 2^32 - 1 and 2^64 - 1), on
   every limb at 4096/3, the first and last at 16384/13 and chain C's
   first prime at both degrees, with ok-false rows (a queue of 8, chain
   C under the default cap), timed alone against its bound; the compiled
   sym streams at 4096/3 and 16384/13 launch it once a limb a call;
   KK's ternary role (a call's whole ternary draw in one launch) bit-equal
   to its plain version (sample_ternary_exact's loop on the CPU) at n =
   4096, 8192 and 16384 and B = 1, 16, 512 and 1024, the planted seeds
   and counters at 2^32 - 3 and 2^64 - 3 among the streams, and at n =
   4096 with its window forced down to 1, 2, 33 and 97 counters; its
   window's permutations beside those consumed, and its time alone
   against its bound at (16384, 512) and (4096, 1024);

11. entry: ``seal_embedded_tpu_torch.entry.entry()`` (the compiled
   ``sym_encrypt_batch`` at n = 4096, L = 3, B = 4) on the card, its
   first call timed, two replays each equal to the same fn on the CPU
   path, rows 0..3 bit-exact against golden/ckks.py, ms a call.

12. memory: the device registry of compiled entries (``graphs.Registry``)
   in the process phases 1 to 11 filled with graphs.  (a) The compiled
   fused sym factory at n = 16384, L = 13 in turn at B = 1024, 2048, 3072,
   4096, 5120 and 1024 again (``perf_memory.py``'s sequence: each batch
   fits the card alone, their graphs together do not), golden at both
   ends of every batch, per call the entries evicted, its ms and
   memory_reserved; (b) the same factory at B = 128, 256, ..., 1024, each
   signature's resident bytes and footprint, their sum, what the registry
   kept; (c) the compiled sym stream at 16384/13, B = 1024, and the asym
   one at B = 512, golden limb by limb at both ends and every limb equal
   to the fused batch's, the launches one call must make, the pool (at most
   ``STREAM_POOL_MIB``, beside ``EVERY_LIMB_POOL_MIB``), the footprint
   and the streamed ms beside the batch + fetch, and the sym stream's
   pool at L = 3 on the same inputs within ``RING_GAP_MIB`` of its pool
   at L = 13 (its limbs equal to SymEncryptor's); (d) phase 5's
   headline sym, every phase 8
   factory and every phase 9 batch again, captured again where evicted,
   golden or equal to their eager modules, and the whole call of a live
   entry within 0.05 ms of the call as it was before the registry
   (``perf_memory.call_cost``, each beside ``Entry.replay``), and a
   compiled function that its caller drops leaves the registry zeroed.
   Evicting or dropping a function's entries must give their pools back
   (memory_reserved).  (e) The caller's tensors before idle entries:
   ``perf_memory.run_held`` through the same factory (B = 1024, 2048 and
   3072 captured, then 16 calls at B = 1024 holding every output, each
   golden at both ends once all are held, the B = 1024 entry never
   evicted), and ``se_encrypt_seeded`` with ``send`` at 16384/13, B =
   1024, on a card that idle entries fill to under 2 GiB free, its sent
   bytes golden at both ends.

Phases 7 to 12 run before phase 6 prints, so their runs are in phase
6's list; phases 4, 5 and 5b call the factories, so they capture graphs
too.
Imports no jax and nothing of the JAX package.  Any failure raises and
exits non-zero; there is no CPU fallback.  The last line is one JSON
object with "ok" and the device; the line before it lists the kernels.
"""

from __future__ import annotations

import collections
import gc
import json
import pathlib
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from benchmark.peaks import (HBM_BYTES_PER_S, INSTR_PER_BUTTERFLY,
                             INSTR_PER_PERMUTATION, int_rate)
from perf_memory import (HOLD_B, HOLD_CALLS, HOLD_FIRST, SEQUENCE,
                         SEQUENCE_L, SEQUENCE_N, call_cost, run_held,
                         run_sequence, timed_call)
from perf_stages import PORT_KERNELS, kernel_alone_ms, timeline, trace
from seal_embedded_tpu_torch import adapter, api, graphs, sweep
from seal_embedded_tpu_torch.ckks import stream
from seal_embedded_tpu_torch.ckks.asym import (AsymEncryptor, gen_pk_batch,
                                              make_asym_encryptor,
                                              make_fused_asym_encryptor)
from seal_embedded_tpu_torch.ckks.fast import (SymEncryptor,
                                              make_fused_encryptor)
from seal_embedded_tpu_torch.ckks.limbwise import (LimbscanEncryptor,
                                                  expand_c1,
                                                  make_c1_expander,
                                                  make_from_pte_encryptor,
                                                  make_limbscan_encryptor)
from seal_embedded_tpu_torch.ckks.sym import (Decryptor, decrypt_batch,
                                             make_decryptor,
                                             sym_encrypt_batch)
from seal_embedded_tpu_torch.config import Parms, default_parms
from seal_embedded_tpu_torch.convert import (asym_state_to_device,
                                             pk_to_device, state_to_device,
                                             unpack_sk)
from seal_embedded_tpu_torch.entry import entry as port_entry
from seal_embedded_tpu_torch.golden import ckks as gckks
from seal_embedded_tpu_torch.io import network, serialize
from seal_embedded_tpu_torch.ops import calibrate as cal
from seal_embedded_tpu_torch.ops import encode as enc
from seal_embedded_tpu_torch.ops.encode import Decoder, make_decoder
from seal_embedded_tpu_torch.ops import keccak as kc
from seal_embedded_tpu_torch.ops import modarith as ma
from seal_embedded_tpu_torch.ops import ntt as ntt_ops
from seal_embedded_tpu_torch.ops import sampling as sp
from seal_embedded_tpu_torch.ops.kernels import build
from seal_embedded_tpu_torch.ops.kernels import calibrate as k_calib
from seal_embedded_tpu_torch.ops.kernels import counters
from seal_embedded_tpu_torch.ops.kernels import encode as k_encode
from seal_embedded_tpu_torch.ops.kernels import keccak as k_keccak
from seal_embedded_tpu_torch.ops.kernels import ntt as k_ntt
from seal_embedded_tpu_torch.parallel import comm, launch
from seal_embedded_tpu_torch.parallel import multihost as mh
from seal_embedded_tpu_torch.parallel.coeff_ntt import ntt_coeff_sharded
from seal_embedded_tpu_torch.parallel.limbwise import (
    make_asym_limb_sharded_encryptor, make_limb_sharded_encryptor)
from seal_embedded_tpu_torch.parallel.mesh import (Shards, make_mesh,
                                                  sym_encrypt_sharded)
from seal_embedded_tpu_torch.utils.checkpoint import (CheckpointJournal,
                                                      CheckpointedRunner)
from seal_embedded_tpu_torch.utils.timing import cuda_time_ms

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests"
GOLDEN_CONFIGS = ((1024, 1), (2048, 1), (4096, 3), (8192, 3), (8192, 6),
                  (16384, 3), (16384, 13))
ASYM_GOLDEN_CONFIGS = ((4096, 3), (8192, 6), (16384, 13))
N, L, B = 4096, 3, 1024
TIME_ITERS = 10
KE_ROWS = 256       # KE's rows at n = 8192 and 16384

TPU = "seal_embedded_tpu/ops/kernels/"
K1 = TPU + "keccak.py:362 _squeeze_call"
K2 = TPU + "keccak.py:243 _squeeze_call_1blk"
K3 = TPU + "ntt.py:241 _pallas_ntt_call"
K4 = TPU + "ntt.py:269 _pallas_ntt_fused_sym_call"
K5 = TPU + "encode2.py:584 _encode_call"
K6 = TPU + "ntt.py:342 ntt_coeff_major_fused_asym"
K7 = TPU + "calibrate.py:94 _calib_call"

# KC: the bit-for-bit check and the kernel-vs-plain timing run short
# loops that the plain version can take; the ceilings run long ones.  A
# full card is 2 blocks of 1024 threads on every SM; the ceiling tries 2,
# 4 and 6 blocks per SM with the same work per call (2 x 1024 x 32768
# lane-iterations per SM), 10 to 50 ms per call.
CALIB_CHECK_ITERS = 64
CALIB_MID_ITERS = 512
CALIB_BLOCKS_PER_SM = (2, 4, 6)
CALIB_LANE_ITERS_PER_SM = 2 * 1024 * 32768

# Bounds.  Bytes: each input read once and each output written once, a
# value at the width it needs (u32 words and values below q 4 bytes, pte
# and KE's coefficients 8, CBD values in [-63, 63] 1), at the HBM rate.
# Operations: the 32-bit integer-pipe instructions the work needs at
# least, at the SMs' integer rate.  Both rates, and the instructions of a
# Keccak-f[1600] permutation and of a Harvey butterfly, are those of the
# benchmark's table of peaks (benchmark/peaks.py).  KC's mixes, per chain
# and iteration: keccak a rotation and 2 LOP3, 3; ntt a butterfly per
# pair of chains, 2.
#
# f64, which the benchmark's table does not hold: 64 add or multiply
# results per clock per SM (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0); KE needs 10 a butterfly (2 adds, 2
# subtractions and 4 products for u + w and (u - w) * s, complex) and 2 a
# coefficient (the scaling product and the rounding's add).
F64_OPS_PER_SM_CLOCK = 64
F64_OPS_PER_BUTTERFLY = 10
F64_OPS_PER_COEFF = 2
INT_OPS_PER_UNIT = {"keccak": INSTR_PER_PERMUTATION,
                    "ntt": INSTR_PER_BUTTERFLY}
INT_OPS_PER_MIX_CHAIN = {"keccak": 3, "ntt": 2}

# The kernels each path must launch (the names of ops/kernels/counters.py):
# sym's c0 comes from KN's from-pte entry, sym_encrypt_batch's from KN
# unfused and a torch combine.
SYM_PATH = ("keccak", "keccak_uniform", "keccak_cbd", "ntt", "ntt_pte",
            "encode")
TABLE_PATH = ("keccak", "keccak_uniform", "keccak_cbd", "ntt", "encode")
ASYM_PATH = ("keccak_ternary", "keccak_cbd", "ntt_asym", "encode")


def seed_bytes(tag: int) -> bytes:
    return bytes((tag + i) & 0xFF for i in range(64))


def u32(rng, shape, dev):
    return torch.as_tensor(rng.integers(0, 2 ** 32, shape, dtype=np.int64),
                           device=dev)


def max_abs_err(got, want) -> int:
    """On got's device: a deep batch's copy to the host would take
    seconds."""
    return int((got - want.to(got.device)).abs().max())


def require_equal(name, got, want):
    err = max_abs_err(got, want)
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def phase_device():
    """The card: returns (its name and power limit as nvidia-smi gives
    them, its SMs times their maximum clock in Hz: the per-SM-per-clock
    rates times this are the card's rates)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = nvidia_smi("name,power.limit")
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_hz = sms * mhz * 1e6
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {nvcc[-1]} | "
          f"{sms} SMs, max SM clock {mhz:.0f} MHz: integer pipe "
          f"{int_rate(sm_hz) / 1e12:.3f} Tinstr/s")
    print(smi)
    return smi, sm_hz


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


def set_kernel_alone_ms(rows):
    """Each row's "kernel_ms": device ms per call of its "fn" in the
    port's own kernels, the kernel alone; the fn is dropped after (its
    inputs would count in the later phases' peaks)."""
    for r, ms in zip(rows, kernel_alone_ms([r.pop("fn") for r in rows],
                                           TIME_ITERS)):
        r["kernel_ms"] = ms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def u32_bytes(*tensors) -> int:
    """The bytes of u32 values (held in int64), at 4 bytes each."""
    return 4 * sum(t.numel() for t in tensors)


def kernel_row(name, source, replaces, counter, err, fn, ms, plain_ms, shape,
               work, moved, f64_ops=0) -> dict:
    """One kernel row: fn, kept so that it binds its inputs, timed through
    the wrapper (ms) and, in set_kernel_alone_ms, alone; plain_ms its plain
    version's time.  work: ("keccak", permutations) or ("ntt",
    butterflies), from which bound_line reckons the integer instructions
    and phase 3b sol_frac_calibrated; moved: the bytes the function must
    read and write, each input once and each output once; f64_ops: the f64
    operations it must do."""
    ops = 0 if work is None else work[1] * INT_OPS_PER_UNIT[work[0]]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "counter": counter, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "fn": fn, "shape": shape,
            "work": work, "ops": ops, "f64_ops": f64_ops, "bytes": moved}


def phase_kernels(dev):
    rng = np.random.default_rng(1)
    rows = []

    def row(name, source, replaces, counter, err, fn, plain_fn, *args,
            **kwargs):
        """A kernel_row, fn and its plain version plain_fn timed."""
        rows.append(kernel_row(name, source, replaces, counter, err, fn,
                               *timed_pair(fn, plain_fn), *args, **kwargs))

    # KK: the uniform base draw (121 blocks, one warp per stream), the
    # queue (nwords=1, 160 per stream: the chain-aware queue_cap_for) and
    # the CBD fills (nwords=24, 256 per stream) with explicit counters, the
    # same two through the seed-broadcast form the samplers call, and the
    # CBD values role, with counters at 2^32 - 1 and 2^64 - 1 so the carry
    # paths run.
    seeds = u32(rng, (B, 16), dev)
    ctr = u32(rng, (B, 2), dev)
    ctr[0] = torch.tensor([2 ** 32 - 1, 0])
    ctr[1] = torch.tensor([2 ** 32 - 1, 2 ** 32 - 1])
    ctr[2] = torch.tensor([2 ** 32 - 170, 7])
    nblocks = -(-4 * N // 136)
    cap = sp.queue_cap_for(N, default_parms(N, L).moduli)
    nfills = N // 16
    kk = "seal_embedded_tpu_torch/csrc/keccak.cu"
    tq = 1 + torch.arange(sp.TERNARY_QUEUE_CAP, device=dev)
    cases = (("base", nblocks, None, ctr, K1),
             ("queue", 1, 1, kc.counter_offsets(
                 ctr, 1 + torch.arange(cap, device=dev)), K2),
             ("cbd", 1, 24, kc.counter_offsets(
                 ctr, torch.arange(nfills, device=dev)), K2),
             ("ternary", 1, 24, ctr, K2),
             ("ternary queue", 1, 1, kc.counter_offsets(ctr, tq), K2))
    for role, nb, nw, c, replaces in cases:
        s = kc.align_seed(seeds, c).expand(c.shape[:-1] + (16,))
        s = s.reshape(-1, 16).contiguous()
        c = c.reshape(-1, 2).contiguous()
        got = k_keccak.keccak_squeeze(s, c, nb, nw)
        want = kc.shake256_words(s, c, nb, nw)
        err = require_equal(f"KK {role}", got, want)
        row(f"keccak_squeeze {role}", kk, replaces, "keccak", err,
            lambda s=s, c=c, nb=nb, nw=nw: k_keccak.keccak_squeeze(
                s, c, nb, nw),
            lambda: kc.shake256_words(s, c, nb, nw),
            f"{s.shape[0]} streams x {nb} blocks, nwords={nw}",
            ("keccak", s.shape[0] * nb), u32_bytes(s, c, got))
    for role, per_seed, start, nw in (("queue broadcast", cap, 1, 1),
                                      ("cbd broadcast", nfills, 0, 24)):
        offs = start + torch.arange(per_seed, device=dev)
        got = k_keccak.keccak_squeeze(seeds, ctr, 1, nw, per_seed, start)
        want = kc.shake256_words(seeds, kc.counter_offsets(ctr, offs), 1,
                                 nw).reshape(B * per_seed, nw)
        err = require_equal(f"KK {role}", got, want)
        row(f"keccak_squeeze {role}", kk, K2, "keccak", err,
            lambda nw=nw, per_seed=per_seed, start=start:
                k_keccak.keccak_squeeze(seeds, ctr, 1, nw, per_seed, start),
            lambda: kc.shake256_words(seeds, kc.counter_offsets(ctr, offs),
                                      1, nw),
            f"{B} seeds x {per_seed} streams from counter + {start}, "
            f"nwords={nw}", ("keccak", B * per_seed),
            u32_bytes(seeds, ctr, got))
    got = k_keccak.cbd_values(seeds, ctr, N)
    err = require_equal("KK cbd values", got, kc.cbd_values(seeds, ctr, N))
    row("cbd_values", kk, K2, "keccak_cbd", err,
        lambda: k_keccak.cbd_values(seeds, ctr, N),
        lambda: kc.cbd_values(seeds, ctr, N),
        f"{B} seeds x {nfills} fills -> (B, n) = ({B}, {N}) values",
        ("keccak", B * nfills), u32_bytes(seeds, ctr) + got.numel())

    # KN at the main paths' shapes, on inputs that include q: ntt(s)
    # (3, 1, 4096) and sym_encrypt_batch's ntt(pte) (3, 1024, 4096); then
    # n = 16384; then KN from pte (the main path's c0) at (3, 1024, 4096),
    # the stream's (1, 1024, 4096) and n = 16384, on edge pte values.
    kn = "seal_embedded_tpu_torch/csrc/ntt.cu"

    def tables(n, lim):
        moduli = default_parms(n, lim).moduli
        op, quot = (torch.as_tensor(t.astype(np.int64), device=dev)
                    for t in ntt_ops.ntt_tables_stacked(n, moduli))
        return moduli, op, quot, torch.tensor(moduli, dtype=torch.int64,
                                              device=dev)

    for n, lim, batch in ((N, L, 1), (N, L, B), (16384, 3, 1)):
        moduli, op, quot, q = tables(n, lim)
        x = u32(rng, (lim, batch, n), dev) % (q[:, None, None] + 1)
        x[:, :, :8] = q[:, None, None]
        got = k_ntt.ntt_fwd(x, op, quot, q)
        tag = "ntt" if batch == 1 else f"ntt B={batch}"
        err = require_equal(f"KN {tag} n={n}", got,
                            ntt_ops.ntt_limbs(x, op, quot, q))
        if n == N:
            row(f"ntt_fwd {tag}", kn, K3, "ntt", err,
                lambda x=x, op=op, quot=quot, q=q: k_ntt.ntt_fwd(
                    x, op, quot, q),
                lambda: ntt_ops.ntt_limbs(x, op, quot, q),
                f"(L, B, n) = ({lim}, {batch}, {n})",
                ("ntt", k_calib.ntt_butterflies(lim, batch, n)),
                u32_bytes(x, op, quot, q, got))
        else:
            print(f"[3 kernels] KN {tag} n={n} B={batch}: bit-equal")

    for n, lim, batch in ((N, L, B), (N, 1, B), (16384, 3, 1)):
        moduli, op, quot, q = tables(n, lim)
        mods = ma.modpack(moduli, dev)
        pte = edge_pte(rng, moduli, batch, n, dev)
        a = u32(rng, (lim, batch, n), dev) % q[:, None, None]
        s_op = u32(rng, (lim, n), dev) % q[:, None]
        args = (pte, a, s_op, ma.shoup_quotient(s_op, q[:, None]), op, quot,
                q, mods.r0, mods.r1)
        got = k_ntt.ntt_sym_from_pte(*args)
        err = require_equal(f"KN from pte n={n} L={lim} B={batch}", got,
                            ntt_ops.ntt_sym_from_pte_plain(*args))
        if n == N:
            row(f"ntt_sym_from_pte L={lim}", kn, K4, "ntt_pte", err,
                lambda args=args: k_ntt.ntt_sym_from_pte(*args),
                lambda: ntt_ops.ntt_sym_from_pte_plain(*args),
                f"pte (B, n) = ({batch}, {n}) -> (L, B, n) = ({lim}, "
                f"{batch}, {n}), edge pte values",
                ("ntt", k_calib.ntt_butterflies(lim, batch, n)),
                nbytes(pte) + u32_bytes(*args[1:], got))
        else:
            print(f"[3 kernels] KN from pte n={n} L={lim} B={batch}, edge "
                  "pte values: bit-equal")

    # KA from the signed u, e1 and the int64 pte: at the asym headline's
    # shape with the 4096_3 golden pk, at the stream's per-limb shape (its
    # first limb), and at n = 16384 with the 16384_13 golden pk.  u holds
    # every value of {-1, 0, 1}, e1 +-63 and 0, pte the edge values.
    for n, lim, batch in ((N, L, B), (N, 1, B), (16384, 13, 2)):
        gold = load_golden("asym", n, max(lim, L))
        pk = [p[:lim] for p in pk_to_device(gold["pk0"], gold["pk1"], dev)]
        moduli, op, quot, q = tables(n, max(lim, L))
        moduli, op, quot, q = moduli[:lim], op[:lim], quot[:lim], q[:lim]
        mods = ma.modpack(moduli, dev)
        u = torch.as_tensor(rng.integers(-1, 2, (batch, n)), device=dev)
        u[:, :3] = torch.tensor([-1, 0, 1])
        e1 = torch.as_tensor(rng.integers(-63, 64, (batch, n)), device=dev)
        e1[:, :3] = torch.tensor([-63, 0, 63])
        pte = edge_pte(rng, moduli, batch, n, dev)
        args = (u, e1, pte, op, quot, q, mods.r0, mods.r1)
        for p in pk:
            args += (p, ma.shoup_quotient(p, q[:, None]))
        got = k_ntt.ntt_asym_from_signed(*args)
        want = ntt_ops.ntt_asym_from_signed_plain(*args)
        err = max(require_equal(f"KA {c} n={n} L={lim} B={batch}", g, w)
                  for c, g, w in zip(("c0", "c1"), got, want))
        if n == N:
            row(f"ntt_asym_from_signed L={lim}", kn, K6, "ntt_asym", err,
                lambda args=args: k_ntt.ntt_asym_from_signed(*args),
                lambda args=args: ntt_ops.ntt_asym_from_signed_plain(*args),
                f"u, e1, pte (B, n) = ({batch}, {n}) -> (L, B, n) = ({lim}, "
                f"{batch}, {n}), golden pk, edge pte values",
                ("ntt", k_calib.ntt_butterflies(lim, batch, n, 3)),
                u.numel() + e1.numel() + nbytes(pte)
                + u32_bytes(*args[3:], *got))
        else:
            print(f"[3 kernels] KA n={n} L={lim} B={batch}, edge pte "
                  "values: bit-equal")

    # KE with edge rows: +0.0, -0.0, f32 subnormals, half-zero rows, and
    # rows scaled so their largest coefficient lands at 0.5 and 0.99 of
    # the 2^63 overflow bound, at 1.02 and 2 times it, and 3e38: at n =
    # 4096 (the main path's shape, one block a row), 8192 and 16384 (a
    # 2-CTA cluster a row).  The reference is the plain encode on CPU
    # copies.
    ke = "seal_embedded_tpu_torch/csrc/encode.cu"
    for n, batch in ((N, B), (8192, KE_ROWS), (16384, KE_ROWS)):
        sn = enc.scale_over_n(default_parms(n, L))
        imap, tw_re, tw_im = enc.table_tensors(n, dev)
        tabs = [t.cpu() for t in (imap, tw_re, tw_im)]
        v = torch.as_tensor(ke_edge_values(rng, n, batch, tabs, sn),
                            device=dev)
        coeff, ok = k_encode.encode_f64(v, imap, tw_re, tw_im, sn)
        want_c, want_ok = enc.encode_tables(v.cpu(), *tabs, sn)
        if not torch.equal(ok.cpu(), want_ok):
            raise AssertionError(f"KE n={n}: ok flags differ from the plain "
                                 "version")
        if not (bool(want_ok[:6].all()) and not bool(want_ok[6:9].any())):
            raise AssertionError(f"KE n={n}: edge rows did not straddle "
                                 "the bound")
        err = require_equal(f"KE n={n}", coeff.cpu()[want_ok],
                            want_c[want_ok])
        logn = n.bit_length() - 1
        ctas = 1 if n < 8192 else 2
        row(f"encode_f64 n={n}", ke, K5, "encode", err,
            lambda v=v, imap=imap, tw_re=tw_re, tw_im=tw_im, sn=sn:
                k_encode.encode_f64(v, imap, tw_re, tw_im, sn),
            lambda v=v, imap=imap, tw_re=tw_re, tw_im=tw_im, sn=sn:
                enc.encode_tables(v, imap, tw_re, tw_im, sn),
            f"(B, vlen) = ({batch}, {n // 2}), n = {n}, {ctas} CTA a row; "
            f"{int((~want_ok).sum())} overflow rows", None,
            nbytes(v, imap, tw_re, tw_im, coeff, ok),
            batch * (F64_OPS_PER_BUTTERFLY * logn * n // 2
                     + F64_OPS_PER_COEFF * n))
    for r in rows:
        print(f"[3 kernels] {r['name']} {r['shape']}: bit-equal; "
              f"{r['ms']:.4f} ms through the wrapper, plain "
              f"{r['plain_ms']:.4f} ms")
    return rows


def edge_pte(rng, moduli, batch, n, dev):
    """int64 (batch, n) plaintext + error: random values of every
    magnitude, with 0, +-k q of each modulus, +-(2^63 - 1), INT64_MIN and
    the encode's overflow-edge magnitudes (the largest doubles below 2^63,
    2^62, 2^53 + 1) at the head of the rows."""
    big = np.iinfo(np.int64)
    x = rng.integers(big.min, big.max, (batch, n), dtype=np.int64,
                     endpoint=True)
    x[:, n // 2:] >>= rng.integers(0, 63, (batch, n - n // 2))
    edges = [0, 1, -1, big.max, -big.max, big.min, 2 ** 63 - 1024,
             -(2 ** 63 - 1024), 2 ** 62, -(2 ** 62), 2 ** 53 + 1,
             -(2 ** 53 + 1)]
    for q in moduli:
        for k in (1, 2, 12345, (2 ** 63 - 1) // q):
            edges += [k * q, -k * q, k * q + 1, -k * q - 1]
    flat = x.reshape(-1)
    flat[:len(edges)] = edges
    return torch.as_tensor(x, device=dev)


def ke_edge_values(rng, n, batch, tables, sn):
    """float32 (batch >= 9, n / 2) values for KE: rows 0..3 +0.0, -0.0,
    f32 subnormals and half zeros, rows 4..7 scaled so their largest
    coefficient (the plain encode's, on the CPU tables) lands at 0.5 and
    0.99 of the 2^63 bound and at 1.02 and 2 times it, row 8 times 3e38,
    the rest uniform in [-1, 1)."""
    vals = rng.uniform(-1, 1, (batch, n // 2)).astype(np.float32)
    vals[0] = 0.0
    vals[1] = -0.0
    vals[2] = rng.choice(np.array([1e-45, -1e-45, 1e-40, -3e-39, 1.1e-38],
                                  dtype=np.float32), n // 2)
    vals[3, ::2] = 0.0
    unit, _ = enc.encode_tables(torch.as_tensor(vals[4:8]), *tables, sn)
    peak = unit.abs().max(dim=1).values.double().numpy()
    for r, f in enumerate((0.5, 0.99, 1.02, 2.0)):
        vals[4 + r] *= np.float32(f * 2.0 ** 63 / peak[r])
    vals[8] *= np.float32(3e38)
    return vals


def phase_calibrate(dev, smi, sm_hz, rows):
    """KC against its plain version, then the ceilings, then each row's
    bound and roofline share, and each KK, KN and KA row's
    sol_frac_calibrated (bench.py's share of the measured op-mix ceiling,
    above 1 where a kernel packs its ops better than the mix), through
    its wrapper and alone.  Returns (KC's rows, the launch counts of the
    ceiling run)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = 2 * sms
    kc_src = "seal_embedded_tpu_torch/csrc/calibrate.cu"
    kc_rows = []
    for mix in cal.MIXES:
        err = 0
        for nchain in (8, 16):
            x = k_calib.mix_input(nchain, tiles, dev)
            err = max(err, require_equal(
                f"KC {mix} nchain={nchain}",
                k_calib.calib_mix(x, mix, CALIB_CHECK_ITERS),
                cal.mix_plain(x, mix, CALIB_CHECK_ITERS)))
        x = k_calib.mix_input(8, tiles, dev)
        ms, pms = timed_pair(
            lambda: k_calib.calib_mix(x, mix, CALIB_MID_ITERS),
            lambda: cal.mix_plain(x, mix, CALIB_MID_ITERS))
        kc_rows.append({"name": f"calib_mix {mix}", "route": "cuda",
                        "source": kc_src, "replaces": K7, "counter": "calib",
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "fn": lambda x=x, mix=mix: k_calib.calib_mix(
                            x, mix, CALIB_MID_ITERS),
                        "shape": f"{tiles} tiles x 8 chains x 1024 lanes, "
                                 f"{CALIB_MID_ITERS} iters",
                        "work": None, "kind": mix, "f64_ops": 0,
                        "ops": CALIB_MID_ITERS * 8
                        * INT_OPS_PER_MIX_CHAIN[mix] * tiles * k_calib.LANES,
                        "bytes": 2 * u32_bytes(x)})
        print(f"[3b calibrate] KC {mix}: bit-equal at nchain 8 and 16, "
              f"{tiles} tiles, {CALIB_CHECK_ITERS} iters; at "
              f"{CALIB_MID_ITERS} iters {ms:.4f} ms vs plain {pms:.4f} ms")

    # The ceilings: the highest rate over the tile counts, each call
    # doing the same work.
    torch.cuda.synchronize()
    counters.reset()
    best = {}
    for per_sm in CALIB_BLOCKS_PER_SM:
        t = per_sm * sms
        iters = CALIB_LANE_ITERS_PER_SM // (per_sm * k_calib.LANES)
        iters -= iters % k_calib.UNROLL
        for mix, rate in k_calib.measure_ceilings(dev, iters, t).items():
            ms = iters * cal.ops_per_iter(mix) * t * k_calib.LANES / rate * 1e3
            print(f"[3b calibrate] {mix} mix: {rate / 1e9:.1f} Gop/s, "
                  f"{iters} iters x {t} tiles, {ms:.3f} ms per call")
            if rate > best.get(mix, (0,))[0]:
                best[mix] = (rate, iters, t, ms)
    torch.cuda.synchronize()
    counts = counters.read()
    for mix, (rate, iters, t, ms) in best.items():
        print(f"[3b calibrate] ceiling {mix}: {rate / 1e9:.1f} Gop/s "
              f"(source-convention u32 ops; {iters} iters, {t} tiles, "
              f"{ms:.3f} ms per call); {smi}")

    set_kernel_alone_ms(rows + kc_rows)

    # Each row's bound: the largest of its bytes at the HBM rate, its
    # integer instructions at the SMs' integer rate and its f64 operations
    # at their f64 rate.  No kernel alone may beat it.
    ceiling = {mix: v[0] for mix, v in best.items()}
    for r in rows + kc_rows:
        kind = r["work"][0] if r["work"] else r.get("kind")
        line = f"[3b calibrate] {bound_line(r, sm_hz)}"
        if r["work"]:
            units = r["work"][1]
            share = (k_calib.keccak_share if kind == "keccak"
                     else k_calib.ntt_share)
            line += (f"; sol_frac_calibrated "
                     f"{share(units, r['ms'], ceiling[kind]):.4f} through "
                     f"the wrapper, "
                     f"{share(units, r['kernel_ms'], ceiling[kind]):.4f} "
                     f"kernel alone")
        print(line)
    return kc_rows, counts


def bound_line(r, sm_hz) -> str:
    """Set kernel row r's bound_ms, the largest of its bytes at the HBM
    rate, its integer instructions at the SMs' integer rate and its f64
    operations at their f64 rate (sm_hz: the card's SMs times their
    maximum clock), and its bound_by; raise if its time alone beats the
    bound.  Returns the text that states them."""
    ints = int_rate(sm_hz)
    f64_rate = F64_OPS_PER_SM_CLOCK * sm_hz
    bound_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ops = max(r["ops"] / ints, r["f64_ops"] / f64_rate) * 1e3
    r["bound_ms"] = max(bound_bytes, bound_ops)
    r["bound_by"] = "bytes" if bound_bytes >= bound_ops else "operations"
    roofline = r["bound_ms"] / r["kernel_ms"]
    if roofline > 1:
        raise AssertionError(f"{r['name']}: {r['kernel_ms']:.4f} ms alone "
                             f"beats its bound {r['bound_ms']:.4f} ms")
    return (f"{r['name']} ({r['shape']}): bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({r['bytes'] / 1e6:.1f} MB at 3.35 TB/s: "
            f"{bound_bytes:.4f} ms; {r['ops'] / 1e6:.1f} M integer "
            f"instructions: {r['ops'] / ints * 1e3:.4f} ms; "
            f"{r['f64_ops'] / 1e6:.1f} M f64 operations: "
            f"{r['f64_ops'] / f64_rate * 1e3:.4f} ms); roofline share "
            f"{roofline:.4f} alone, {r['bound_ms'] / r['ms']:.4f} through "
            f"the wrapper")


def load_golden(kind, n, nprimes):
    """The C-reference vectors of golden_{kind}_{n}_{nprimes}.npz, stacked:
    v, pt, pte (G, ...), c0, c1 (L, G, n); for asym also the pk (L, n)
    and its error ep."""
    d = np.load(GOLDEN / f"golden_{kind}_{n}_{nprimes}.npz")
    G = sum(1 for k in d.files if k.startswith("v_"))
    gold = {"sk": unpack_sk(d["sk_packed_0"], n)}
    for key in ("v", "pt", "pte"):
        gold[key] = np.stack([d[f"{key}_{t}"] for t in range(G)])
    for key in ("c0", "c1"):
        gold[key] = np.stack([np.stack([d[f"{key}_{nprimes * t + i}"]
                                        for t in range(G)])
                              for i in range(nprimes)])
    if kind == "asym":
        gold["ep"] = d["pk_ep"].astype(np.int64)
        for key in ("pk0", "pk1"):
            gold[key] = np.stack([d[f"{key}_{i}"] for i in range(nprimes)])
    return gold


def check_golden_rows(out, gold, name, keys=("c0", "c1", "pt", "pte"),
                      at=0):
    """Rows at..at+G-1 of out equal the G golden rows; ok for the whole
    batch."""
    G = gold["v"].shape[0]
    rows = slice(at, at + G)
    for key in keys:
        got = (out[key][:, rows] if key in ("c0", "c1") else out[key][rows])
        if not np.array_equal(got.cpu().numpy(), gold[key]):
            raise AssertionError(f"{name}: {key} differs from the golden file")
    if not bool(out["ok"].all()):
        raise AssertionError(f"{name}: ok is False")


def golden_seeds(G):
    return (np.tile(kc.seed_to_words(seed_bytes(2)), (G, 1)),
            np.tile(kc.seed_to_words(seed_bytes(3)), (G, 1)))


def golden_pk(gold, parms, dev):
    """gen_pk_batch on the card from the golden sk, pk seed and ep."""
    seed = kc.seed_to_words(seed_bytes(4)).astype(np.int64)
    return gen_pk_batch(torch.as_tensor(gold["sk"], device=dev),
                        torch.as_tensor(seed, device=dev),
                        torch.as_tensor(gold["ep"], device=dev), parms)


def check_pk(pk, gold, name):
    for key, got in zip(("pk0", "pk1"), pk):
        if not np.array_equal(got.cpu().numpy(), gold[key]):
            raise AssertionError(f"{name}: gen_pk's {key} differs from the "
                                 "golden file")


def check_c1(c1, ok, want, name):
    if not torch.equal(c1, want):
        raise AssertionError(f"{name}: expand_c1 differs from the encryptor")
    if not bool(ok.all()):
        raise AssertionError(f"{name}: expand_c1's ok is False")


def phase_golden(dev):
    for n, nprimes in GOLDEN_CONFIGS:
        name = f"golden_sym_{n}_{nprimes}"
        gold = load_golden("sym", n, nprimes)
        parms = default_parms(n, nprimes)
        G = gold["v"].shape[0]
        args = state_to_device(gold["v"], gold["sk"], *golden_seeds(G), dev)
        check_golden_rows(SymEncryptor(parms, dev)(*args), gold, name)
        out = make_limbscan_encryptor(parms, "reference", "sf",
                                      device=dev)(*args)
        check_golden_rows(out, gold, f"{name} limb-scan")
        check_c1(*expand_c1(args[2], parms), out["c1"], f"{name} expand_c1")
        check_golden_rows(sym_encrypt_batch(*args, parms, "table"), gold,
                          f"{name} sym_encrypt_batch")
        print(f"[4 golden] {name}.npz: {G} x {nprimes} c0/c1/pt/pte "
              f"bit-exact on {dev} through SymEncryptor, the limb-scan "
              f"encryptor and sym_encrypt_batch; expand_c1's c1 too")
    for n, nprimes in ASYM_GOLDEN_CONFIGS:
        name = f"golden_asym_{n}_{nprimes}"
        gold = load_golden("asym", n, nprimes)
        parms = default_parms(n, nprimes)
        G = gold["v"].shape[0]
        check_pk(golden_pk(gold, parms, dev), gold, name)
        args = asym_state_to_device(gold["v"], golden_seeds(G)[1], dev)
        pk = pk_to_device(gold["pk0"], gold["pk1"], dev)
        out = AsymEncryptor(parms, *pk, dev)(*args)
        check_golden_rows(out, gold, name)
        print(f"[4 golden] {name}.npz: gen_pk pk0/pk1 and {G} x {nprimes} "
              f"c0/c1/pt/pte bit-exact on {dev}")


EXACT_CASES = (("seal-default-n4096", 512, None),
               ("seal-n16384-L13", 512, 16))
EXACT_SEEDS = (8337867, 2647653)   # > 8 refills in the first block
EXACT_ROWS = (0, 1, 255, 511)      # where they are planted, twice each
EXACT_ITERS = 3


def exact_seed(value: int) -> bytes:
    return value.to_bytes(8, "little").ljust(64, b"\x00")


def exact_batch(n, batch, rng, planted=True):
    """`batch` messages of uniform values and own seeds, the two seeds
    that overflow the ternary queue planted at EXACT_ROWS (alternately)
    where `planted`: (values, seeds)."""
    values = rng.uniform(-1, 1, (batch, n // 2)).astype(np.float32)
    seeds = [rng.bytes(64) for _ in range(batch)]
    if planted:
        for k, row in enumerate(EXACT_ROWS):
            seeds[row] = exact_seed(EXACT_SEEDS[k % 2])
    return values, seeds


def phase_exact_ternary(dev, smi):
    """4b: the planted seeds whose ternary block needs more than 8
    refills, in a B = 512 batch at 4096/3 and 16384/13, through
    se_encrypt_streaming (the compiled asym stream, whose prologue draws
    u with KK's ternary role, the redraw unbounded): no call raises, no
    row is encrypted again (asym.redo_overflowed finds none), the public
    key and the rows (all at 4096/3, the planted and 12 more at depth)
    bit-equal to the NumPy reference (benchmark/reference); then the
    call's host-clock time with the seeds planted and without, median of
    EXACT_ITERS each, in turns: they should read equal."""
    from benchmark.catalog import Catalog
    from benchmark.reference import ckks as rckks
    from benchmark.reference.params import from_config
    from seal_embedded_tpu_torch.ckks import asym as asym_mod

    for config, batch, kept in EXACT_CASES:
        p = from_config(Catalog().config(config))
        n = p.degree
        rng = np.random.default_rng(19)
        sk = rng.integers(-1, 2, n).astype(np.int32)
        pk_seed = rng.bytes(64)
        ctx = api.se_setup_custom(n, p.nprimes, p.scale, api.ASYM, sk=sk,
                                  pk_seed=pk_seed, device=dev)
        pk = rckks.public_key(p, sk, pk_seed)
        for got, want, name in zip((ctx.pk0, ctx.pk1), pk, ("pk0", "pk1")):
            if not np.array_equal(got.astype(np.int64), want):
                raise AssertionError(f"4b exact {config}: {name} differs "
                                     "from the reference")
        values, seeds = exact_batch(n, batch, rng)
        plain = exact_batch(n, batch, rng, planted=False)
        before = asym_mod.redo_counts()
        limbs = stream.se_encrypt_streaming(ctx, values, err_seeds=seeds)
        torch.cuda.synchronize()
        redone = asym_mod.redo_counts()["rows"] - before["rows"]
        if redone:
            raise AssertionError(f"4b exact {config}: {redone} rows run "
                                 "again; KK's ternary role draws every row "
                                 "whole")
        if kept is None:
            rows = np.arange(batch)
        else:
            others = np.setdiff1d(np.arange(batch), EXACT_ROWS)
            rows = np.sort(np.concatenate([EXACT_ROWS, rng.choice(
                others, kept - len(EXACT_ROWS), replace=False)]))
        c0 = np.stack([l["c0"][rows] for l in limbs])
        c1 = np.stack([l["c1"][rows] for l in limbs])
        want0, want1 = [], []
        for at in range(0, len(rows), 64):
            part = rows[at:at + 64]
            w0, w1 = rckks.asym_encrypt(p, pk[0], pk[1], values[part],
                                        [seeds[r] for r in part])
            want0.append(w0)
            want1.append(w1)
        for got, want, name in ((c0, np.concatenate(want0, 1), "c0"),
                                (c1, np.concatenate(want1, 1), "c1")):
            bad = int(np.count_nonzero(got != want))
            if bad:
                raise AssertionError(f"4b exact {config}: {bad} {name} "
                                     "coefficients differ from the "
                                     "reference")
        del limbs
        times = {"planted": [], "plain": []}
        for _ in range(EXACT_ITERS):
            for tag, (v, s) in (("planted", (values, seeds)),
                                ("plain", plain)):
                t0 = time.perf_counter()
                stream.se_encrypt_streaming(ctx, v, err_seeds=s)
                times[tag].append((time.perf_counter() - t0) * 1e3)
        api.se_cleanup(ctx)
        print(f"[4b exact] {config} asym n={n} L={p.nprimes} B={batch}: "
              f"seeds {EXACT_SEEDS} at rows {EXACT_ROWS}, {redone} rows run "
              f"again, no call raised; pk and {len(rows)} rows x "
              f"{p.nprimes} limbs of c0/c1 bit-equal to the NumPy "
              f"reference; call {statistics.median(times['planted']):.2f} "
              f"ms planted, {statistics.median(times['plain']):.2f} ms "
              f"without (host clock, median of {EXACT_ITERS}); {smi}")


def headline_inputs(gold):
    """B messages and per-message seeds made from seed 0, rows 0..G-1 set
    to the golden messages and seeds: (values, share, err)."""
    G = gold["v"].shape[0]
    rng = np.random.default_rng(0)
    values = rng.uniform(-1, 1, (B, N // 2)).astype(np.float32)
    share = rng.integers(0, 2 ** 32, (B, 16), dtype=np.int64).astype(np.uint32)
    err = rng.integers(0, 2 ** 32, (B, 16), dtype=np.int64).astype(np.uint32)
    values[:G] = gold["v"]
    share[:G], err[:G] = golden_seeds(G)
    return values, share, err


def golden_verified(gold):
    G = gold["v"].shape[0]
    return f"rows 0..{G - 1} golden-bitexact ({G}x{L}), ok for all {B}"


def report_headline(tag, verified, ms, peak, smi, extra=""):
    print(f"[5 headline] {tag} n={N} L={L} B={B}: {verified}; "
          f"{B / ms * 1e3:.1f} enc/s, {ms:.3f} ms/batch (median of "
          f"{TIME_ITERS}), peak {peak / 2 ** 20:.1f} MiB{extra}; "
          f"{smi}")


def host_clock(fn) -> str:
    """fn()'s host-clock time to a finished card, median of TIME_ITERS
    calls each started on an idle card, as report_headline's extra."""
    ms, _ = host_time_ms(lambda: (fn(), torch.cuda.synchronize()),
                         TIME_ITERS)
    return f"; host clock {ms:.3f} ms/batch (median of {TIME_ITERS})"


def counted_run(fn):
    """fn() once with every launch counter at 0 and the peak memory
    reset: (its output, the counts, the peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, counters.read(), torch.cuda.max_memory_allocated()


def phase_headline_sym(dev, smi):
    gold = load_golden("sym", N, L)
    values, share, err = headline_inputs(gold)
    args = state_to_device(values, gold["sk"], share, err, dev)
    encryptor = SymEncryptor(default_parms(N, L), dev)

    out, counts, peak = counted_run(lambda: encryptor(*args))
    check_golden_rows(out, gold, "sym headline batch")
    ms = cuda_time_ms(lambda: encryptor(*args), TIME_ITERS)
    report_headline("sym", golden_verified(gold), ms, peak, smi,
                    host_clock(lambda: encryptor(*args)))
    return counts


def phase_headline_asym(dev, smi):
    """gen_pk from the golden key material, then one asym batch."""
    parms = default_parms(N, L)
    gold = load_golden("asym", N, L)
    values, _, seeds = headline_inputs(gold)
    args = asym_state_to_device(values, seeds, dev)

    def keygen_and_encrypt():
        pk = golden_pk(gold, parms, dev)
        encryptor = AsymEncryptor(parms, *pk, dev)
        return pk, encryptor, encryptor(*args)

    (pk, encryptor, out), counts, peak = counted_run(keygen_and_encrypt)
    check_pk(pk, gold, "asym headline")
    check_golden_rows(out, gold, "asym headline batch")

    ms = cuda_time_ms(lambda: encryptor(*args), TIME_ITERS)
    pk_ms = cuda_time_ms(lambda: golden_pk(gold, parms, dev), 3, 1)
    report_headline("asym", golden_verified(gold), ms, peak, smi,
                    host_clock(lambda: encryptor(*args))
                    + f"; gen_pk {pk_ms:.3f} ms (median of 3)")
    return counts


def check_decrypts(out, sk, parms, name):
    """decrypt_batch gives pte back from every limb, canonical and lazy."""
    for impl in ("canonical", "lazy"):
        cen = decrypt_batch(out["c0"], out["c1"], sk, parms, impl)
        if not all(torch.equal(c, out["pte"]) for c in cen):
            raise AssertionError(f"{name}: {impl} decrypt does not give "
                                 "pte back")


def phase_headline_limbscan(dev, smi):
    """The limb-scan encryptor (reference, parallel and reverse order) and
    sym_encrypt_batch on the sym headline's inputs.  Returns the launch
    counts of each path's run."""
    parms = default_parms(N, L)
    rev_parms = Parms(parms.degree, parms.moduli[::-1], parms.scale)
    gold = load_golden("sym", N, L)
    values, share, err = headline_inputs(gold)
    args = state_to_device(values, gold["sk"], share, err, dev)
    golden = golden_verified(gold)
    runs = {}

    def check_reference(out, name):
        check_golden_rows(out, gold, name)

    def check_parallel(out, name):
        if not bool(out["ok"].all()):
            raise AssertionError(f"{name}: ok is False")
        check_c1(*expand_c1(args[2], parms, "parallel"), out["c1"], name)
        check_decrypts(out, args[1], parms, name)

    def check_reverse(out, name):
        G = gold["v"].shape[0]
        if not (bool(out["ok"].all()) and np.array_equal(
                out["pte"][:G].cpu().numpy(), gold["pte"])):
            raise AssertionError(f"{name}: ok or pte rows wrong")
        check_decrypts(out, args[1], rev_parms, name)

    paths = (
        ("limb-scan reference",
         make_limbscan_encryptor(parms, "reference", "sf", device=dev),
         check_reference, golden),
        ("limb-scan parallel",
         make_limbscan_encryptor(parms, "parallel", "sf", device=dev),
         check_parallel, f"c1 = expand_c1(parallel), decrypt_batch gives "
                         f"pte back (canonical, lazy), ok for all {B}"),
        ("sym_encrypt_batch table",
         lambda *a: sym_encrypt_batch(*a, parms, "table"),
         check_reference, golden),
        ("limb-scan reverse",
         LimbscanEncryptor(parms, "reference", "reverse", dev),
         check_reverse, f"pte rows 0..5 golden, decrypt_batch under the "
                        f"reversed chain gives pte back (canonical, lazy), "
                        f"ok for all {B}"))
    for tag, fn, check, verified in paths:
        out, runs[tag], peak = counted_run(lambda: fn(*args))
        check(out, f"{tag} headline batch")
        del out   # else it would count in the next path's peak
        ms = cuda_time_ms(lambda: fn(*args), TIME_ITERS)
        report_headline(tag, verified, ms, peak, smi)
    return runs


STREAM_ITERS = 5
SEND_ROWS = 16


def host_time_ms(fn, iters=STREAM_ITERS):
    """Median host milliseconds of fn() after one warm-up call, each call
    started on an idle card; fn ends with its results in host memory.
    Returns (median ms, the last call's result)."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def peak_run(fn):
    """counted_run, with the peak given above the memory allocated when fn
    starts (the inputs both compared paths share)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out, counts, peak = counted_run(fn)
    return out, counts, peak - base


def fetch_to_pinned(out):
    """c0, c1 of a batch to pinned host memory as int32 (the stream's own
    transfer), waited for: uint32 (L, B, n) numpy arrays."""
    host = []
    for key in ("c0", "c1"):
        h = torch.empty(out[key].shape, dtype=torch.int32, pin_memory=True)
        h.copy_(out[key].to(torch.int32), non_blocking=True)
        host.append(h)
    torch.cuda.synchronize()
    return [h.numpy().view(np.uint32) for h in host]


def check_limbs(limbs, c0, c1, walk, name):
    """The streamed limbs, read after the stream was consumed, against
    the batch's c0/c1 (L, B, n) stacked in walk order."""
    if [l["prime_idx"] for l in limbs] != walk:
        raise AssertionError(f"{name}: limbs in order "
                             f"{[l['prime_idx'] for l in limbs]}, not {walk}")
    for j, l in enumerate(limbs):
        for key, want in (("c0", c0), ("c1", c1)):
            if not np.array_equal(l[key], want[j].cpu().numpy()):
                raise AssertionError(f"{name}: limb {j} (prime "
                                     f"{l['prime_idx']}) {key} differs from "
                                     "the batch")


def stream_launches(kind, parms) -> dict:
    """The launches one call of a compiled stream of `kind` on `parms`
    must make, by counter of ops/kernels/counters.py (every other one 0).
    Sym: in the prologue KN's ntt(s), KE and KK's CBD role; a limb KK's
    queue squeeze, its uniform role and KN from pte.  Asym: in the
    prologue KE, KK's ternary role (the whole ternary u) and two CBD
    draws; a limb KA."""
    L = parms.nprimes
    if kind == "sym":
        want = {"keccak": L, "keccak_uniform": L, "keccak_cbd": 1,
                "ntt": 1, "ntt_pte": L, "encode": 1}
    else:
        want = {"keccak_ternary": 1, "keccak_cbd": 2, "ntt_asym": L,
                "encode": 1}
    return {k: want.get(k, 0) for k in counters.COUNTERS}


def check_launches(counts, kind, parms, name):
    want = stream_launches(kind, parms)
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, one call makes "
                             f"{want}")


def rotated_host_ms(fns, rounds=STREAM_ITERS):
    """Median host ms of each fn() (each ends with its results in host
    memory), started on an idle card, after one warm-up call each; round
    i starts at fn i mod len(fns), so the host's drift falls on all
    alike.  Returns (medians, each fn's last result)."""
    last = [fn() for fn in fns]
    times = [[] for _ in fns]
    for i in range(rounds):
        for k in range(len(fns)):
            j = (i + k) % len(fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last[j] = fns[j]()
            times[j].append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in times], last


def pool_resident(fn):
    """fn() with the allocator's cache emptied before and after: (its
    result, the bytes it left reserved).  fn ends with its results in
    host memory, so what stays is what a first call captured: its
    graphs' pools and static inputs."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, torch.cuda.memory_reserved() - before


def stream_cases(dev, parms, args, ainputs):
    """(tag, walk, compiled stream through its public entry point, the
    cached Stream it runs, its inputs, eager batch, compiled batch) of
    each stream of phase 5b."""
    fwd = SymEncryptor(parms, dev)
    rev = LimbscanEncryptor(parms, "reference", "reverse", dev)
    asym = AsymEncryptor(parms, *ainputs[1:3], dev)
    return (
        ("sym forward", [0, 1, 2],
         lambda *a: stream.sym_encrypt_stream(*a, parms, "f64", "forward"),
         stream.sym_stream(parms, "forward", dev), args,
         lambda: fwd(*args), make_fused_encryptor(parms, device=dev)),
        ("sym reverse", [2, 1, 0],
         lambda *a: stream.sym_encrypt_stream(*a, parms, "f64", "reverse"),
         stream.sym_stream(parms, "reverse", dev), args,
         lambda: rev(*args),
         make_limbscan_encryptor(parms, "reference", "sf", "reverse", dev)),
        ("asym forward", [0, 1, 2],
         lambda *a: stream.asym_encrypt_stream(*a, parms, "f64", "forward"),
         stream.asym_stream(parms, "forward", dev), ainputs,
         lambda: asym(ainputs[0], ainputs[3]),
         make_asym_encryptor(parms, device=dev)))


def phase_streams(dev, smi, parms, args, ainputs):
    """Phase 5b's streams at the headline's shape: each compiled stream's
    first call (the capture) and its footprint, every limb against the
    eager batch's, launches per call against those one call must make
    (stream_launches), a stream abandoned after its first limb and a
    whole one after it, times beside the compiled batch + fetch, and the
    compiled footprint against the batch's.  Returns the launch counts
    of one compiled stream of each."""
    runs = {}
    for (tag, walk, compiled, cached, inputs, batch,
         cbatch) in stream_cases(dev, parms, args, ainputs):
        name = f"stream {tag}"
        torch.cuda.synchronize()
        cached.chain.clear()
        compiled_of(cbatch).clear()

        def first():
            t0 = time.perf_counter()
            return list(compiled(*inputs)), (time.perf_counter() - t0) * 1e3
        (limbs, first_ms), resident = pool_resident(first)
        entry, = cached.chain.entries.values()
        if len(entry.outputs) != graphs.RING_SLOTS:
            raise AssertionError(f"{name}: {len(entry.outputs)} limb slots, "
                                 f"not {graphs.RING_SLOTS}")
        out, _, batch_peak = peak_run(batch)
        want = [out[k].cpu() for k in ("c0", "c1")]
        del out
        check_limbs(limbs, *want, walk, f"compiled {name}")
        limbs, runs[name], peak = peak_run(lambda: list(compiled(*inputs)))
        check_limbs(limbs, *want, walk, f"compiled {name} replay")
        check_launches(runs[name], tag.split()[0], parms, name)
        _, batch_resident = pool_resident(
            lambda: fetch_to_pinned(cbatch(*inputs)))
        _, _, cbatch_peak = peak_run(lambda: fetch_to_pinned(cbatch(*inputs)))
        footprint = resident + peak
        batch_footprint = batch_resident + cbatch_peak
        if tag.startswith("sym") and footprint > batch_footprint:
            raise AssertionError(f"compiled {name}: {footprint} B with its "
                                 f"pool, above the compiled batch's "
                                 f"{batch_footprint} B")
        # A stream of other inputs abandoned after its first limb; the
        # next stream copies its inputs in and replays.
        other = compiled(*(t.flip(0) for t in inputs))
        next(other)
        del other
        check_limbs(list(compiled(*inputs)), *want, walk,
                    f"compiled {name} after an abandoned one")
        if list(cached.chain.entries.values()) != [entry]:
            raise AssertionError(f"{name}: a later call captured again")
        (ms, batch_ms), (limbs, _) = rotated_host_ms(
            [lambda: list(compiled(*inputs)),
             lambda: fetch_to_pinned(cbatch(*inputs))])
        waits = [l["wait_ms"] for l in limbs]
        del limbs, want
        mib = 2 ** 20
        print(f"[5b stream] {tag} n={N} L={L} B={B}: compiled through "
              f"the public entry point ({len(entry.graph.steps)} limb "
              f"graphs in one pool, {len(entry.outputs)} limb slots, one "
              f"entry) every "
              f"limb equal to the batch's, also "
              f"after a stream abandoned after its first limb, no capture "
              f"after the first call; launches per stream "
              f"{sum(runs[name].values())}, those one call makes; "
              f"streamed {ms:.3f} ms compiled "
              f"vs compiled batch + fetch {batch_ms:.3f} ms (host "
              f"clock to the last limb in host memory, medians of "
              f"{STREAM_ITERS} rotated rounds); host waits "
              f"{sum(waits):.3f} ms ({' / '.join(f'{w:.3f}' for w in waits)}"
              f" per limb); first call {first_ms:.1f} ms (two eager warm-up "
              f"streams and one capture); footprint "
              f"{footprint / mib:.1f} MiB ({resident / mib:.1f} resident + "
              f"{peak / mib:.1f} peak above the inputs) vs compiled batch "
              f"{batch_footprint / mib:.1f} ({batch_resident / mib:.1f} + "
              f"{cbatch_peak / mib:.1f}); the eager batch's peak above the "
              f"inputs {batch_peak / mib:.1f} MiB; {smi}")
    return runs


def interleaved_asym_streams(parms, ainputs):
    """Two asym streams through asym_encrypt_stream, of different B and
    different keys, limb by limb in turn: each equal to the compiled
    batch under its own key."""
    values, pk0, pk1, seeds = ainputs
    half = values.shape[0] // 2
    cases = [(values, pk0, pk1, seeds),
             (values[:half], pk0.roll(1, 1), pk1.roll(1, 1), seeds[:half])]
    batch = make_asym_encryptor(parms, device=values.device)
    wants = []
    for case in cases:
        out = batch(*case)
        wants.append([out[k].cpu() for k in ("c0", "c1")])
        del out
    runs = [stream.asym_encrypt_stream(*case, parms, "f64", "forward")
            for case in cases]
    got = [[], []]
    for _ in range(parms.nprimes):
        for k, run in enumerate(runs):
            got[k].append(next(run))
    for k, (limbs, want) in enumerate(zip(got, wants)):
        check_limbs(limbs, *want, list(range(parms.nprimes)),
                    f"interleaved asym stream {k}")
    print(f"[5b stream] two asym streams, B={values.shape[0]} and "
          f"B={half} under different keys, limb by limb in turn: each "
          f"equal to the compiled batch under its own key")


def api_streaming(ctx, values, share_seeds, err_seeds, compiled, kind):
    """se_encrypt_streaming on SEND_ROWS messages, twice: the sent bytes
    equal ct_component_bytes of the limbs, and the second call replays
    the context's cached compiled stream (no capture)."""
    rows = slice(0, SEND_ROWS)
    shares = None if share_seeds is None else share_seeds[rows]
    entries = []
    for _ in range(2):
        send, store = network.collecting_sender()
        limbs = stream.se_encrypt_streaming(ctx, values[rows], shares,
                                            err_seeds[rows], send)
        want = [serialize.ct_component_bytes(l[key][b]) for l in limbs
                for b in range(SEND_ROWS) for key in ("c0", "c1")]
        if store != want:
            raise AssertionError(f"api streaming {kind}: sent bytes differ")
        entries.append(list(compiled.chain.entries.values()))
    if entries[0] != entries[1] or compiled not in ctx._streams:
        raise AssertionError(f"api streaming {kind}: the second call did "
                             "not replay the cached chain")
    print(f"[5b api] se_encrypt_streaming {kind} on {SEND_ROWS} messages, "
          f"twice: {len(store)} components sent per call, equal to "
          f"ct_component_bytes of the limbs; the second call replayed the "
          f"compiled stream the first one captured")


def phase_api_stream(dev, smi):
    """Phase 5b: the public API and per-prime streaming at the headline's
    shape and inputs.  Returns the launch counts of each run."""
    parms = default_parms(N, L)
    gold = load_golden("sym", N, L)
    G = gold["v"].shape[0]
    values, share, err = headline_inputs(gold)
    share_seeds = [kc.words_to_bytes_np(w) for w in share]
    err_seeds = [kc.words_to_bytes_np(w) for w in err]
    if share_seeds[0] != seed_bytes(2) or err_seeds[0] != seed_bytes(3):
        raise AssertionError("api: golden seeds do not round-trip")
    args = state_to_device(values, gold["sk"], share, err, dev)
    runs = {}
    scratch = ROOT / "build"      # git-ignored; key files live here briefly
    scratch.mkdir(exist_ok=True)

    # API sym: golden rows, and SymEncryptor's bits on the same inputs.
    ctx = api.se_setup_custom(N, L, 2 ** 25, api.SYM, sk=gold["sk"],
                              device=dev)
    out, runs["api sym"], _ = counted_run(
        lambda: api.se_encrypt_seeded(ctx, values, share_seeds, err_seeds))
    check_golden_rows(out, gold, "api sym")
    ref = SymEncryptor(parms, dev)(*args)
    for key in ("c0", "c1", "pte", "ok"):
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"api sym: {key} differs from SymEncryptor")
    dec = api.se_decrypt_decode(ctx, {k: out[k][:, :G] for k in ("c0", "c1")})
    dec_err = float(np.abs(dec - gold["v"]).max())
    if dec_err > 1e-3:
        raise AssertionError(f"api sym: decode error {dec_err}")
    del out, ref
    print(f"[5b api] sym se_encrypt_seeded n={N} L={L} B={B}: "
          f"{golden_verified(gold)}, c0/c1/pte/ok torch.equal to "
          f"SymEncryptor; se_decrypt_decode rows 0..{G - 1} within "
          f"{dec_err:.3g} of the values")

    rows = slice(0, SEND_ROWS)
    send, store = network.collecting_sender()
    out = api.se_encrypt_seeded(ctx, values[rows], share_seeds[rows],
                                err_seeds[rows], send=send)
    c0, c1 = (out[k].cpu().numpy() for k in ("c0", "c1"))
    want = [serialize.ct_component_bytes(c[i, b]) for b in range(SEND_ROWS)
            for i in range(L) for c in (c0, c1)]
    if store != want:
        raise AssertionError("api sym send: bytes differ from "
                             "ct_component_bytes of the output")
    send, store = network.collecting_sender()
    out = api.se_encrypt_seeded(ctx, values[rows], share_seeds[rows],
                                err_seeds[rows], send=send,
                                send_seed_only=True)
    parsed = [serialize.seeded_ct_parse(blob) for blob in store]
    if [s for s, _ in parsed] != share_seeds[rows]:
        raise AssertionError("api seed-only: seeds differ")
    words = graphs.to_device(kc.seed_words([s for s, _ in parsed]), dev)
    c1, ok = expand_c1(words, parms)
    if not (torch.equal(c1, out["c1"]) and bool(ok.all())):
        raise AssertionError("api seed-only: expand_c1 differs from c1")
    c0 = torch.as_tensor(np.stack([c for _, c in parsed], axis=1)
                         .astype(np.int64), device=dev)
    cen = decrypt_batch(c0, c1, ctx._sk, parms)
    if not all(torch.equal(c, out["pte"]) for c in cen):
        raise AssertionError("api seed-only: decrypt does not give pte back")
    print(f"[5b api] send on {SEND_ROWS} messages: {len(want)} components "
          f"equal to ct_component_bytes (c0 then c1, per prime, per "
          f"message); send_seed_only: {SEND_ROWS} blobs, expand_c1 on {dev} "
          f"gives c1, decrypt_batch gives pte back")
    sstream = stream.sym_stream(parms, "forward", dev)
    api_streaming(ctx, values, share_seeds, err_seeds, sstream, "sym")
    api.se_cleanup(ctx)
    entry, = sstream.chain.entries.values()
    kept = []
    graphs.map_tensors((entry.inputs, entry.carry), kept.append)
    if any(bool(t.any()) for t in kept):
        raise AssertionError("se_cleanup left the key in the stream's "
                             "static inputs or hand-offs")

    # API asym from a pk written by the port's serializer.
    agold = load_golden("asym", N, L)
    avalues, _, aseeds = headline_inputs(agold)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        serialize.write_pk(tmp, parms, list(zip(agold["pk0"], agold["pk1"])))
        actx = api.se_setup_custom(N, L, 2 ** 25, api.ASYM, pk_dir=tmp,
                                   device=dev)
    out, runs["api asym"], _ = counted_run(lambda: api.se_encrypt_seeded(
        actx, avalues, seeds=[kc.words_to_bytes_np(w) for w in aseeds]))
    check_golden_rows(out, agold, "api asym")
    del out
    print(f"[5b api] asym se_setup_custom(pk_dir) + se_encrypt_seeded "
          f"n={N} L={L} B={B}: {golden_verified(agold)}")

    # Streams: compiled (one graph chain a signature) against the eager
    # stream and the batch; times, waits, footprints; se_encrypt_streaming.
    aargs = asym_state_to_device(avalues, aseeds, dev)
    apk = pk_to_device(agold["pk0"], agold["pk1"], dev)
    runs.update(phase_streams(dev, smi, parms, args, (aargs[0], *apk,
                                                      aargs[1])))
    interleaved_asym_streams(parms, (aargs[0], *apk, aargs[1]))
    astream = stream.asym_stream(parms, "forward", dev)
    api_streaming(actx, avalues, None, [kc.words_to_bytes_np(w)
                                        for w in aseeds], astream, "asym")

    # Adapter: the CRT verify of two of the card's ciphertexts (host only).
    out = api.se_encrypt_seeded(actx, avalues[:2],
                                seeds=[seed_bytes(50), seed_bytes(51)])
    c0, c1 = (out[k].cpu().numpy() for k in ("c0", "c1"))
    api.se_cleanup(actx)
    sk_packed = serialize.pack_ternary(
        serialize.signed_to_file_ternary(agold["sk"]))
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = pathlib.Path(tmp)
        serialize.write_sk(str(tmp / f"sk_{N}.dat"), sk_packed)
        verdicts = []
        for flip in (False, True):
            cc0 = c0.copy()
            if flip:
                cc0[2, 0, 5] ^= 1
            with open(tmp / "cts", "w") as f:
                for b in range(2):
                    f.write(serialize.format_poly(
                        "v", avalues[b].astype(np.float64)))
                    for i in range(L):
                        f.write(serialize.format_poly(f"c0 (t{b} p{i})",
                                                      cc0[i, b]))
                        f.write(serialize.format_poly(f"c1 (t{b} p{i})",
                                                      c1[i, b]))
            verdicts.append(adapter.verify_ciphertexts(
                str(tmp / "cts"), str(tmp / f"sk_{N}.dat"), N, L))
    if verdicts != [True, False]:
        raise AssertionError(f"adapter verify: {verdicts}, want "
                             "[True, False]")
    print("[5b adapter] verify_ciphertexts on two asym ciphertexts from the "
          "card: passes, and fails with one coefficient of prime 2 flipped")
    return runs

DEEP_N, DEEP_L, DEEP_B = 16384, 13, 64
DEEP_ROUNDS = 3


def deep_inputs(gold, dev):
    """DEEP_B messages and seeds made from seed 4, rows 0..G-1 the golden
    messages and seeds, on `dev`."""
    G = gold["v"].shape[0]
    rng = np.random.default_rng(4)
    values = rng.uniform(-1, 1, (DEEP_B, DEEP_N // 2)).astype(np.float32)
    share, err = (rng.integers(0, 2 ** 32, (DEEP_B, 16)) for _ in range(2))
    values[:G] = gold["v"]
    share[:G], err[:G] = golden_seeds(G)
    return state_to_device(values, gold["sk"], share, err, dev)


def phase_deep_stream(dev, smi):
    """The compiled sym stream at n = 16384, L = 13, B = DEEP_B: one graph
    (KE as 2-CTA clusters in its prologue) of 13 limb events, one entry,
    golden rows limb by limb, every limb equal to SymEncryptor's, the
    launches one call must make (stream_launches), and a second call that
    captures nothing.  Returns the launch counts of one compiled
    stream."""
    parms = default_parms(DEEP_N, DEEP_L)
    gold = load_golden("sym", DEEP_N, DEEP_L)
    G = gold["v"].shape[0]
    args = deep_inputs(gold, dev)
    compiled = stream.sym_stream(parms, "forward", dev)
    torch.cuda.synchronize()
    compiled.chain.clear()
    limbs = list(compiled(*args))
    entry, = compiled.chain.entries.values()
    host = {k: torch.as_tensor(np.stack([l[k] for l in limbs])
                               .astype(np.int64)) for k in ("c0", "c1")}
    check_golden_rows({**host, "ok": torch.ones(1, dtype=torch.bool)}, gold,
                      "compiled deep stream", ("c0", "c1"))
    enc = SymEncryptor(parms, dev)
    out = enc(*args)
    want = [out[k].cpu() for k in ("c0", "c1")]
    del out
    walk = list(range(DEEP_L))
    check_limbs(limbs, *want, walk, "compiled deep stream")
    limbs, counts, _ = counted_run(lambda: list(compiled(*args)))
    check_limbs(limbs, *want, walk, "compiled deep stream, second call")
    if list(compiled.chain.entries.values()) != [entry] or len(
            entry.graph.steps) != DEEP_L:
        raise AssertionError("deep stream: the second call captured again")
    check_launches(counts, "sym", parms, "deep stream")
    del limbs, want
    print(f"[5b deep] compiled sym stream n={DEEP_N} L={DEEP_L} B={DEEP_B}:"
          f" {len(entry.graph.steps)} limb graphs and "
          f"{len(entry.outputs)} limb slots, one entry, "
          f"golden_sym_{DEEP_N}_{DEEP_L}.npz rows 0..{G - 1} bit-exact limb "
          f"by limb, every limb equal to SymEncryptor's, the second call "
          f"captured nothing; launches {sum(counts.values())}, those one "
          f"call makes; {smi}")
    return counts

COEFF_ROWS = 64
SWEEP_DEGREE, SWEEP_BATCH = 4096, 16


def require_same(name, got, want, keys=("c0", "c1", "pte", "pt", "ok")):
    for key in keys:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"{name}: {key} differs from the "
                                 "single-device path")


def paired_cuda_ms(fn, other, pairs=TIME_ITERS):
    """Median CUDA-event ms of fn() and of other(), timed in alternation
    (pair i runs fn first when i is even, other first when it is odd), so
    that the host's drift between calls falls on both alike."""
    fns = (fn, other)
    times = ([], [])
    for f in fns:
        f(), f()
    for i in range(pairs):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end))
    return tuple(statistics.median(t) for t in times)


def require_shards_equal(name, got, want):
    """Two Shards: the same blocks (torch.equal) and the same index."""
    if not isinstance(got, Shards) or got.index != want.index:
        raise AssertionError(f"{name}: the compiled output's Shards index "
                             f"differs from the eager run's")
    require_same(name, got, want, tuple(want))


def report_sharded(tag, verified, fn, eager, single, peaks, counts, comms,
                   first_ms, smi, shape=None):
    """Times of a compiled sharded function beside its eager form and the
    single-device path; peaks: (compiled, eager, single) above the
    inputs."""
    ms, single_ms = paired_cuda_ms(fn, single)
    ms, eager_ms = paired_cuda_ms(fn, eager)
    host, eager_host = paired_host_ms(fn, eager)
    busy, eager_busy, single_busy = (timeline(f)["busy_ms"]
                                     for f in (fn, eager, single))
    n, nprimes, batch = shape or (N, L, B)
    mib = 2 ** 20
    print(f"[7 scale-out] {tag} n={n} L={nprimes} B={batch} at world size "
          f"1: {verified}; compiled: torch.equal to its eager run with the "
          f"same Shards.index, launches and collectives per replay equal "
          f"to the eager call's; {ms:.3f} ms/batch vs eager {eager_ms:.3f} "
          f"vs single device {single_ms:.3f} ms (CUDA events, medians of "
          f"{TIME_ITERS} alternated pairs), host clock {host:.3f} vs "
          f"{eager_host:.3f} ms, device busy {busy:.3f} vs "
          f"{eager_busy:.3f} vs {single_busy:.3f} ms/batch "
          f"(perf_stages.timeline), idle share {1 - busy / ms:.1%} vs "
          f"{1 - eager_busy / eager_ms:.1%}, peak above the inputs "
          f"{peaks[0] / mib:.1f} vs {peaks[1] / mib:.1f} vs "
          f"{peaks[2] / mib:.1f} MiB; first call {first_ms:.1f} ms; "
          f"launches {counts}; collectives {comms}; {smi}")


def phase_scale_out(dev, smi):
    """Phase 7: parallel/ at world size 1, one rank on `dev` (NCCL on the
    card, gloo on the CPU), in a group destroyed at the end.  Returns the
    launch counts of each run."""
    parms = default_parms(N, L)
    gold = load_golden("sym", N, L)
    values, share, err = headline_inputs(gold)
    args = state_to_device(values, gold["sk"], share, err, dev)
    agold = load_golden("asym", N, L)
    avalues, _, aseeds = headline_inputs(agold)
    aargs = asym_state_to_device(avalues, aseeds, dev)
    apk = pk_to_device(agold["pk0"], agold["pk1"], dev)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    runs = {}
    t0 = time.perf_counter()

    def sharded_run(tag, g, a, single, check, verified, shape=None):
        """g, a compiled sharded function, on the arguments a: its first
        call (the capture), then a replay against g's eager form (bits,
        index, launches, collectives) and the single-device path."""
        fn, eager = (lambda: g(*a)), (lambda: g.fn(*a))
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - start) * 1e3
        comm.counts = {}
        out, runs[tag], peak = peak_run(fn)
        comms = comm.counts
        comm.counts = {}
        eager_out, eager_counts, eager_peak = peak_run(eager)
        require_shards_equal(tag, out, eager_out)
        if runs[tag] != eager_counts or comms != comm.counts:
            raise AssertionError(f"{tag}: per replay launches {runs[tag]}, "
                                 f"collectives {comms}; eager per call "
                                 f"{eager_counts}, {comm.counts}")
        del eager_out
        want, _, single_peak = peak_run(single)
        check(out, want, tag)
        del out, want
        report_sharded(tag, verified, fn, eager, single,
                       (peak, eager_peak, single_peak), runs[tag],
                       {k: tuple(v) for k, v in comms.items()}, first_ms,
                       smi, shape)

    with tempfile.TemporaryDirectory(dir=scratch) as tmp, \
            launch.process_group(1, 0, str(pathlib.Path(tmp) / "store"),
                                 dev.type):
        mesh = make_mesh(1, 1, dev.type)
        hmesh = mh.make_host_mesh(1, 1, dev.type)
        parallel = LimbscanEncryptor(parms, "parallel", device=dev)

        def check_parallel(out, want, tag):
            require_same(tag, out, want)
            check_decrypts(out, args[1], parms, tag)

        sym = make_limb_sharded_encryptor(mesh, parms)
        sharded_run("limb-sharded sym", sym, args,
                    lambda: parallel(*args), check_parallel,
                    "torch.equal to LimbscanEncryptor(parallel), "
                    "decrypt_batch gives pte back (canonical, lazy)")

        asym = make_asym_limb_sharded_encryptor(mesh, parms)
        single_asym = AsymEncryptor(parms, *apk, dev)

        def check_asym(out, want, tag):
            check_golden_rows(out, agold, tag)
            require_same(tag, out, want)
        sharded_run("limb-sharded asym", asym, (aargs[0], *apk, aargs[1]),
                    lambda: single_asym(*aargs), check_asym,
                    f"{golden_verified(agold)}, torch.equal to "
                    "AsymEncryptor")

        ses = sym_encrypt_sharded(mesh, parms)

        def check_batch(out, want, tag):
            check_golden_rows(out, gold, tag)
            require_same(tag, out, want)
        sharded_run("sym_encrypt_sharded", ses, args,
                    lambda: sym_encrypt_batch(*args, parms),
                    check_batch, f"{golden_verified(gold)}, torch.equal to "
                    "sym_encrypt_batch")

        multi = mh.make_multihost_encryptor(hmesh, parms)
        sharded_run("multihost (1, 1, 1)", multi,
                    mh.shard_inputs(hmesh, *args),
                    lambda: parallel(*args), check_parallel,
                    "torch.equal to LimbscanEncryptor(parallel), "
                    "decrypt_batch gives pte back")

        # The sym pipeline's two collectives alone, at the headline's shape.
        rows = torch.zeros((B, N + 17), dtype=torch.int64, device=dev)
        flags = torch.ones(B, dtype=torch.bool, device=dev)
        group = mesh.get_group("limb")

        def collectives():
            comm.all_gather_rows(rows, group)
            comm.all_and(flags, group)
        host_ms, _ = host_time_ms(
            lambda: (collectives(), torch.cuda.synchronize()), TIME_ITERS)
        print(f"[7 scale-out] the limb all-gather ({B} x {N + 17} int64) "
              f"and the ok reduce alone at world size 1: "
              f"{cuda_time_ms(collectives, TIME_ITERS):.3f} ms (CUDA "
              f"events), host clock {host_ms:.3f} ms to a finished card "
              f"(medians of {TIME_ITERS}); {smi}")
        del rows, flags

        dparms = default_parms(DEEP_N, DEEP_L)
        rng = np.random.default_rng(3)
        dargs = state_to_device(
            rng.uniform(-1, 1, (DEEP_B, DEEP_N // 2)).astype(np.float32),
            rng.integers(-1, 2, DEEP_N), rng.integers(0, 2 ** 32, (DEEP_B, 16)),
            rng.integers(0, 2 ** 32, (DEEP_B, 16)), dev)
        deep = make_limb_sharded_encryptor(mesh, dparms)
        deep_single = LimbscanEncryptor(dparms, "parallel", device=dev)
        sharded_run("deep limb-sharded sym", deep, dargs,
                    lambda: deep_single(*dargs),
                    lambda out, want, tag: require_same(tag, out, want),
                    "torch.equal to LimbscanEncryptor(parallel)",
                    (DEEP_N, DEEP_L, DEEP_B))

        # The coefficient-sharded NTT against KN, on values below 4q.
        for n, lim in ((N, L), (DEEP_N, DEEP_L)):
            q = default_parms(n, lim).moduli[0]
            op, quot = (torch.as_tensor(t.astype(np.int64)[None], device=dev)
                        for t in ntt_ops.ntt_tables(n, q))
            x = torch.as_tensor(rng.integers(0, 4 * q, (COEFF_ROWS, n)),
                                device=dev)
            want = k_ntt.ntt_fwd(x[None].contiguous(), op, quot,
                                 torch.tensor([q], device=dev))[0]
            for variant in ("staged", "4step"):
                f = ntt_coeff_sharded(mesh, n, q, "data", variant)
                f(x)                                   # the capture
                tag = f"ntt_coeff_sharded {variant} n={n}"
                comm.counts = {}
                got, counts, _ = counted_run(lambda: f(x))
                comms = comm.counts
                comm.counts = {}
                eager_got, eager_counts, _ = counted_run(lambda: f.fn(x))
                if not (torch.equal(got, want) and torch.equal(eager_got,
                                                               want)):
                    raise AssertionError(f"{tag}: differs from KN")
                if counts != eager_counts or comms != comm.counts:
                    raise AssertionError(f"{tag}: per replay {counts}, "
                                         f"{comms}; eager {eager_counts}, "
                                         f"{comm.counts}")
                ms, eager_ms = paired_cuda_ms(lambda: f(x), lambda: f.fn(x))
                del got, eager_got
                print(f"[7 scale-out] {tag} ({COEFF_ROWS} rows) at world "
                      f"size 1: compiled and eager bit-equal to KN ntt_fwd; "
                      f"collectives per replay {comms} = eager's; "
                      f"{ms:.3f} ms compiled vs {eager_ms:.3f} eager (CUDA "
                      f"events, medians of {TIME_ITERS} alternated pairs); "
                      f"{smi}")

        result, runs["sweep"], _ = counted_run(lambda: sweep.run_sweep(
            SWEEP_DEGREE, SWEEP_BATCH, device=dev))
        if not result.ok:
            raise AssertionError("sweep: configs failed: " + ", ".join(
                r[0] for r in result.results if not r[1]))
        print(f"[7 scale-out] sweep at degree {SWEEP_DEGREE}, batch "
              f"{SWEEP_BATCH} on {dev}: {len(result.results)} of "
              f"{len(result.results)} configs pass")

        # A restart of the sym headline from the journal, bit-exact.
        encryptor = SymEncryptor(parms, dev)
        with tempfile.TemporaryDirectory(dir=scratch) as jdir:
            first = CheckpointedRunner(CheckpointJournal(jdir), encryptor)
            out0 = first.run(0, *args)
            first.journal.begin(1, {"values": values, "share_words": share,
                                    "err_words": err})
            outs, runs["checkpoint restart"], _ = counted_run(
                lambda: CheckpointedRunner(CheckpointJournal(jdir),
                                           encryptor).resume(args[1]))
        if list(outs) != [1]:
            raise AssertionError(f"checkpoint: resumed {list(outs)}")
        require_same("checkpoint restart", outs[1], out0)
        check_golden_rows(outs[1], gold, "checkpoint restart")
        print(f"[7 scale-out] CheckpointedRunner restart of the sym "
              f"headline (B={B}): the journaled batch re-runs bit-exact, "
              f"{golden_verified(gold)}")
    print(f"[7 scale-out] phase 7 took {time.perf_counter() - t0:.1f} s")
    return runs


# Phase 8: the compiled entry points (graphs.py).
CU_GRAPH_NODE_KERNEL, CU_GRAPH_NODE_MEMCPY, CU_GRAPH_NODE_MEMSET = 0, 1, 2
SMALL_B = 512


def graph_node_kinds(graph) -> dict:
    """Kernel, memcpy, memset and other nodes of a captured CUDA graph,
    read with libcuda's cuGraphGetNodes from CUDAGraph.raw_cuda_graph()."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    names = {CU_GRAPH_NODE_KERNEL: "kernel", CU_GRAPH_NODE_MEMCPY: "memcpy",
             CU_GRAPH_NODE_MEMSET: "memset"}
    kinds = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    kind = ctypes.c_int()
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds[names.get(kind.value, "other")] += 1
    return kinds


def traced_kinds(fn, calls=4, traces=3) -> dict:
    """Kernels (the port's among them), memcpys and memsets the device ran
    in one call of fn: the most common count over `calls` calls in one
    profiler trace, each between marker kernels (torch.cuda._sleep's spin
    kernel).  A profiler trace can drop events (in this script's runs,
    the first one, and once all of them), so a lead marker goes first, a
    count seen once is not taken, and a trace that leaves no count seen
    twice is taken again, up to `traces` in all."""
    fn()
    torch.cuda.synchronize()

    def run():
        torch.cuda._sleep(1000)
        for _ in range(calls):
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
    seen = []
    for _ in range(traces):
        evs = trace(run)
        marks = [i for i, e in enumerate(evs) if "spin_kernel" in e[2]]
        per_call = []
        for a, b in zip(marks, marks[1:]):
            kinds = dict.fromkeys(("kernel", "port", "memcpy", "memset"), 0)
            for _, _, name in evs[a + 1:b]:
                if name.startswith("Memcpy"):
                    kinds["memcpy"] += 1
                elif name.startswith("Memset"):
                    kinds["memset"] += 1
                else:
                    kinds["kernel"] += 1
                    kinds["port"] += any(k in name for k in PORT_KERNELS)
            if any(kinds.values()):          # not the lead marker's gap
                per_call.append(tuple(kinds.items()))
        common = collections.Counter(per_call).most_common(1)
        if common and common[0][1] >= 2:
            return dict(common[0][0])
        seen.append(per_call)
    raise RuntimeError(f"the profiler's counts per call disagree in "
                       f"{traces} traces: {seen}")


def require_outputs_equal(name, got, want):
    """Every tensor of two outputs (a dict, a tuple or one tensor) equal."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    keys = got.keys() if isinstance(got, dict) else range(len(got))
    for k in keys:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{name}: {k} differs from the eager module")


def clone_outputs(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return tuple(v.clone() for v in out)


def compiled_cases(dev):
    """(tag, compiled function, eager counterpart running the same body on
    a module of its own, headline args, other args, B = 512 args, check of
    the headline output (its docstring says what it checks), the kernels
    its path must launch)."""
    parms = default_parms(N, L)
    gold = load_golden("sym", N, L)
    G = gold["v"].shape[0]
    values, share, err = headline_inputs(gold)
    args = state_to_device(values, gold["sk"], share, err, dev)
    rng = np.random.default_rng(8)
    args2 = state_to_device(
        rng.uniform(-1, 1, (B, N // 2)).astype(np.float32), gold["sk"],
        rng.integers(0, 2 ** 32, (B, 16)), rng.integers(0, 2 ** 32, (B, 16)),
        dev)
    small = (args[0][:SMALL_B], args[1], args[2][:SMALL_B],
             args[3][:SMALL_B])
    sym = SymEncryptor(parms, dev)
    out1, out2 = sym(*args), sym(*args2)

    def golden_sym(out, name):
        """rows 0..5 golden"""
        check_golden_rows(out, gold, name)

    def decrypts(walk):
        def check(out, name):
            """decrypt_batch under the chain in walk order gives pte back"""
            if not (bool(out["ok"].all()) and all(
                    torch.equal(c, out["pte"]) for c in decrypt_batch(
                        out["c0"], out["c1"], args[1], walk))):
                raise AssertionError(f"{name}: ok or decrypt wrong")
        return check
    rev_parms = Parms(parms.degree, parms.moduli[::-1], parms.scale)

    cases = [("fused sym", make_fused_encryptor(parms, device=dev), sym,
              args, args2, small, golden_sym, SYM_PATH)]
    for layout, order, check in (
            ("reference", "forward", golden_sym),
            ("parallel", "forward", decrypts(parms)),
            ("reference", "reverse", decrypts(rev_parms)),
            ("parallel", "reverse", decrypts(rev_parms))):
        cases.append((f"limb-scan {layout} {order}",
                      make_limbscan_encryptor(parms, layout, "sf", order,
                                              device=dev),
                      LimbscanEncryptor(parms, layout, order, dev), args,
                      args2, small, check, SYM_PATH))

    def golden_from_pte(out, name):
        """rows 0..5 golden"""
        check_golden_rows(out, gold, name, ("c0", "c1", "pte"))
    cases.append(("from-pte", make_from_pte_encryptor(parms, device=dev),
                  LimbscanEncryptor(parms, "reference", "forward",
                                    dev).encrypt_pte,
                  (out1["pte"], args[1], args[2]),
                  (out2["pte"], args2[1], args2[2]),
                  (out1["pte"][:SMALL_B], args[1], args[2][:SMALL_B]),
                  golden_from_pte, ("keccak", "ntt", "ntt_pte")))

    def golden_c1(out, name):
        """c1 rows 0..5 golden"""
        check_golden_rows({"c1": out[0], "ok": out[1]}, gold, name, ("c1",))
    cases.append(("c1 expander", make_c1_expander(parms, device=dev),
                  lambda w: expand_c1(w, parms), (args[2],), (args2[2],),
                  (args[2][:SMALL_B],), golden_c1, ("keccak",)))

    agold = load_golden("asym", N, L)
    avalues, _, aseeds = headline_inputs(agold)
    aargs = asym_state_to_device(avalues, aseeds, dev)
    apk = pk_to_device(agold["pk0"], agold["pk1"], dev)
    other_pk = pk_to_device(*(np.stack([rng.integers(0, q, N)
                                        for q in parms.moduli])
                              for _ in range(2)), dev)
    ref = AsymEncryptor(parms, device=dev)

    def asym_eager(v, pk0, pk1, seeds):
        ref.set_key(pk0, pk1)
        return ref(v, seeds)

    def golden_asym(out, name):
        """rows 0..5 golden"""
        check_golden_rows(out, agold, name)
    cases.append(("asym", make_asym_encryptor(parms, device=dev), asym_eager,
                  (aargs[0], *apk, aargs[1]), (args2[0], *other_pk, args2[3]),
                  (aargs[0][:SMALL_B], *apk, aargs[1][:SMALL_B]),
                  golden_asym, ASYM_PATH))

    def gives_pte(out, name):
        """every limb gives pte back"""
        if not all(torch.equal(c, out1["pte"]) for c in out):
            raise AssertionError(f"{name}: does not give pte back")
    for impl in ("canonical", "lazy"):
        cases.append((f"decryptor {impl}",
                      make_decryptor(parms, impl, device=dev),
                      Decryptor(parms, impl, None, dev),
                      (out1["c0"], out1["c1"], args[1]),
                      (out2["c0"], out2["c1"], args[1]),
                      (out1["c0"][:, :SMALL_B], out1["c1"][:, :SMALL_B],
                       args[1]), gives_pte, ("ntt",)))

    def decodes(out, name):
        """within 1e-3 of the values"""
        worst = float((out - args[0].double()).abs().max())
        if worst > 1e-3:
            raise AssertionError(f"{name}: decode error {worst}")
    cases.append(("decoder", make_decoder(parms, dev), Decoder(parms, dev),
                  (out1["pte"],), (out2["pte"],), (out1["pte"][:SMALL_B],),
                  decodes, ()))

    q = torch.tensor(parms.moduli, dtype=torch.int64,
                     device=dev)[:, None, None]
    bent = out2["c1"].clone()
    bent[2, 7, 5] = parms.moduli[2]

    def canonical(out, name):
        """True on a canonical ciphertext, False with one c1 value = q"""
        if not bool(out):
            raise AssertionError(f"{name}: a canonical ciphertext fails")
    cases.append(("range check", api._canon_graph(parms, dev),
                  lambda c0, c1: (c0 < q).all() & (c1 < q).all(),
                  (out1["c0"], out1["c1"]), (out2["c0"], bent),
                  (out1["c0"][:, :SMALL_B], out1["c1"][:, :SMALL_B]),
                  canonical, ()))
    return cases


def compiled_of(fn):
    """The graphs.Graphed behind a compiled factory's function."""
    return fn if isinstance(fn, graphs.Graphed) else fn.graphed


def phase_compiled(dev, smi):
    """Phase 8: every compiled factory at the headline's shape against its
    eager module (bits, goldens, a second call, a B = 512 recapture,
    launches and graph nodes, times), KE's cluster launch at n = 16384
    through the compiled sym factory, and the API's compiled functions.
    Returns the launch counts of one replay of each."""
    t0 = time.perf_counter()
    runs = {}
    for (tag, fn, eager, args, args2, args_small, check,
         needed) in compiled_cases(dev):
        g = compiled_of(fn)
        torch.cuda.synchronize()
        g.clear()   # earlier phases' graphs: this first call captures
        base = torch.cuda.memory_allocated()
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - start) * 1e3
        resident = torch.cuda.memory_allocated() - base
        require_outputs_equal(tag, out, eager(*args))
        check(out, f"compiled {tag}")
        kept = clone_outputs(out)
        require_outputs_equal(f"{tag} second call", fn(*args2),
                              eager(*args2))
        require_outputs_equal(f"{tag} first output after a second call",
                              out, kept)
        require_outputs_equal(f"{tag} B={SMALL_B}", fn(*args_small),
                              eager(*args_small))
        if len(g.entries) != 2:
            raise AssertionError(f"{tag}: {len(g.entries)} entries after "
                                 f"B={B} and B={SMALL_B} calls, want 2")
        del out, kept
        replay, replay_counts, peak = peak_run(lambda: fn(*args))
        del replay
        _, eager_counts, eager_peak = peak_run(lambda: eager(*args))
        if replay_counts != eager_counts or any(
                replay_counts[k] < 1 for k in needed):
            raise AssertionError(f"{tag}: launches per replay "
                                 f"{replay_counts}, eager per call "
                                 f"{eager_counts}")
        runs[f"compiled {tag}"] = (replay_counts, needed)
        entry = next(e for e in g.entries.values()
                     if e.inputs[0].shape == args[0].shape)
        nodes = graph_node_kinds(entry.graph)
        eager_kinds = traced_kinds(lambda: eager(*args))
        replay_kinds = traced_kinds(lambda: fn(*args))
        if (nodes["kernel"] != eager_kinds["kernel"]
                or replay_kinds["port"] != sum(replay_counts.values())):
            raise AssertionError(f"{tag}: graph nodes {nodes}, eager call "
                                 f"{eager_kinds}, replay {replay_kinds}, "
                                 f"counted {replay_counts}")
        ms, eager_ms = paired_cuda_ms(lambda: fn(*args), lambda: eager(*args))
        host, eager_host = paired_host_ms(lambda: fn(*args),
                                          lambda: eager(*args))
        busy, eager_busy = (timeline(f)["busy_ms"] for f in (
            lambda: fn(*args), lambda: eager(*args)))
        print(f"[8 compiled] {tag} n={N} L={L} B={B}: torch.equal to the "
              f"eager module on two inputs, {check.__doc__}, first "
              f"output unchanged by the second call, B={SMALL_B} recaptured "
              f"and equal; launches per replay {sum(replay_counts.values())}"
              f" = eager's per call; graph nodes {nodes} (eager call's "
              f"kernels {eager_kinds['kernel']}, the port's "
              f"{replay_kinds['port']} per replay); {ms:.3f} vs eager "
              f"{eager_ms:.3f} ms CUDA events, host clock {host:.3f} vs "
              f"{eager_host:.3f} ms (medians of {TIME_ITERS} alternated "
              f"pairs), device busy {busy:.3f} vs {eager_busy:.3f} ms, idle "
              f"share {1 - busy / ms:.1%} vs {1 - eager_busy / eager_ms:.1%}"
              f", peak above the inputs {peak / 2 ** 20:.1f} vs "
              f"{eager_peak / 2 ** 20:.1f} MiB, first call {capture_ms:.1f} "
              f"ms (two warm-up calls and the capture) leaving "
              f"{resident / 2 ** 20:.1f} MiB resident with its output; "
              f"{smi}")

    # KE's 2-CTA cluster launch (n = 16384) inside a captured graph.
    deep = default_parms(16384, 13)
    gold = load_golden("sym", 16384, 13)
    G = gold["v"].shape[0]
    dargs = state_to_device(gold["v"], gold["sk"], *golden_seeds(G), dev)
    fn = make_fused_encryptor(deep, device=dev)
    check_golden_rows(fn(*dargs), gold, "compiled sym n=16384")
    out, counts, _ = counted_run(lambda: fn(*dargs))
    require_outputs_equal("compiled sym n=16384", out,
                          SymEncryptor(deep, dev)(*dargs))
    runs["compiled sym n=16384"] = (counts, SYM_PATH)
    print(f"[8 compiled] sym n=16384 L=13 ({G} golden rows, KE as 2-CTA "
          f"clusters inside the graph): golden_sym_16384_13.npz rows "
          f"bit-exact, torch.equal to SymEncryptor")

    # The API's encrypt, decrypt-decode and range check (phase 5b's calls)
    # went through captured graphs.
    parms = default_parms(N, L)
    for name, g in (("encrypt", make_fused_encryptor(parms, device=dev)),
                    ("decrypt", make_decryptor(parms, device=dev)),
                    ("decode", make_decoder(parms, dev)),
                    ("range check", api._canon_graph(parms, dev))):
        if not g.entries:
            raise AssertionError(f"api {name}: no captured graph")
    print(f"[8 compiled] api: se_encrypt_seeded, se_decrypt_decode and the "
          f"send path's range check replayed captured graphs; phase 8 took "
          f"{time.perf_counter() - t0:.1f} s")
    return runs


def paired_host_ms(fn, other, pairs=TIME_ITERS):
    """Median host-clock ms to a finished card of fn() and other(), in
    alternated pairs, each call started on an idle card."""
    fns = (fn, other)
    times = ([], [])
    for i in range(pairs):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fns[j]()
            torch.cuda.synchronize()
            times[j].append((time.perf_counter() - start) * 1e3)
    return tuple(statistics.median(t) for t in times)


# Phase 9: the JAX package's own tracked sizes.  bench.py:264-267 runs
# sym n=8192/L=6 and n=16384/L=13 at B=1024, asym 8192/6 at B=1024 and
# asym 16384/13 at B=512, golden rows inside the timed batch; bench.py:209
# (bsweep) the n=4096/L=3 headline at B = 1024 ... 8192; B = 10240 is
# BASELINE.json's "10k+" (its config 4).  Each row: (tag, kind, n, L, its
# batches, the kernels held against their plain versions at its last
# batch's shapes).
DEPTH_ROWS = (
    ("sym-8192-6", "sym", 8192, 6, (1024,), ()),
    ("sym-16384-13", "sym", 16384, 13, (1024,),
     ("KK base", "KN ntt(s)", "KN from pte", "KE")),
    ("asym-8192-6", "asym", 8192, 6, (1024,), ()),
    ("asym-16384-13", "asym", 16384, 13, (512,), ("KA",)),
    ("bsweep", "sym", 4096, 3, (1024, 2048, 4096, 8192, 10240),
     ("KK queue", "KK cbd", "KE")))
DEPTH_SEED = 9
DEPTH_INDEP_B = 8     # the row-independence batch, a second signature
DEPTH_KE_ROWS = 8     # KE's rows held against the plain encode on the CPU
DEPTH_ITERS_16384 = 5     # timed batches at n = 16384, as bench.py


def depth_inputs(gold, batch, seed=DEPTH_SEED):
    """`batch` messages and seeds made from numpy seed `seed`, with the G
    golden messages and seeds in rows 0..G-1 and again in rows
    batch-G..batch-1: (values float32 (batch, n/2), share, err uint32
    (batch, 16)).  The asym path takes err as its private seeds (tag 3,
    as the golden files do)."""
    G, half = gold["v"].shape
    if batch < 2 * G:
        raise ValueError(f"depth_inputs: batch {batch} cannot hold the {G} "
                         f"golden rows at both ends")
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, (batch, half)).astype(np.float32)
    share, err = (rng.integers(0, 2 ** 32, (batch, 16), dtype=np.int64)
                  .astype(np.uint32) for _ in range(2))
    for rows in (slice(0, G), slice(batch - G, batch)):
        values[rows] = gold["v"]
        share[rows], err[rows] = golden_seeds(G)
    return values, share, err


def check_golden_ends(out, gold, name):
    """Both golden blocks of a depth_inputs batch bit-exact; ok for all."""
    G = gold["v"].shape[0]
    batch = out["pte"].shape[0]
    for at in (0, batch - G):
        check_golden_rows(out, gold, f"{name} rows {at}..{at + G - 1}",
                          at=at)


def middle_rows(batch, G, seed):
    """DEPTH_INDEP_B seeded rows of a batch, sorted, none golden."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(np.arange(G, batch - G), DEPTH_INDEP_B,
                              replace=False))


def check_rows_of(small, out, rows, name):
    """A batch of the rows `rows` equals those rows of the large batch."""
    for key, want in out.items():
        want = want[:, rows] if key in ("c0", "c1") else want[rows]
        if not torch.equal(small[key], want):
            raise AssertionError(f"{name}: {key} of rows {rows.tolist()} "
                                 f"run as a batch of {len(rows)} differs "
                                 f"from the large batch's")


def depth_case(kind, n, nprimes, batch, dev):
    """(compiled factory function, the encryptor behind it, its args on
    `dev`, the positions of the per-message args, the kernels its path
    must launch, gold) of one depth batch; asym's pk comes from
    gen_pk_batch on the golden key material and is checked against the
    golden file."""
    parms = default_parms(n, nprimes)
    gold = load_golden(kind, n, nprimes)
    values, share, err = depth_inputs(gold, batch)
    if kind == "sym":
        fn = make_fused_encryptor(parms, device=dev)
        return (fn, fn.fn,
                state_to_device(values, gold["sk"], share, err, dev),
                (0, 2, 3), SYM_PATH, gold)
    pk = golden_pk(gold, parms, dev)
    check_pk(pk, gold, f"asym n={n} L={nprimes}")
    v, s = asym_state_to_device(values, err, dev)
    fn = make_fused_asym_encryptor(parms, device=dev)
    return fn, fn.encryptor, (v, *pk, s), (0, 3), ASYM_PATH, gold


def timed_plain(fn):
    """(fn()'s result, its CUDA-event ms): one call, the plain versions at
    the deep shapes being too slow for more."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def depth_kernels(names, module, out, args, iters, dev, phase="9"):
    """The kernels `names` at a depth batch's shapes, on its own tensors:
    the batch's outputs `out`, its inputs `args`, and `module`, the
    encryptor behind the compiled function.  Each is held against the
    batch's output where it computes a part of it, and bit for bit against
    its plain version: KK, KN and KA on every row, on the card; KE on
    DEPTH_KE_ROWS rows, the first and the last among them, against the
    plain encode on CPU copies.  Each is timed through its wrapper
    (`iters` calls) and its plain version (one call).  Returns the kernel
    rows, their fn still bound for the time alone; `phase` tags the
    lines it prints."""
    rows = []
    kk = "seal_embedded_tpu_torch/csrc/keccak.cu"
    kn = "seal_embedded_tpu_torch/csrc/ntt.cu"
    L, batch, n = out["c0"].shape

    def row(name, source, replaces, counter, err, fn, plain_ms, shape,
            *args, **kwargs):
        """A kernel_row, fn timed through its wrapper."""
        ms = cuda_time_ms(fn, iters)
        rows.append(kernel_row(name, source, replaces, counter, err, fn, ms,
                               plain_ms, shape, *args, **kwargs))
        print(f"[{phase} kernels] {name} ({shape}): bit-equal to its plain "
              f"version; {ms:.4f} ms through the wrapper (median of "
              f"{iters}), plain {plain_ms:.4f} ms (one call)")

    def kk_check(name, fn, plain):
        got = fn()
        want, pms = timed_plain(plain)
        return got, require_equal(name, got, want.reshape(got.shape)), pms

    for name in names:
        if name == "KK base":
            # The uniform base draw of every limb in one launch: the share
            # seeds once per limb, counters seeded, three at the carries.
            rng = np.random.default_rng(DEPTH_SEED)
            seeds = args[2].repeat(L, 1).contiguous()
            ctr = u32(rng, (L * batch, 2), dev)
            ctr[0] = torch.tensor([2 ** 32 - 1, 0])
            ctr[1] = torch.tensor([2 ** 32 - 1, 2 ** 32 - 1])
            ctr[-1] = torch.tensor([2 ** 32 - 170, 7])
            nb = -(-4 * n // 136)
            fn = lambda: k_keccak.keccak_squeeze(seeds, ctr, nb)
            got, err, pms = kk_check(name, fn, lambda: kc.shake256_words(
                seeds, ctr, nb))
            row(f"keccak_squeeze base n={n}", kk, K1, "keccak", err, fn, pms,
                f"{L} x {batch} streams x {nb} blocks",
                ("keccak", L * batch * nb), u32_bytes(seeds, ctr, got))
        elif name in ("KK queue", "KK cbd"):
            # The first limb's queue draw and the CBD error, as the path
            # calls them: the share and err seeds at counter 0.
            ctr = sp.counter_zero((batch,), dev)
            if name == "KK queue":
                cap = module.queue_cap
                offs = 1 + torch.arange(cap, device=dev)
                fn = lambda: k_keccak.keccak_squeeze(args[2], ctr, 1, 1, cap,
                                                     1)
                got, err, pms = kk_check(name, fn, lambda: kc.shake256_words(
                    args[2], kc.counter_offsets(ctr, offs), 1, 1))
                row(f"keccak_squeeze queue broadcast B={batch}", kk, K2,
                    "keccak", err, fn, pms,
                    f"{batch} seeds x {cap} streams from counter + 1, "
                    f"nwords=1", ("keccak", batch * cap),
                    u32_bytes(args[2], ctr, got))
            else:
                fn = lambda: k_keccak.cbd_values(args[3], ctr, n)
                got, err, pms = kk_check(name, fn, lambda: kc.cbd_values(
                    args[3], ctr, n))
                row(f"cbd_values B={batch}", kk, K2, "keccak_cbd", err, fn,
                    pms, f"{batch} seeds x {n // 16} fills -> (B, n) = "
                    f"({batch}, {n}) values", ("keccak", batch * n // 16),
                    u32_bytes(args[3], ctr) + got.numel())
        elif name == "KN ntt(s)":
            # ntt(s) of every limb, once a sym batch: (L, 1, n).
            sk = args[1].to(torch.int64).reshape(1, 1, -1)
            s_args = (torch.where(sk < 0, module.q[:, None, None] - 1,
                                  sk).contiguous(),
                      module.ntt_op, module.ntt_quot, module.q)
            fn = lambda s_args=s_args: k_ntt.ntt_fwd(*s_args)
            got = fn()
            want, pms = timed_plain(lambda: ntt_ops.ntt_limbs(*s_args))
            err = require_equal(name, got, want)
            row(f"ntt_fwd ntt(s) n={n} L={L}", kn, K3, "ntt", err, fn, pms,
                f"(L, B, n) = ({L}, 1, {n}), the batch's secret key mod q",
                ("ntt", k_calib.ntt_butterflies(L, 1, n)),
                u32_bytes(*s_args, got))
        elif name == "KN from pte":
            ntt_s = module.ntt_secret(args[1])
            kargs = (out["pte"], out["c1"], ntt_s,
                     ma.shoup_quotient(ntt_s, module.q[:, None]),
                     module.ntt_op, module.ntt_quot, module.q, module.r0,
                     module.r1)
            fn = lambda: k_ntt.ntt_sym_from_pte(*kargs)
            got = fn()
            if not torch.equal(got, out["c0"]):
                raise AssertionError(f"{name}: differs from the batch's c0")
            want, pms = timed_plain(
                lambda: ntt_ops.ntt_sym_from_pte_plain(*kargs))
            err = require_equal(name, got, want)
            del want
            row(f"ntt_sym_from_pte n={n} L={L}", kn, K4, "ntt_pte", err, fn,
                pms, f"pte (B, n) = ({batch}, {n}) -> (L, B, n) = ({L}, "
                f"{batch}, {n}), the batch's pte, c1 and ntt(s)",
                ("ntt", k_calib.ntt_butterflies(L, batch, n)),
                nbytes(out["pte"]) + u32_bytes(*kargs[1:], got))
        elif name == "KA":
            pt, pte, u, e1, ok = module.prologue(args[0], args[3])
            if not (torch.equal(pte, out["pte"])
                    and torch.equal(pt, out["pt"])):
                raise AssertionError(f"{name}: the prologue's pt or pte "
                                     f"differs from the batch's")
            kargs = (u, e1, pte, module.ntt_op, module.ntt_quot, module.q,
                     module.r0, module.r1, *module.key(args[1], args[2]))
            fn = lambda: k_ntt.ntt_asym_from_signed(*kargs)
            got = fn()
            if not (torch.equal(got[0], out["c0"])
                    and torch.equal(got[1], out["c1"])):
                raise AssertionError(f"{name}: differs from the batch's c0, "
                                     f"c1")
            want, pms = timed_plain(
                lambda: ntt_ops.ntt_asym_from_signed_plain(*kargs))
            err = max(require_equal(f"{name} {c}", g, w)
                      for c, g, w in zip(("c0", "c1"), got, want))
            del want
            row(f"ntt_asym_from_signed n={n} L={L}", kn, K6, "ntt_asym", err,
                fn, pms, f"u, e1, pte (B, n) = ({batch}, {n}) -> (L, B, n) "
                f"= ({L}, {batch}, {n}), the batch's prologue and pk",
                ("ntt", k_calib.ntt_butterflies(L, batch, n, 3)),
                u.numel() + e1.numel() + nbytes(pte)
                + u32_bytes(*kargs[3:], *got))
        elif name == "KE":
            v = args[0]
            tabs = (module.imap, module.tw_re, module.tw_im)
            fn = lambda: k_encode.encode_f64(v, *tabs, module.scale_n)
            coeff, ok = fn()
            if not torch.equal(coeff, out["pt"]):
                raise AssertionError(f"{name}: differs from the batch's pt")
            rng = np.random.default_rng(DEPTH_SEED)
            sample = np.sort(np.concatenate([[0, batch - 1], rng.choice(
                np.arange(1, batch - 1), DEPTH_KE_ROWS - 2, replace=False)]))
            want_c, want_ok = enc.encode_tables(
                v.cpu()[sample], *(t.cpu() for t in tabs), module.scale_n)
            got_c = coeff[torch.as_tensor(sample, device=dev)].cpu()
            got_ok = ok[torch.as_tensor(sample, device=dev)].cpu()
            if not (torch.equal(got_ok, want_ok) and bool(want_ok.all())):
                raise AssertionError(f"{name}: ok flags differ from the "
                                     f"plain version")
            err = require_equal(f"{name} n={n} B={batch}", got_c, want_c)
            _, pms = timed_plain(lambda: enc.encode_tables(
                v, *tabs, module.scale_n))
            logn = n.bit_length() - 1
            row(f"encode_f64 n={n} B={batch}", "seal_embedded_tpu_torch/"
                "csrc/encode.cu", K5, "encode", err, fn, pms,
                f"(B, vlen) = ({batch}, {n // 2}), n = {n}, "
                f"{1 if n < 8192 else 2} CTA a row; rows "
                f"{sample.tolist()} against the plain encode on the CPU",
                None, nbytes(v, *tabs, coeff, ok),
                batch * (F64_OPS_PER_BUTTERFLY * logn * n // 2
                         + F64_OPS_PER_COEFF * n))
        else:
            raise ValueError(f"depth_kernels: no check named {name}")
    return rows


def first_and_replay(fn, args):
    """A compiled fn's first call on args (two warm-ups and the capture)
    timed, with the memory it leaves reserved, then a replay: (output,
    launch counts, first-call ms, resident bytes, replay peak above the
    inputs)."""
    def first():
        start = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3
    first_ms, resident = pool_resident(first)
    out, counts, peak = peak_run(lambda: fn(*args))
    return out, counts, first_ms, resident, peak


def depth_batch(tag, kind, n, nprimes, batch, names, dev, smi):
    """One depth batch through its compiled factory: the first call (two
    warm-ups and the capture) timed, with the memory it leaves reserved; a
    replay, both golden blocks bit-exact and ok for all; one eager call of
    the same module, equal bit for bit with the same launches; eight
    middle rows as a batch of DEPTH_INDEP_B (a second signature), equal to
    the large batch's; the kernels `names` at its shapes (depth_kernels);
    CUDA-event and host-clock ms, device busy and idle share.  Returns
    (the launch counts of one replay and the kernels the path must
    launch, the kernel rows)."""
    fn, module, args, per_row, needed, gold = depth_case(kind, n, nprimes,
                                                         batch, dev)
    g = compiled_of(fn)
    G = gold["v"].shape[0]
    name = f"depth {tag} B={batch}"
    iters = DEPTH_ITERS_16384 if n >= 16384 else TIME_ITERS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()

    out, counts, first_ms, resident, peak = first_and_replay(fn, args)
    check_golden_ends(out, gold, f"{name} compiled")
    eager, eager_counts, eager_peak = peak_run(lambda: g.fn(*args))
    require_outputs_equal(f"{name} compiled vs eager", out, eager)
    del eager
    if counts != eager_counts or any(counts[k] < 1 for k in needed):
        raise AssertionError(f"{name}: launches per replay {counts}, eager "
                             f"per call {eager_counts}")
    mid = torch.as_tensor(middle_rows(batch, G, DEPTH_SEED + batch),
                          device=dev)
    small = tuple(a.index_select(0, mid) if i in per_row else a
                  for i, a in enumerate(args))
    check_rows_of(fn(*small), out, mid, name)
    sizes = {e.inputs[0].shape[0] for e in g.entries.values()}
    if not {batch, DEPTH_INDEP_B} <= sizes:
        raise AssertionError(f"{name}: captured batch sizes {sorted(sizes)}"
                             f", want {batch} and {DEPTH_INDEP_B} among them")
    krows = depth_kernels(names, module, out, args, iters, dev)
    del out
    ms = cuda_time_ms(lambda: fn(*args), iters)
    host = host_time_ms(lambda: (fn(*args), torch.cuda.synchronize()),
                        iters)[0]
    busy = timeline(lambda: fn(*args))["busy_ms"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    mib = 2 ** 20
    print(f"[9 depth] {tag} {kind} n={n} L={nprimes} B={batch}, compiled "
          f"({fn.__class__.__name__} of the factory): rows 0..{G - 1} and "
          f"{batch - G}..{batch - 1} golden_{kind}_{n}_{nprimes}.npz "
          f"bit-exact (c0, c1, pt, pte), ok for all {batch}; torch.equal to "
          f"one eager call of the same module, launches per replay "
          f"{sum(counts.values())} = eager's; rows {mid.tolist()} as a "
          f"batch of {DEPTH_INDEP_B} (a second signature) equal to the "
          f"large batch's; {ms:.3f} ms/batch CUDA events (median of "
          f"{iters}), {batch / ms * 1e3:.1f} enc/s, host clock {host:.3f} "
          f"ms, device busy {busy:.3f} ms, idle share {1 - busy / ms:.1%}; "
          f"peak above the inputs {peak / mib:.1f} MiB (eager "
          f"{eager_peak / mib:.1f}); footprint {(resident + peak) / mib:.1f}"
          f" MiB ({resident / mib:.1f} left reserved by the first call + "
          f"{peak / mib:.1f} a replay's peak); first call {first_ms:.1f} ms "
          f"(two warm-ups and the capture); memory_reserved "
          f"{before / mib:.1f} -> {after / mib:.1f} MiB; {smi}")
    return (counts, needed), krows


def phase_depth(dev, smi, sm_hz):
    """Phase 9: every DEPTH_ROWS batch through its compiled factory
    (depth_batch), in order, every signature's graph kept; then the
    kernels at the deep shapes alone with their bounds, and the memory the
    rows keep reserved against the card's.  Returns (the launch counts of
    one replay of each batch with the kernels its path must launch, the
    kernel rows)."""
    t0 = time.perf_counter()
    # Earlier phases captured graphs of the n = 4096 and 16384 sym
    # factories: dropped, so that every first call here captures.
    for _, kind, n, nprimes, _, _ in DEPTH_ROWS:
        make = (make_fused_encryptor if kind == "sym"
                else make_fused_asym_encryptor)
        compiled_of(make(default_parms(n, nprimes),
                         device=dev)).clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved()
    evictions = graphs.registry_for(dev).evictions
    runs, rows = {}, []
    for tag, kind, n, nprimes, batches, names in DEPTH_ROWS:
        for batch in batches:
            runs[f"depth {tag} B={batch}"], krows = depth_batch(
                tag, kind, n, nprimes, batch,
                names if batch == batches[-1] else (), dev, smi)
            rows += krows
    kept = torch.cuda.memory_reserved()
    set_kernel_alone_ms(rows)
    for r in rows:
        print(f"[9 kernels] {bound_line(r, sm_hz)}; "
              f"{r['kernel_ms']:.4f} ms alone; {smi}")
    mib = 2 ** 20
    card = torch.cuda.get_device_properties(dev).total_memory
    print(f"[9 depth] memory_reserved {start / mib:.1f} MiB before the rows,"
          f" {kept / mib:.1f} MiB after them, every signature's graph "
          f"resident ({(kept - start) / mib:.1f} MiB for the "
          f"{len(runs)} batches and their B={DEPTH_INDEP_B} signatures), "
          f"of the card's {card / mib:.1f} MiB; "
          f"{graphs.registry_for(dev).evictions - evictions} evictions in "
          f"the rows; phase 9 took "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    return runs, rows


# Phase 10: a prime chain that Parms accepts and no default chain holds.
# q = 536903681 = 2^29 + 2^15 + 1 (= 1 mod 32768) rejects 12.5% of the
# uniform sampler's words, so its queue cap (ops/sampling.py
# queue_cap_for: 1,472 at n = 8192, 2,768 at 16384) exceeds the 160
# positions a 4096-wide chunk keeps on the default chains: the sampler's
# wide-cap rules (queue_cap_for, _chunk_k) and KK's queue at those widths,
# KN and KA on a prime near 2^29.  Each row: (n, the sym batch, the asym
# batch, the kernels held against their plain versions at the sym batch's
# shapes, at the asym batch's).
CUSTOM_CHAIN = (536903681, 1053818881, 1054015489)
CUSTOM_SCALE = 2.0 ** 25
CUSTOM_ROWS = ((8192, 1024, 1024, ("KK queue", "KN from pte"), ("KA",)),
               (16384, 1024, 512, ("KK queue", "KN from pte"), ("KA",)))
CUSTOM_SEED = 10
CUSTOM_ORACLE_ROWS = (0, 1, -1)   # rows held against golden/ckks.py
CUSTOM_SHARD_B = 8


def custom_inputs(n, batch, seed=CUSTOM_SEED):
    """numpy inputs of a phase 10 row from numpy seed `seed`: values
    float32 (batch, n/2), sk int32 (n,) in {-1, 0, 1}, share and err
    seeds uint32 (batch, 16) (asym takes err as its private seeds), the
    pk seed uint32 (16,) and the pk's error ep int64 (n,) in [-21, 21]."""
    rng = np.random.default_rng(seed + n)
    values = rng.uniform(-1, 1, (batch, n // 2)).astype(np.float32)
    sk = (rng.integers(0, 3, n) - 1).astype(np.int32)
    share, err = (rng.integers(0, 2 ** 32, (batch, 16), dtype=np.int64)
                  .astype(np.uint32) for _ in range(2))
    pk_seed = rng.integers(0, 2 ** 32, 16, dtype=np.int64).astype(np.uint32)
    ep = rng.integers(-21, 22, n)
    return values, sk, share, err, pk_seed, ep


def seed_of(words) -> bytes:
    """u32 seed words as the PRNG's 64 seed bytes."""
    return np.asarray(words, dtype="<u4").tobytes()


def oracle_rows(batch):
    return sorted({r % batch for r in CUSTOM_ORACLE_ROWS})


def check_oracle(out, cts, rows, name):
    """Rows `rows` of out bit-exact against the C loop's ciphertexts
    `cts` (golden/ckks.py, one per row); ok for the whole batch."""
    for row, ct in zip(rows, cts):
        got = {k: out[k][:, row].cpu().numpy() for k in ("c0", "c1")}
        for key, want in (("pt", ct.conj_vals_int), ("pte", ct.pte)):
            if not np.array_equal(out[key][row].cpu().numpy(), want):
                raise AssertionError(f"{name}: row {row} {key} differs from "
                                     f"golden/ckks.py")
        for i, (c0, c1) in enumerate(ct.components):
            if not (np.array_equal(got["c0"][i], c0)
                    and np.array_equal(got["c1"][i], c1)):
                raise AssertionError(f"{name}: row {row} prime {i} c0/c1 "
                                     f"differ from golden/ckks.py")
    if not bool(out["ok"].all()):
        raise AssertionError(f"{name}: ok is False")


def custom_timed(tag, n, batch, fns, smi):
    """Phase 10's timing of one kind at (n, L = 3, batch): the custom
    chain's compiled batch beside the default chain's, in alternated
    pairs (CUDA events), each with its device busy, idle share and
    footprint.  fns: {chain: (fn, args, first ms, resident, peak)}."""
    (cfn, cargs, *cmem), (dfn, dargs, *dmem) = fns.values()
    iters = DEPTH_ITERS_16384 if n >= 16384 else TIME_ITERS
    ms = paired_cuda_ms(lambda: cfn(*cargs), lambda: dfn(*dargs), iters)
    busy = [timeline(lambda f=f, a=a: f(*a))["busy_ms"]
            for f, a in ((cfn, cargs), (dfn, dargs))]
    mib = 2 ** 20
    parts = []
    for chain, t, b, (first_ms, resident, peak) in zip(
            fns, ms, busy, (cmem, dmem)):
        parts.append(f"{chain}: {t:.3f} ms/batch, {batch / t * 1e3:.1f} "
                     f"enc/s, busy {b:.3f} ms, idle share {1 - b / t:.1%}, "
                     f"footprint {(resident + peak) / mib:.1f} MiB "
                     f"({resident / mib:.1f} resident + {peak / mib:.1f} "
                     f"peak), first call {first_ms:.1f} ms")
    print(f"[10 custom] {tag} n={n} L=3 B={batch}, compiled, CUDA events "
          f"(medians of {iters} alternated pairs): {'; '.join(parts)}; "
          f"{smi}")


def custom_sampler_alone(n, batch, share, dev, smi):
    """The rank-select (ops/sampling.py _rank_select: the chunked top-k,
    the merge sort, the scatter) and KK's queue draw of one limb alone,
    on the custom chain's first prime and the default chain's, from the
    batch's share seeds at counter 0: device ms per call
    (perf_stages.port_kernels, every device event of the fn, with its
    event-count check)."""
    ctr = sp.counter_zero((batch,), dev)
    base = sp._squeeze(share, ctr, -(-4 * n // 136))[..., :n]
    fns, labels = [], []
    for chain, q, cap in (
            ("custom", CUSTOM_CHAIN[0], sp.queue_cap_for(n, CUSTOM_CHAIN)),
            ("default", default_parms(n, 3).moduli[0],
             sp.queue_cap_for(n, default_parms(n, 3).moduli))):
        m = ma.as_mod(q)
        rejected = base >= m.max_multiple
        qvals = sp._squeeze(share, ctr, 1, nwords=1, per_seed=cap,
                            start=1)[..., 0]
        qacc = qvals < m.max_multiple
        fns += [lambda r=rejected, v=qvals, a=qacc:
                sp._rank_select(base, r, v, a),
                lambda cap=cap: k_keccak.keccak_squeeze(share, ctr, 1, 1,
                                                        cap, 1)]
        labels += [f"{chain} rank-select (q={q}, cap {cap}, "
                   f"{int(rejected.sum(-1).max())} rejected at most)",
                   f"{chain} KK queue ({batch} x {cap} streams)"]
    ms = kernel_alone_ms(fns, TIME_ITERS, kinds=None)
    print(f"[10 custom] n={n} B={batch}, one limb alone (device ms per "
          f"call, every kernel of the fn, the mean of {TIME_ITERS} calls "
          f"in one trace): "
          + "; ".join(f"{lab} {t:.4f} ms" for lab, t in zip(labels, ms))
          + f"; {smi}")


UNIFORM_B = 1024
UNIFORM_SEED = 20
UNIFORM_SMALL_CAP = 8     # a queue that falls short on every row
KU = ("seal_embedded_tpu/ops/sampling.py:277 sample_uniform (:211 "
      "_rank_select, :169 _rejected_positions; ops/modarith.py:89 "
      "barrett32)")


def uniform_inputs(n, dev, seed=UNIFORM_SEED):
    """UNIFORM_B streams' seed words and counters made from numpy seed
    `seed` + n, rows 0..2 at counters 2^32 - 1, 2^64 - 1 and 0."""
    rng = np.random.default_rng(seed + n)
    seeds = torch.as_tensor(rng.integers(0, 2 ** 32, (UNIFORM_B, 16)),
                            device=dev)
    ctr = torch.as_tensor(rng.integers(0, 2 ** 32, (UNIFORM_B, 2)),
                          device=dev)
    ctr[:3] = torch.tensor([[2 ** 32 - 1, 0], [2 ** 32 - 1, 2 ** 32 - 1],
                            [0, 0]])
    return seeds, ctr


def uniform_check(name, seeds, ctr, n, q, cap):
    """KK's uniform role (kernels.keccak.uniform_draw) on one limb against
    its plain version (sampling.uniform_plain: the base squeeze, the
    torch rank-select and barrett32 on the card), values, next counters
    and ok bit for bit, on the same queue.  Returns (the role's outputs,
    a fn that launches it alone, the plain ms, the queue)."""
    m = ma.as_mod(q)
    queue = k_keccak.keccak_squeeze(seeds, ctr, 1, 1, cap, 1).reshape(-1, cap)
    rule = sp._chunk_rule(n, cap)

    def fn():
        return k_keccak.uniform_draw(seeds, ctr, queue, n, m.q, m.r1,
                                     m.max_multiple, *rule)
    got = fn()
    want, pms = timed_plain(lambda: sp.uniform_plain(seeds, ctr, queue, n,
                                                     m))
    for part, g, w in zip(("a", "next counter", "ok"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: the uniform role's {part} "
                                 f"differs from its plain version")
    return got, fn, pms, queue


def uniform_role(dev, smi):
    """Phase 10's KK uniform role (kernels.keccak.uniform_draw) against
    its plain version on the card, UNIFORM_B streams, rows 0..2 at
    counters 2^32 - 1, 2^64 - 1 and 0: every limb of the default chain at
    4096/3 (the counter carried from limb to limb, as the stream does),
    the first and last limbs at 16384/13, and chain C's first prime
    (536903681, 12.5% of the words rejected) at both degrees under its
    wide cap; ok-false rows from a queue of UNIFORM_SMALL_CAP, and from
    chain C's prime under the default chain's cap (every chunk past its
    160).  Then the compiled sym streams at 4096/3 and 16384/13 launch
    the role once a limb a call.  Returns the kernel rows (timed alone
    later, beside their bounds)."""
    rows = []
    kk = "seal_embedded_tpu_torch/csrc/keccak.cu"
    for n, nprimes in ((4096, 3), (16384, 13)):
        chain = default_parms(n, nprimes).moduli
        cap = sp.queue_cap_for(n, chain)
        wide = sp.queue_cap_for(n, (CUSTOM_CHAIN[0],))
        seeds, ctr = uniform_inputs(n, dev)
        limbs = (list(enumerate(chain)) if n == 4096
                 else [(0, chain[0]), (nprimes - 1, chain[-1])])
        c = ctr
        for i, q in limbs:
            got, fn, pms, queue = uniform_check(
                f"uniform n={n} limb {i}", seeds, c, n, q, cap)
            if not bool(got[2].all()):
                raise AssertionError(f"uniform n={n} limb {i}: ok false on "
                                     f"a default chain")
            if i == 0:
                ms = cuda_time_ms(fn, TIME_ITERS)
                nb = -(-n // 34)
                rows.append(kernel_row(
                    f"uniform_draw n={n} q={q}", kk, KU, "keccak_uniform", 0,
                    fn, ms, pms, f"{UNIFORM_B} streams x {nb} blocks, cap "
                    f"{cap}", ("keccak", UNIFORM_B * nb),
                    u32_bytes(seeds, c, queue, *got[:2]) + got[2].numel()))
            c = got[1] if n == 4096 else c
        for name, q, qcap, ok_rows in (
                ("queue of 8", chain[0], UNIFORM_SMALL_CAP, 0),
                (f"chain C q={CUSTOM_CHAIN[0]}, cap {wide}", CUSTOM_CHAIN[0],
                 wide, UNIFORM_B),
                (f"chain C q={CUSTOM_CHAIN[0]}, the default cap {cap}",
                 CUSTOM_CHAIN[0], cap, 0)):
            got, fn, pms, queue = uniform_check(f"uniform n={n} {name}",
                                                seeds, ctr, n, q, qcap)
            if int(got[2].sum()) != ok_rows:
                raise AssertionError(f"uniform n={n} {name}: "
                                     f"{int(got[2].sum())} rows ok, want "
                                     f"{ok_rows}")
            if name.startswith("chain C") and ok_rows:
                ms = cuda_time_ms(fn, TIME_ITERS)
                nb = -(-n // 34)
                rows.append(kernel_row(
                    f"uniform_draw n={n} q={q}", kk, KU, "keccak_uniform", 0,
                    fn, ms, pms, f"{UNIFORM_B} streams x {nb} blocks, cap "
                    f"{qcap}", ("keccak", UNIFORM_B * nb),
                    u32_bytes(seeds, ctr, queue, *got[:2]) + got[2].numel()))
        print(f"[10 uniform] n={n}: KK's uniform role bit-equal to its plain "
              f"version (values, next counters, ok) on {UNIFORM_B} streams, "
              f"counters 2^32 - 1, 2^64 - 1 and 0 among them: limbs "
              f"{[i for i, _ in limbs]} of the default chain (cap {cap}), "
              f"chain C's {CUSTOM_CHAIN[0]} at cap {wide} (every row ok), "
              f"ok false on every row with a queue of {UNIFORM_SMALL_CAP} "
              f"and on chain C at the default cap; {smi}")
    # The compiled sym streams: one launch of the role a limb a call.
    for n, nprimes in ((4096, 3), (16384, 13)):
        parms = default_parms(n, nprimes)
        values, sk, share, err = custom_inputs(n, UNIFORM_B)[:4]
        args = state_to_device(values, sk, share, err, dev)

        def streamed():
            return list(stream.sym_encrypt_stream(*args, parms, "f64",
                                                  "forward"))
        streamed()
        _, counts, _ = counted_run(streamed)
        if counts["keccak_uniform"] != nprimes:
            raise AssertionError(f"sym stream n={n} L={nprimes}: "
                                 f"{counts['keccak_uniform']} launches of "
                                 f"the uniform role a call, want {nprimes}")
        stream.sym_stream(parms, "forward", dev).chain.clear()
        print(f"[10 uniform] compiled sym stream n={n} L={nprimes} "
              f"B={UNIFORM_B}: the uniform role launched {nprimes} times a "
              f"call, once a limb (launches {counts}); {smi}")
    return rows


TERNARY_NS = (4096, 8192, 16384)
TERNARY_BS = (1, 16, 512, 1024)
TERNARY_WINDOWS = (1, 2, 33, 97)   # forced: the walk stops, squeezes again
TERNARY_ROWS = ((16384, 512), (4096, 1024))     # timed alone
KT = ("seal_embedded_tpu/ops/sampling.py:330 sample_ternary (:309 "
      "_ternary_block, :211 _rank_select)")


def ternary_inputs(n, batch, dev):
    """batch streams' seed words and counters from numpy seed n + batch:
    EXACT_SEEDS (more than 8 refills in their first block) at rows 0 and
    batch - 1, counters 2^32 - 3 and 2^64 - 3 at rows 1 and 2 (where the
    batch has them), the others random."""
    rng = np.random.default_rng(n + batch)
    seeds = rng.integers(0, 2 ** 32, (batch, 16), dtype=np.int64)
    ctr = rng.integers(0, 2 ** 32, (batch, 2), dtype=np.int64)
    seeds[0] = kc.seed_to_words(exact_seed(EXACT_SEEDS[0]))
    seeds[-1] = kc.seed_to_words(exact_seed(EXACT_SEEDS[-1]))
    for row, value in ((1, 2 ** 32 - 3), (2, 2 ** 64 - 3))[:batch - 1]:
        ctr[row] = (value & 0xFFFFFFFF, value >> 32)
    return (torch.as_tensor(seeds, device=dev),
            torch.as_tensor(ctr, device=dev))


def ternary_check(name, seeds, ctr, n, want, shape=None):
    """KK's ternary role (kernels.keccak.ternary_draw, or ternary_launch
    with shape = (window, threads)) against want, its plain version's
    (u, next counters), bit for bit; it must launch once.  Returns (the
    role's outputs, a fn that launches it)."""
    def fn():
        if shape is None:
            return k_keccak.ternary_draw(seeds, ctr, n)
        return k_keccak.ternary_launch(seeds, ctr, n, *shape)
    before = k_keccak.ternary_launches
    got = fn()
    torch.cuda.synchronize()
    if k_keccak.ternary_launches - before != 1:
        raise AssertionError(f"{name}: the ternary role launched "
                             f"{k_keccak.ternary_launches - before} times")
    for part, g, w in zip(("u", "next counter"), got, want):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"{name}: the ternary role's {part} "
                                 "differs from its plain version")
    return got, fn


def ternary_role(dev, smi):
    """Phase 10's KK ternary role (kernels.keccak.ternary_draw: a call's
    whole ternary draw, the redraw unbounded, in one launch) against its
    plain version (sample_ternary_exact's loop on the CPU, on the same
    seeds and counters), values and next counters bit for bit, at every
    n of TERNARY_NS and B of TERNARY_BS, the planted seeds and counters
    at 2^32 - 3 and 2^64 - 3 among them (ternary_inputs); at n = 4096, B
    = 16, windows forced down to TERNARY_WINDOWS, so that the walk stops
    and the CTA squeezes again.  Prints the window's permutations beside
    those consumed (next counter - c0).  Returns the kernel rows of
    TERNARY_ROWS (timed alone later, beside their bounds, the
    permutations counted as benchmark/metrics/keccak_roofline.py counts
    them)."""
    rows = []
    kk = "seal_embedded_tpu_torch/csrc/keccak.cu"
    r = 2 / 256
    for n in TERNARY_NS:
        for batch in TERNARY_BS:
            seeds, ctr = ternary_inputs(n, batch, dev)
            t0 = time.perf_counter()
            want = sp.sample_ternary_exact(seeds.cpu(), ctr.cpu(), n)
            pms = (time.perf_counter() - t0) * 1e3
            name = f"ternary n={n} B={batch}"
            got, fn = ternary_check(name, seeds, ctr, n, want)
            window, threads = k_keccak.ternary_shape(n, batch)
            used = [((a | b << 32) - (c | d << 32)) % 2 ** 64
                    for (a, b), (c, d) in zip(got[1].tolist(),
                                              ctr.tolist())]
            again = sum(u > window - 33 for u in used)
            print(f"[10 ternary] {name}: KK's ternary role bit-equal to its "
                  f"plain version (u, next counters; seeds {EXACT_SEEDS} "
                  f"planted, counters 2^32 - 3 and 2^64 - 3), window "
                  f"{window}, {threads} threads a CTA: {batch * window} "
                  f"permutations in the first windows, "
                  f"{sum(used)} consumed, unused share "
                  f"{1 - sum(used) / (batch * window):.4f}, "
                  f"{again} streams squeezed again; plain {pms:.1f} ms on "
                  f"the CPU; {smi}")
            if (n, batch) in TERNARY_ROWS:
                ms = cuda_time_ms(fn, TIME_ITERS)
                perms = batch * (-(-n // 96) + n * r / (1 - r))
                rows.append(kernel_row(
                    f"ternary_draw n={n} B={batch}", kk, KT,
                    "keccak_ternary", 0, fn, ms, pms,
                    f"{batch} streams x {-(-n // 96)} blocks, window "
                    f"{window} (plain: the CPU loop)", ("keccak", perms),
                    u32_bytes(seeds, ctr, got[1]) + got[0].numel()))
            if (n, batch) == (4096, 16):
                for w in TERNARY_WINDOWS:
                    ternary_check(f"{name} window {w}", seeds, ctr, n, want,
                                  (w, 32 * -(-w // 32)))
                print(f"[10 ternary] {name}: bit-equal with the window "
                      f"forced to each of {TERNARY_WINDOWS} counters; {smi}")
    return rows


def custom_row(n, sym_b, asym_b, sym_names, asym_names, mesh, dev, smi):
    """One phase 10 row at degree n on the custom chain: the compiled
    fused sym batch (sym_b) and asym batch (asym_b, pk from gen_pk_batch)
    at full width, ok for every row and the oracle rows bit-exact against
    golden/ckks.py (pk too); the limb-scan reference layout and the
    compiled sym stream equal to the sym batch; the world-size-1
    limb-sharded sym on a B = CUSTOM_SHARD_B slice equal to the
    single-device parallel layout, decrypted to its pte; the kernels
    against their plain versions on the batches' own tensors; each batch
    timed beside the default chain's at (n, 3).  Returns (the launch
    counts of each run with the kernels its path must launch, the kernel
    rows)."""
    parms = Parms(n, CUSTOM_CHAIN, CUSTOM_SCALE)
    base = default_parms(n, len(CUSTOM_CHAIN))
    values, sk, share, err, pk_seed, ep = custom_inputs(n, sym_b)
    packed = serialize.pack_ternary((sk + 1).tolist())
    args = state_to_device(values, sk, share, err, dev)
    runs, rows = {}, []
    tag = f"custom n={n}"
    iters = DEPTH_ITERS_16384 if n >= 16384 else TIME_ITERS
    t0, spent = time.perf_counter(), [0.0]

    def oracle(fn, *a, **kw):
        """A golden/ckks.py call, its host time counted."""
        start = time.perf_counter()
        out = fn(*a, **kw)
        spent[0] += time.perf_counter() - start
        return out
    caps = (sp.queue_cap_for(n, CUSTOM_CHAIN), sp.queue_cap_for(
        n, base.moduli))

    # sym, compiled, checked against the C loop, the limb-scan reference
    # layout, the compiled stream and the sharded path.
    sym = make_fused_encryptor(parms, device=dev)
    out, counts, *sym_mem = first_and_replay(sym, args)
    rows_o = oracle_rows(sym_b)
    check_oracle(out, [oracle(gckks.sym_encrypt, parms, values[r], packed,
                              seed_of(share[r]), seed_of(err[r]))
                       for r in rows_o], rows_o, f"{tag} sym")
    runs[f"{tag} sym"] = (counts, SYM_PATH)
    # Each compiled path's first call captures; its replay is counted.
    limbscan = make_limbscan_encryptor(parms, "reference", "sf", device=dev)
    limbscan(*args)
    got, counts, _ = counted_run(lambda: limbscan(*args))
    runs[f"{tag} limb-scan"] = (counts, SYM_PATH)
    for key, want in out.items():
        if not torch.equal(got[key], want):
            raise AssertionError(f"{tag} limb-scan reference: {key} "
                                 f"differs from the fused batch")
    del got

    def streamed():
        return list(stream.sym_encrypt_stream(*args, parms, "f64",
                                              "forward"))
    streamed()
    limbs, counts, _ = counted_run(streamed)
    runs[f"{tag} sym stream"] = (counts, SYM_PATH)
    check_limbs(limbs, out["c0"], out["c1"], [0, 1, 2], f"{tag} sym stream")
    del limbs
    part = tuple(a[:CUSTOM_SHARD_B] if i != 1 else a
                 for i, a in enumerate(args))
    sharded = make_limb_sharded_encryptor(mesh, parms)
    sharded(*part)
    got, counts, _ = counted_run(lambda: sharded(*part))
    runs[f"{tag} limb-sharded"] = (counts, SYM_PATH)
    require_same(f"{tag} limb-sharded", got, LimbscanEncryptor(
        parms, "parallel", device=dev)(*part))
    check_decrypts(got, args[1], parms, f"{tag} limb-sharded")
    if not (torch.equal(got["pte"], out["pte"][:CUSTOM_SHARD_B])
            and bool(got["ok"].all())):
        raise AssertionError(f"{tag} limb-sharded: pte or ok wrong")
    del got
    print(f"[10 custom] {tag} sym L=3 B={sym_b} (chain {CUSTOM_CHAIN}, "
          f"queue cap {caps[0]}, default chain's {caps[1]}), compiled: ok "
          f"for all {sym_b}, rows {rows_o} bit-exact (c0, c1, pt, pte) "
          f"against golden/ckks.py sym_encrypt; the limb-scan reference "
          f"layout and the compiled sym stream (every limb) equal to the "
          f"batch; the limb-sharded sym at world size 1 on rows "
          f"0..{CUSTOM_SHARD_B - 1} equal to the parallel layout, "
          f"decrypted to pte; launches {sum(counts.values())} a replay; "
          f"{smi}")
    rows += depth_kernels(sym_names, sym.fn, out, args, iters, dev, "10")
    del out
    custom_sampler_alone(n, sym_b, args[2], dev, smi)

    # The default chain's sym batch at (n, 3), its golden rows at both ends.
    gold = load_golden("sym", n, 3)
    dv, ds, de = depth_inputs(gold, sym_b)
    dargs = state_to_device(dv, gold["sk"], ds, de, dev)
    dsym = make_fused_encryptor(base, device=dev)
    dout, _, *dsym_mem = first_and_replay(dsym, dargs)
    check_golden_ends(dout, gold, f"{tag} default-chain sym")
    del dout
    custom_timed("sym", n, sym_b, {"custom": (sym, args, *sym_mem),
                                   "default": (dsym, dargs, *dsym_mem)}, smi)

    # asym, compiled, under gen_pk_batch's key.
    key_material = (args[1], torch.as_tensor(pk_seed.astype(np.int64),
                                             device=dev),
                    torch.as_tensor(ep, device=dev))
    pk = gen_pk_batch(*key_material, parms)
    gpk = oracle(gckks.gen_pk, parms, packed, seed_of(pk_seed),
                 ep=ep.tolist())
    for i, (w0, w1) in enumerate(gpk.components):
        if not (np.array_equal(pk[0][i].cpu().numpy(), w0)
                and np.array_equal(pk[1][i].cpu().numpy(), w1)):
            raise AssertionError(f"{tag}: gen_pk_batch's prime {i} differs "
                                 f"from golden/ckks.py gen_pk")
    v, s = asym_state_to_device(values[:asym_b], err[:asym_b], dev)
    aargs = (v, *pk, s)
    asym = make_fused_asym_encryptor(parms, device=dev)
    aout, counts, *asym_mem = first_and_replay(asym, aargs)
    rows_o = oracle_rows(asym_b)
    check_oracle(aout, [oracle(gckks.asym_encrypt, parms, values[r], gpk,
                               seed_of(err[r]))
                        for r in rows_o], rows_o, f"{tag} asym")
    runs[f"{tag} asym"] = (counts, ASYM_PATH)
    print(f"[10 custom] {tag} asym L=3 B={asym_b}, compiled, pk from "
          f"gen_pk_batch bit-exact against golden/ckks.py gen_pk: ok for "
          f"all {asym_b}, rows {rows_o} bit-exact (c0, c1, pt, pte) against "
          f"golden/ckks.py asym_encrypt; launches {sum(counts.values())} a "
          f"replay; {smi}")
    rows += depth_kernels(asym_names, asym.encryptor, aout, aargs, iters,
                          dev, "10")
    del aout
    dargs = (v, *gen_pk_batch(*key_material, base), s)
    dasym = make_fused_asym_encryptor(base, device=dev)
    dout, _, *dasym_mem = first_and_replay(dasym, dargs)
    if not bool(dout["ok"].all()):
        raise AssertionError(f"{tag} default-chain asym: ok is False")
    del dout
    custom_timed("asym", n, asym_b, {"custom": (asym, aargs, *asym_mem),
                                     "default": (dasym, dargs, *dasym_mem)},
                 smi)
    for fn in (sym, dsym, limbscan, asym, dasym, sharded):
        compiled_of(fn).clear()
    stream.sym_stream(parms, "forward", dev).chain.clear()
    print(f"[10 custom] {tag}: {time.perf_counter() - t0:.1f} s, of which "
          f"golden/ckks.py {spent[0]:.1f} s on the host; {smi}")
    return runs, rows


def phase_custom(dev, smi, sm_hz):
    """Phase 10: every CUSTOM_ROWS row (custom_row), the sharded path in a
    world-size-1 group; then the kernels' times alone against their
    bounds.  Returns (the runs' launch counts with the kernels each path
    must launch, the kernel rows)."""
    t0 = time.perf_counter()
    runs, rows = {}, []
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp, \
            launch.process_group(1, 0, str(pathlib.Path(tmp) / "store"),
                                 dev.type):
        mesh = make_mesh(1, 1, dev.type)
        for row in CUSTOM_ROWS:
            r, k = custom_row(*row, mesh, dev, smi)
            runs.update(r)
            rows += k
    rows += uniform_role(dev, smi)
    rows += ternary_role(dev, smi)
    set_kernel_alone_ms(rows)
    for r in rows:
        print(f"[10 kernels] {bound_line(r, sm_hz)}; "
              f"{r['kernel_ms']:.4f} ms alone; {smi}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[10 custom] phase 10 took {time.perf_counter() - t0:.1f} s; "
          f"{smi}")
    return runs, rows


def phase_entry(dev, smi):
    """Phase 11: seal_embedded_tpu_torch.entry.entry() on the card (a
    compiled sym_encrypt_batch, 4096/3, B = 4): its first call timed, two
    replays each torch.equal to the same fn on the CPU path
    (entry(device="cpu")), rows 0..3 bit-exact against golden/ckks.py
    sym_encrypt, ms per call.  Returns the launch counts of a replay."""
    fn, args = port_entry()
    if not (isinstance(fn, graphs.Graphed) and fn.device.type == dev.type
            and all(a.device.type == dev.type for a in args)):
        raise AssertionError(f"entry(): not compiled for {dev}")
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - start) * 1e3
    cpu_fn, cpu_args = port_entry(device="cpu")
    for got, want in zip(args, cpu_args):
        if not torch.equal(got.cpu(), want):
            raise AssertionError("entry(): example args differ on the card")
    want = cpu_fn(*cpu_args)
    for i in range(2):
        out, counts, _ = counted_run(lambda: fn(*args))
        for key, w in want.items():
            if not torch.equal(out[key].cpu(), w):
                raise AssertionError(f"entry(): replay {i} {key} differs "
                                     f"from the CPU path")
    if dev.type == "cuda" and len(fn.entries) != 1:
        raise AssertionError(f"entry(): {len(fn.entries)} signatures")
    parms = default_parms(4096, 3)
    values, sk, share, err = (a.cpu().numpy() for a in cpu_args)
    packed = serialize.pack_ternary((sk + 1).tolist())
    rows = list(range(values.shape[0]))
    check_oracle(out, [gckks.sym_encrypt(parms, values[r], packed,
                                         seed_of(share[r]), seed_of(err[r]))
                       for r in rows], rows, "entry()")
    ms = cuda_time_ms(lambda: fn(*args), TIME_ITERS)
    print(f"[11 entry] entry(): compiled sym_encrypt_batch n=4096 L=3 "
          f"B={values.shape[0]} on {args[0].device}; two replays torch.equal "
          f"to entry(device=\"cpu\") (c0, c1, pt, pte, ok); rows {rows} "
          f"bit-exact against golden/ckks.py sym_encrypt; {ms:.3f} ms a call"
          f" (CUDA events, median of {TIME_ITERS}), first call "
          f"{first_ms:.1f} ms (two warm-ups and the capture); launches "
          f"{sum(counts.values())} a replay; {smi}")
    return counts


# Phase 12: the device registry of compiled entries (graphs.Registry), in
# the process that phases 1 to 11 filled with graphs.  (a) is
# perf_memory.py's sequence: each batch fits the card alone, their
# graphs together do not; (b) eight signatures of one function; (c) the
# deep streams at full batch; (d) the early entries after the evictions.
MEMORY_N, MEMORY_L = SEQUENCE_N, SEQUENCE_L
MEMORY_SEQUENCE = SEQUENCE
MEMORY_SIGNATURES = tuple(range(128, 1025, 128))
MEMORY_STREAM_B = {"sym": 1024, "asym": 512}
MEMORY_PAIRS = 30
MEMORY_TOUCHES = 1000
MIB = 2 ** 20
# (c): the streams' pools when they held every limb's outputs, on an
# H100 80GB HBM3 at 700 W; the most a ring of two limb slots may hold;
# the short chain the sym pool is held against at the same n and B, and
# how far the two pools may differ (a limb at B = 1024 is 128 MiB).
EVERY_LIMB_POOL_MIB = {"sym": 2600.4, "asym": 1273.3}
STREAM_POOL_MIB = {"sym": 1350, "asym": 700}
RING_L = 3
RING_GAP_MIB = 32
# (e): what the idle entries leave free before the API's send path, and
# the most one of them holds.
FILL_FREE_GIB = 2
FILL_MAX_GIB = 16
GIB = 2 ** 30


def entry_name(owner, sig) -> str:
    """A registry entry as function and signature: the function's name and
    its tensor arguments' shapes (owner None: a function since dropped)."""
    if owner is None:
        name = "a dropped function"
    else:
        fn = owner.fn if isinstance(owner, graphs.Graphed) else owner.prologue
        fn = getattr(fn, "func", fn)                 # a partial's function
        name = getattr(fn, "__qualname__", type(fn).__name__)
    shapes = ", ".join("x".join(map(str, k[1])) for k in sig[0]
                       if k[0] == "tensor")
    return f"{name}({shapes})"


def evicted_since(reg, keys) -> str:
    """The entries of `keys` (registry keys: a function's weak reference
    and a signature) that the registry no longer holds."""
    gone = [entry_name(ref(), sig) for ref, sig in keys
            if (ref, sig) not in reg.order]
    return f"{len(gone)} evicted" + (f": {'; '.join(gone)}" if gone else "")


def cleared(g) -> str:
    """Evict every entry of the compiled function g: memory_reserved must
    fall by at least their pools' bytes (what each capture left reserved
    beyond its static inputs), or the pools did not go back."""
    entries = list(g.entries.values())
    pools = sum(e.resident - graphs.nbytes(e.inputs) for e in entries)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    g.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fell = before - torch.cuda.memory_reserved()
    if fell < pools:
        raise AssertionError(f"cleared {len(entries)} entries: "
                             f"memory_reserved fell {fell} B, their pools "
                             f"hold {pools} B")
    return (f"{len(entries)} entries evicted, memory_reserved fell "
            f"{fell / MIB:.1f} MiB for {pools / MIB:.1f} MiB of pools")


def memory_case(batch, dev):
    """(compiled fused sym factory, its Graphed, args of depth_inputs,
    their signature, gold) of one sym batch at MEMORY_N, MEMORY_L."""
    gold = load_golden("sym", MEMORY_N, MEMORY_L)
    values, share, err = depth_inputs(gold, batch)
    args = state_to_device(values, gold["sk"], share, err, dev)
    fn = make_fused_encryptor(default_parms(MEMORY_N, MEMORY_L), device=dev)
    return fn, compiled_of(fn), args, graphs.signature(args, {}), gold


def memory_sequence(dev, smi, reg, card):
    """(a): MEMORY_SEQUENCE through the compiled fused sym factory at
    16384/13 (perf_memory.run_sequence), its own earlier graphs evicted
    first, every earlier phase's kept: each batch golden at both ends and
    ok for all; per call whether it captured (again), its ms, the entry's
    resident bytes, the entries evicted, the warm-ups run again after
    running out, memory_reserved.  Returns the largest peak
    memory_reserved."""
    gold = load_golden("sym", MEMORY_N, MEMORY_L)
    fn = make_fused_encryptor(default_parms(MEMORY_N, MEMORY_L), device=dev)
    g = compiled_of(fn)
    print(f"[12 memory] (a) {entry_name(g, ((), ()))}: its earlier "
          f"signatures first: {cleared(g)}; {smi}")
    top, seen, before = 0, set(), {}

    def inputs_of(batch):
        values, share, err = depth_inputs(gold, batch)
        args = state_to_device(values, gold["sk"], share, err, dev)
        before.update(keys=list(reg.order), retries=reg.retries,
                      fresh=graphs.signature(args, {}) not in g.entries)
        return args

    def report(i, batch, args, out, ms, peak):
        nonlocal top
        check_golden_ends(out, gold, f"memory (a) call {i} B={batch}")
        top = max(top, peak)
        how = ("replayed" if not before["fresh"] else "captured again"
               if batch in seen else "captured")
        seen.add(batch)
        entry = g.entries[graphs.signature(args, {})]
        print(f"[12 memory] (a) call {i} sym n={MEMORY_N} L={MEMORY_L} "
              f"B={batch}: rows 0..5 and {batch - 6}..{batch - 1} golden, "
              f"ok for all; {how} in {ms:.1f} ms (host clock, card "
              f"finished); entry resident {entry.resident / MIB:.1f} MiB; "
              f"{evicted_since(reg, before['keys'])}, "
              f"{reg.retries - before['retries']} warm-ups run again; "
              f"memory_reserved after "
              f"{torch.cuda.memory_reserved() / MIB:.1f} MiB, peak in the "
              f"call {peak / MIB:.1f} of {card / MIB:.1f}; registry "
              f"{len(reg.order)} entries, {reg.resident() / MIB:.1f} MiB; "
              f"{smi}")
    run_sequence(fn, inputs_of, report, MEMORY_SEQUENCE)
    return top


def memory_signatures(dev, smi, reg, card):
    """(b): MEMORY_SIGNATURES through the compiled fused sym factory at
    16384/13 (MAX_ENTRIES of them), its earlier graphs evicted first: each
    golden at both ends; each signature's resident bytes and footprint,
    their sum and what the registry kept.  Returns the largest peak
    memory_reserved."""
    top, rows = 0, []
    for batch in MEMORY_SIGNATURES:
        fn, g, args, sig, gold = memory_case(batch, dev)
        if not rows:
            print(f"[12 memory] (b) {entry_name(g, sig)}: {cleared(g)}")
        keys = list(reg.order)
        out, ms, peak = timed_call(fn, args)
        check_golden_ends(out, gold, f"memory (b) B={batch}")
        del out
        replay_peak = peak_run(lambda: fn(*args))[2]
        resident = g.entries[sig].resident
        rows.append((batch, sig, resident, resident + replay_peak))
        top = max(top, peak)
        print(f"[12 memory] (b) sym n={MEMORY_N} L={MEMORY_L} B={batch}: "
              f"golden at both ends, ok for all; captured in {ms:.1f} ms; "
              f"resident {resident / MIB:.1f} MiB, footprint "
              f"{(resident + replay_peak) / MIB:.1f} MiB (+ a replay's peak"
              f" {replay_peak / MIB:.1f}); {evicted_since(reg, keys)}; {smi}")
    kept = [b for b, sig, _, _ in rows if sig in g.entries]
    print(f"[12 memory] (b) {len(rows)} signatures: resident "
          f"{sum(r[2] for r in rows) / MIB:.1f} MiB in all, footprints "
          f"{sum(r[3] for r in rows) / MIB:.1f} MiB in all; the registry "
          f"kept B={kept} ({len(reg.order)} entries, "
          f"{reg.resident() / MIB:.1f} MiB); memory_reserved "
          f"{torch.cuda.memory_reserved() / MIB:.1f} MiB of "
          f"{card / MIB:.1f}; {smi}")
    return top


def memory_ring_gap(dev, smi, args, pool):
    """(c): the compiled sym stream at MEMORY_N, L = RING_L on the inputs
    of the L = MEMORY_L one, whose pool holds `pool` bytes: every limb
    equal to SymEncryptor's batch, and its pool within RING_GAP_MIB of
    `pool` (the ring does not grow with the chain)."""
    parms = default_parms(MEMORY_N, RING_L)
    cached = stream.sym_stream(parms, "forward", dev)
    cached.chain.clear()
    limbs = list(stream.sym_encrypt_stream(*args, parms))
    entry, = cached.chain.entries.values()
    out = SymEncryptor(parms, dev)(*args)
    check_limbs(limbs, *(out[k].cpu() for k in ("c0", "c1")),
                list(range(RING_L)), f"memory (c) sym L={RING_L}")
    del out, limbs
    gap = pool - entry.resident
    print(f"[12 memory] (c) compiled sym stream n={MEMORY_N} L={RING_L} "
          f"B={args[0].shape[0]} on the same inputs: every limb equal to "
          f"SymEncryptor's; pool resident {entry.resident / MIB:.1f} MiB "
          f"against {pool / MIB:.1f} at L={MEMORY_L}, {gap / MIB:.1f} MiB "
          f"apart (at most {RING_GAP_MIB}); {smi}")
    if abs(gap) > RING_GAP_MIB * MIB:
        raise AssertionError(f"memory (c): the sym stream's pool at L="
                             f"{MEMORY_L} and L={RING_L} differ by {gap} B")
    cached.chain.clear()


def memory_streams(dev, smi):
    """(c): the compiled sym stream at 16384/13, B=1024, and the asym one
    at B=512 (pk from gen_pk_batch), through their public entry points:
    the golden rows at both ends limb by limb, every limb against the
    compiled fused factory's batch (golden at both ends), a replay equal
    and making the launches one call must make (stream_launches); the
    pool's resident bytes (the registry's;
    at most STREAM_POOL_MIB), the footprint, the streamed ms beside the
    compiled batch + fetch; then the sym pool against the L = RING_L
    one's (memory_ring_gap).  Returns the launch counts of one replayed
    stream of each with the kernels its path must launch."""
    parms = default_parms(MEMORY_N, MEMORY_L)
    walk = list(range(MEMORY_L))
    runs = {}
    for kind, batch in MEMORY_STREAM_B.items():
        name = f"memory (c) {kind} stream n={MEMORY_N} B={batch}"
        gold = load_golden(kind, MEMORY_N, MEMORY_L)
        G = gold["v"].shape[0]
        values, share, err = depth_inputs(gold, batch)
        if kind == "sym":
            args = state_to_device(values, gold["sk"], share, err, dev)
            cached = stream.sym_stream(parms, "forward", dev)
            fn = make_fused_encryptor(parms, device=dev)

            def streamed():
                return list(stream.sym_encrypt_stream(*args, parms))
        else:
            pk = golden_pk(gold, parms, dev)
            check_pk(pk, gold, name)
            v, s = asym_state_to_device(values, err, dev)
            args = (v, *pk, s)
            cached = stream.asym_stream(parms, "forward", dev)
            fn = make_fused_asym_encryptor(parms, device=dev)

            def streamed():
                return list(stream.asym_encrypt_stream(v, *pk, s, parms))
        cached.chain.clear()
        limbs, first_ms, _ = timed_call(streamed, ())
        entry, = cached.chain.entries.values()
        host = {k: torch.as_tensor(np.stack([l[k] for l in limbs])
                                   .astype(np.int64)) for k in ("c0", "c1")}
        for at in (0, batch - G):
            check_golden_rows({**host, "ok": torch.ones(1, dtype=torch.bool)},
                              gold, f"{name} rows {at}..", ("c0", "c1"), at)
        del host
        out = fn(*args)
        check_golden_ends(out, gold, f"{name}: the fused batch")
        want = [out[k].cpu() for k in ("c0", "c1")]
        del out
        check_limbs(limbs, *want, walk, name)
        limbs, counts, peak = peak_run(streamed)
        runs[name] = (counts, SYM_PATH if kind == "sym" else ASYM_PATH)
        check_limbs(limbs, *want, walk, f"{name}, replayed")
        check_launches(counts, kind, parms, name)
        del limbs, want
        if len(entry.outputs) != graphs.RING_SLOTS:
            raise AssertionError(f"{name}: {len(entry.outputs)} limb slots")
        g = compiled_of(fn)
        batch_resident = next(e.resident for e in g.entries.values()
                              if e.inputs[0].shape[0] == batch)
        batch_peak = peak_run(lambda: fetch_to_pinned(fn(*args)))[2]
        (ms, batch_ms), _ = rotated_host_ms(
            [streamed, lambda: fetch_to_pinned(fn(*args))], DEEP_ROUNDS)
        print(f"[12 memory] (c) compiled {kind} stream n={MEMORY_N} "
              f"L={MEMORY_L} B={batch}: rows 0..{G - 1} and {batch - G}.."
              f"{batch - 1} golden_{kind}_{MEMORY_N}_{MEMORY_L}.npz limb by "
              f"limb, every limb equal to the compiled fused batch's (golden "
              f"at both ends), a replay equal; first call {first_ms:.1f} ms;"
              f" pool resident {entry.resident / MIB:.1f} MiB (at most "
              f"{STREAM_POOL_MIB[kind]}; {EVERY_LIMB_POOL_MIB[kind]} when it "
              f"held every limb), {len(entry.outputs)} limb slots; "
              f"footprint "
              f"{(entry.resident + peak) / MIB:.1f} MiB (+ {peak / MIB:.1f}"
              f" peak above the inputs) vs compiled batch + fetch "
              f"{(batch_resident + batch_peak) / MIB:.1f} "
              f"({batch_resident / MIB:.1f} + {batch_peak / MIB:.1f}); "
              f"streamed {ms:.3f} ms vs compiled batch + fetch "
              f"{batch_ms:.3f} ms (host clock to the last limb in host "
              f"memory, medians of {DEEP_ROUNDS} rotated rounds); launches "
              f"{sum(counts.values())}, those one call makes; {smi}")
        if entry.resident > STREAM_POOL_MIB[kind] * MIB:
            raise AssertionError(f"{name}: pool {entry.resident} B, above "
                                 f"{STREAM_POOL_MIB[kind]} MiB")
        if kind == "sym":
            memory_ring_gap(dev, smi, args, entry.resident)
    return runs


def memory_early(dev, smi, early):
    """(d): phase 5's headline sym 4096/3 B=1024 (rows 0..5 golden) and
    the cost of a call of its live entry (perf_memory.call_cost): the
    whole call against the call as it was before the registry, each
    beside Entry.replay, in rotated rounds; then every phase 8 factory at
    the headline's shape (equal to its eager module, its check) and every
    phase 9 batch (golden at both ends), each captured again if the
    registry evicted it."""
    parms = default_parms(N, L)
    gold = load_golden("sym", N, L)
    values, share, err = headline_inputs(gold)
    args = state_to_device(values, gold["sk"], share, err, dev)
    fn = make_fused_encryptor(parms, device=dev)
    g = compiled_of(fn)
    sig = graphs.signature(args, {})
    how = ("replayed" if sig in g.entries else "captured again"
           if (g.ref, sig) in early else "captured")
    out = fn(*args)
    check_golden_rows(out, gold, "memory (d) headline sym")
    del out
    cost = call_cost(g, args, MEMORY_PAIRS)
    start = time.perf_counter()
    for _ in range(MEMORY_TOUCHES):
        with g.use(sig, args, {}):
            pass
    touch_us = (time.perf_counter() - start) / MEMORY_TOUCHES * 1e6
    added = cost["call"] - cost["before_registry"]
    if added >= 0.05:
        raise AssertionError(f"memory (d): the whole call {cost['call']:.4f}"
                             f" ms, as before the registry "
                             f"{cost['before_registry']:.4f} ms")
    print(f"[12 memory] (d) headline sym n={N} L={L} B={B} {how}, rows "
          f"0..5 golden; then its live entry: the whole call "
          f"{cost['call']:.4f} ms, as before the registry "
          f"{cost['before_registry']:.4f} ms (the registry adds "
          f"{added:.4f}), Entry.replay {cost['replay']:.4f} ms (CUDA events,"
          f" medians of {MEMORY_PAIRS} rotated rounds); a lookup with its "
          f"locks {touch_us:.2f} us (host, mean of {MEMORY_TOUCHES}); {smi}")

    again, live = [], []
    for tag, cfn, eager, cargs, _, _, check, _ in compiled_cases(dev):
        (live if any(e.inputs[0].shape == cargs[0].shape
                     for e in compiled_of(cfn).entries.values())
         else again).append(tag)
        out = cfn(*cargs)
        require_outputs_equal(f"memory (d) {tag}", out, eager(*cargs))
        check(out, f"memory (d) {tag}")
    for tag, kind, n, nprimes, batches, _ in DEPTH_ROWS:
        for batch in batches:
            dfn, _, dargs, _, _, dgold = depth_case(kind, n, nprimes, batch,
                                                    dev)
            name = f"{tag} B={batch}"
            (live if any(e.inputs[0].shape[0] == batch
                         for e in compiled_of(dfn).entries.values())
             else again).append(name)
            check_golden_ends(dfn(*dargs), dgold, f"memory (d) {name}")
    print(f"[12 memory] (d) phase 8's factories and phase 9's batches, "
          f"equal to their eager modules or golden at both ends: "
          f"{len(again)} captured again ({', '.join(again)}), {len(live)} "
          f"still live; {smi}")


def memory_dropped(dev, smi):
    """(d): a compiled function that its caller drops (an uncached
    graphed SymEncryptor at the headline's shape, rows 0..5 golden): its
    entry leaves the registry, its static inputs (the key's copy among
    them) are zeroed, and memory_reserved falls by its pool."""
    gold = load_golden("sym", N, L)
    values, share, err = headline_inputs(gold)
    args = state_to_device(values, gold["sk"], share, err, dev)
    g = graphs.graphed(SymEncryptor(default_parms(N, L), dev), dev)
    check_golden_rows(g(*args), gold, "memory (d) a dropped function")
    entry, = g.entries.values()
    inputs, pool = entry.inputs, entry.resident - graphs.nbytes(entry.inputs)
    reg = graphs.registry_for(dev)
    held = len(reg.order)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    del g, entry
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fell = before - torch.cuda.memory_reserved()
    if len(reg.order) != held - 1 or any(bool(t.any()) for t in inputs):
        raise AssertionError("memory (d): a dropped function's entry stayed"
                             " in the registry or was not zeroed")
    if fell < pool:
        raise AssertionError(f"memory (d): dropping a function gave back "
                             f"{fell} B, its pool holds {pool} B")
    print(f"[12 memory] (d) a compiled function dropped by its caller: its "
          f"entry left the registry, static inputs zeroed, memory_reserved "
          f"fell {fell / MIB:.1f} MiB for a pool of {pool / MIB:.1f} MiB; "
          f"{smi}")


def free_bytes() -> int:
    """The card's free bytes once the allocator's cache is handed back."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def memory_held(dev, smi, reg, card):
    """(e): perf_memory.run_held through the compiled fused sym factory at
    16384/13, its earlier graphs evicted first: B = HOLD_FIRST captured,
    then HOLD_CALLS calls at B = HOLD_B with every output kept (the
    middle rows of call k from seed DEPTH_SEED + k), each golden at both
    ends once all are held; the B = HOLD_B entry is the same throughout
    (never evicted for the outputs).  Returns the largest peak
    memory_reserved."""
    gold = load_golden("sym", MEMORY_N, MEMORY_L)
    fn = make_fused_encryptor(default_parms(MEMORY_N, MEMORY_L), device=dev)
    g = compiled_of(fn)
    print(f"[12 memory] (e) {entry_name(g, ((), ()))}: its earlier "
          f"signatures first: {cleared(g)}; {smi}")
    evictions, top, live = reg.evictions, 0, []
    t0 = time.perf_counter()

    def inputs_of(batch, k):
        values, share, err = depth_inputs(
            gold, batch, DEPTH_SEED + (0 if k is None else k))
        return state_to_device(values, gold["sk"], share, err, dev)

    def report(k, args, out, ms, peak):
        nonlocal top
        top = max(top, peak)
        live.append(g.entries.get(graphs.signature(args, {})))
        print(f"[12 memory] (e) held call {k} sym n={MEMORY_N} "
              f"L={MEMORY_L} B={HOLD_B}: {k + 1} outputs held, "
              f"{ms:.1f} ms (host clock, card finished); "
              f"{reg.evictions - evictions} evictions since the captures "
              f"began; memory_reserved {torch.cuda.memory_reserved() / MIB:.1f}"
              f" MiB, peak in the call {peak / MIB:.1f} of "
              f"{card / MIB:.1f}; registry {len(reg.order)} entries, "
              f"{reg.resident() / MIB:.1f} MiB; {smi}")
    held = run_held(fn, inputs_of, report, HOLD_FIRST, HOLD_B, HOLD_CALLS)
    for k, out in enumerate(held):
        check_golden_ends(out, gold, f"memory (e) held call {k}")
    if live[0] is None or any(e is not live[0] for e in live):
        raise AssertionError("memory (e): the held calls' entry was "
                             "evicted or captured again")
    outs = graphs.nbytes(held)
    reserved = torch.cuda.memory_reserved()
    del held
    print(f"[12 memory] (e) held outputs: B={list(HOLD_FIRST)} captured, "
          f"then k = {HOLD_CALLS} of {HOLD_CALLS} calls at B={HOLD_B} with "
          f"every output held ({outs / MIB:.1f} MiB), each golden at both "
          f"ends and ok for all, one live entry throughout; "
          f"{reg.evictions - evictions} evictions; memory_reserved with all"
          f" held {reserved / MIB:.1f} MiB of {card / MIB:.1f}; "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    return top


def card_filler(x, size):
    """A compiled function whose graph's pool keeps a scratch of `size`
    bytes: once captured, an idle entry of about that size."""
    return {"y": x + torch.zeros(size, dtype=torch.uint8,
                                 device=x.device)[:1]}


def memory_api_full(dev, smi, reg, card):
    """(e): se_encrypt_seeded with send at 16384/13, B = HOLD_B (the
    golden rows at both ends), its signature captured first, then idle
    card_filler entries captured until the card has under FILL_FREE_GIB
    free (none evicted): the call's clones, the canonicality check and
    the send path's casts make their room, and every sent component of
    the golden rows equals ct_component_bytes of the golden file."""
    gold = load_golden("sym", MEMORY_N, MEMORY_L)
    G = gold["v"].shape[0]
    values, share, err = depth_inputs(gold, HOLD_B)
    share_seeds = [kc.words_to_bytes_np(w) for w in share]
    err_seeds = [kc.words_to_bytes_np(w) for w in err]
    ctx = api.se_setup_custom(MEMORY_N, MEMORY_L, 2 ** 25, api.SYM,
                              sk=gold["sk"], device=dev)
    check_golden_ends(api.se_encrypt_seeded(ctx, values, share_seeds,
                                            err_seeds), gold,
                      "memory (e) api")
    fill = graphs.graphed(card_filler, dev)
    x = torch.zeros(1, dtype=torch.int64, device=dev)
    evictions, sizes = reg.evictions, []
    while (free := free_bytes()) >= FILL_FREE_GIB * GIB:
        if len(sizes) == graphs.MAX_ENTRIES:
            raise AssertionError(f"memory (e): {len(sizes)} fillers left "
                                 f"{free} B free")
        # Sizes apart by a byte: each is a signature of its own.
        sizes.append(min(free - 3 * GIB // 2, FILL_MAX_GIB * GIB)
                     - len(sizes))
        fill(x, sizes[-1])
    if reg.evictions != evictions:
        raise AssertionError("memory (e): filling the card evicted "
                             f"{reg.evictions - evictions} entries")
    per_message = 2 * MEMORY_L
    sent = {"n": 0, "bad": []}

    def send(data):
        b, rest = divmod(sent["n"], per_message)
        i, part = divmod(rest, 2)
        sent["n"] += 1
        golden = b < G or b >= HOLD_B - G
        row = b if b < G else b - (HOLD_B - G)
        if golden and data != serialize.ct_component_bytes(
                gold[("c0", "c1")[part]][i, row]):
            sent["bad"].append((b, i, part))
        if len(data) != 4 * MEMORY_N:
            sent["bad"].append((b, i, part, len(data)))
        return len(data)
    before = reg.evictions
    start = time.perf_counter()
    out = api.se_encrypt_seeded(ctx, values, share_seeds, err_seeds,
                                send=send)
    ms = (time.perf_counter() - start) * 1e3
    check_golden_ends(out, gold, "memory (e) api send")
    del out
    if sent["bad"] or sent["n"] != per_message * HOLD_B:
        raise AssertionError(f"memory (e) api send: {sent['n']} components"
                             f" sent, wrong: {sent['bad'][:8]}")
    print(f"[12 memory] (e) api se_encrypt_seeded with send, sym n="
          f"{MEMORY_N} L={MEMORY_L} B={HOLD_B}, its signature captured, "
          f"then {len(sizes)} idle card_filler entries "
          f"({sum(sizes) / MIB:.1f} MiB, none evicted) left {free / MIB:.1f}"
          f" MiB free: the call evicted {reg.evictions - before} entries "
          f"for its clones, check and casts and took {ms:.1f} ms (host "
          f"clock, with the send); {sent['n']} components sent, the golden"
          f" rows 0..{G - 1} and {HOLD_B - G}..{HOLD_B - 1} equal to "
          f"ct_component_bytes of the golden file, ok for all; {smi}")
    api.se_cleanup(ctx)
    fill.clear()


def phase_memory(dev, smi):
    """Phase 12: the registry holds the card's memory as jax.jit does (see
    memory_sequence, memory_signatures, memory_streams, memory_early,
    memory_held, memory_api_full); no peak memory_reserved in a call
    above the card.  Returns the launch counts of the streams' replays
    with the kernels their paths must launch."""
    t0 = time.perf_counter()
    reg = graphs.registry_for(dev)
    early = set(reg.order)
    evictions, retries = reg.evictions, reg.retries
    card = torch.cuda.get_device_properties(dev).total_memory
    print(f"[12 memory] before phase 12: the registry holds {len(early)} "
          f"entries of {len({owner for owner, _ in early})} functions, "
          f"{reg.resident() / MIB:.1f} MiB left reserved by their captures"
          f", {reg.evictions} evictions so far (the earlier phases clear a "
          f"function's entries before they time its first call); "
          f"memory_reserved "
          f"{torch.cuda.memory_reserved() / MIB:.1f} MiB of "
          f"{card / MIB:.1f}; {smi}")
    top = max(memory_sequence(dev, smi, reg, card),
              memory_signatures(dev, smi, reg, card))
    runs = memory_streams(dev, smi)
    memory_early(dev, smi, early)
    memory_dropped(dev, smi)
    top = max(top, memory_held(dev, smi, reg, card))
    memory_api_full(dev, smi, reg, card)
    if top > card:
        raise AssertionError(f"memory_reserved peaked at {top} B, above the "
                             f"card's {card} B")
    print(f"[12 memory] phase 12: {reg.evictions - evictions} evictions, "
          f"{reg.retries - retries} warm-ups run again, "
          f"peak memory_reserved in a call {top / MIB:.1f} MiB of "
          f"{card / MIB:.1f}; {len(reg.order)} entries, "
          f"{reg.resident() / MIB:.1f} MiB kept; phase 12 took "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    return runs


def main():
    smi, sm_hz = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    kc_rows, calib_counts = phase_calibrate(dev, smi, sm_hz, rows)
    rows += kc_rows
    phase_golden(dev)
    phase_exact_ternary(dev, smi)
    sym_path, table_path, asym_path = SYM_PATH, TABLE_PATH, ASYM_PATH
    runs = {"sym headline": (phase_headline_sym(dev, smi), sym_path),
            "asym headline": (phase_headline_asym(dev, smi),
                              asym_path + ("ntt",))}
    for tag, counts in phase_headline_limbscan(dev, smi).items():
        runs[f"{tag} headline"] = (counts, table_path
                                   if "sym_encrypt_batch" in tag
                                   else sym_path)
    for tag, counts in phase_api_stream(dev, smi).items():
        runs[tag] = (counts, asym_path if "asym" in tag else sym_path)
    runs["deep stream"] = (phase_deep_stream(dev, smi), sym_path)
    for tag, counts in phase_scale_out(dev, smi).items():
        runs[tag] = (counts, {"sym_encrypt_sharded": table_path,
                              "sweep": sym_path + ("ntt_asym",)}.get(
            tag, asym_path if "asym" in tag else sym_path))
    runs.update(phase_compiled(dev, smi))
    depth_runs, depth_rows = phase_depth(dev, smi, sm_hz)
    runs.update(depth_runs)
    rows += depth_rows
    custom_runs, custom_rows = phase_custom(dev, smi, sm_hz)
    runs.update(custom_runs)
    rows += custom_rows
    runs["entry"] = (phase_entry(dev, smi), TABLE_PATH)
    runs.update(phase_memory(dev, smi))
    runs["calibration"] = (calib_counts, ("calib",))
    for path, (counts, needed) in runs.items():
        missing = [k for k in needed if counts[k] < 1]
        if missing:
            raise AssertionError(f"kernels not launched by the {path} "
                                 f"run: {missing}")
        print(f"[6 launches] {path} run: {counts}")
    for r in rows:
        print(f"[5 headline] kernel {r['name']} ({r['shape']}): "
              f"{r['ms']:.4f} ms through the wrapper, {r['kernel_ms']:.4f} "
              f"ms alone, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"plain torch {r['plain_ms']:.4f} ms")
    # No single PyTorch call computes any of these functions (SHAKE-256,
    # the negacyclic NTT mod q, the bit-exact f64 encode, the op mixes),
    # so library_ms is null in every row.
    kernels = [{"name": r["name"], "route": r["route"], "source": r["source"],
                "replaces": r["replaces"],
                "launches": sum(c[r["counter"]] for c, _ in runs.values()),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "kernel_ms": r["kernel_ms"]} for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
