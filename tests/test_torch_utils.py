"""The port's utils against the JAX package's: the checkpoint journal
(a restart is bit-exact and equal to the JAX limb-scan encryptor, a
dropped DONE record is recovered, ok=False journals FAILED, lost inputs
raise, and the JAX journal reads the port's files), and the timers of
tests/test_utils_net.py."""

import json
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.ckks.limbwise import sym_encrypt_limbscan
from seal_embedded_tpu.config import Parms as JParms
from seal_embedded_tpu.utils import checkpoint as jckpt
from seal_embedded_tpu.utils import timing as jtiming
from seal_embedded_tpu_torch.ckks.limbwise import make_limbscan_encryptor
from seal_embedded_tpu_torch.config import PRIMES_27BIT, Parms
from seal_embedded_tpu_torch.convert import state_to_device
from seal_embedded_tpu_torch.utils import timing
from seal_embedded_tpu_torch.utils.checkpoint import (CheckpointJournal,
                                                      CheckpointedRunner)

torch.set_num_threads(2)

PARMS = Parms(64, PRIMES_27BIT[:2], 2.0 ** 20)
JPARMS = JParms(degree=64, moduli=PRIMES_27BIT[:2], scale=2.0 ** 20)


def _inputs(seed, B=3):
    n = PARMS.degree
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, n // 2)).astype(np.float32),
            (rng.integers(0, 3, n) - 1).astype(np.int32),
            rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32),
            rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))


def test_restart_is_bit_exact(tmp_path):
    fn = make_limbscan_encryptor(PARMS, device="cpu")
    raw = _inputs(0)
    values, sk, share, err = state_to_device(*raw, device="cpu")

    j1 = CheckpointJournal(str(tmp_path))
    r1 = CheckpointedRunner(j1, fn)
    sent = {}
    out0 = r1.run(0, values, sk, share, err,
                  on_output=lambda b, o: sent.setdefault(b, o["c0"]))
    assert out0 is not None and 0 in sent
    # Batch 1 "crashes" after begin (no done record written).
    j1.begin(1, {"values": values.numpy(), "share_words": share.numpy(),
                 "err_words": err.numpy()})
    assert j1.scan() == {0: "done", 1: "pending"}
    # The JAX journal reads the port's files.
    assert jckpt.CheckpointJournal(str(tmp_path)).scan() == j1.scan()

    # New process: resume re-runs exactly the pending batch, bit-identical,
    # and equal to the JAX encryptor on the same inputs.
    j2 = CheckpointJournal(str(tmp_path))
    outs = CheckpointedRunner(j2, fn).resume(sk)
    assert list(outs) == [1]
    assert torch.equal(outs[1]["c0"], out0["c0"])
    want = jax.jit(partial(sym_encrypt_limbscan, parms=JPARMS))(
        *(jnp.asarray(a) for a in raw))
    for k in ("c0", "c1", "pte"):
        assert np.array_equal(outs[1][k].numpy(),
                              np.asarray(want[k]).astype(np.int64)), k
    assert j2.scan() == {0: "done", 1: "done"}


def test_resume_reads_a_jax_journal(tmp_path):
    """Inputs journaled by the JAX runner (uint32 seed words) re-run on
    the port to the JAX runner's ciphertexts."""
    raw = _inputs(2)
    jfn = jax.jit(partial(sym_encrypt_limbscan, parms=JPARMS))
    jj = jckpt.CheckpointJournal(str(tmp_path))
    jj.begin(4, {"values": raw[0], "share_words": raw[2],
                 "err_words": raw[3]})
    want = jfn(*(jnp.asarray(a) for a in raw))
    sk = torch.as_tensor(raw[1].astype(np.int64))
    outs = CheckpointedRunner(CheckpointJournal(str(tmp_path)),
                              make_limbscan_encryptor(PARMS, device="cpu")
                              ).resume(sk)
    assert np.array_equal(outs[4]["c1"].numpy(),
                          np.asarray(want["c1"]).astype(np.int64))


def test_failed_batch_journals(tmp_path):
    def bad_fn(values, sk, share, err):
        return {"ok": torch.zeros((values.shape[0],), dtype=torch.bool)}

    j = CheckpointJournal(str(tmp_path))
    values, sk, share, err = state_to_device(*_inputs(1), device="cpu")
    assert CheckpointedRunner(j, bad_fn).run(7, values, sk, share,
                                             err) is None
    assert j.scan() == {7: "failed"}
    with open(tmp_path / "journal.jsonl") as f:
        rec = json.loads(f.readlines()[-1])
    assert rec["batch_id"] == 7 and rec["meta"]["reason"] == "ok flag false"


def test_pending_raises_on_lost_inputs(tmp_path):
    j = CheckpointJournal(str(tmp_path))
    values = _inputs(3)[0]
    j.begin(7, {"values": values})
    os.remove(tmp_path / "batch_7_inputs.npz")
    with pytest.raises(RuntimeError, match="missing or corrupt"):
        j.pending()
    j.begin(8, {"values": values})
    with open(tmp_path / "batch_8_inputs.npz", "wb") as f:
        f.write(b"PK\x03\x04truncated")
    with pytest.raises(RuntimeError, match="missing or corrupt"):
        j.pending()


def test_begin_writes_inputs_atomically(tmp_path):
    j = CheckpointJournal(str(tmp_path))
    values = torch.as_tensor(_inputs(4)[0])
    j.begin(9, {"values": values.numpy()})
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    data = dict(np.load(tmp_path / "batch_9_inputs.npz"))
    assert np.array_equal(data["values"], values.numpy())
    assert j.scan() == {9: "pending"}


def test_timer_accumulates_and_resets():
    for mod in (timing, jtiming):
        t = mod.Timer()
        t.start()
        time.sleep(0.01)
        t.stop()
        first = t.read_us()
        assert first >= 9_000
        t.start()
        t.stop()
        assert t.read_us() >= first
        t.reset()
        assert t.read_us() == 0.0
    with pytest.raises(RuntimeError):
        timing.Timer().stop()


def test_bench_stats_curr_avg_min_max():
    times = [0.002, 0.001, 0.004]
    s, js = timing.BenchStats(times), jtiming.BenchStats(times)
    assert s.curr == 0.004 and s.min == 0.001 and s.max == 0.004
    assert abs(s.avg - 0.007 / 3) < 1e-12
    assert s.summary_us() == js.summary_us()
    assert s.summary_us()["min"] == 1000.0


def test_bench_fn_runs_torch_fn():
    stats = timing.bench_fn(lambda x: (x * 2).sum(), torch.arange(128),
                            iters=3, warmup=1)
    assert len(stats.times_s) == 3 and stats.min > 0


def test_profile_trace_writes_chrome_trace(tmp_path):
    with timing.profile_trace(str(tmp_path / "trace")) as logdir:
        (torch.arange(1024) * 3).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_print_config_names_the_device():
    banner = timing.print_config(PARMS, {"batch": 4}, device="cpu")
    jbanner = jtiming.print_config(JPARMS, {"batch": 4})
    assert "device:            cpu" in banner
    # The JAX banner's parameter and extra lines.
    assert banner.splitlines()[1:7] == jbanner.splitlines()[1:7]
    assert banner.splitlines()[-1] == jbanner.splitlines()[-1]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            timing.print_config(PARMS)
