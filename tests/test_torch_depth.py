"""The port at the JAX package's tracked depths, on its CPU path:
chip_smoke.py's depth_inputs (phase 9's batches, the golden rows at both
ends), sym and asym at n=8192/L=6 with B=16 against the JAX fused
functions and the C-reference golden files at both ends, and row
independence at n=4096/L=3.  Phase 9 runs the same checks at full batch
(up to B=10240) on the card.  Also the profiler helpers that phase 9's
measurements repaired (perf_stages.py)."""

import pathlib
import sys
import weakref
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks.asym import asym_encrypt_fused as jax_asym
from seal_embedded_tpu.ckks.fast import sym_encrypt_fused as jax_sym
from seal_embedded_tpu_torch import config as tcfg
from seal_embedded_tpu_torch.ckks.asym import AsymEncryptor
from seal_embedded_tpu_torch.ckks.fast import SymEncryptor
from seal_embedded_tpu_torch.convert import (asym_state_to_device,
                                             pk_to_device, state_to_device)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import perf_stages  # noqa: E402

torch.set_num_threads(2)

B = 16
G = 6       # golden rows in every golden file used here
CPU = "cpu"


def _jax(fn, parms, *arrays):
    out = jax.jit(partial(fn, parms=parms, encode_mode="f64"))(
        *(jnp.asarray(a) for a in arrays))
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_equal_to_jax(got, want):
    assert bool(want["ok"].all())
    for k in ("c0", "c1", "pt", "pte", "ok"):
        assert np.array_equal(got[k].numpy(),
                              want[k].astype(got[k].numpy().dtype)), k


def _assert_golden_at_both_ends(out, gold):
    batch = out["pte"].shape[0]
    assert bool(out["ok"].all())
    for at in (0, batch - G):
        for t in range(G):
            for k in ("pt", "pte"):
                assert np.array_equal(out[k][at + t].numpy(),
                                      gold[k][t]), (at, t, k)
            for k in ("c0", "c1"):
                assert np.array_equal(out[k][:, at + t].numpy(),
                                      gold[k][:, t]), (at, t, k)


def test_depth_inputs_golden_at_both_ends():
    gold = chip_smoke.load_golden("sym", 4096, 3)
    values, share, err = chip_smoke.depth_inputs(gold, 20, seed=3)
    assert values.shape == (20, 2048) and values.dtype == np.float32
    assert share.shape == err.shape == (20, 16)
    assert share.dtype == err.dtype == np.uint32
    gshare, gerr = chip_smoke.golden_seeds(G)
    for rows in (slice(0, G), slice(20 - G, 20)):
        assert np.array_equal(values[rows], gold["v"])
        assert np.array_equal(share[rows], gshare)
        assert np.array_equal(err[rows], gerr)
    again = chip_smoke.depth_inputs(gold, 20, seed=3)
    other = chip_smoke.depth_inputs(gold, 20, seed=4)
    for a, b, c in zip((values, share, err), again, other):
        assert np.array_equal(a, b)
        assert not np.array_equal(a[G:20 - G], c[G:20 - G])
    values, _, _ = chip_smoke.depth_inputs(gold, 2 * G)
    assert np.array_equal(values[:G], values[G:])
    with pytest.raises(ValueError):
        chip_smoke.depth_inputs(gold, 2 * G - 1)


def test_middle_rows_leave_out_the_golden_blocks():
    rows = chip_smoke.middle_rows(1024, G, 9)
    assert len(rows) == len(set(rows.tolist())) == chip_smoke.DEPTH_INDEP_B
    assert np.array_equal(rows, np.sort(rows))
    assert rows.min() >= G and rows.max() < 1024 - G
    assert np.array_equal(rows, chip_smoke.middle_rows(1024, G, 9))


@pytest.fixture(scope="module")
def sym_8192_6():
    gold = chip_smoke.load_golden("sym", 8192, 6)
    values, share, err = chip_smoke.depth_inputs(gold, B)
    got = SymEncryptor(tcfg.default_parms(8192, 6), CPU)(
        *state_to_device(values, gold["sk"], share, err, CPU))
    return gold, (values, gold["sk"], share, err), got


def test_sym_8192_6_golden_at_both_ends(sym_8192_6):
    gold, _, got = sym_8192_6
    _assert_golden_at_both_ends(got, gold)
    chip_smoke.check_golden_ends(got, gold, "sym 8192/6")
    bent = dict(got, c1=got["c1"].clone())
    bent["c1"][5, B - 1, 7] ^= 1
    with pytest.raises(AssertionError, match="rows 10..15"):
        chip_smoke.check_golden_ends(bent, gold, "sym 8192/6")


def test_sym_8192_6_vs_jax(sym_8192_6):
    _, inputs, got = sym_8192_6
    _assert_equal_to_jax(got, _jax(jax_sym, jcfg.default_parms(8192, 6),
                                   *inputs))


@pytest.fixture(scope="module")
def asym_8192_6():
    gold = chip_smoke.load_golden("asym", 8192, 6)
    parms = tcfg.default_parms(8192, 6)
    pk = chip_smoke.golden_pk(gold, parms, torch.device(CPU))
    values, _, seeds = chip_smoke.depth_inputs(gold, B)
    got = AsymEncryptor(parms, *pk, CPU)(
        *asym_state_to_device(values, seeds, CPU))
    return gold, pk, (values, seeds), got


def test_asym_8192_6_golden_at_both_ends(asym_8192_6):
    gold, pk, _, got = asym_8192_6
    chip_smoke.check_pk(pk, gold, "asym 8192/6")
    _assert_golden_at_both_ends(got, gold)


def test_asym_8192_6_vs_jax(asym_8192_6):
    gold, _, (values, seeds), got = asym_8192_6
    _assert_equal_to_jax(got, _jax(jax_asym, jcfg.default_parms(8192, 6),
                                   values, gold["pk0"], gold["pk1"], seeds))


@pytest.mark.parametrize("kind", ["sym", "asym"])
def test_row_independence_4096_3(kind):
    """Eight middle rows of a B = 32 batch, run as a B = 8 batch, give the
    large batch's rows bit for bit; the large batch equals the JAX one."""
    gold = chip_smoke.load_golden(kind, 4096, 3)
    values, share, err = chip_smoke.depth_inputs(gold, 32)
    jparms = jcfg.default_parms(4096, 3)
    parms = tcfg.default_parms(4096, 3)
    if kind == "sym":
        run = SymEncryptor(parms, CPU)
        args = state_to_device(values, gold["sk"], share, err, CPU)
        per_row = (0, 2, 3)
        want = _jax(jax_sym, jparms, values, gold["sk"], share, err)
    else:
        run = AsymEncryptor(parms, *pk_to_device(gold["pk0"], gold["pk1"],
                                                 CPU), CPU)
        args = asym_state_to_device(values, err, CPU)
        per_row = (0, 1)
        want = _jax(jax_asym, jparms, values, gold["pk0"], gold["pk1"], err)
    out = run(*args)
    _assert_equal_to_jax(out, want)
    _assert_golden_at_both_ends(out, gold)
    rows = torch.as_tensor(chip_smoke.middle_rows(32, G, 5))
    small = run(*(a[rows] if i in per_row else a
                  for i, a in enumerate(args)))
    for k, v in out.items():
        want_rows = v[:, rows] if k in ("c0", "c1") else v[rows]
        assert torch.equal(small[k], want_rows), k
    chip_smoke.check_rows_of(small, out, rows, kind)
    small["c0"][1, 3, 5] += 1
    with pytest.raises(AssertionError, match="c0"):
        chip_smoke.check_rows_of(small, out, rows, kind)


def test_parted_survives_a_lost_marker():
    """perf_stages.parted: the events between marker kernels, whether the
    trace kept the lead marker or lost it; a lost middle marker merges two
    groups (port_kernels then takes the trace again)."""
    def ev(name, t):
        return (t, t + 1.0, name)
    mark = "void spin_kernel(long)"
    a, b, c = ev("keccak_a", 2), ev("ntt_b", 4), ev("encode_c", 6)
    whole = [ev(mark, 0), ev(mark, 1), a, ev(mark, 3), b, ev(mark, 5), c,
             ev(mark, 7)]
    assert perf_stages.parted(whole) == [[a], [b], [c]]
    assert perf_stages.parted(whole[1:]) == [[a], [b], [c]]
    assert perf_stages.parted(whole[:-1]) == [[a], [b], [c]]
    assert perf_stages.parted(whole[:3] + whole[4:]) == [[a, b], [c]]


def test_port_kernels_retraces_a_trace_that_lost_events(monkeypatch):
    """A trace that lost one of a fn's kernel launches, or a marker, is
    taken again; the first whole one is returned, port kernels only,
    without the decoy stretch (the first fn's calls before the fns), which
    may lose events."""
    mark = (0.0, 0.0, "void spin_kernel(long)")
    k0, k1 = (1.0, 2.0, "keccak_x"), (3.0, 4.0, "ntt_kernel")
    other = (5.0, 6.0, "elementwise_kernel")
    decoy = [mark, mark, k0, mark]
    whole = decoy + [k0, k0, other, mark, k1, k1, mark]
    lost_launch = decoy + [k0, k0, mark, k1, mark]
    lost_marker = decoy + [k0, k0, k1, k1, mark]
    traces = [lost_launch, lost_marker, whole]
    monkeypatch.setattr(perf_stages, "trace",
                        lambda run, cpu=True: (run(), traces.pop(0))[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    fns = [lambda: None, lambda: None]
    assert perf_stages.port_kernels(fns, 2) == [[k0, k0], [k1, k1]]
    assert not traces
    traces[:] = [lost_launch] * perf_stages.MARKED_TRACES
    with pytest.raises(RuntimeError, match="multiple of 2"):
        perf_stages.port_kernels(fns, 2)


def test_timeline_drops_each_output(monkeypatch):
    """timeline holds one traced call's output at a time (five batches at
    n = 16384, L = 13, B = 1024 would hold 18 GB)."""
    refs, alive = [], []

    def fn():
        alive.append(sum(r() is not None for r in refs))
        out = torch.zeros(4)
        refs.append(weakref.ref(out))
        return out

    def fake_trace(run, cpu=True):
        run()
        return [(0.0, 2.0, "ntt_kernel"), (1.0, 3.0, "keccak_x")]

    monkeypatch.setattr(perf_stages, "trace", fake_trace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    got = perf_stages.timeline(fn)
    assert len(refs) == 1 + perf_stages.PROFILED_BATCHES
    assert max(alive) == 0
    assert got["busy_ms"] == pytest.approx(3e-3 / perf_stages.PROFILED_BATCHES)


def test_port_kernels_kinds_none_keeps_every_kernel(monkeypatch):
    """With kinds None a fn's group holds every device event between its
    markers (the rank-select's torch passes), not the port's kernels only;
    kernel_alone_ms sums them per call."""
    mark = (0.0, 0.0, "void spin_kernel(long)")
    k0, k1 = (1.0, 2.0, "keccak_x"), (3.0, 5.0, "ntt_kernel")
    other = (2.0, 4.0, "elementwise_kernel")
    trace = [mark, mark, k0, mark, k0, other, mark, k1, mark]
    monkeypatch.setattr(perf_stages, "trace", lambda run, cpu=True: trace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    fns = [lambda: None, lambda: None]
    assert perf_stages.port_kernels(fns, 1, None) == [[k0, other], [k1]]
    assert perf_stages.port_kernels(fns, 1) == [[k0], [k1]]
    assert perf_stages.kernel_alone_ms(fns, 1, None) == [3e-3, 2e-3]
