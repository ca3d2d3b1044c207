"""The end-to-end arithmetic on made-up call times, and each roofline
count against a value worked by hand at n = 4096, three primes, B = 1024."""

import math

import pytest

from benchmark import harness, peaks, stats
from benchmark.catalog import Catalog

H100_SM_HZ = 132 * 1980e6       # 132 SMs at 1,980 MHz


def calls(ms_list, messages=1024, wait=1.0):
    out, t = [], 0.0
    for ms in ms_list:
        out.append(harness.Call(t, t + ms / 1e3, wait, messages))
        t += ms / 1e3 + 0.0005        # the caller's own 0.5 ms between calls
    return out


def test_rate_is_all_the_work_over_all_the_window():
    cs = calls([10.0] * 99 + [50.0])
    window = cs[-1].end - cs[0].start
    done = sum(c.messages for c in cs)
    assert stats.rate(done, window) == pytest.approx(
        100 * 1024 / (1.040 + 99 * 0.0005))


def test_p95_is_over_all_calls_linear_between_ranks():
    ms = [float(i) for i in range(1, 101)]          # 1 .. 100 ms
    assert stats.percentile(ms, 95) == pytest.approx(95.05)
    assert stats.percentile(ms, 50) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95) == 7.0
    # numpy's default: index 0.95 * 99 = 94.05 between 95 and 96.
    ms = [10.0] * 90 + [20.0] * 10
    assert stats.percentile(ms, 95) == pytest.approx(20.0)
    assert stats.percentile([10.0] * 95 + [20.0] * 5, 95) == \
        pytest.approx(10.5)


def test_host_ms_is_the_call_less_its_waits():
    c = Catalog()
    obs = harness.Observation(c.cell("n4096.sym.b16"), None,
                              c.traffic("sym.b16"), calls([4.0, 6.0],
                                                          wait=1.5),
                              0.0105, 0, 0, {})
    assert c.reader("host_ms.small").read(obs) == pytest.approx(3.5)
    assert c.reader("limb_wait_ms").read(obs) == pytest.approx(1.5)


def test_keccak_count_sym_4096_3():
    k = Catalog().reader("keccak_roofline")
    moduli = (1053818881, 1054015489, 1054212097)
    # Words at or above max_multiple, per prime: 2^32 - (0xFFFFFFFF -
    # (0xFFFFFFFF mod q) - 1); q = 1053818881: 4q = 4,215,275,524, so
    # 79,691,773.
    assert [2 ** 32 * k.rejected(q) for q in moduli] == \
        [79691773, 78905341, 78118909]
    redraws = 4096 * sum(r / (2 ** 32 - r)
                         for r in (79691773, 78905341, 78118909))
    # per message: CBD 256 fills, 121 base blocks a prime, the redraws
    want = 1024 * (256 + 3 * 121 + redraws)
    assert k.permutations(4096, moduli, 1024, "sym") == pytest.approx(want)
    assert want == pytest.approx(869350.69, abs=0.01)
    assert k.nbytes(4096, 3, 1024, "sym") == 1024 * (128 + 49152 + 4096)
    # 869,350.69 x 4,152 instructions at 16.727 Tinstr/s: 0.2158 ms
    assert k.bound_s(4096, moduli, 1024, "sym", H100_SM_HZ) == \
        pytest.approx(want * 4152 / (64 * H100_SM_HZ))


def test_keccak_count_asym_4096_3():
    k = Catalog().reader("keccak_roofline")
    # 43 ternary blocks, 4096 x 2/254 expected byte redraws, 2 x 256 fills
    want = 1024 * (43 + 4096 * 2 / 254 + 512)
    assert k.permutations(4096, (1053818881,) * 3, 1024, "asym") == \
        pytest.approx(want)
    assert want == pytest.approx(601346.02, abs=0.01)
    assert k.nbytes(4096, 3, 1024, "asym") == 1024 * (64 + 3 * 4096)


def test_ntt_count_sym_4096_3():
    t = Catalog().reader("ntt_roofline")
    # ntt(pte) for 1024 messages and ntt(s), 3 primes, 2048 x 12 each
    assert t.butterflies(4096, 3, 1024, "sym") == 75_571_200
    # pte int64, a and c0 u32 on 3 primes; s and ntt(s)
    assert t.nbytes(4096, 3, 1024, "sym") == 134_270_976
    # bound by its bytes: 134,270,976 / 3.35e12 s = 0.04008 ms
    assert t.bound_s(4096, 3, 1024, "sym", H100_SM_HZ) == \
        pytest.approx(134_270_976 / 3.35e12)
    assert 75_571_200 * 4 / peaks.int_rate(H100_SM_HZ) < 134_270_976 / 3.35e12


def test_ntt_count_asym_4096_3():
    t = Catalog().reader("ntt_roofline")
    # ntt(u), ntt(e1), ntt(pte): 3 x 3 x 1024 x 24,576, as KA's 226.5 M
    assert t.butterflies(4096, 3, 1024, "asym") == 226_492_416
    # pte 8 bytes, u and e1 one each, c0 and c1 u32 on 3 primes; pk
    assert t.nbytes(4096, 3, 1024, "asym") == 142_704_640
    assert t.bound_s(4096, 3, 1024, "asym", H100_SM_HZ) == pytest.approx(
        max(226_492_416 * 4 / (64 * H100_SM_HZ), 142_704_640 / 3.35e12))


def test_a_share_of_a_roofline_is_bound_over_time():
    """keccak_roofline reads bound x calls / the keccak kernels' time, and
    nothing where the trace holds no such kernel."""
    from benchmark import trace
    c = Catalog()
    k = c.reader("keccak_roofline")
    moduli = (1053818881, 1054015489, 1054212097)
    bound = k.bound_s(4096, moduli, 1024, "sym", H100_SM_HZ)
    seg = trace.Segment([(0.0, 1000.0, "void (anonymous namespace)::"
                          "keccak_lanes_kernel(long long const*)"),
                         (1000.0, 1400.0, "Memcpy DtoH (Device -> Pinned)")],
                        2000.0, 2)
    from benchmark.reference.params import from_config
    obs = harness.Observation(c.cell("n4096.sym.b1024"),
                              from_config(c.config("seal-default-n4096")),
                              c.traffic("sym.b1024"), [], 1.0, 0, 0,
                              {"sm_hz": H100_SM_HZ}, seg)
    assert k.read(obs) == pytest.approx(100 * bound * 2 / 1e-3)
    assert c.reader("idle_share").read(obs) == pytest.approx(30.0)
    assert c.reader("ntt_roofline").read(obs) is None
    assert math.isclose(c.reader("torch_ops_ms").read(obs), 0.0)


def test_a_window_times_the_entry_alone():
    """Each call's time runs from the entry to its return: the seed lists
    are made before the window (Traffic.prepare), a call past those made
    is counted and its seeds made before its clock starts, and the last
    call's outputs are released before the next call."""
    import time
    import weakref

    import numpy as np

    from benchmark.reference.params import from_config
    from benchmark.traffic import Sample, Traffic

    c = Catalog()
    params = from_config(c.config("seal-default-n4096"))
    traffic = Traffic(params.degree, dict(c.traffic("sym.b16"), batch=2), 9)
    make = traffic._make

    def slow_make(k):
        time.sleep(0.02)
        return make(k)
    traffic._make = slow_make

    class Limbs(list):
        pass
    last = [lambda: None]

    def encrypt(ctx, values, share_seeds, err_seeds, order):
        assert last[0]() is None, "the last call's outputs are still held"
        time.sleep(0.002)
        z = np.zeros((2, params.degree), np.uint32)
        out = Limbs({"prime_idx": j, "q": q, "ok": True, "c0": z, "c1": z,
                     "wait_ms": 0.5} for j, q in enumerate(params.moduli))
        last[0] = weakref.ref(out)
        return out

    cell = object.__new__(harness.Cell)
    cell.params, cell.traffic, cell.ctx, cell.calls = params, traffic, None, 0
    cell._encrypt = encrypt
    cell.prepare(0.1, 0.002)
    assert traffic.prepared >= 8 + 75
    win = cell.window(0.1, Sample(2, traffic.sample_rng))
    assert win.unprepared == 0 and win.walk_errors == 0 and not win.errors
    assert max(x.ms for x in win.calls) < 15
    traffic.prepare(0)
    cell.calls = traffic.prepared
    win = cell.window(0.1, Sample(2, traffic.sample_rng))
    assert win.unprepared == len(win.calls) > 0
    assert max(x.ms for x in win.calls) < 15
