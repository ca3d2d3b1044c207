"""The port's compiled factories (graphs.py, the counterpart of jax.jit) on
their CPU path against the JAX package's jitted factories on the same
numpy inputs, bit for bit, at n = 1024, L = 1 and n = 4096, L = 3, B = 4;
and graphs.py's pure-Python parts: the signature, the LRU of entries, the
launch counters a replay adds and the outputs it hands over.  The capture
and replay themselves need the card (chip_smoke.py phase 8)."""

import os
import sys
import threading
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu import config as jcfg
from seal_embedded_tpu.ckks import asym as jasym
from seal_embedded_tpu.ckks import fast as jfast
from seal_embedded_tpu.ckks import limbwise as jlw
from seal_embedded_tpu.ckks import sym as jsym
from seal_embedded_tpu.io import serialize as jser
from seal_embedded_tpu.ops.encode import decode as jdecode
from seal_embedded_tpu_torch import graphs
from seal_embedded_tpu_torch.ckks import asym as tasym
from seal_embedded_tpu_torch.ckks import limbwise as tlw
from seal_embedded_tpu_torch.ckks import sym as tsym
from seal_embedded_tpu_torch.ckks.fast import make_fused_encryptor
from seal_embedded_tpu_torch.convert import (asym_state_to_device,
                                             parms_from_jax, pk_to_device,
                                             state_to_device)
from seal_embedded_tpu_torch.ops import modarith as tma
from seal_embedded_tpu_torch.ops.encode import make_decoder
from seal_embedded_tpu_torch.ops.kernels import counters

torch.set_num_threads(2)

B = 4
CONFIGS = [(1024, 1), (4096, 3)]
CPU = "cpu"
KEYS = ("c0", "c1", "pt", "pte", "ok")


def _parms(n, nprimes):
    return jcfg.default_parms(n, nprimes)


@lru_cache(maxsize=None)
def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, n // 2)).astype(np.float32),
            (rng.integers(0, 3, n) - 1).astype(np.int32),
            rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32),
            rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))


def _keys(P, seed):
    rng = np.random.default_rng(seed)
    return tuple(np.stack([rng.integers(0, q, P.degree) for q in P.moduli])
                 .astype(np.uint32) for _ in range(2))


def _equal(got, want, keys=KEYS):
    for k in keys:
        w = np.asarray(want[k])
        got_k = got[k].numpy()
        assert np.array_equal(got_k, w.astype(got_k.dtype)), k


def _jax(fn, *args):
    return {k: np.asarray(v) for k, v in fn(*map(jnp.asarray, args)).items()}


# ------------------------------------------------------------ factories

@pytest.mark.parametrize("n,nprimes", CONFIGS)
def test_fused_encryptor_vs_jax(n, nprimes):
    P = _parms(n, nprimes)
    args = _inputs(n, 1)
    want = _jax(jfast.make_fused_encryptor(P, "f64"), *args)
    fn = make_fused_encryptor(parms_from_jax(P), "f64", device=CPU)
    assert isinstance(fn, graphs.Graphed) and fn.device.type == "cpu"
    _equal(fn(*state_to_device(*args, device=CPU)), want)


@pytest.mark.parametrize("n,nprimes", CONFIGS)
@pytest.mark.parametrize("layout", ["reference", "parallel"])
@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_limbscan_encryptor_vs_jax(n, nprimes, layout, order):
    P = _parms(n, nprimes)
    args = _inputs(n, 2)
    want = _jax(jlw.make_limbscan_encryptor(P, layout, "f64", order), *args)
    fn = tlw.make_limbscan_encryptor(parms_from_jax(P), layout, "f64", order,
                                     device=CPU)
    if order == "forward":
        assert fn is tsym.make_sym_encryptor(parms_from_jax(P), layout, CPU)
    _equal(fn(*state_to_device(*args, device=CPU)), want)


@pytest.mark.parametrize("n,nprimes", CONFIGS)
def test_from_pte_encryptor_vs_jax(n, nprimes):
    P = _parms(n, nprimes)
    _, sk, share, _ = _inputs(n, 3)
    pte = np.random.default_rng(3).integers(-2 ** 40, 2 ** 40, (B, n))
    want = _jax(jlw.make_from_pte_encryptor(P, "reference"), pte, sk, share)
    got = tlw.make_from_pte_encryptor(parms_from_jax(P), "reference", CPU)(
        torch.as_tensor(pte), torch.as_tensor(sk.astype(np.int64)),
        torch.as_tensor(share.astype(np.int64)))
    _equal(got, want, ("c0", "c1", "pte", "ok"))


@pytest.mark.parametrize("n,nprimes", CONFIGS)
@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_c1_expander_vs_jax(n, nprimes, order):
    """The reference layout (the JAX parallel expander raises, ROADMAP
    R1; test_torch_limbwise.py holds the port's against the encryptor)."""
    P = _parms(n, nprimes)
    share = _inputs(n, 4)[2]
    want_c1, want_ok = jlw.make_c1_expander(P, "reference", order)(
        jnp.asarray(share))
    c1, ok = tlw.make_c1_expander(parms_from_jax(P), "reference", order,
                                  CPU)(torch.as_tensor(share.astype(np.int64)))
    assert np.array_equal(c1.numpy(), np.asarray(want_c1).astype(np.int64))
    assert np.array_equal(ok.numpy(), np.asarray(want_ok))


@pytest.mark.parametrize("n,nprimes", CONFIGS)
def test_asym_encryptor_keys_in_turn_vs_jax(n, nprimes):
    """One function for every key: two keys in turn, then a key tensor the
    caller changes in place between two calls, each equal to the JAX
    factory's output for the key given."""
    P = _parms(n, nprimes)
    values, _, _, seeds = _inputs(n, 5)
    key_a, key_b = _keys(P, 50), _keys(P, 51)
    jfn = jasym.make_asym_encryptor(P, "f64")
    want_a = _jax(jfn, values, *key_a, seeds)
    want_b = _jax(jfn, values, *key_b, seeds)
    fn = tasym.make_asym_encryptor(parms_from_jax(P), "f64", device=CPU)
    v, s = asym_state_to_device(values, seeds, device=CPU)
    _equal(fn(v, *key_a, s), want_a)
    _equal(fn(v, *key_b, s), want_b)
    t0, t1 = pk_to_device(*key_a, device=CPU)
    _equal(fn(v, t0, t1, s), want_a)
    for t, new in zip((t0, t1), pk_to_device(*key_b, device=CPU)):
        t.copy_(new)
    _equal(fn(v, t0, t1, s), want_b)


def test_set_key_matches_a_fresh_encryptor():
    P = parms_from_jax(_parms(1024, 1))
    key_a, key_b = _keys(P, 60), _keys(P, 61)
    enc = tasym.AsymEncryptor(P, *key_a, device=CPU)
    enc.set_key(*pk_to_device(*key_b, device=CPU))
    fresh = tasym.AsymEncryptor(P, *key_b, device=CPU)
    q = torch.tensor(P.moduli, dtype=torch.int64)[:, None]
    for name in ("pk0", "pk1", "pk0_quot", "pk1_quot"):
        assert torch.equal(getattr(enc, name), getattr(fresh, name)), name
    assert torch.equal(enc.pk1_quot, tma.shoup_quotient(enc.pk1, q))
    keyless = tasym.AsymEncryptor(P, device=CPU)
    assert not keyless.pk0.any()
    keyless.set_key(*key_b)                      # numpy uint32 too
    assert torch.equal(keyless.pk0_quot, fresh.pk0_quot)


@pytest.mark.parametrize("n,nprimes", CONFIGS)
@pytest.mark.parametrize("impl", ["canonical", "lazy"])
def test_decryptor_vs_jax(n, nprimes, impl):
    """The lazy INTT reads loaded fast tables for the first prime and
    computes the others' (the JAX factory jits only the canonical form)."""
    P = _parms(n, nprimes)
    values, sk, share, err = _inputs(n, 6)
    out = make_fused_encryptor(parms_from_jax(P), device=CPU)(
        *state_to_device(values, sk, share, err, device=CPU))
    q0 = int(P.moduli[0])
    pairs = jser.intt_fast_root_table(n, P.logn, q0, P.ntt_root(q0))
    loaded = {q0: (pairs[0::2], pairs[1::2])} if impl == "lazy" else None
    jfn = (jsym.make_decryptor(P) if impl == "canonical" else
           jax.jit(partial(jsym.decrypt_batch, parms=P, intt_impl=impl,
                           loaded_intt=loaded)))
    want = jfn(*(jnp.asarray(out[k].numpy().astype(np.uint32))
                 for k in ("c0", "c1")), jnp.asarray(sk))
    fn = tsym.make_decryptor(parms_from_jax(P), impl, loaded, CPU)
    assert fn is tsym.make_decryptor(parms_from_jax(P), impl, loaded, CPU)
    got = fn(out["c0"], out["c1"], torch.as_tensor(sk.astype(np.int64)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert all(torch.equal(g, out["pte"]) for g in got)


@pytest.mark.parametrize("n,nprimes", CONFIGS)
def test_decoder_vs_eager_jax(n, nprimes):
    """Bit for bit against the JAX decode run eagerly (its jitted form
    differs within 1e-9, ROADMAP.md §4)."""
    P = _parms(n, nprimes)
    pte = np.random.default_rng(7).integers(-2 ** 40, 2 ** 40, (B, n))
    want = np.asarray(jdecode(jnp.asarray(pte), P))
    got = make_decoder(parms_from_jax(P), CPU)(torch.as_tensor(pte))
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)


FACTORIES = {
    "make_fused_encryptor": lambda P, d: make_fused_encryptor(P, device=d),
    "make_limbscan_encryptor": lambda P, d: tlw.make_limbscan_encryptor(
        P, device=d),
    "make_from_pte_encryptor": lambda P, d: tlw.make_from_pte_encryptor(
        P, device=d),
    "make_c1_expander": lambda P, d: tlw.make_c1_expander(P, device=d),
    "make_sym_encryptor": lambda P, d: tsym.make_sym_encryptor(P, device=d),
    "make_asym_encryptor": lambda P, d: tasym.make_asym_encryptor(P,
                                                                  device=d),
    "make_decryptor": lambda P, d: tsym.make_decryptor(P, device=d),
    "make_decoder": lambda P, d: make_decoder(P, d),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_on_cuda_raises_without_a_card(name):
    """Asked for the card on a torch without CUDA, a factory raises: it
    never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    P = parms_from_jax(_parms(1024, 1))
    with pytest.raises((RuntimeError, AssertionError)):
        FACTORIES[name](P, "cuda")
    called = []
    with pytest.raises(RuntimeError):
        graphs.graphed(lambda *a: called.append(a), "cuda")
    assert not called


# ---------------------------------------------------- graphs.py, plain

def test_cpu_calls_run_the_function_as_it_is():
    seen = []

    def fn(x, k=1):
        seen.append(x)
        return {"y": x * k}

    g = graphs.graphed(fn, CPU)
    x = torch.arange(4)
    out = g(x, k=3)
    assert seen[0] is x and torch.equal(out["y"], x * 3)
    assert not g.entries


def test_signature_tells_shape_dtype_device_and_values_apart():
    sig = graphs.signature
    x = torch.zeros((2, 3), dtype=torch.int64)
    base = sig((x, 1), {"mode": "a"})
    assert sig((torch.ones((2, 3), dtype=torch.int64), 1),
               {"mode": "a"}) == base          # values do not count
    assert sig((x.t().contiguous().t(), 1), {"mode": "a"}) == base
    others = [sig((torch.zeros((3, 2), dtype=torch.int64), 1), {"mode": "a"}),
              sig((x.to(torch.int32), 1), {"mode": "a"}),
              sig((torch.zeros((2, 3), dtype=torch.int64, device="meta"), 1),
                  {"mode": "a"}),
              sig((x, 2), {"mode": "a"}),
              sig((x, 1.0), {"mode": "a"}),
              sig((x, True), {"mode": "a"}),
              sig((x, 1), {"mode": "b"}),
              sig((x, 1), {"mode": "a", "ok": None}),
              sig((x,), {"mode": "a"})]
    assert len({base, *others}) == len(others) + 1
    assert sig((x,), {"b": 1, "a": 2}) == sig((x,), {"a": 2, "b": 1})
    with pytest.raises(TypeError):
        sig((x, [1, 2]), {})


class _FakeGraph:
    """Stands in for a CUDAGraph: replay computes out = 2 * in into the
    static output, as a captured kernel would."""

    def __init__(self, inp, out):
        self.inp, self.out = inp, out

    def replay(self):
        torch.mul(self.inp, 2, out=self.out)


def _fake_entry(shape=(3,), launches=None):
    inp = torch.zeros(shape, dtype=torch.int64)
    out = torch.zeros(shape, dtype=torch.int64)
    launches = launches or dict.fromkeys(counters.COUNTERS, 0)
    return graphs.Entry([inp], _FakeGraph(inp, out), {"y": out, "n": 7},
                        launches)


class _Recording(graphs.Graphed):
    """A Graphed whose capture makes a fake entry and records the call."""

    def __init__(self, max_entries):
        super().__init__(lambda *a: None, CPU, max_entries)
        self.captured = []

    def capture(self, args, kwargs):
        self.captured.append(graphs.signature(args, kwargs))
        return _fake_entry(args[0].shape)


def test_entries_are_reused_per_signature_and_evicted_lru():
    g = _Recording(max_entries=2)

    def get(shape, *rest):
        args = (torch.zeros(shape, dtype=torch.int64), *rest)
        return g.entry(graphs.signature(args, {}), args, {})

    a = get((2,))
    assert get((2,)) is a
    b = get((3,))
    assert get((2,)) is a                  # a is now the most recent
    get((4,))                              # evicts b, the least recent
    assert len(g.entries) == 2 and len(g.captured) == 3
    assert get((2,)) is a
    assert get((3,)) is not b and len(g.captured) == 4
    get((2,), "other")
    assert len(g.captured) == 5 and len(g.entries) == 2


def test_replay_adds_the_captured_launches_and_hands_over_outputs():
    launches = dict.fromkeys(counters.COUNTERS, 0)
    launches.update(keccak=86, keccak_cbd=2, ntt_asym=1, encode=1)
    entry = _fake_entry(launches=launches)
    before = counters.read()
    try:
        first = entry.replay([torch.tensor([1, 2, 3])])
        assert counters.since(before) == launches
        second = entry.replay([torch.tensor([5, 6, 7])])
        assert counters.since(before) == {k: 2 * v
                                          for k, v in launches.items()}
    finally:
        counters.restore(before)
    assert first["n"] == 7
    assert torch.equal(first["y"], torch.tensor([2, 4, 6]))   # not overwritten
    assert torch.equal(second["y"], torch.tensor([10, 12, 14]))
    assert first["y"].data_ptr() != entry.outputs["y"].data_ptr()
    entry.scrub()
    assert not entry.inputs[0].any()


def test_replays_from_many_threads_keep_their_own_inputs():
    """The entry's lock keeps copy-in, replay and clone-out together: with
    more threads than cores and a short switch interval, every output is
    twice its own call's input."""
    entry = _fake_entry(shape=(64,))
    failures = []

    def worker(tag):
        for i in range(200):
            x = torch.full((64,), tag * 1000 + i, dtype=torch.int64)
            if not torch.equal(entry.replay([x])["y"], 2 * x):
                failures.append((tag, i))

    before = counters.read()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        counters.restore(before)
    assert not failures


def test_counters_map_round_trip():
    before = counters.read()
    try:
        counters.reset()
        assert set(counters.read().values()) == {0}
        counters.add(dict.fromkeys(counters.COUNTERS, 3))
        assert counters.since(dict.fromkeys(counters.COUNTERS, 1)) == \
            dict.fromkeys(counters.COUNTERS, 2)
    finally:
        counters.restore(before)
    assert counters.read() == before
