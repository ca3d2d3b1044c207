"""The port's scale-out layer on 8 gloo CPU ranks against the JAX
package's on conftest's 8-device virtual CPU mesh, bit for bit, at
tests/test_parallel.py's sizes: the limb-sharded sym and asym encryptors
on a 4x2 (data, limb) mesh, sym_encrypt_sharded, the multi-host encryptor
on (2, 2, 2) through collect_to_host, and the coefficient-sharded NTT in
both plans, with the collectives pinned on the port's own counter.

The 8 ranks are spawned once for the module (each runs every scenario of
seal_embedded_tpu_torch.parallel.dryrun.rank_body and asserts that it
never imported jax) while this process computes the JAX side: the JAX
parallel/ functions on meshes of the virtual devices (the NTT's on the
first D of them).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.config import Parms as JParms
from seal_embedded_tpu.parallel.coeff_ntt import (
    ntt_coeff_sharded as jax_coeff_ntt)
from seal_embedded_tpu.parallel import multihost as jmh
from seal_embedded_tpu.parallel.limbwise import (
    make_asym_limb_sharded_encryptor as jax_asym_sharded,
    make_limb_sharded_encryptor as jax_sym_sharded)
from seal_embedded_tpu.parallel.mesh import make_mesh as jax_mesh
from seal_embedded_tpu.parallel.mesh import sym_encrypt_sharded as jax_ses
from seal_embedded_tpu_torch.ckks.asym import gen_pk_batch
from seal_embedded_tpu_torch.config import PRIMES_27BIT, Parms
from seal_embedded_tpu_torch.parallel import dryrun, launch
from seal_embedded_tpu_torch.parallel import multihost as tmh

torch.set_num_threads(2)

WORLD = 8
Q27 = PRIMES_27BIT[0]
P512 = Parms(512, PRIMES_27BIT[:2], 2.0 ** 20)
P64 = Parms(64, PRIMES_27BIT[:2], 2.0 ** 20)
NTT_CASES = [(256, 8), (512, 4), (64, 8), (4096, 8)]
KEYS = ("c0", "c1", "pte", "pt", "ok")


def _asym_pk(parms, seed):
    """pk from sk, a shareable seed and ep drawn as test_parallel.py's
    asym test draws them (the port's gen_pk_batch is bit-equal to the
    JAX one, tests/test_torch_asym.py)."""
    n = parms.degree
    rng = np.random.default_rng(seed)
    sk = torch.as_tensor(rng.integers(0, 3, n) - 1)
    ep = torch.as_tensor(rng.integers(-20, 21, n))
    pkseed = torch.as_tensor(rng.integers(0, 2 ** 32, (1, 16)))
    return tuple(t.numpy() for t in gen_pk_batch(sk, pkseed, ep, parms))


def _scenarios():
    out = {
        "sym": {"kind": "sym", "mesh": (4, 2), "parms": P512, "B": 8,
                "seed": 0},
        "asym": {"kind": "asym", "mesh": (4, 2), "parms": P512, "B": 8,
                 "seed": 8, "pk": _asym_pk(P512, 7)},
        "sym_sharded": {"kind": "sym_sharded", "mesh": (4, 2),
                        "parms": P64, "B": 8, "seed": 0},
        "multihost": {"kind": "multihost", "mesh": (2, 2, 2),
                      "parms": P512, "B": 8, "seed": 11},
    }
    for n, D in NTT_CASES:
        for variant in ("staged", "4step"):
            out[f"ntt {n} {D} {variant}"] = {
                "kind": "ntt", "variant": variant, "q": Q27,
                "mesh": (D, WORLD // D), "axis": "data",
                "x": dryrun.ntt_input(n, Q27, 3, n)}
    return out


SCENARIOS = _scenarios()


def _jax_side(name, spec):
    """The JAX package's outputs of a scenario, as numpy."""
    if spec["kind"] == "ntt":
        D = spec["mesh"][0]
        mesh = jax_mesh(n_data=D, n_limb=1, devices=jax.devices()[:D])
        x = jnp.asarray(spec["x"].astype(np.uint32))
        return {"y": np.asarray(jax_coeff_ntt(mesh, x.shape[-1], spec["q"],
                                              "data", spec["variant"])(x))}
    p = spec["parms"]
    jp = JParms(degree=p.degree, moduli=p.moduli, scale=p.scale)
    values, sk, share, err = (jnp.asarray(a) for a in dryrun.rand_inputs(
        p, spec["B"], spec["seed"]))
    if spec["kind"] == "sym":
        out = jax_sym_sharded(jax_mesh(n_data=4, n_limb=2), jp)(
            values, sk, share, err)
    elif spec["kind"] == "asym":
        pk0, pk1 = (jnp.asarray(k.astype(np.uint32)) for k in spec["pk"])
        out = jax_asym_sharded(jax_mesh(n_data=4, n_limb=2), jp)(
            values, pk0, pk1, share)
    elif spec["kind"] == "sym_sharded":
        mesh = jax_mesh(n_data=4, n_limb=2)
        with mesh:
            out = jax_ses(mesh, jp)(values, sk, share, err)
    else:
        mesh = jmh.make_host_mesh(n_limb=2, n_hosts=2)
        return jmh.collect_to_host(jmh.make_multihost_encryptor(mesh, jp)(
            *jmh.shard_inputs(mesh, values, sk, share, err)))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    """(the port's global arrays, its collectives per rank, the JAX
    outputs) of every scenario; the ranks run while JAX computes."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, WORLD, dryrun.rank_body,
                            (SCENARIOS,), "cpu", 300)
        want = {name: _jax_side(name, spec)
                for name, spec in SCENARIOS.items()}
        parts = ranks.result()
    got = {name: dryrun.assemble([r[name]["out"] for r in parts],
                                 dryrun.output_shapes(spec))
           for name, spec in SCENARIOS.items()}
    comms = {name: [r[name]["comm"] for r in parts] for name in SCENARIOS}
    return got, comms, want


def _same(got, want):
    return np.array_equal(got, np.asarray(want).astype(got.dtype))


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("name", ["sym", "asym", "sym_sharded",
                                  "multihost"])
def test_sharded_encryptors_match_jax(runs, name, key):
    """Limb-sharded sym and asym (4x2), sym_encrypt_sharded (4x2, n=64)
    and the (2, 2, 2) multi-host encryptor through collect_to_host."""
    got, _, want = runs
    if key == "ok":
        assert got[name]["ok"].all()
    assert _same(got[name][key], want[name][key]), (name, key)


@pytest.mark.parametrize("variant", ["staged", "4step"])
@pytest.mark.parametrize("n,D", NTT_CASES)
def test_coeff_sharded_ntt_matches_jax(runs, n, D, variant):
    got, _, want = runs
    name = f"ntt {n} {D} {variant}"
    assert _same(got[name]["y"], want[name]["y"])


def test_init_distributed_noop_single_process():
    assert tmh.init_distributed() is False
    assert tmh.init_distributed(num_processes=1) is False
    assert tmh.init_distributed(num_processes=1, device_type="cpu") is False


@pytest.mark.parametrize("variant,kind,calls", [
    # 4step: exactly two all-to-alls, each of one shard per rank; staged:
    # exactly log2(D) exchanges of one shard each.  Nothing else.
    ("4step", "all_to_all", 2), ("staged", "exchange", 3)])
def test_coeff_ntt_collectives(runs, variant, kind, calls):
    _, comms, _ = runs
    spec = SCENARIOS[f"ntt 4096 8 {variant}"]
    shard_bytes = spec["x"].shape[0] * (4096 // 8) * 4   # int32 on the wire
    for c in comms[f"ntt 4096 8 {variant}"]:
        assert c == {kind: [calls, calls * shard_bytes]}, c


@pytest.mark.parametrize("name", ["sym", "multihost"])
def test_sym_pipeline_collectives(runs, name):
    """The limb pipeline's only collectives: one all-gather over the limb
    group of the data block's rows (pte, the 16 share words and the
    encode flag, int64) and the ok reduce (one byte a row), within 5% of
    that; no exchange or all-to-all, never ciphertext-sized data."""
    _, comms, _ = runs
    spec = SCENARIOS[name]
    mesh = spec["mesh"]
    rows = spec["B"] // int(np.prod(mesh[:-1]))
    analytic = rows * (spec["parms"].degree + 17) * 8 + rows
    for c in comms[name]:
        assert set(c) == {"all_gather", "all_reduce"}, c
        assert c["all_gather"][0] == 1 and c["all_reduce"][0] == 1, c
        total = c["all_gather"][1] + c["all_reduce"][1]
        assert abs(total - analytic) <= 0.05 * analytic, (c, analytic)


def test_asym_pipeline_collectives(runs):
    """Asym: one all-gather of u, e1, pte and the flag, nothing else."""
    _, comms, _ = runs
    spec = SCENARIOS["asym"]
    rows = spec["B"] // spec["mesh"][0]
    for c in comms["asym"]:
        assert c == {"all_gather": [1, rows * (3 * 512 + 1) * 8]}, c
