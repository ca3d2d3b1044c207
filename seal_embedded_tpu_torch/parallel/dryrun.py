"""Multi-rank dry run of the scale-out paths on CPU processes.

    python -m seal_embedded_tpu_torch.parallel.dryrun 8   # 8 gloo ranks

The counterpart of ``__graft_entry__.py dryrun 8``, with its scenarios:
limb-sharded sym at n = 4096; limb-sharded asym at n = 512 (27-bit
chain); deep-chain limb-sharded sym at n = 8192, L = 6; the
coefficient-sharded NTT at n = 4096 and 16384 in both communication
plans; and the multi-host encryptor on a (2, world/4, 2) mesh.  Each
scenario's blocks are gathered in this process and held bit-equal to the
single-device path (LimbscanEncryptor "parallel", AsymEncryptor,
ops.ntt.ntt_limbs).  Exits non-zero on any failure.

``rank_body`` is what every rank runs, here and in the tests: it builds
the meshes and inputs a scenario names, runs it, and returns its blocks
(``multihost.collect_to_host``) and its collectives (``comm.counts``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ckks.asym import AsymEncryptor, gen_pk_batch
from ..ckks.limbwise import LimbscanEncryptor
from ..config import PRIMES_27BIT, Parms, default_parms
from ..convert import asym_state_to_device, pk_to_device, state_to_device
from ..ops import ntt as ntt_ops
from . import comm, launch
from . import multihost as mh
from .coeff_ntt import ntt_coeff_sharded
from .limbwise import (make_asym_limb_sharded_encryptor,
                       make_limb_sharded_encryptor)
from .mesh import (Shards, block, mesh_device, new_mesh, shard_batch,
                   sym_encrypt_sharded)


def rand_inputs(parms: Parms, B: int, seed: int):
    """numpy (values f32 (B, n/2), sk int32 (n,), share, err uint32
    (B, 16)) from default_rng(seed), drawn in that order."""
    n = parms.degree
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, n // 2)).astype(np.float32),
            (rng.integers(0, 3, n) - 1).astype(np.int32),
            rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32),
            rng.integers(0, 2 ** 32, (B, 16)).astype(np.uint32))


def ntt_input(n: int, q: int, rows: int, seed: int) -> np.ndarray:
    """int64 (rows, n) values in [0, q) from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, q, (rows, n)).astype(np.int64)


_NAMES = {2: ("data", "limb"), 3: ("host", "data", "limb")}


def _run(spec: dict, meshes: dict) -> Shards:
    shape = spec["mesh"]
    if shape not in meshes:
        meshes[shape] = new_mesh(shape, _NAMES[len(shape)],
                                 comm.group_device_type())
    mesh = meshes[shape]
    dev = mesh_device(mesh)
    kind, parms = spec["kind"], spec.get("parms")
    if kind == "ntt":
        x = torch.as_tensor(spec["x"], device=dev)
        axis = spec.get("axis", "data")
        d, D = mesh.get_local_rank(axis), mesh.size(
            mesh.mesh_dim_names.index(axis))
        cols = block(d, x.shape[-1] // D)
        fn = ntt_coeff_sharded(mesh, x.shape[-1], spec["q"], axis,
                               spec["variant"])
        return Shards({"y": fn(x[:, cols].contiguous())},
                      {"y": (slice(None), cols)})
    values, sk, share, err = state_to_device(
        *rand_inputs(parms, spec["B"], spec["seed"]), dev)
    if kind == "asym":
        pk = pk_to_device(*spec["pk"], dev)
        values, _, seeds, _ = mh.shard_inputs(mesh, values, sk, share, err)
        return make_asym_limb_sharded_encryptor(mesh, parms)(values, *pk,
                                                             seeds)
    if kind == "sym_sharded":
        values, share, err = shard_batch(mesh, values, share, err)
        return sym_encrypt_sharded(mesh, parms)(values, sk, share, err)
    args = mh.shard_inputs(mesh, values, sk, share, err)
    if kind == "multihost":
        return mh.make_multihost_encryptor(mesh, parms)(*args)
    return make_limb_sharded_encryptor(mesh, parms)(*args)


def rank_body(rank: int, world: int, scenarios: dict) -> dict:
    """Run every scenario of {name: spec} in order, on every rank, on the
    device of the joined group (the card under NCCL, the CPU under gloo:
    ``launch.spawn``'s device_type decides).  A
    spec names its kind ("sym", "asym", "sym_sharded", "multihost",
    "ntt"), its mesh shape (2 axes: data, limb; 3: host, data, limb), and
    parms, B and seed (inputs from rand_inputs; asym also pk, a numpy
    (pk0, pk1)) or q, variant, the whole input x and the mesh axis.
    Returns {name: {"out": collect_to_host's, "comm": comm.counts}}."""
    meshes = {}
    results = {}
    for name, spec in scenarios.items():
        comm.counts = {}
        out = _run(spec, meshes)
        results[name] = {"out": mh.collect_to_host(out),
                         "comm": dict(comm.counts)}
    return results


def assemble(parts: list, shapes: dict) -> dict:
    """The global arrays {key: shape} from every rank's collect_to_host
    output; a block that two ranks hold must agree, and every element
    must be filled."""
    whole = {}
    for key, shape in shapes.items():
        first = parts[0][key][0][1]
        arr = np.zeros(shape, first.dtype)
        seen = np.zeros(shape, bool)
        for part in parts:
            for index, blk in part[key]:
                held = seen[index]
                if not np.array_equal(arr[index][held], blk[held]):
                    raise AssertionError(f"{key}: ranks disagree at "
                                         f"{index}")
                arr[index] = blk
                seen[index] = True
        if not seen.all():
            raise AssertionError(f"{key}: blocks do not cover {shape}")
        whole[key] = arr
    return whole


def output_shapes(spec: dict) -> dict:
    """{key: global shape} of a scenario's outputs."""
    if spec["kind"] == "ntt":
        return {"y": spec["x"].shape}
    p, B = spec["parms"], spec["B"]
    n = p.degree
    return {"c0": (p.nprimes, B, n), "c1": (p.nprimes, B, n),
            "pt": (B, n), "pte": (B, n), "ok": (B,)}


def reference(spec: dict) -> dict:
    """The single-device outputs of a scenario, on the CPU."""
    cpu = torch.device("cpu")
    if spec["kind"] == "ntt":
        n, q = spec["x"].shape[-1], int(spec["q"])
        op, quot = (torch.as_tensor(t.astype(np.int64)[None])
                    for t in ntt_ops.ntt_tables(n, q))
        x = torch.as_tensor(spec["x"])[None]
        return {"y": ntt_ops.ntt_limbs(x, op, quot,
                                       torch.tensor([q]))[0].numpy()}
    parms = spec["parms"]
    values, sk, share, err = rand_inputs(parms, spec["B"], spec["seed"])
    if spec["kind"] == "asym":
        enc = AsymEncryptor(parms, *pk_to_device(*spec["pk"], cpu), cpu)
        out = enc(*asym_state_to_device(values, share, cpu))
    else:
        out = LimbscanEncryptor(parms, "parallel", device=cpu)(
            *state_to_device(values, sk, share, err, cpu))
    return {k: v.numpy() for k, v in out.items()}


def scenarios(world: int) -> dict:
    """The dry run's scenarios on `world` ranks (even; multi-host from 4
    ranks on), at the sizes of ``__graft_entry__.py dryrun``."""
    n_limb = 2 if world % 2 == 0 else 1
    mesh = (world // n_limb, n_limb)
    sym = default_parms(4096, max(2, n_limb))
    aparms = Parms(512, PRIMES_27BIT[:max(2, n_limb)], 2.0 ** 20)
    a_sk, a_seed, a_ep = (torch.as_tensor(t) for t in (
        rand_inputs(aparms, 1, 7)[1].astype(np.int64),
        rand_inputs(aparms, 1, 8)[2].astype(np.int64),
        np.random.default_rng(9).integers(-20, 21, 512)))
    pk = tuple(t.numpy() for t in gen_pk_batch(a_sk, a_seed, a_ep, aparms))
    out = {
        "sym n=4096": {"kind": "sym", "mesh": mesh, "parms": sym,
                       "B": 2 * world, "seed": 0},
        "asym n=512": {"kind": "asym", "mesh": mesh, "parms": aparms,
                       "B": 2 * world, "seed": 1, "pk": pk},
        "deep sym n=8192 L=6": {"kind": "sym", "mesh": mesh,
                                "parms": default_parms(8192, 6), "B": world,
                                "seed": 2},
    }
    for n, q in ((4096, sym.moduli[0]),
                 (16384, default_parms(16384, 13).moduli[0])):
        for variant in ("staged", "4step"):
            out[f"ntt {variant} n={n}"] = {
                "kind": "ntt", "mesh": (world, 1), "q": q,
                "variant": variant, "x": ntt_input(n, q, 4, n)}
    if world % 4 == 0:
        out["multihost (2, %d, 2)" % (world // 4)] = {
            "kind": "multihost", "mesh": (2, world // 4, 2), "parms": sym,
            "B": 2 * world, "seed": 0}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("world", type=int, nargs="?", default=8)
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    plan = scenarios(args.world)
    parts = launch.spawn(args.world, rank_body, (plan,), "cpu",
                         args.timeout)
    for name, spec in plan.items():
        got = assemble([r[name]["out"] for r in parts], output_shapes(spec))
        want = reference(spec)
        for key, arr in got.items():
            if not np.array_equal(arr, want[key]):
                raise AssertionError(f"{name}: {key} differs from the "
                                     "single-device path")
        if "ok" in got and not got["ok"].all():
            raise AssertionError(f"{name}: ok is False")
        comms = ", ".join(f"{k} x{c}, {b} B" for k, (c, b)
                          in parts[0][name]["comm"].items())
        print(f"dryrun {name} on {args.world} gloo ranks, mesh "
              f"{spec['mesh']}: bit-equal to the single-device path; "
              f"rank 0's collectives: {comms}")
    print(f"dryrun ok: {len(plan)} scenarios on {args.world} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
