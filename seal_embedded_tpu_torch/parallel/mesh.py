"""Device mesh and sharded encryption entry points on torch.distributed.

Port of ``seal_embedded_tpu/parallel/mesh.py``.  Parallelism axes for
CKKS encode/encrypt (SURVEY.md S2.3):
  data  — batch of independent messages (DP): embarrassingly parallel
  limb  — RNS primes (TP-like): each prime's NTT/sampling is independent

A mesh is a ``DeviceMesh`` over the initialized process group, one rank
per device, ranks laid out row-major over the mesh's axes.  Each rank
runs its own part of a batch (SPMD): a sharded function takes this
rank's rows (``shard_batch``, ``multihost.shard_inputs``) and returns a
``Shards``, the rank's blocks of the global outputs with the global
slices they occupy, which ``multihost.collect_to_host`` hands to the
host.  The coefficient-sharded NTT is ``parallel/coeff_ntt.py``.  Every
sharded function is compiled per input signature on the rank's device
(``graphs.graphed``, the JAX package's jit): on the card its NCCL
collectives are captured inside the graph, and on the CPU (gloo) it runs
as it is.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import Parms
from ..graphs import graphed
from .comm import backend_for


class Shards(dict):
    """This rank's blocks of a sharded output: key -> tensor, and
    ``index[key]``, the tuple of slices of the global array the block
    fills (blocks of replicated keys repeat on several ranks)."""

    def __init__(self, blocks: dict, index: dict):
        super().__init__(blocks)
        self.index = index


def require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "multihost.init_distributed or join one with "
                           "launch.process_group first")


def new_mesh(shape: tuple[int, ...], names: tuple[str, ...],
             device_type: str) -> DeviceMesh:
    """A DeviceMesh of `shape` over all ranks of the process group."""
    backend_for(device_type)
    require_group()
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_data: int | None = None, n_limb: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """The ("data", "limb") mesh over the process group; n_data defaults
    to world / n_limb."""
    require_group()
    if n_data is None:
        n_data = dist.get_world_size() // n_limb
    return new_mesh((n_data, n_limb), ("data", "limb"), device_type)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_index(mesh: DeviceMesh, axes) -> tuple[int, int]:
    """(this rank's index, the size) of one mesh axis or of several taken
    together, the first outermost: ("host", "data") numbers the ranks'
    batch blocks host by host."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    index, size = 0, 1
    for a in axes:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        index = index * n + mesh.get_local_rank(a)
        size *= n
    return index, size


def split(total: int, parts: int, what: str) -> int:
    if total % parts:
        raise ValueError(f"{what} {total} does not split evenly over "
                         f"{parts} ranks")
    return total // parts


def block(index: int, size: int) -> slice:
    return slice(index * size, (index + 1) * size)


def shard_batch(mesh: DeviceMesh, *tensors):
    """This rank's rows of batched tensors, the batch axis split over
    "data"."""
    d, n_data = axis_index(mesh, "data")
    return tuple(t[block(d, split(t.shape[0], n_data, "batch"))]
                 for t in tensors)


def limb_block(mesh: DeviceMesh, parms: Parms, limb_axis="limb") -> slice:
    """The primes this rank owns: L / n_limb of them, in chain order."""
    l, n_limb = axis_index(mesh, limb_axis)
    return block(l, split(parms.nprimes, n_limb, "nprimes"))


def sym_encrypt_sharded(mesh: DeviceMesh, parms: Parms):
    """sym_encrypt_batch on this rank's "data" rows (shard_batch's), its
    c0/c1 kept to this rank's "limb" block of primes.

    The counterpart of the JAX package's GSPMD wrapper: the batch splits
    over "data" and the outputs land limb-sharded, but every rank computes
    all primes of its rows.  For limb-parallel compute (each rank owns its
    primes end to end) use parallel.limbwise.make_limb_sharded_encryptor.
    Returns fn(values, sk_signed, share_words, err_words) -> Shards, c0/c1
    bit-equal to the unsharded function's blocks, the inputs on the
    mesh's device; compiled per input signature there (``graphs.py``),
    as the JAX wrapper is jitted, through a BatchEncryptor whose tables
    stay resident.
    """
    from ..ckks.sym import BatchEncryptor

    limbs = limb_block(mesh, parms)
    d, _ = axis_index(mesh, "data")
    dev = mesh_device(mesh)
    enc = BatchEncryptor(parms, dev)

    def run(values, sk_signed, share_words, err_words):
        out = enc(values, sk_signed, share_words, err_words)
        rows = block(d, values.shape[0])
        blocks = {"c0": out["c0"][limbs], "c1": out["c1"][limbs],
                  "pt": out["pt"], "pte": out["pte"], "ok": out["ok"]}
        index = {"c0": (limbs, rows), "c1": (limbs, rows), "pt": (rows,),
                 "pte": (rows,), "ok": (rows,)}
        return Shards(blocks, index)
    return graphed(run, dev)
