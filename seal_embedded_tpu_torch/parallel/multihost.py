"""Multi-host scale-out of the CKKS encrypt pipelines on torch.distributed.

Port of ``seal_embedded_tpu/parallel/multihost.py``.  The reference is a
single-core embedded library with no distribution at all; scale-out is a
new design axis (SURVEY.md §2.3 "Multi-host" row):

* every rank (one per device, on every host) joins one process group
  (:func:`init_distributed`): NCCL on cards, gloo on CPUs;
* the mesh is (host, data, limb), ranks laid out host by host: the batch
  of messages shards over host x data, so host boundaries only ever cut
  the embarrassingly parallel batch axis, and the only traffic between
  hosts is input distribution and output collection;
* RNS limbs shard over "limb", inside a host, exactly as in
  parallel/limbwise.py, whose limb pipeline runs unchanged with the
  composite batch axis ("host", "data").

Single-machine testing: a (2, 2, 2) mesh of 8 gloo ranks on one machine
runs the same collectives a 2-host run would (tests/test_torch_parallel.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import Parms
from .comm import backend_for
from .launch import join
from .limbwise import make_limb_sharded_encryptor
from .mesh import block, new_mesh, require_group, split


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device_type: str = "cuda") -> bool:
    """Join the process group (one call per rank, before any collective):
    coordinator_address "host:port" (or any init_method URL), the world
    size and this rank; on "cuda", rank r uses card r mod the cards of
    its machine.  Does nothing and returns False with one process, so the
    same entry point runs unmodified on one device or many."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None:
        raise ValueError("init_distributed needs the coordinator's address "
                         "with more than one process")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    join(url, num_processes, process_id, device_type)
    return True


def make_host_mesh(n_limb: int = 1, n_hosts: int | None = None,
                   device_type: str = "cuda"):
    """The (host, data, limb) mesh over the process group.  n_hosts
    defaults to the ranks over the cards of this machine (one rank per
    card) on "cuda", and 1 on "cpu"; pass it to lay a many-host topology
    over the ranks of one machine."""
    backend_for(device_type)
    require_group()
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = (max(world // torch.cuda.device_count(), 1)
                   if device_type == "cuda" else 1)
    n_data = split(world, n_hosts * n_limb, "world")
    return new_mesh((n_hosts, n_data, n_limb), ("host", "data", "limb"),
                    device_type)


def make_multihost_encryptor(mesh, parms: Parms, encode_mode: str = "f64"):
    """Symmetric batched encode + encrypt over a (host, data, limb) mesh:
    parallel/limbwise.py's pipeline with the batch over ("host", "data").
    Bit-identical to the single-device "parallel"-layout pipeline for any
    mesh shape.  Returns fn(values, sk_signed, share_words, err_words) ->
    Shards, the inputs shard_inputs's."""
    return make_limb_sharded_encryptor(mesh, parms, encode_mode,
                                       data_axis=("host", "data"),
                                       limb_axis="limb")


def shard_inputs(mesh, values, sk_signed, share_words, err_words):
    """This rank's inputs: its rows of the batch, which splits over all
    the mesh's axes (host x data x limb, rank order), and sk whole."""
    coord = mesh.get_coordinate()
    flat = int(np.ravel_multi_index(coord, mesh.mesh.shape))
    rows = block(flat, split(values.shape[0], mesh.size(), "batch"))
    return values[rows], sk_signed, share_words[rows], err_words[rows]


def collect_to_host(out) -> dict:
    """A sharded output (a Shards) as host numpy for serialization (the
    reference's send-over-network seam, seal_embedded.c:180-204).

    One rank: key -> the whole array.  Several: key -> [(index, block)],
    ``index`` the tuple of slices of the global array this rank's block
    fills, so a host can tell which batch rows and primes it holds."""
    host = {k: v.cpu().numpy() for k, v in out.items()}
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return host
    return {k: [(out.index[k], v)] for k, v in host.items()}
