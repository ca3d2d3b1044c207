"""The collectives of the scale-out paths, counted.

Each function runs one ``torch.distributed`` collective over a group and
adds its kind and the bytes it delivers to this rank (the result's bytes,
the measure the JAX package's tests read from the partitioned HLO) to
``counts``, as the kernel wrappers count their launches: the tests and
``chip_smoke.py`` set it to {} before a run and read it after.  It is
registered with the kernel counters (``ops/kernels/counters.py``), so a
CUDA graph that replays these collectives adds them as it adds its
launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.kernels import counters

# kind -> [calls, bytes delivered to this rank]
counts: dict[str, list[int]] = {}
counters.register("comm", lambda: counts)

# The process-group backend of each device type: NCCL on the card, gloo
# on the CPU.  The caller's device decides, never what is available.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"unknown device type {device_type!r}; "
                         f"one of {sorted(BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type 'cuda' needs a CUDA device")
    return BACKENDS[device_type]


def group_device_type() -> str:
    """The device type of the process group this rank has joined: "cuda"
    under NCCL, "cpu" under gloo."""
    return {b: d for d, b in BACKENDS.items()}[dist.get_backend()]


def _count(kind: str, t: torch.Tensor) -> None:
    c = counts.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The x (r, ...) of every rank of `group`, concatenated along dim 0
    in group-rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    _count("all_gather", out)
    return out


def all_and(ok: torch.Tensor, group) -> torch.Tensor:
    """The AND of the bool flags `ok` over `group`."""
    flags = ok.to(torch.uint8)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=group)
    _count("all_reduce", flags)
    return flags.bool()


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of x (D, ...) goes to group rank j; block j of the result
    came from group rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _count("all_to_all", out)
    return out


def exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send x to group rank `peer` and receive its tensor of the same
    shape: one batch_isend_irecv pair."""
    peer = dist.get_global_rank(group, peer)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peer, group),
           dist.P2POp(dist.irecv, out, peer, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count("exchange", out)
    return out
