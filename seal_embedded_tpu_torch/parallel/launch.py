"""Start the ranks of a scale-out run on one machine.

``spawn(world, body, args)`` starts `world` processes (the ``spawn``
start method), each of which joins one process group through a
``file://`` store in a fresh temporary directory (no TCP port, so
concurrent runs never collide), calls ``body(rank, world, *args)`` and
hands its result back.  ``body`` must be importable by name (a
module-level function of this package: a child imports the module that
holds it) and its arguments and result picklable.  Any rank's exception
is re-raised in the caller; a rank that dies without one, or a run that
outlasts ``timeout_s``, kills every child and raises.

``join(url, world, rank, device_type)`` joins a process group: gloo on
the CPU, NCCL on the card (rank r on card r mod the cards of its
machine).  ``process_group(world, rank, store, device_type)`` is that
join through a file store, as a context manager that leaves the group on
exit.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .comm import backend_for

_POLL_S = 0.2


def join(url: str, world: int, rank: int, device_type: str = "cuda"):
    """Join the `world`-rank process group at init_method `url` as
    `rank`, with the backend of `device_type`."""
    backend = backend_for(device_type)
    kw = {}
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank, **kw)


@contextlib.contextmanager
def process_group(world: int, rank: int, store: str,
                  device_type: str = "cuda"):
    """Join the `world`-rank process group whose file store is `store` as
    `rank`, and leave it on exit."""
    join(f"file://{store}", world, rank, device_type)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _child(rank, world, store, device_type, body, args, results):
    torch.set_num_threads(1)
    try:
        with process_group(world, rank, store, device_type):
            out = body(rank, world, *args)
        if "jax" in sys.modules:
            raise RuntimeError(f"rank {rank} imported jax")
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    results.put((rank, True, out))


def spawn(world: int, body, args=(), device_type: str = "cuda",
          timeout_s: float = 300.0) -> list:
    """Run body(rank, world, *args) on `world` ranks; returns their
    results in rank order.  Raises RuntimeError with the first failing
    rank's traceback, or when a rank dies silently or the run passes
    timeout_s (every child is killed first)."""
    backend_for(device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world, store, device_type, body,
                                   tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, world, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)


def _collect(procs, results, world, timeout_s):
    deadline = time.monotonic() + timeout_s
    got = {}
    while len(got) < world:
        try:
            rank, ok, out = results.get(timeout=_POLL_S)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                # A failed rank sends its traceback before it exits.
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    rank, ok = None, True
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                raise RuntimeError(f"ranks {dead} died with exit codes "
                                   f"{[procs[r].exitcode for r in dead]} "
                                   "and no result")
            if time.monotonic() > deadline:
                raise RuntimeError(f"spawn: {world - len(got)} of {world} "
                                   f"ranks still running after {timeout_s} s")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{out}")
        got[rank] = out
    return [got[r] for r in range(world)]
