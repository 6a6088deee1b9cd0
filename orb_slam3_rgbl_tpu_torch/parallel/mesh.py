"""Ranks over the landmark axis (counterpart of
``orb_slam3_rgbl_tpu.parallel.mesh``, whose 1-D ``jax.sharding.Mesh`` on axis
``lm`` becomes a ``torch.distributed`` group here).

``make_mesh`` joins one process to the group with the backend its caller
names — ``nccl`` for ranks on distinct CUDA cards, ``gloo`` on the CPU or
for CUDA tensors of ranks that share a card (NCCL refuses two ranks on one
card) — and raises if that backend cannot start: there is no silent switch.
``landmark_sharding`` gives a rank its contiguous slice of the landmark
axis, the real counts split as evenly as they go (no padding to a multiple
of the world size); ``replicated`` is the whole axis. ``rank_layout`` says
where ranks run on a device (``None``: the card, as every entry point of the
port): rank r on card r over NCCL while there are cards enough, else gloo
ranks sharing the cards; gloo ranks on the CPU only when the caller names
it. ``run_ranks`` spawns one process per rank of that layout (the ``spawn``
start method: CUDA may already be initialized in the caller), runs a
module-level function on each with its ``Mesh`` and returns every rank's
result.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from orb_slam3_rgbl_tpu_torch.device import resolve

BACKENDS = ("nccl", "gloo")


class Mesh:
    """One rank's view of the group: its rank, the world size, the backend,
    its device, and ``all_reduce`` (an in-place sum over the ranks) with
    the count of collectives and bytes it has carried (``stats``)."""

    def __init__(self, rank: int, world_size: int, backend: str, device: torch.device, group):
        self.rank, self.world_size, self.backend = rank, world_size, backend
        self.device, self.group = device, group
        self.stats = {"collectives": 0, "bytes": 0}

    def all_reduce(self, flat: torch.Tensor) -> None:
        self.stats["collectives"] += 1
        self.stats["bytes"] += flat.numel() * flat.element_size()
        dist.all_reduce(flat, group=self.group)

    def close(self):
        """Leave the group (every rank must, before its process ends)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def file_store() -> tuple:
    """(``init_method`` of a fresh file store, its directory): the ranks of
    one group meet there; remove the directory once the group is closed."""
    d = tempfile.mkdtemp(prefix="orb_slam3_ranks_")
    return "file://" + os.path.join(d, "store"), d


def make_mesh(rank: int, world_size: int, backend: str, init_method: str, device=None,
              timeout_s: float = 600.0) -> Mesh:
    """Join this process to a ``world_size``-rank group as ``rank``, on
    ``device`` (default ``cuda``), over ``backend``; raises if the backend
    cannot serve the device or does not start."""
    dev = resolve(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and (dev.type != "cuda" or not dist.is_nccl_available()):
        raise RuntimeError(f"backend 'nccl' cannot serve device {dev} here "
                           f"(NCCL available: {dist.is_nccl_available()})")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("backend 'gloo' is not available in this build of torch")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(rank, world_size, backend, dev, dist.group.WORLD)


def landmark_sharding(n: int, rank: int, world_size: int) -> slice:
    """Rank ``rank``'s contiguous slice of ``n`` landmarks: the first
    ``n % world_size`` ranks hold one more than the others."""
    base, extra = divmod(n, world_size)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (rank < extra))


def replicated(n: int) -> slice:
    """The whole axis: what every rank holds of a replicated array."""
    return slice(0, n)


def rank_layout(world_size: int, device=None) -> tuple:
    """(backend, each rank's device) for ``world_size`` ranks on ``device``
    (default ``cuda``; raises without CUDA, as ``device.resolve``): gloo
    ranks on the CPU; on CUDA, rank r on card r over NCCL while there are
    cards enough, otherwise gloo ranks sharing the cards round-robin (NCCL
    refuses two ranks on one card)."""
    dev = resolve(device)
    if dev.type == "cpu":
        return "gloo", ["cpu"] * world_size
    cards = torch.cuda.device_count()
    if world_size <= cards:
        return "nccl", [f"cuda:{r}" for r in range(world_size)]
    return "gloo", [f"cuda:{r % cards}" for r in range(world_size)]


def _rank_main(rank, world_size, backend, device, init_method, threads, timeout_s, fn, args,
               results):
    torch.set_num_threads(threads)
    mesh = None
    try:
        mesh = make_mesh(rank, world_size, backend, init_method, device, timeout_s)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:       # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if mesh is not None:
            mesh.close()


def run_ranks(fn: Callable, args: tuple, world_size: int, device=None, threads: int = 1,
              timeout_s: float = 600.0) -> list:
    """``[fn(mesh_r, *args) for r in range(world_size)]``, each in a spawned
    process of its own, placed by ``rank_layout(world_size, device)``
    (``device`` default ``cuda``; ``threads`` torch threads a rank). ``fn``
    must be a module-level function and its result picklable (numpy, not
    CUDA tensors). A rank that raises, or a group that outlives
    ``timeout_s``, stops every rank and raises here."""
    backend, devices = rank_layout(world_size, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method, store_dir = file_store()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(r, world_size, backend, devices[r], init_method, threads,
                               timeout_s, fn, args, results))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        out = [None] * world_size
        deadline = time.monotonic() + timeout_s
        for _ in range(world_size):
            # drain before joining: a rank's queue feeder holds it until read
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue_mod.Empty:
                raise TimeoutError(f"{world_size} ranks over {backend}: no result within "
                                   f"{timeout_s:.0f} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} ({backend}) failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
