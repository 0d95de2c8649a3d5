"""Process-group start-up: one process per rank.

Port of ``dream_gnn_tpu/sharding/multihost.py``.  JAX's distributed
runtime gives one controller every device; ``torch.distributed`` runs one
process per rank, so a run starts its ranks either under ``torchrun``
(which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``: ``initialize``) or from one process (``spawn``).  The
backend is always the caller's argument: NCCL with one rank a card, gloo
on the CPU and for ranks that share a card (sharding/collectives.py says
how their CUDA tensors travel).

The layout builders (sharding/scale_graph.py,
sharding/scale_decoder_spmd.py) plan every shard the same way on every
rank from the same arrays, and each rank keeps its own: the JAX package's
rank-agnostic plan.
"""

from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT_S = 600


def rank_device(local_rank: int, cpu: bool) -> torch.device:
    """The rank's device: the CPU, or ``cuda:{local_rank % cards}``; raises
    when a card is asked for and there is none."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {local_rank} was asked for a card and finds "
                           f"none; pass the CPU explicitly to run there")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize(backend: str, *, cpu: bool = False):
    """``init_process_group`` from ``torchrun``'s environment and this
    rank's device.  Does nothing and returns None where no multi-process
    environment is set, as the JAX function does; returns the rank's device
    otherwise."""
    env = os.environ
    if "WORLD_SIZE" not in env:
        return None
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(env["RANK"]),
                                world_size=int(env["WORLD_SIZE"]),
                                timeout=timedelta(seconds=TIMEOUT_S))
    return rank_device(int(env.get("LOCAL_RANK", env["RANK"])), cpu)


def describe(group=None) -> str:
    """The line a run prints: backend and transport, world size, cards."""
    from dream_gnn_tpu_torch.sharding.collectives import transport

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return (f"backend {transport(group)}, world size "
            f"{dist.get_world_size(group)}, {cards} card(s)")


def global_mesh(mp: int = 1, dp: int | None = None):
    """The (dp, mp) mesh over every rank of the default group, after
    ``initialize`` or under ``spawn`` (multihost.py:62): ``dp`` spans the
    hosts and defaults to world size // mp (folds never communicate), and
    ``mp`` groups consecutive ranks, one host's cards, so that the decoders'
    collectives stay on a host's fabric."""
    from dream_gnn_tpu_torch.sharding.mesh import make_mesh

    return make_mesh(dp=dp, mp=mp)


def local_shard_slice(global_len: int) -> slice:
    """The contiguous [start, stop) range of a length-``global_len``
    leading axis owned by this rank (equal split; multihost.py:70-75)."""
    per = -(-global_len // dist.get_world_size())
    start = dist.get_rank() * per
    return slice(start, min(start + per, global_len))


def _child(rank: int, fn, world: int, backend: str, cpu: bool,
           init_file: str, args, result_file: str) -> None:
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank_device(rank, cpu), *args)
        if rank == 0:
            torch.save(out, result_file)
    finally:
        dist.destroy_process_group()


def spawn(fn, nproc: int, backend: str, args=(), *, cpu: bool = False,
          workdir: str | None = None, timeout_s: float = 2 * TIMEOUT_S):
    """Run ``fn(device, *args)`` on ``nproc`` new ranks (start method
    ``spawn``, as CUDA cannot be forked) joined through a file under
    ``workdir`` (a new temporary directory by default); returns rank 0's
    return value (passed back through a file there).  A rank that raises
    fails the call and stops the others; ranks still running after
    ``timeout_s`` are stopped and the call raises."""
    import torch.multiprocessing as mp

    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="dgt_pg_") if own else workdir
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    init_file = os.path.join(workdir, f"pg_init_{tag}")
    result_file = os.path.join(workdir, f"rank0_result_{tag}.pt")
    try:
        ranks = mp.start_processes(
            _child, args=(fn, nproc, backend, cpu, init_file, args,
                          result_file),
            nprocs=nproc, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ranks.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ranks.processes:
                    proc.terminate()
                raise TimeoutError(f"{nproc} ranks still running after "
                                   f"{timeout_s} s")
        return torch.load(result_file, weights_only=False)
    finally:
        for f in (init_file, result_file):
            if os.path.exists(f):
                os.remove(f)
        if own:
            os.rmdir(workdir)
