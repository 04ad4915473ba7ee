"""Rank bootstrap: one process per rank, federated by ``torch.distributed``.

Counterpart of dvbt_tpu/parallel/multihost.py.  The JAX package federates
processes with ``jax.distributed`` and lays a ``('hosts', 'chips')`` mesh
over them (``make_host_chip_mesh``); here every rank is a process with one
device, and the world group (or any group) IS the mesh, so that function
has no counterpart.  The collectives of the port's parallel paths go
through the helpers below, which stage tensors through the host for gloo.

* ``initialize`` joins the process group with a finite timeout, so a rank
  that hangs fails the run instead of stalling it.
* ``launch`` starts ``n_ranks`` processes with the spawn start method (a
  process that has initialised CUDA must not fork), on a free localhost
  port, and raises in the parent when any rank fails or the run outlasts
  its deadline.
* ``rank_device``: rank r takes ``cuda:{r % device_count}``.  On one card
  all ranks share ``cuda:0``; NCCL refuses two ranks on one device, so the
  bootstrap and the small collectives use gloo.
* ``make_multihost_loopback`` is mux-DP (parallel/sharding.py) over the
  world group.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 300.0


def initialize(init_method: str, world_size: int, rank: int,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join (or create) the gloo process group; returns the world size.

    ``init_method`` is e.g. ``tcp://127.0.0.1:PORT``.  Every collective of
    the group fails after ``timeout_s`` seconds instead of waiting for a
    rank that never comes."""
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def rank_device(rank: int) -> torch.device:
    """The card of ``rank``: ``cuda:{rank % device_count}``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass a CPU device explicitly")
    return torch.device("cuda", rank % n)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n_ranks, init_method, timeout_s, threads, args):
    if threads is not None:
        torch.set_num_threads(threads)
    initialize(init_method, n_ranks, rank, timeout_s)
    try:
        fn(rank, n_ranks, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, args: tuple = (),
           timeout_s: float = DEFAULT_TIMEOUT_S,
           deadline_s: float = 1200.0, threads: int | None = None) -> None:
    """Run ``fn(rank, n_ranks, *args)`` in ``n_ranks`` spawned processes
    that have joined one gloo process group (a rank may add an NCCL group
    with ``dist.new_group``); return when all have ended.

    ``fn`` must be importable by name (a module-level function).  An
    exception in any rank ends the others and is raised here; so is a run
    longer than ``deadline_s`` seconds.  ``threads`` sets each rank's
    ``torch.set_num_threads``."""
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, n_ranks, init_method, timeout_s, threads,
                          args),
        nprocs=n_ranks, join=False, start_method="spawn")
    deadline = time.monotonic() + deadline_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(timeout=30)
            raise TimeoutError(f"{n_ranks} ranks ran past {deadline_s} s")


# --- collectives of small tensors, staged through the host for gloo ------

def global_rank(group, group_rank: int) -> int:
    """The world rank of ``group_rank`` in ``group`` (None: the world)."""
    return group_rank if group is None else dist.get_global_rank(group,
                                                                 group_rank)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group, on the CPU."""
    t = x.to("cpu", copy=True)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank, on ``x``'s device."""
    t = x.to("cpu", copy=True).contiguous()
    dist.broadcast(t, src=global_rank(group, src), group=group)
    return t.to(x.device)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(group size, *x.shape): every rank's ``x``, on ``x``'s device."""
    t = x.to("cpu", copy=True).contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).to(x.device)


def make_multihost_loopback(mode, device, muxes_per_rank: int = 1):
    """Mux-DP loopback over the world group.

    Returns (step, init_states, n_packets_per_mux, B_global) with the
    contract of parallel.sharding.make_sharded_loopback; each rank passes
    its own (muxes_per_rank, P, 188) packets, the muxes
    [rank * muxes_per_rank, (rank + 1) * muxes_per_rank) of the fleet."""
    from .sharding import make_sharded_loopback

    step, init_states, n_pk = make_sharded_loopback(mode, device,
                                                    muxes_per_rank)
    return step, init_states, n_pk, dist.get_world_size() * muxes_per_rank
