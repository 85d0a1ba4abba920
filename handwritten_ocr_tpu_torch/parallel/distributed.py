"""Multi-process runtime: a ``torch.distributed`` process group, one
process per rank.

Port of ``handwritten_ocr_tpu/parallel/distributed.py``. Every process
joins one group; NCCL carries the collectives where each rank has its own
card, gloo where ranks share a card or there is none (the CPU). Each rank
binds its card (``cuda:{local rank}``; ranks on one card all bind
``cuda:0``) before the group forms, so the engines built after it place
their tensors there.

Where the job says nothing of its hosts (HOCR_DIST_* alone, as the JAX
contract allows across hosts), the ranks meet first on a ``TCPStore`` at
the coordinator's address, each naming its host and its card count; the
local rank is then a rank's index among the ranks of its host
(:func:`placement`), and the group forms over the same store.

Single-process use is untouched: :func:`initialize_from_env` is a no-op
unless the environment opts in.

Env contract (the JAX package's, letter for letter):

  ``HOCR_DIST_COORD``    coordinator ``host:port`` (process 0's address)
  ``HOCR_DIST_NPROCS``   total number of processes in the job
  ``HOCR_DIST_PROC_ID``  this process's rank, ``0..NPROCS-1`` (required:
                         the JAX package defaults it to 0)

With ``initialize_from_env(auto=True)`` and none of these set, torchrun's
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (and
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``) describe the job instead: the
counterpart of JAX's cluster autodetection.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from handwritten_ocr_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                                     make_mesh)


def distributed_env() -> dict | None:
    """The HOCR_DIST_* job description, or None when unset/solo.

    A job of two or more processes must give each its HOCR_DIST_PROC_ID:
    without it every process would take rank 0 and serve the rendezvous
    store, so this raises ValueError instead of defaulting to 0."""
    coord = os.environ.get("HOCR_DIST_COORD")
    nprocs = os.environ.get("HOCR_DIST_NPROCS")
    if not coord or not nprocs or int(nprocs) < 2:
        return None
    proc_id = os.environ.get("HOCR_DIST_PROC_ID")
    if proc_id is None:
        raise ValueError(f"HOCR_DIST_NPROCS={nprocs} needs HOCR_DIST_PROC_ID "
                         f"(this process's rank, 0..{int(nprocs) - 1})")
    return {
        "coordinator_address": coord,
        "num_processes": int(nprocs),
        "process_id": int(proc_id),
    }


def _torchrun_env() -> dict | None:
    """torchrun's job description in the HOCR_DIST_* form, or None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2 or "MASTER_ADDR" not in os.environ:
        return None
    return {
        "coordinator_address": (f"{os.environ['MASTER_ADDR']}:"
                                f"{os.environ.get('MASTER_PORT', '29500')}"),
        "num_processes": world,
        "process_id": int(os.environ.get("RANK", "0")),
    }


def placement(hosts: Sequence[str], cards: Sequence[int],
              rank: int) -> tuple[str, int | None]:
    """(backend, card) of ``rank`` in a job whose rank r runs on host
    ``hosts[r]``, which has ``cards[r]`` cards: NCCL and ``cuda:{local
    rank}`` (the rank's index among the ranks of its host) when every
    host has a card for each of its ranks; else gloo, the ranks of a host
    sharing its ``cuda:0``, or no card on a host without one. Every rank
    computes the same backend."""
    host = hosts[rank]
    local_rank = sum(1 for other in hosts[:rank] if other == host)
    per_host = {h: (hosts.count(h), n) for h, n in zip(hosts, cards)}
    if all(0 < count <= n for count, n in per_host.values()):
        return "nccl", local_rank
    return "gloo", 0 if cards[rank] > 0 else None


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _placement(env: dict, hosts: Sequence[str] | None = None,
               cards: Sequence[int] | None = None) -> tuple[str, int | None]:
    """(backend, card) of this process. torchrun's ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE``, where set, give its host's share; else
    ``hosts`` / ``cards`` (each rank's host and card count, from the
    rendezvous) do, and without them the whole job runs on this host."""
    n, rank = env["num_processes"], env["process_id"]
    if "LOCAL_RANK" in os.environ or "LOCAL_WORLD_SIZE" in os.environ:
        n = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        rank = int(os.environ.get("LOCAL_RANK", rank))
        hosts = None
    if hosts is None:
        hosts, cards = ["this host"] * n, [_cards()] * n
    return placement(hosts, cards, rank)


def _rendezvous(env: dict) -> tuple[dist.TCPStore, list[str], list[int]]:
    """A ``TCPStore`` on the coordinator's address (served by process 0)
    where every rank sets its host name and card count; returns the
    store and every rank's host and card count."""
    host, port = env["coordinator_address"].rsplit(":", 1)
    n, rank = env["num_processes"], env["process_id"]
    store = dist.TCPStore(host, int(port), n, is_master=rank == 0,
                          timeout=datetime.timedelta(minutes=10))
    store.set(f"hocr_host/{rank}", f"{_cards()} {socket.gethostname()}")
    entries = [store.get(f"hocr_host/{r}").decode().split(" ", 1)
               for r in range(n)]
    return store, [h for _, h in entries], [int(c) for c, _ in entries]


def initialize_from_env(auto: bool = False) -> bool:
    """Join the process group described by HOCR_DIST_*; idempotent.

    Returns True when this process is part of a multi-process job (after
    joining), False for ordinary single-process runs. With ``auto=True``
    and no HOCR_DIST_* set, torchrun's variables describe the job; with
    neither it is a single-process no-op."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = distributed_env()
    if env is None and auto:
        env = _torchrun_env()
    if env is None:
        return False
    join = dict(world_size=env["num_processes"], rank=env["process_id"])
    if "LOCAL_RANK" in os.environ or "LOCAL_WORLD_SIZE" in os.environ:
        backend, card = _placement(env)
        join["init_method"] = f"tcp://{env['coordinator_address']}"
    else:
        join["store"], hosts, cards = _rendezvous(env)
        backend, card = _placement(env, hosts, cards)
    if card is not None:
        torch.cuda.set_device(card)      # before anything is allocated
    dist.init_process_group(backend, **join)
    return True


def is_coordinator() -> bool:
    """True in the process that should own side effects (artifact
    writes, console output) — rank 0, or any solo process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(model_parallel: int | None = None):
    """("data", "model") mesh over every rank of the job. Ranks are
    row-major, so a model group is adjacent ranks: on a host of several
    cards its TP collectives stay on the host's NVLink while the "data"
    axis spans hosts."""
    return make_mesh(model_parallel=model_parallel)


def shard_host_batch(mesh, per_index: Callable[[tuple], np.ndarray],
                     global_shape: tuple, device=None) -> torch.Tensor:
    """This rank's rows of a batch split over the mesh's "data" axis.

    ``per_index`` receives the global index (a tuple of slices) of this
    rank's shard and returns its host data, so a folder workload loads
    and decodes only its own pages. The batch axis (0) must divide by the
    "data" axis. A train batch already on the device: ``train/data.py:
    shard_batch``."""
    data, rank = axis_size(mesh, "data"), axis_rank(mesh, "data")
    if global_shape[0] % data:
        raise ValueError(f"batch {global_shape[0]} not divisible by "
                         f"data={data}")
    rows = global_shape[0] // data
    index = (slice(rank * rows, (rank + 1) * rows),) + tuple(
        slice(0, n) for n in global_shape[1:])
    return torch.as_tensor(np.asarray(per_index(index)), device=device)


def replicate_params(mesh, params, fsdp: bool = False):
    """This rank's slices of a parameter tree under the standard TP
    shardings. Every process must hold the SAME values (same checkpoint
    / same init seed); each keeps only the slices its rank owns."""
    from handwritten_ocr_tpu_torch.parallel.sharding import shard_params
    return shard_params(mesh, params, fsdp=fsdp)
