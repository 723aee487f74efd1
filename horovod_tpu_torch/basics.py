"""Process/topology bootstrap (counterpart of ``horovod_tpu/basics.py``).

One process per GPU, as in the original Horovod: ``rank()`` is the GPU.
``init()`` joins the ``torch.distributed`` default process group — NCCL
for CUDA, gloo for the CPU — and pins this process to
``cuda:local_rank``.

The world comes from, in order:

* ``hvdrun``'s environment: ``HVDTPU_RANK/SIZE/COORDINATOR`` and
  ``HVDTPU_LOCAL_*`` / ``HVDTPU_CROSS_*``;
* ``torchrun``'s: ``RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT`` and
  ``LOCAL_RANK/LOCAL_WORLD_SIZE/GROUP_RANK``;
* neither: a world of 1 on a TCP store on ``127.0.0.1`` (a free port).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from datetime import timedelta
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .exceptions import NotInitializedError
from .utils import env as envmod

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "rank",
    "size",
    "local_rank",
    "local_size",
    "cross_rank",
    "cross_size",
    "is_homogeneous",
    "device",
    "global_topology",
    "NotInitializedError",
]


@dataclass(frozen=True)
class Topology:
    """Static view of the job, fixed at init()."""

    process_rank: int
    process_count: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    device: torch.device
    backend: str
    homogeneous: bool = True


class _World(NamedTuple):
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    coordinator: Optional[str]


_state_lock = threading.Lock()
_topology: Optional[Topology] = None


def _world_from_env(environ) -> _World:
    """The rendezvous environment: hvdrun's, else torchrun's, else a
    world of 1."""
    get = lambda name, default: int(environ.get(name) or default)
    if environ.get(envmod.SIZE):
        size = get(envmod.SIZE, 1)
        rank = get(envmod.RANK, 0) if size > 1 else 0
        return _World(
            rank, size,
            get(envmod.LOCAL_RANK, 0), get(envmod.LOCAL_SIZE, 1),
            get(envmod.CROSS_RANK, rank), get(envmod.CROSS_SIZE, size),
            environ.get(envmod.COORDINATOR),
        )
    if environ.get(envmod.TORCHRUN_WORLD_SIZE):
        size = get(envmod.TORCHRUN_WORLD_SIZE, 1)
        rank = get(envmod.TORCHRUN_RANK, 0)
        local_size = get(envmod.TORCHRUN_LOCAL_WORLD_SIZE, 1)
        addr = environ.get(envmod.TORCHRUN_MASTER_ADDR)
        port = environ.get(envmod.TORCHRUN_MASTER_PORT)
        return _World(
            rank, size, get(envmod.TORCHRUN_LOCAL_RANK, 0), local_size,
            get(envmod.TORCHRUN_GROUP_RANK, rank // local_size),
            max(size // local_size, 1),
            f"{addr}:{port}" if addr and port else None,
        )
    return _World(0, 1, 0, 1, 0, 1, None)


def _resolve_device(device, local_rank: int) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is visible; pass "
                "device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def init(comm=None, device=None) -> Topology:
    """Initialize the framework (reference: horovod_init).  Re-init is a
    no-op that returns the existing topology.

    ``device``: ``None`` means this process's GPU (``cuda:local_rank``);
    with no GPU visible that raises — pass ``device="cpu"`` for a gloo
    world on the CPU.  ``comm`` sub-communicators are not supported, as
    in the reference.
    """
    global _topology
    with _state_lock:
        if _topology is not None:
            return _topology
        if comm not in (None, []):
            raise ValueError(
                "horovod_tpu_torch.init(comm=...) sub-communicators are not "
                "supported; the world is the default process group."
            )
        w = _world_from_env(os.environ)
        dev = _resolve_device(device, w.local_rank)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if w.size > 1:
            if w.coordinator is None:
                raise RuntimeError(
                    "HVDTPU_SIZE > 1 but HVDTPU_COORDINATOR is unset; launch "
                    "with hvdrun or torchrun, or set the rendezvous "
                    "environment explicitly."
                )
            dist.init_process_group(
                backend, init_method=f"tcp://{w.coordinator}",
                rank=w.rank, world_size=w.size,
                timeout=timedelta(
                    seconds=envmod.env_int(envmod.START_TIMEOUT, 300)),
            )
        else:
            # port 0: the OS picks a free port
            store = dist.TCPStore("127.0.0.1", 0, 1, True)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
        homogeneous = True
        if w.size > 1:
            # the reference compares local sizes across ranks
            # (mpi_controller.cc:46-81)
            sizes = [None] * w.size
            dist.all_gather_object(sizes, w.local_size)
            homogeneous = len(set(sizes)) <= 1
        _topology = Topology(
            process_rank=w.rank, process_count=w.size,
            local_rank=w.local_rank, local_size=w.local_size,
            cross_rank=w.cross_rank, cross_size=w.cross_size,
            device=dev, backend=backend, homogeneous=homogeneous,
        )
        return _topology


def shutdown() -> None:
    """Tear down state and the process group init() created (reference:
    horovod_shutdown)."""
    global _topology
    with _state_lock:
        if _topology is not None:
            dist.destroy_process_group()
        _topology = None


def is_initialized() -> bool:
    return _topology is not None


def global_topology() -> Topology:
    if _topology is None:
        raise NotInitializedError()
    return _topology


def rank() -> int:
    """Process rank (reference: horovod_rank)."""
    return global_topology().process_rank


def size() -> int:
    """Process count (reference: horovod_size)."""
    return global_topology().process_count


def local_rank() -> int:
    return global_topology().local_rank


def local_size() -> int:
    return global_topology().local_size


def cross_rank() -> int:
    return global_topology().cross_rank


def cross_size() -> int:
    return global_topology().cross_size


def is_homogeneous() -> bool:
    return global_topology().homogeneous


def device() -> torch.device:
    """This process's device, fixed at init()."""
    return global_topology().device
