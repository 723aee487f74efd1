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

Ranks are cross-major, as torchrun numbers them and as the reference's
``mesh("hierarchical")`` lays out its devices: global rank = ``cross_rank
x local_size + local_rank``.  ``init`` builds the two subgroups of the
two-level schedules (``parallel/hierarchical.py``) once: this rank's
*local* group (the ranks of its host, ``LOCAL_AXIS``) and its *cross*
group (the ranks of its local index on every host, ``CROSS_AXIS``).
After them it builds the eager engine's own groups (:class:`EngineGroups`),
which no other code issues collectives on, and :func:`shutdown` stops the
engine before it destroys any group.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, NamedTuple, Optional

import numpy as np
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
    "num_devices",
    "device_rank",
    "slice_id",
    "num_slices",
    "slice_size",
    "slice_of_rank",
    "local_group",
    "cross_group",
    "group_of_axis",
    "init_axes",
    "slice_grid",
    "mesh",
    "xla_collectives_built",
    "native_engine_built",
    "mpi_built",
    "mpi_enabled",
    "mpi_threads_supported",
    "gloo_built",
    "gloo_enabled",
    "nccl_built",
    "ccl_built",
    "ddl_built",
    "DP_AXIS",
    "CROSS_AXIS",
    "LOCAL_AXIS",
    "SLICE_AXIS",
]

# The reference's axis names (horovod_tpu/basics.py:76-84).  Here they name
# process groups, not mesh axes: DP_AXIS the world, LOCAL_AXIS the ranks of
# one host, CROSS_AXIS the ranks of one local index across hosts.
DP_AXIS = "hvd"
CROSS_AXIS = "hvd_cross"
LOCAL_AXIS = "hvd_local"
SLICE_AXIS = "hvd_slice"

_log = logging.getLogger(__name__)


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
    # the forced slice partition (contiguous equal blocks of processes)
    num_slices: int = 1
    slice_id: int = 0
    # this rank's subgroups (torch.distributed process groups); None when
    # the world is not local_size x cross_size cross-major
    local_group: Any = field(default=None, repr=False, compare=False)
    cross_group: Any = field(default=None, repr=False, compare=False)
    # the eager engine's own groups (None in a world of one)
    engine_groups: Any = field(default=None, repr=False, compare=False)

    @property
    def num_devices(self) -> int:
        """GPUs in the job: one per process."""
        return self.process_count


class EngineGroups(NamedTuple):
    """The process groups only the eager engine's background thread uses
    (``runtime/engine.py``): two threads issuing collectives on one
    communicator could interleave differently on two ranks and hang.

    ``control``: gloo, the negotiation's allgathers and the host data
    plane.  ``data``: NCCL for CUDA payloads (None on a CPU world).
    ``local`` / ``cross``: NCCL copies of this rank's two-level groups for
    the engine's hierarchical allreduce (None unless the world is hosts x
    local ranks with both larger than 1)."""

    control: Any
    data: Any
    local: Any
    cross: Any


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
# the named axes of init_axes: name -> this rank's process group
_axes: dict = {}
# mesh(): shape -> DeviceMesh, and the groups of mesh("slice")'s axes
_mesh_cache: dict = {}
_slice_axes: dict = {}


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


def resolve_slice_partition(world: int, proc: int, env=None) -> tuple:
    """``(num_slices, slice_id)`` of process ``proc`` in a world of
    ``world`` (the reference's ``resolve_slice_partition``,
    horovod_tpu/basics.py:133-220, for one GPU per process):
    ``HVDTPU_NUM_SLICES`` forces a count of contiguous process blocks, else
    ``HVDTPU_SLICE_SIZE`` the processes per slice; a value that does not
    divide the world is ignored with a warning.  GPUs report no slice of
    their own, so with neither set the job is one slice."""
    e = os.environ if env is None else env

    def val(name):
        raw = e.get(name)
        try:
            return int(raw) if raw not in (None, "") else 0
        except ValueError:
            _log.warning("%s=%r is not an integer; ignoring", name, raw)
            return 0

    n = val(envmod.NUM_SLICES)
    if n <= 0:
        ssize = val(envmod.SLICE_SIZE)
        if ssize > 0:
            if world % ssize:
                _log.warning("%s=%d does not divide the %d-process world; "
                             "running single-slice", envmod.SLICE_SIZE,
                             ssize, world)
            else:
                n = world // ssize
    if n > 1:
        if world % n:
            _log.warning("forced slice count %d does not divide the "
                         "%d-process world; running single-slice", n, world)
            return 1, 0
        return n, proc // (world // n)
    return 1, 0


def _subgroups(w: _World, layouts) -> tuple:
    """``(local_group, cross_group)`` of this rank.  ``layouts`` holds every
    rank's ``(local_rank, local_size, cross_rank, cross_size)``; the groups
    exist only when every rank sits at ``cross_rank x local_size +
    local_rank`` of a ``local_size x cross_size`` world (else ``(None,
    None)``, decided alike on every rank).  Every rank creates every group,
    in one order, as ``new_group`` requires; at world 1 both are the
    world."""
    if w.size == 1:
        return dist.group.WORLD, dist.group.WORLD
    local_n, cross_n = w.local_size, w.cross_size
    if local_n * cross_n != w.size or any(
            lay != (r % local_n, local_n, r // local_n, cross_n)
            for r, lay in enumerate(layouts)):
        return None, None
    local = [dist.new_group([c * local_n + l for l in range(local_n)])
             for c in range(cross_n)]
    cross = [dist.new_group([c * local_n + l for c in range(cross_n)])
             for l in range(local_n)]
    return local[w.cross_rank], cross[w.local_rank]


def _engine_groups(w: _World, backend: str, local) -> Optional[EngineGroups]:
    """The eager engine's groups, built by every rank in one order (after
    the two-level groups: ``new_group`` is collective and order-sensitive,
    so it runs here in ``init``, never lazily on a first eager call that
    ranks reach at different times)."""
    if w.size == 1:
        return None
    control = dist.new_group(backend="gloo")
    if backend != "nccl":
        return EngineGroups(control, None, None, None)
    data = dist.new_group(backend="nccl")
    local_n, cross_n = w.local_size, w.cross_size
    if local is None or local_n == 1 or cross_n == 1:
        return EngineGroups(control, data, None, None)
    locals_ = [dist.new_group([c * local_n + l for l in range(local_n)],
                              backend="nccl") for c in range(cross_n)]
    crosses = [dist.new_group([c * local_n + l for c in range(cross_n)],
                              backend="nccl") for l in range(local_n)]
    return EngineGroups(control, data, locals_[w.cross_rank],
                        crosses[w.local_rank])


def _resolve_device(device, local_rank: int, environ=None) -> torch.device:
    """``device`` (``None``: this process's GPU, ``cuda:local_rank``).  An
    elastic worker (``HVDTPU_ELASTIC_RANK`` set) runs a world of one of
    its own, so ``local_rank`` is 0 there: it takes the local slot the
    elastic launcher gave it (``HVDTPU_LOCAL_RANK``), round-robin over
    the host's GPUs (its collectives ride the launcher's KV store, not
    NCCL, so two workers may share a GPU)."""
    environ = os.environ if environ is None else environ
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is visible; pass "
                "device='cpu' to run on the CPU"
            )
        if dev.index is None and environ.get("HVDTPU_ELASTIC_RANK") \
                and not environ.get(envmod.SIZE):
            local_rank = (int(environ.get(envmod.LOCAL_RANK) or 0)
                          % torch.cuda.device_count())
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
        mine = (w.local_rank, w.local_size, w.cross_rank, w.cross_size)
        layouts = [mine]
        if w.size > 1:
            layouts = [None] * w.size
            dist.all_gather_object(layouts, mine)
        # the reference compares local sizes across ranks
        # (mpi_controller.cc:46-81)
        homogeneous = len({lay[1] for lay in layouts}) <= 1
        local, cross = _subgroups(w, layouts)
        engine_groups = _engine_groups(w, backend, local)
        n_slices, slice_i = resolve_slice_partition(w.size, w.rank)
        _topology = Topology(
            process_rank=w.rank, process_count=w.size,
            local_rank=w.local_rank, local_size=w.local_size,
            cross_rank=w.cross_rank, cross_size=w.cross_size,
            device=dev, backend=backend, homogeneous=homogeneous,
            num_slices=n_slices, slice_id=slice_i,
            local_group=local, cross_group=cross,
            engine_groups=engine_groups,
        )
    _arm_obs(_topology)
    # The native engine starts at init in worlds of more than one process
    # (horovod_tpu/basics.py:356-369; the reference's InitializeHorovodOnce,
    # operations.cc:604-650), so every rank's engine cycles for negotiation
    # and stall inspection even before it enqueues anything.  The Python
    # engine starts at its first eager op.
    if w.size > 1 and os.environ.get(envmod.EAGER_ENGINE, "auto").lower() \
            == "native":
        from ._engine_registry import get_engine  # noqa: PLC0415

        get_engine()
    return _topology


def _arm_obs(topo: Topology) -> None:
    """Arm the observability planes at init (horovod_tpu/basics.py:
    334-352): the first registry use installs the ``HVDTPU_METRICS_DUMP``
    exit dump; the flight recorder's death hooks (excepthook,
    threading.excepthook, SIGTERM/SIGABRT/SIGUSR1) make a rank killed by
    a signal still flush its ring, its metrics and its final live delta;
    the live stream starts when the launcher exported
    ``HVDTPU_LIVE_STATS_SECS`` and a KV endpoint."""
    from .obs import flightrec, get_registry  # noqa: PLC0415
    from .obs import stream as obs_stream  # noqa: PLC0415

    get_registry().gauge("process.rank").set(topo.process_rank)
    flightrec.install_death_hooks()
    flightrec.record("init", name=f"rank{topo.process_rank}",
                     detail=f"world={topo.process_count}")
    obs_stream.maybe_start_from_env()


def shutdown() -> None:
    """Tear down state and the process group init() created (reference:
    horovod_shutdown).  The eager engine stops first: its background
    thread may be blocked in a collective on its own groups, and
    destroying them under it would hang or crash the peers.  Its
    coordinated shutdown fails every pending handle, here and on the
    peers, with ``HorovodShutdownError``."""
    global _topology
    from ._engine_registry import shutdown_engine  # noqa: PLC0415

    shutdown_engine()
    with _state_lock:
        # a serving fleet's width group may have replaced the default group
        if _topology is not None and dist.is_initialized():
            dist.destroy_process_group()
        _topology = None
        _axes.clear()
        _mesh_cache.clear()
        _slice_axes.clear()


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


def num_devices() -> int:
    """GPUs in the job, the width of the data-parallel world: one per
    process, so ``size()``."""
    return global_topology().num_devices


def device_rank() -> int:
    """Global index of this process's GPU: ``rank()``, one GPU per
    process."""
    return global_topology().process_rank


def slice_id() -> int:
    """The slice this process belongs to (0 in a single-slice job)."""
    return global_topology().slice_id


def num_slices() -> int:
    """Slices of the job (1 unless ``HVDTPU_NUM_SLICES`` /
    ``HVDTPU_SLICE_SIZE`` force a partition)."""
    return global_topology().num_slices


def slice_size() -> int:
    """Processes per slice (the whole world when there is one slice)."""
    topo = global_topology()
    if topo.num_slices <= 1:
        return topo.process_count
    return topo.process_count // topo.num_slices


def slice_of_rank(rank: int) -> int:
    """The slice of process ``rank``: contiguous equal blocks."""
    topo = global_topology()
    if topo.num_slices <= 1:
        return 0
    return int(rank) // (topo.process_count // topo.num_slices)


def _group(kind: str):
    topo = global_topology()
    group = topo.local_group if kind == "local" else topo.cross_group
    if group is None:
        raise ValueError(
            f"no {kind} group: the two-level groups need a world of "
            f"local_size x cross_size ranks numbered cross-major (rank = "
            f"cross_rank x local_size + local_rank); this world has size "
            f"{topo.process_count}, local_size {topo.local_size}, "
            f"cross_size {topo.cross_size}")
    return group


def local_group():
    """This rank's local group: the ``local_size`` ranks of its host, in
    local-rank order (the reference's ``LOCAL_AXIS``)."""
    return _group("local")


def cross_group():
    """This rank's cross group: the ``cross_size`` ranks of its local
    index on every host, in cross-rank order (``CROSS_AXIS``)."""
    return _group("cross")


def init_axes(shape) -> dict:
    """Carve the world into a grid of named axes, row-major: ``{"dp": 2,
    "tp": 2}`` puts rank ``r`` at ``(r // 2, r % 2)``, the last axis
    fastest, as a mesh reshaped from the rank list lays its devices
    out.  One process group is made per slice of each axis (every rank
    makes every group, in one order: ``new_group`` is collective), and
    this rank's group of each axis is registered, so that
    :func:`group_of_axis` resolves the name.  Every rank calls it after
    :func:`init`, with the same ``shape``, whose sizes must multiply to
    the world size.  A second call replaces the grid.  Returns ``{name:
    index of this rank along it}``.

    This is the process-group view of the reference's mesh axes (the
    ``sp`` / ``tp`` / ``pp`` / ``ep`` axes its schedules name inside
    ``shard_map``); the schedules of ``parallel/`` take these names or a
    process group where the reference takes an axis name."""
    topo = global_topology()
    names = list(shape)
    sizes = [int(shape[n]) for n in names]
    if any(n in (DP_AXIS, LOCAL_AXIS, CROSS_AXIS) for n in names):
        raise ValueError(f"{names} reuses a reserved axis name")
    total = 1
    for n in sizes:
        if n < 1:
            raise ValueError(f"axis sizes must be positive, got {shape}")
        total *= n
    if total != topo.process_count:
        raise ValueError(
            f"axes {dict(shape)} hold {total} ranks; the world has "
            f"{topo.process_count}")
    grid = torch.arange(total).reshape(sizes) if sizes else None
    coords = ([int(c) for c in torch.nonzero(grid == topo.process_rank)[0]]
              if sizes else [])
    axes = {}
    for a, name in enumerate(names):
        # the slices along axis a, in one order on every rank
        lines = grid.movedim(a, -1).reshape(-1, sizes[a])
        for line in lines.tolist():
            group = (dist.group.WORLD if total == 1
                     else dist.new_group(line))
            if topo.process_rank in line:
                axes[name] = group
    with _state_lock:
        _axes.clear()
        _axes.update(axes)
    return dict(zip(names, coords))


def group_of_axis(axis):
    """The process group an axis name stands for: a name of
    :func:`init_axes` its registered group, ``DP_AXIS`` the world (the
    default ``torch.distributed`` group, whoever formed it),
    ``LOCAL_AXIS`` / ``CROSS_AXIS`` this rank's local / cross group of the
    two-level schedules.  A process group passes through unchanged, so
    the schedules take either."""
    if not isinstance(axis, str):
        if axis is None:
            raise ValueError("an axis name or a process group is required")
        return axis
    if axis == LOCAL_AXIS:
        return local_group()
    if axis == CROSS_AXIS:
        return cross_group()
    if axis == DP_AXIS:  # the default group, however it was formed
        return dist.group.WORLD
    global_topology()
    if axis == SLICE_AXIS:
        if axis not in _slice_axes:
            raise ValueError(f"no {SLICE_AXIS!r} group: build mesh('slice') "
                             f"first")
        return _slice_axes[axis]
    if axis not in _axes:
        raise ValueError(
            f"unknown axis {axis!r}; the named axes are {list(_axes)} "
            f"(init_axes), and {DP_AXIS!r}, {LOCAL_AXIS!r}, "
            f"{CROSS_AXIS!r}")
    return _axes[axis]


def slice_grid(ranks, num_slices: int, hosts: int) -> np.ndarray:
    """Reshape a flat rank list into the 3-level (slice, host, rank) view:
    contiguous blocks per slice, contiguous per host within it.  ``hosts``
    is the number of hosts WITHIN one slice (1 when the host level
    degenerates, e.g. a one-host world forced into slices).  The
    reference's pure function (horovod_tpu/basics.py:569-588)."""
    ranks = np.asarray(ranks, dtype=object)
    total = ranks.size
    if num_slices < 1 or total % num_slices:
        raise ValueError(
            f"cannot partition {total} devices into {num_slices} slices")
    per_slice = total // num_slices
    if hosts < 1 or per_slice % hosts:
        raise ValueError(
            f"cannot split a {per_slice}-device slice over {hosts} hosts")
    return ranks.reshape(num_slices, hosts, per_slice // hosts)


def mesh(shape: str = "flat"):
    """The named mesh of the world's ranks (reference ``hvd.mesh``), a
    ``torch.distributed.device_mesh.DeviceMesh`` built once per shape
    (cached until :func:`shutdown`):

    * ``flat``: one dimension, ``DP_AXIS``, over every rank;
    * ``hierarchical``: ``(CROSS_AXIS, LOCAL_AXIS)``, hosts x ranks per host;
    * ``slice``: ``(SLICE_AXIS, CROSS_AXIS, LOCAL_AXIS)``, laid out by
      :func:`slice_grid` (needs a forced slice partition,
      ``HVDTPU_NUM_SLICES`` / ``HVDTPU_SLICE_SIZE``).

    Ranks sit where the reference puts its devices.  A dimension's group is
    the port's own group of that axis, the one :func:`group_of_axis`
    returns (``DeviceMesh.from_group``: no second communicator).  The slice
    mesh's ``SLICE_AXIS`` groups are made here, on every rank in one order,
    and :func:`group_of_axis` resolves them from then on; its
    ``CROSS_AXIS`` dimension is the hosts of one slice, which is the
    two-level cross group only when the job is one slice, so where the two
    differ that dimension gets a group of its own
    (``mesh("slice").get_group(CROSS_AXIS)``).  Every rank calls it with the
    same shape."""
    from torch.distributed.device_mesh import DeviceMesh  # noqa: PLC0415

    topo = global_topology()
    if shape in _mesh_cache:
        return _mesh_cache[shape]
    ranks = np.arange(topo.process_count)
    if shape == "flat":
        grid, names = ranks, (DP_AXIS,)
        groups = [group_of_axis(DP_AXIS)]
    elif shape == "hierarchical":
        hosts = topo.cross_size if topo.process_count > 1 else 1
        if len(ranks) % max(hosts, 1):
            raise ValueError(
                f"cannot build hierarchical mesh: {len(ranks)} devices over "
                f"{hosts} hosts is uneven")
        grid = ranks.reshape(hosts, len(ranks) // max(hosts, 1))
        names = (CROSS_AXIS, LOCAL_AXIS)
        groups = [group_of_axis(CROSS_AXIS), group_of_axis(LOCAL_AXIS)]
    elif shape == "slice":
        if topo.num_slices < 2:
            raise ValueError(
                "mesh('slice') needs a multi-slice topology; force one "
                "with HVDTPU_NUM_SLICES / HVDTPU_SLICE_SIZE on dev worlds")
        n = topo.num_slices
        hosts = (topo.cross_size // n
                 if topo.cross_size > 1 and topo.cross_size % n == 0 else 1)
        grid = slice_grid(ranks, n, hosts).astype(np.int64)
        names = (SLICE_AXIS, CROSS_AXIS, LOCAL_AXIS)
        groups = _slice_groups(grid, topo)
    else:
        raise ValueError(f"unknown mesh shape {shape!r}")
    device_type = topo.device.type
    m = DeviceMesh.from_group(groups if len(groups) > 1 else groups[0],
                              device_type, mesh=torch.as_tensor(grid),
                              mesh_dim_names=names)
    _mesh_cache[shape] = m
    return m


def _slice_groups(grid: np.ndarray, topo: Topology) -> list:
    """This rank's group along each dimension of the slice mesh's
    ``grid``: the two-level local / cross group where a line is exactly
    the ranks of one, else a group made here.  Whether a line is reused is
    decided from the topology alone, so every rank makes the same groups in
    one order, as ``new_group`` requires."""
    me, local_n, cross_n = (topo.process_rank, topo.local_size,
                            topo.cross_size)
    two_level = {}
    if topo.local_group is not None:
        for c in range(cross_n):
            two_level[tuple(c * local_n + l for l in range(local_n))] = \
                topo.local_group
        for l in range(local_n):
            two_level[tuple(c * local_n + l for c in range(cross_n))] = \
                topo.cross_group
    mine = []
    for d in range(grid.ndim):
        lines = np.moveaxis(grid, d, -1).reshape(-1, grid.shape[d])
        own = None
        for line in lines.tolist():
            group = two_level.get(tuple(line))
            if group is None:
                group = dist.new_group(line)
            if me in line:
                own = group
        mine.append(own)
    with _state_lock:
        _slice_axes[SLICE_AXIS] = mine[0]
    return mine


# -- feature probes (the reference's horovod_{mpi,gloo,nccl,...}_built,
# horovod_tpu/basics.py:510-566), answered for the port's transports:
# torch.distributed's NCCL on CUDA and gloo on the CPU. --


def xla_collectives_built() -> bool:
    """Whether collectives compile through XLA: never in the port, whose
    collectives are torch.distributed's."""
    return False


def native_engine_built() -> bool:
    """Whether the native (C++) eager engine's library is built for the
    port's current sources (``runtime/native_build.py``; the reference's
    gloo_built).  ``HVDTPU_EAGER_ENGINE=native`` builds it at first use."""
    from .runtime import native_build  # noqa: PLC0415

    return native_build.built()


def mpi_built() -> bool:
    """Whether the port runs on MPI: no, its rendezvous and collectives are
    torch.distributed's NCCL and gloo."""
    return False


mpi_enabled = mpi_built


def mpi_threads_supported() -> bool:
    """MPI's thread support: False, as the port uses no MPI."""
    return False


def gloo_built() -> bool:
    """Whether torch.distributed has gloo, the port's CPU transport."""
    return dist.is_gloo_available()


gloo_enabled = gloo_built


def nccl_built() -> bool:
    """Whether torch.distributed has NCCL, the port's GPU transport."""
    return dist.is_nccl_available()


def ccl_built() -> bool:
    """oneCCL: not a transport of the port."""
    return False


def ddl_built() -> bool:
    """IBM DDL: not a transport of the port."""
    return False
