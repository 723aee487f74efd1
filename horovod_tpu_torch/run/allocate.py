"""Host/slot allocation (a copy of ``horovod_tpu/run/allocate.py``).

Reference: horovod/run/gloo_run.py:54-112 (`_allocate`) — parse a hosts
string like ``h1:2,h2:2`` into per-process SlotInfo carrying the three
communicator coordinates (rank / local_rank / cross_rank and their sizes,
≙ Communicator GLOBAL/LOCAL/CROSS, horovod/common/common.h:111-115).

The local axis is the processes of one host (one GPU each, NVLink), the
cross axis one process per host."""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class HostSlots:
    hostname: str
    slots: int


@functools.lru_cache(maxsize=1)
def _local_names() -> tuple:
    # getfqdn() can block on DNS; both names are process-invariant, so
    # resolve once (launch paths call is_local_host per host and per slot).
    import socket

    return ("localhost", "127.0.0.1", socket.gethostname(), socket.getfqdn())


def is_local_host(name: str) -> bool:
    """One definition of "this machine" for every launcher component."""
    return name in _local_names()


def routable_ip(probe_host: str) -> str:
    """The local address a remote host would reach us on.  A connected UDP
    socket never sends a packet but makes the kernel pick the outbound
    interface — immune to the Debian /etc/hosts 127.0.1.1 hostname trap
    that gethostbyname(gethostname()) falls into.  Shared by the launcher
    (KV-store address) and the native engine's mesh rendezvous."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((probe_host, 9))
        return s.getsockname()[0]
    except OSError:
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
    finally:
        s.close()


@dataclass(frozen=True)
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_hosts(hosts: str) -> List[HostSlots]:
    """``"h1:2,h2:2"`` -> [HostSlots(h1,2), HostSlots(h2,2)] (reference
    runner.py hosts arg; also accepts bare hostnames meaning 1 slot)."""
    out: List[HostSlots] = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^(?P<host>[^:]+)(:(?P<slots>\d+))?$", part)
        if m is None:
            raise ValueError(f"bad host specification: {part!r}")
        out.append(
            HostSlots(m.group("host"), int(m.group("slots") or 1))
        )
    if not out:
        raise ValueError("empty hosts specification")
    return out


def parse_hostfile(path: str) -> List[HostSlots]:
    """Hostfile lines ``hostname slots=N`` (reference runner.py:553-565)."""
    out: List[HostSlots] = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            m = re.match(r"^(?P<host>\S+)(\s+slots\s*=\s*(?P<slots>\d+))?$", line)
            if m is None:
                raise ValueError(f"bad hostfile line: {line!r}")
            out.append(HostSlots(m.group("host"), int(m.group("slots") or 1)))
    return out


def slice_assignment(np: int, num_slices: int) -> List[int]:
    """rank -> slice id for a forced multislice partition: ``num_slices``
    contiguous equal blocks of ranks (the same contiguous-block rule
    ``basics.slice_of_rank`` applies inside the workers, so the launcher
    and the data plane always agree which slice a rank is in).

    Raises when the partition cannot be even — the launcher should
    refuse a bad ``--num-slices`` before spawning anything, not let every
    worker discover it independently."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if np % num_slices:
        raise ValueError(
            f"--num-slices {num_slices} does not divide np={np}: slices "
            f"must be equal (the hierarchical schedule's cross-fabric "
            f"shard math is only rank-symmetric over equal slices)"
        )
    per = np // num_slices
    return [r // per for r in range(np)]


def allocate(hosts: List[HostSlots], np: int) -> List[SlotInfo]:
    """Fill slots host-by-host up to ``np`` processes (reference
    gloo_run.py:54-112: ranks assigned in host order; local_rank within
    host; cross_rank = index of host among hosts that have this
    local_rank)."""
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested np={np} processes but hosts provide only {total} "
            f"slots"
        )
    # slots actually used per host, in order
    used: List[HostSlots] = []
    remaining = np
    for h in hosts:
        take = min(h.slots, remaining)
        if take > 0:
            used.append(HostSlots(h.hostname, take))
        remaining -= take
        if remaining == 0:
            break

    # For a given local_rank, the cross communicator is the set of hosts
    # that have that slot; cross_rank is this host's index *within that
    # set* (not the global host index — they differ when hosts have
    # heterogeneous slot counts).
    cross_sizes: Dict[int, int] = {}
    for h in used:
        for lr in range(h.slots):
            cross_sizes[lr] = cross_sizes.get(lr, 0) + 1

    slots: List[SlotInfo] = []
    rank = 0
    cross_seen: Dict[int, int] = {}
    for h in used:
        for lr in range(h.slots):
            cross_rank = cross_seen.get(lr, 0)
            cross_seen[lr] = cross_rank + 1
            slots.append(
                SlotInfo(
                    hostname=h.hostname,
                    rank=rank,
                    size=np,
                    local_rank=lr,
                    local_size=h.slots,
                    cross_rank=cross_rank,
                    cross_size=cross_sizes[lr],
                )
            )
            rank += 1
    return slots
