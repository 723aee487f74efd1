"""Host blacklist with exponential-backoff re-admission (a copy of
``horovod_tpu/run/blacklist.py``).

The elastic launcher's memory of which hosts keep killing workers
(upstream analog: the elastic driver's host blacklist in
horovod/runner/elastic/discovery.py, which a fixed cooldown re-admits;
here the cooldown doubles per repeat failure so a flapping host backs
off geometrically instead of thrashing the respawn budget).

Single-host degenerate case: when EVERY candidate is blacklisted the
selector returns the one whose re-admission lands soonest rather than
deadlocking — on a localhost-only job the only host is also the only
place a respawn can go, and failing the job because its one host had one
crash would make the blacklist strictly worse than no blacklist.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set

from ..utils.logging import get_logger

__all__ = ["HostBlacklist"]

LOG = get_logger("blacklist")

DEFAULT_COOLDOWN_BASE_SECS = 10.0
DEFAULT_COOLDOWN_CAP_SECS = 300.0


@dataclass
class _Entry:
    failures: int = 0
    readmit_at: float = 0.0


class HostBlacklist:
    """Tracks per-host failures; a host is inadmissible until its
    cooldown (base * 2^(failures-1), capped) elapses."""

    def __init__(
        self,
        cooldown_base: float = DEFAULT_COOLDOWN_BASE_SECS,
        cooldown_cap: float = DEFAULT_COOLDOWN_CAP_SECS,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cooldown_base = cooldown_base
        self.cooldown_cap = cooldown_cap
        self._clock = clock
        self._hosts: Dict[str, _Entry] = {}
        # Slice-level memory (multislice jobs): which hosts of each
        # slice have failed, and which slices have been blacklisted
        # wholesale.  A slice whose DCN link or shared power domain is
        # bad kills its hosts one by one; waiting to blacklist them
        # individually burns one respawn per host on a doomed slice.
        self._slice_failed: Dict[int, Set[str]] = {}
        # slice -> readmit_at of its wholesale hold; once the hold
        # expires the slice gets a CLEAN failure window (stale failures
        # must neither instantly re-blacklist a recovered slice nor —
        # the opposite bug — block a persistently bad one from ever
        # being held out again).
        self._slices_out: Dict[int, float] = {}

    def record_failure(
        self,
        host: str,
        *,
        slice_id: Optional[int] = None,
        slice_hosts: Optional[Sequence[str]] = None,
    ) -> int:
        """Register a worker failure on ``host``; returns the host's
        total failure count.

        With ``slice_id``/``slice_hosts`` (the launcher's view of which
        slice the failed rank belonged to and every host in it), a
        QUORUM of distinct failed hosts — strictly more than half the
        slice — blacklists the WHOLE slice: every member host gets the
        failed hosts' longest cooldown, so the next respawn lands on a
        healthy slice instead of the next victim of the same fabric."""
        entry = self._hosts.setdefault(host, _Entry())
        entry.failures += 1
        cooldown = min(
            self.cooldown_base * (2 ** (entry.failures - 1)),
            self.cooldown_cap,
        )
        entry.readmit_at = self._clock() + cooldown
        if slice_id is not None and slice_hosts:
            members = set(slice_hosts)
            now = self._clock()
            if (
                slice_id in self._slices_out
                and now >= self._slices_out[slice_id]
            ):
                # The previous wholesale hold expired: fresh window —
                # only failures AFTER readmission count toward the next
                # quorum, and a still-bad slice can be held out again.
                del self._slices_out[slice_id]
                self._slice_failed[slice_id] = set()
            failed = self._slice_failed.setdefault(slice_id, set())
            failed.add(host)
            if (
                slice_id not in self._slices_out
                and 2 * len(failed & members) > len(members)
            ):
                worst = max(
                    self._hosts[h].readmit_at
                    for h in failed & members
                    if h in self._hosts
                )
                self._slices_out[slice_id] = worst
                for h in members:
                    e = self._hosts.setdefault(h, _Entry())
                    e.readmit_at = max(e.readmit_at, worst)
                LOG.warning(
                    "slice %d blacklisted: %d/%d of its hosts failed "
                    "(%s); all member hosts held out until the longest "
                    "cooldown elapses",
                    slice_id, len(failed & members), len(members),
                    ",".join(sorted(failed & members)),
                )
        return entry.failures

    def blacklisted_slices(self) -> List[int]:
        """Slices currently held out wholesale by the failure quorum (a
        slice re-admits implicitly when its hold expires — and becomes
        eligible for a fresh quorum if its hosts keep failing)."""
        now = self._clock()
        return sorted(
            s for s, readmit_at in self._slices_out.items()
            if now < readmit_at
        )

    def failures(self, host: str) -> int:
        entry = self._hosts.get(host)
        return entry.failures if entry else 0

    def is_admissible(self, host: str) -> bool:
        """Clean hosts and hosts whose cooldown has elapsed are fair
        game; re-admission is implicit (no state change needed)."""
        entry = self._hosts.get(host)
        return entry is None or self._clock() >= entry.readmit_at

    def readmission_in(self, host: str) -> float:
        """Seconds until ``host`` is admissible again (0 when it already
        is)."""
        entry = self._hosts.get(host)
        if entry is None:
            return 0.0
        return max(entry.readmit_at - self._clock(), 0.0)

    def select(self, hosts: Sequence[str],
               prefer: Optional[str] = None) -> str:
        """Pick a respawn host: ``prefer`` (the failed rank's original
        host) if admissible, else the first admissible candidate in
        order, else the candidate closest to re-admission (degraded
        single-host mode — see module docstring)."""
        if not hosts:
            raise ValueError("no candidate hosts")
        if prefer is not None and prefer in hosts \
                and self.is_admissible(prefer):
            return prefer
        for host in hosts:
            if self.is_admissible(host):
                return host
        return min(hosts, key=lambda h: (self.readmission_in(h),
                                         hosts.index(h)))

    def blacklisted(self) -> List[str]:
        now = self._clock()
        return sorted(
            h for h, e in self._hosts.items() if now < e.readmit_at
        )
