"""Peer-replica tier: committed state kept live, restore without disk (a
copy of ``horovod_tpu/ckpt/replica.py``).

The elastic launcher can respawn a dead rank in seconds, but the
respawned incarnation still has to get its state from somewhere.  The
durable floor is the sharded manifest on disk (ckpt/sharded.py); this
tier keeps a *hot* copy so the common case — one preempted rank in an
otherwise healthy job — never touches cold storage (Ray's
lineage/supervision pattern, PAPERS.md, specialized to SPMD):

* **Push on commit** — after every commit, each rank pushes its shard
  (chunked at ``HVDTPU_CKPT_REPLICA_CHUNK_KB``, SHA-256-checksummed) to
  its ring neighbor's replica key over the launcher's HMAC-signed KV
  path — the same authenticated transport heartbeats and rendezvous
  already trust.  The meta record is written LAST and chunk keys are
  step-namespaced, so a rank dying mid-push leaves the *previous*
  replica intact and readable, never a torn one.
* **Fetch on respawn** — a respawned incarnation asks for the replica
  its predecessor pushed.  Checksum or chunk-count mismatch, or a
  replica from a different job generation, makes :meth:`fetch` return
  ``None`` — the caller falls back to disk.  Old-step chunks are
  garbage-collected (authenticated DELETE) after each successful push.
* **Honest limits** — replicas live in the launcher-resident KV store's
  memory: they survive any number of *rank* deaths but die with the
  launcher/job.  Disk is still the durability floor; this tier is the
  fast path above it, not a replacement.

The ``drop_replica`` fault action (``HVDTPU_FAULT_SPEC=
"replica_push:rank=1:action=drop_replica"``) deterministically
suppresses a push, so stale-replica recovery is testable.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import List, Optional, Tuple

from ..obs import flightrec as _flightrec
from ..obs import get_registry
from ..testing.faults import maybe_fail
from ..utils import env as envmod
from ..utils.logging import get_logger

LOG = get_logger("ckpt")

SCOPE = "ckptrep"

__all__ = ["SCOPE", "ReplicaTier", "tier_from_env", "job_fingerprint"]


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def job_fingerprint(kv) -> str:
    """Job identity derived from the per-job HMAC secret — the guard
    every KV-resident artifact that must not outlive its job stamps
    itself with.  A *different* secret already fails the transport MAC;
    this closes the same-secret-endpoint-reuse case.  Shared by the
    replica tier below and the weight hot-swap announce channel
    (serve/hotswap.py), so both planes reject a recycled endpoint the
    same way."""
    secret = getattr(kv, "_secret", "") or ""
    return hashlib.sha256(
        b"hvdtpu-ckpt-job:" + secret.encode()
    ).hexdigest()[:16]


class ReplicaTier:
    """One rank's handle on the replica plane.

    ``kv`` is a :class:`~..run.rendezvous.KVStoreClient` (HMAC-signed);
    ``world`` is the current membership list, used only to pick the
    ring neighbor recorded as the replica's holder — the key space is
    per-owner, so membership changes never orphan a replica."""

    def __init__(self, kv, rank: int, world: Optional[List[int]] = None,
                 *, chunk_bytes: Optional[int] = None):
        self.kv = kv
        self.rank = int(rank)
        self.world = sorted(world) if world else [self.rank]
        if chunk_bytes is None:
            chunk_bytes = envmod.env_int(
                envmod.CKPT_REPLICA_CHUNK_KB,
                envmod.DEFAULT_REPLICA_CHUNK_KB,
            ) * 1024
        self.chunk_bytes = max(int(chunk_bytes), 1)
        # Job fingerprint: a long-lived/reused KV endpoint must never
        # serve one job's replica to the next job's 0-commit respawn as
        # its own predecessor's state (see job_fingerprint above).
        self.job_id = job_fingerprint(kv)

    # ------------------------------------------------------------ topology

    def holder(self, owner: Optional[int] = None) -> int:
        """The ring neighbor that nominally holds ``owner``'s replica
        (next member in sorted world order).  Observability only: the
        replica bytes live in the KV store either way."""
        owner = self.rank if owner is None else int(owner)
        world = self.world if owner in self.world else sorted(
            set(self.world) | {owner}
        )
        i = world.index(owner)
        return world[(i + 1) % len(world)]

    # ---------------------------------------------------------------- push

    def push(self, payload: bytes, *, step: int,
             commits: Optional[int] = None) -> bool:
        """Push this rank's committed shard.  Chunks first, meta LAST —
        the meta rename is the replica's commit point, so a mid-push
        death leaves the previous version valid.  Returns False when a
        ``drop_replica`` fault suppressed the push (chaos) or the KV
        store is unreachable (launcher going down — never fatal: the
        commit itself already succeeded)."""
        if maybe_fail("replica_push", step=step,
                      rank=self.rank) == "drop_replica":
            get_registry().counter("ckpt.replica_dropped").inc()
            LOG.warning("replica push for step %d suppressed by "
                        "drop_replica fault", step)
            return False
        t0 = time.monotonic()
        checksum = _sha256(payload)
        # memoryview slices: a snapshot of a full-width model (1.6 GB for
        # gpt-small with AdamW) must not be copied once more into chunks
        view = memoryview(payload)
        chunks = [view[i:i + self.chunk_bytes]
                  for i in range(0, len(payload), self.chunk_bytes)] or [b""]
        meta = {
            "step": int(step),
            "commits": int(step if commits is None else commits),
            "chunks": len(chunks),
            "bytes": len(payload),
            "checksum": checksum,
            "holder": self.holder(),
            "job": self.job_id,
            "pushed_at": time.time(),
        }
        written = 0
        try:
            for i, chunk in enumerate(chunks):
                self.kv.put(SCOPE, f"o{self.rank}.s{step}.c{i}", chunk)
                written = i + 1
            old = self._meta()
            self.kv.put(SCOPE, f"owner_{self.rank}",
                        json.dumps(meta).encode())
            if old is not None and old.get("step") != meta["step"]:
                self._gc(old)
        except Exception as exc:
            # The KV store going away mid-push (launcher teardown) must
            # not fail the commit that triggered the push — and the
            # chunks this attempt DID land are unreachable (the meta
            # still names the previous step), so sweep them rather
            # than leak a snapshot's worth of store memory per failure.
            LOG.warning("replica push for step %d failed: %s", step, exc)
            get_registry().counter("ckpt.replica_push_errors").inc()
            self._gc({"step": step, "chunks": written})
            return False
        metrics = get_registry()
        metrics.histogram("ckpt.replica_push_ms").observe(
            (time.monotonic() - t0) * 1e3
        )
        metrics.counter("ckpt.replica_pushes").inc()
        metrics.counter("ckpt.replica_push_bytes").inc(len(payload))
        _flightrec.record(
            "ckpt.replica_push", name=f"step{step}", cycle=int(step),
            detail=f"bytes={len(payload)} chunks={len(chunks)} "
                   f"holder={meta['holder']}",
        )
        return True

    def _meta(self, owner: Optional[int] = None) -> Optional[dict]:
        owner = self.rank if owner is None else int(owner)
        try:
            raw = self.kv.get(SCOPE, f"owner_{owner}")
        except Exception as exc:
            # Transport/auth failure reads as "no replica" — the
            # recovery path must degrade to disk, never crash in sync.
            LOG.warning("replica meta fetch for rank %d failed: %s",
                        owner, exc)
            return None
        if raw is None:
            return None
        try:
            return json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            return None

    def _gc(self, old_meta: dict, owner: Optional[int] = None) -> None:
        """Best-effort delete of a superseded replica's chunks."""
        owner = self.rank if owner is None else int(owner)
        step = old_meta.get("step")
        for i in range(int(old_meta.get("chunks") or 0)):
            try:
                self.kv.delete(SCOPE, f"o{owner}.s{step}.c{i}")
            except Exception:
                return  # launcher going down; leak is bounded anyway

    # --------------------------------------------------------------- fetch

    def fetch(self, owner: Optional[int] = None
              ) -> Optional[Tuple[bytes, dict]]:
        """The newest valid replica pushed for ``owner`` (default: this
        rank — the respawn path asks for its predecessor's).  Returns
        ``(payload, meta)``, or None when no replica exists, a chunk is
        missing (push died before its meta landed... then meta is old
        and chunks exist; a *gc race* can still lose one), or the
        checksum fails — every None means "fall back to disk"."""
        owner = self.rank if owner is None else int(owner)
        meta = self._meta(owner)
        if meta is None:
            return None
        if meta.get("job") != self.job_id:
            # Another job's leftover on a reused KV endpoint: valid
            # bytes, wrong universe — never adopt it.
            get_registry().counter("ckpt.replica_invalid").inc()
            LOG.warning(
                "replica for rank %d belongs to a different job "
                "(fingerprint %s != %s); ignoring it", owner,
                meta.get("job"), self.job_id,
            )
            return None
        step = meta.get("step")
        parts = []
        try:
            for i in range(int(meta.get("chunks") or 0)):
                raw = self.kv.get(SCOPE, f"o{owner}.s{step}.c{i}")
                if raw is None:
                    get_registry().counter("ckpt.replica_invalid").inc()
                    return None
                parts.append(raw)
        except Exception as exc:
            LOG.warning("replica fetch for rank %d failed: %s", owner, exc)
            return None
        payload = b"".join(parts)
        if _sha256(payload) != meta.get("checksum"):
            get_registry().counter("ckpt.replica_invalid").inc()
            LOG.warning(
                "replica for rank %d (step %s) failed checksum "
                "validation; ignoring it", owner, step,
            )
            return None
        return payload, meta


def tier_from_env(ctx=None) -> Optional[ReplicaTier]:
    """Build the ambient tier when ``HVDTPU_CKPT_REPLICA`` is on.

    Under the elastic launcher the tier rides the rendezvous store (the
    worker's :class:`ElasticContext` supplies client, rank, and world);
    outside it, ``HVDTPU_ELASTIC_KV``/``HVDTPU_LIVE_KV`` name the
    endpoint directly.  None when the knob is off or no KV endpoint
    exists — callers degrade to disk."""
    import os  # noqa: PLC0415

    if not envmod.env_bool(envmod.CKPT_REPLICA):
        return None
    if ctx is not None and getattr(ctx, "kv", None) is not None:
        return ReplicaTier(ctx.kv, ctx.rank, list(ctx.world))
    addr = (os.environ.get("HVDTPU_ELASTIC_KV")
            or os.environ.get(envmod.LIVE_KV))
    if not addr:
        return None
    from ..run.rendezvous import KVStoreClient  # noqa: PLC0415
    from ..utils.env import resolve_rank  # noqa: PLC0415

    return ReplicaTier(KVStoreClient(addr), resolve_rank(0))
