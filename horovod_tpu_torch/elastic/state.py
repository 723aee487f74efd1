"""Commit/restore/sync training state for elastic runs (a port of
``horovod_tpu/elastic/state.py``).

Training mutates ``State`` values freely; ``commit()`` snapshots them to
the host as the rollback point; ``restore()`` rewinds to it after a
recoverable failure; ``sync()`` makes the whole (possibly re-formed)
world agree on the newest committed snapshot — a respawned rank with no
history adopts a survivor's state.

What a value may be: a torch tensor, a numpy array, a Python scalar, a
dict / list / tuple of those (the pytree counterpart), an ``nn.Module``
or an optimizer (a ``torch.optim.Optimizer``, ``DistributedOptimizer`` or
``OverlapPlan``), the last two through their ``state_dict``.  A snapshot
holds host copies: CPU tensors, numpy arrays, scalars.

**Restore writes in place.**  ``OverlapPlan`` makes each ``.grad`` a view
into its bucket and, under ZeRO-1, each parameter a view into a flat
buffer that its optimizer's shards are gathered into; a
``DistributedOptimizer`` holds the parameter objects.  So ``restore()``
and a sync that adopts state never rebind a live tensor: tensors take
``copy_``, modules and optimizers ``load_state_dict`` (a ZeRO-1 plan's
shards, which its optimizer steps, are snapshotted and copied back too).
An optimizer's state — AdamW's per-parameter ``step`` and moments —
belongs to the snapshot: restoring a snapshot taken before the first
step clears it.

The checkpoint tier routes through here:

* every ``commit()`` also pushes the committed snapshot to this rank's
  replica key over the signed KV path (``HVDTPU_CKPT_REPLICA=1``,
  ckpt/replica.py);
* ``sync()`` on a freshly respawned incarnation (commit count 0) first
  adopts its predecessor's live replica, then the sharded manifest on
  disk (``HVDTPU_CKPT_DIR``, ckpt/sharded.py), then enters the owner
  election — so recovery touches cold storage only when no live peer
  holds a valid copy;
* the restore *provenance* — ``peer`` (live replica or a surviving
  rank's broadcast), ``disk`` (sharded manifest), ``none`` (fresh
  start) — lands in the metrics registry (``ckpt.restore_source``,
  ``ckpt.restore_ms``) and :attr:`State.last_restore`.

Snapshots travel (replica push, owner election) as one pickle of the
flattened tree (``ckpt/tree.py``): numpy leaves, bfloat16 as raw words,
so no ``ml_dtypes`` is needed.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..obs import flightrec as _flightrec
from ..obs import get_registry
from ..ckpt import tree as _tree
from ..utils import env as envmod
from ..utils.logging import get_logger
from .context import context as _ambient_context
from .exceptions import WorkersAvailableException

LOG = get_logger("elastic")

__all__ = ["State", "dumps_snapshot", "loads_snapshot"]


def _stateful(x) -> bool:
    """An optimizer (or a wrapper of one): restored through its
    ``state_dict`` / ``load_state_dict``."""
    return (not isinstance(x, nn.Module) and hasattr(x, "state_dict")
            and hasattr(x, "load_state_dict")
            and hasattr(x, "param_groups"))


def _zero1_shards(x):
    """The flat parameter shards a ZeRO-1 ``OverlapPlan`` steps (its
    optimizer's parameters), or None."""
    return list(x.shards) if getattr(x, "sharded_state", False) else None


def _clone(tree):
    """Host-side deep copy: tensors land as fresh CPU tensors, numpy
    arrays as fresh arrays, modules and optimizers as copies of their
    ``state_dict``; everything else deep-copies."""
    if isinstance(tree, nn.Module):
        return {k: _clone(v) for k, v in tree.state_dict().items()}
    if _stateful(tree):
        sd = _clone(tree.state_dict())
        shards = _zero1_shards(tree)
        if shards is None:
            return sd
        return {"optimizer": sd, "shards": [_clone(s.detach())
                                            for s in shards]}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.clone() if t.device.type == "cpu" else t.to("cpu")
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return copy.deepcopy(tree)


@torch.no_grad()
def _write_back(live, snap):
    """Write snapshot ``snap`` into the live value ``live`` in place
    where it can be (same kind, shape and dtype) and return the value the
    state now holds: ``live`` itself, or a fresh copy of ``snap``."""
    if isinstance(live, nn.Module):
        live.load_state_dict(snap)
        return live
    if _stateful(live):
        shards = _zero1_shards(live)
        if shards is not None:
            for shard, saved in zip(shards, snap["shards"]):
                shard.copy_(saved)
            snap = snap["optimizer"]
        # a copy: load_state_dict keeps tensors already on the right
        # device as they are, and the optimizer's in-place updates must
        # not reach the snapshot
        live.load_state_dict(_clone(snap))
        return live
    if isinstance(live, torch.Tensor) and isinstance(snap, torch.Tensor) \
            and live.shape == snap.shape and live.dtype == snap.dtype:
        live.copy_(snap)
        return live
    if isinstance(live, np.ndarray) and isinstance(snap, np.ndarray) \
            and live.shape == snap.shape and live.dtype == snap.dtype \
            and live.flags.writeable:
        live[...] = snap
        return live
    if isinstance(live, dict) and isinstance(snap, dict):
        for k in [k for k in live if k not in snap]:
            del live[k]
        for k, v in snap.items():
            live[k] = _write_back(live.get(k), v)
        return live
    if isinstance(live, list) and isinstance(snap, list) \
            and len(live) == len(snap):
        live[:] = [_write_back(a, b) for a, b in zip(live, snap)]
        return live
    if isinstance(live, tuple) and isinstance(snap, tuple) \
            and len(live) == len(snap):
        return type(live)(_write_back(a, b) for a, b in zip(live, snap))
    if isinstance(live, torch.Tensor) and isinstance(snap, torch.Tensor):
        return snap.to(live.device, copy=True)
    return _clone(snap)


def dumps_snapshot(snapshot, commits: int) -> bytes:
    """One pickle of ``(snapshot, commits)`` (``ckpt/tree.py``'s
    :func:`~..ckpt.tree.dumps`): what the replica tier pushes and the
    owner election broadcasts."""
    return _tree.dumps((snapshot, int(commits)))


def loads_snapshot(blob: bytes):
    """Inverse of :func:`dumps_snapshot`: ``(snapshot, commits)``."""
    return _tree.loads(blob)


class State:
    """A bag of named training objects with commit/rollback semantics.

    >>> state = State(model=model, opt=opt, step=0)
    >>> state.step += 1          # attribute access hits the live values
    >>> state.commit()           # rollback point (+ replica push)
    >>> state.restore()          # rewind to the last commit, in place
    """

    def __init__(self, **values: Any):
        # object.__setattr__ for internals so __setattr__ below can route
        # everything non-underscore into the value dict.
        object.__setattr__(self, "_values", dict(values))
        object.__setattr__(self, "_snapshot", _clone(values))
        object.__setattr__(self, "_commits", 0)
        # Commits made by THIS incarnation (vs. adopted through the
        # recovery tier) and the one-shot provenance latch: a first
        # sync() interrupted mid-election and retried must still
        # record where this incarnation's state came from —
        # `_commits == 0` can't tell, because adoption already bumped
        # it.
        object.__setattr__(self, "_own_commits", 0)
        object.__setattr__(self, "_provenance_pending", True)
        object.__setattr__(self, "_ctx", None)
        # Checkpoint tier: None = not probed yet, False = probed and
        # absent (knob off / no KV endpoint), else the ReplicaTier.
        object.__setattr__(self, "_replica_tier", None)
        object.__setattr__(
            self, "_ckpt_dir", os.environ.get(envmod.CKPT_DIR) or None
        )
        object.__setattr__(self, "_last_restore", None)

    # -- attribute routing ------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        values: Dict[str, Any] = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(
            f"elastic State has no value {name!r}; registered: "
            f"{sorted(values)}"
        )

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._values[name] = value

    def register(self, **values: Any) -> None:
        """Add more objects to the state (tracked from the next commit)."""
        self._values.update(values)

    @property
    def commits(self) -> int:
        """Number of commits applied (the freshness key sync elects on)."""
        return self._commits

    @property
    def last_restore(self) -> Optional[dict]:
        """Provenance of this incarnation's recovery, set by its first
        completed ``sync()``: ``{"source": "peer"|"disk"|"none",
        "commits": N, "ms": float, "replica_adopted": bool}``.  None
        only before that first sync.  An incarnation that recovered
        nothing — a job-start rank, or the surviving side of a failure
        — reports ``source="none"``."""
        return self._last_restore

    def values(self) -> Dict[str, Any]:
        return dict(self._values)

    # -- checkpoint tier --------------------------------------------------

    def _tier(self, ctx=None):
        """The ambient replica tier, probed once and kept fresh with the
        current world (membership changes move the ring neighbor)."""
        tier = self._replica_tier
        if tier is None:
            from ..ckpt.replica import tier_from_env  # noqa: PLC0415

            ctx = ctx or self._ctx
            tier = tier_from_env(ctx)
            object.__setattr__(self, "_replica_tier",
                               tier if tier is not None else False)
        if tier in (None, False):
            return None
        ctx = ctx or self._ctx
        if ctx is not None and getattr(ctx, "world", None):
            tier.rank = ctx.rank
            tier.world = sorted(ctx.world)
        return tier

    def _push_replica(self) -> None:
        tier = self._tier()
        if tier is None:
            return
        blob = dumps_snapshot(self._snapshot, self._commits)
        tier.push(blob, step=self._commits, commits=self._commits)

    def save_sharded(self, directory: Optional[str] = None,
                     step: Optional[int] = None, *, ctx=None):
        """Sharded save of the last committed snapshot (the disk tier):
        this rank writes only its own shard; rank 0 commits the
        manifest (with the commit count in ``extra``) last.  Returns a
        :class:`~..ckpt.sharded.ShardedSave` handle — ``wait()`` is the
        commit point.  ``directory`` defaults to ``HVDTPU_CKPT_DIR``."""
        directory = directory or self._ckpt_dir
        if not directory:
            raise ValueError(
                "no checkpoint directory: pass one or set HVDTPU_CKPT_DIR"
            )
        ctx = ctx or self._ctx or _ambient_context()
        from ..ckpt import sharded as _sharded  # noqa: PLC0415

        # Shard by POSITION in the world, not by raw rank: an elastic
        # shrink can leave gaps (world {0, 2} is 2 writers), and the
        # sharded format wants dense writer indices [0, world_size).
        world = sorted(ctx.world) if getattr(ctx, "world", None) else [0]
        try:
            shard_index = world.index(ctx.rank)
        except ValueError:
            raise RuntimeError(
                f"rank {ctx.rank} is not in the current world {world}; "
                f"re-rendezvous before saving"
            ) from None
        return _sharded.save_sharded_async(
            directory,
            self._snapshot,
            int(self._commits if step is None else step),
            rank=shard_index,
            world_size=len(world),
            extra={"commits": self._commits,
                   "epoch": getattr(ctx, "epoch", 0)},
        )

    # -- commit discipline ------------------------------------------------

    def commit(self) -> None:
        """Snapshot the live values as the rollback point and push the
        replica.

        When the launcher has re-minted the rendezvous epoch since this
        rank last rendezvoused, raises :class:`WorkersAvailableException`
        AFTER taking the snapshot and pushing the replica — the commit
        is durable (and its replica live) either way, and
        ``elastic.run`` re-rendezvouses before the next step touches
        the stale world."""
        object.__setattr__(self, "_snapshot", _clone(self._values))
        object.__setattr__(self, "_commits", self._commits + 1)
        object.__setattr__(self, "_own_commits", self._own_commits + 1)
        self._push_replica()
        ctx = self._ctx
        if ctx is not None and ctx.world_changed():
            raise WorkersAvailableException(
                f"rendezvous epoch advanced past {ctx.epoch}; "
                f"re-rendezvous before the next step"
            )

    def restore(self) -> None:
        """Rewind the live values to the last commit (initial values when
        nothing has been committed yet), in place."""
        self._write_back(self._snapshot)

    def _write_back(self, snapshot) -> None:
        values = self._values
        for name, snap in snapshot.items():
            values[name] = _write_back(values.get(name), snap)

    def _adopt(self, snapshot, commits: int) -> None:
        object.__setattr__(self, "_snapshot", snapshot)
        object.__setattr__(self, "_commits", int(commits))

    def _fetch_replica(self, ctx):
        """This rank's predecessor's live replica as ``(snapshot,
        commits)``; None when no peer holds a valid copy (missing,
        torn, checksum-rejected)."""
        tier = self._tier(ctx)
        if tier is None:
            return None
        got = tier.fetch(getattr(ctx, "rank", 0))
        if got is None:
            return None
        payload, meta = got
        try:
            snapshot, commits = loads_snapshot(payload)
        except Exception as exc:
            LOG.warning("peer replica unreadable (%s); falling back", exc)
            get_registry().counter("ckpt.replica_invalid").inc()
            return None
        if int(commits) <= 0:
            return None
        return snapshot, int(commits)

    def _peek_disk_commits(self):
        """The newest manifest's commit count from its metadata ALONE —
        no shard reads, no checksums.  The freshness compare against
        the replica must not cost a full checkpoint read when the
        replica (the common case) is going to win anyway."""
        if not self._ckpt_dir:
            return None
        from ..ckpt import sharded as _sharded  # noqa: PLC0415

        step = _sharded.latest_step(self._ckpt_dir)
        if step is None:
            return None
        manifest = _sharded.load_manifest(self._ckpt_dir, step)
        if manifest is None:
            return None
        commits = int((manifest.get("extra") or {}).get("commits", step))
        return commits if commits > 0 else None

    def _fetch_disk(self):
        """The newest restorable sharded manifest on disk as
        ``(snapshot, commits)``; None when the directory is unset,
        empty, or nothing validates."""
        if not self._ckpt_dir:
            return None
        from ..ckpt import sharded as _sharded  # noqa: PLC0415

        try:
            # The manifest's own structure, not this incarnation's
            # snapshot as the target: an optimizer's state before its
            # first step is empty, so the structures differ by design
            # (load_state_dict checks what is written back).
            snapshot, manifest = _sharded.restore_sharded(
                self._ckpt_dir, with_manifest=True
            )
        except FileNotFoundError:
            return None
        except Exception as exc:
            LOG.warning("disk checkpoint restore failed (%s); starting "
                        "from initial values", exc)
            return None
        commits = int((manifest.get("extra") or {}).get(
            "commits", manifest["step"]))
        if commits <= 0:
            return None
        return snapshot, commits

    def sync(self, ctx=None) -> None:
        """Make every rank in the current world hold the newest committed
        snapshot, written into the live values in place.

        A freshly respawned incarnation (commit count 0) recovers
        through the tier first — live peer replica, then sharded disk
        manifest — and only then enters the owner election (highest
        commit count, ties: lowest rank), so whichever source is
        newest wins on every rank.  The recovery provenance is
        recorded; see :attr:`last_restore`."""
        ctx = ctx or self._ctx or _ambient_context()
        t0 = time.monotonic()
        # "Fresh" = this incarnation has never committed AND has not
        # yet recorded its provenance — NOT `_commits == 0`: a first
        # sync that adopted a replica and was then interrupted by a
        # cascading failure retries with adopted commits > 0, and the
        # retry must still probe the tiers and record the provenance.
        fresh = self._provenance_pending and self._own_commits == 0
        adopted = None
        adopted_commits = 0
        if fresh:
            # Probe BOTH local tiers and adopt the freshest — a stale
            # replica (its last push dropped or raced the kill) must
            # never shadow a newer durable manifest.  The disk probe is
            # metadata-only; shards are read (and checksummed) ONLY
            # when disk can actually win, so the common peer-restore
            # path never touches cold storage.  Ties prefer the
            # replica: identical state, and it proves the hot tier.
            replica = self._fetch_replica(ctx)
            disk = None
            disk_hint = self._peek_disk_commits()
            if disk_hint is not None and (replica is None
                                          or disk_hint > replica[1]):
                disk = self._fetch_disk()
            if replica is not None and (disk is None
                                        or replica[1] >= disk[1]):
                adopted, (snapshot, adopted_commits) = "peer", replica
                self._adopt(snapshot, adopted_commits)
            elif disk is not None:
                adopted, (snapshot, adopted_commits) = "disk", disk
                self._adopt(snapshot, adopted_commits)
        blob = ctx.sync_state(
            lambda: dumps_snapshot(self._snapshot, self._commits),
            self._commits)
        if blob is not None:  # another rank's state won the election
            snapshot, commits = loads_snapshot(blob)
            object.__setattr__(self, "_snapshot", snapshot)
            object.__setattr__(self, "_commits", commits)
        commits = self._commits
        self._write_back(self._snapshot)
        if not fresh:
            return
        if int(commits) <= 0:
            source = "none"
        elif adopted is not None and adopted_commits >= int(commits):
            # The locally adopted tier was at least as fresh as the
            # election winner, so the state this rank holds is (bit for
            # bit) what that tier supplied — even when a tied survivor
            # technically won the broadcast.
            source = adopted
        else:
            # The election overrode local adoption (or there was
            # nothing to adopt): the state came out of a live peer's
            # memory via the broadcast.
            source = "peer"
        ms = (time.monotonic() - t0) * 1e3
        # replica_adopted distinguishes "my predecessor's replica held
        # the state I now run with" from "a surviving peer broadcast to
        # me" — both are source=peer, but only the former proves the
        # replica tier.  A stale replica the election overrode does NOT
        # count, or a broken tier would pass every provenance check.
        replica_ok = (adopted == "peer"
                      and adopted_commits >= int(commits)
                      and int(commits) > 0)
        object.__setattr__(self, "_last_restore", {
            "source": source, "commits": int(commits), "ms": ms,
            "replica_adopted": replica_ok,
        })
        object.__setattr__(self, "_provenance_pending", False)
        # Quiet jobs stay quiet: a fresh start in a job with NO ckpt
        # tier configured is not a recovery event.
        armed = self._tier(ctx) is not None or bool(self._ckpt_dir)
        if source == "none" and not armed:
            return
        metrics = get_registry()
        metrics.counter("ckpt.restore_source", source=source).inc()
        if source != "none":
            metrics.histogram("ckpt.restore_ms").observe(ms)
        _flightrec.record(
            "ckpt.restore", name=f"commit{int(commits)}",
            cycle=int(commits),
            detail=f"source={source} replica={replica_ok} ms={ms:.0f}",
        )
