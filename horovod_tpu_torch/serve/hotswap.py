"""Live weight hot-swap: ship new checkpoints into a serving fleet
without a restart, with a single-version guarantee (a port of
``horovod_tpu/serve/hotswap.py``).

A training job commits versions of the served model's ``state_dict``
through the sharded-manifest format (``ckpt/sharded.py``: every shard
checksummed, rank 0's manifest rename IS the commit point) into a
weights directory the fleet can read, optionally announcing each
version over the job's HMAC-signed KV store.  Serving ranks poll the
manifest between decode steps and flip together on a version-stamped
step (``SlotEngine.set_params``, in place).

**Single-version protocol.**  The swap rides the serving plane's
per-step schedule broadcast: the leader derives every transition from
shared data (the committed manifest, the ranks' prefetch votes in
epoch-scoped KV keys) and broadcasts it; followers only obey.

1. **poll** — every ``poll_steps`` serving steps the leader checks the
   announce key and the weights directory for a committed version newer
   than the incumbent.
2. **prefetch** — the leader broadcasts ``{"phase": "prefetch",
   "version": v}``; every rank reassembles version ``v`` on the host,
   checksum-validating every shard against the manifest and its shapes
   and dtypes against the served model's, and posts an ok/fail vote
   under an epoch-scoped key.  Serving continues on the incumbent.
3. **flip** — once every live rank voted ok, the leader first writes
   the DURABLE version record (``serve/weight_version`` — the value
   epoch-start recovery converges on), then broadcasts ``{"phase":
   "flip", "version": v}``; every rank applies the staged weights before
   that step's admissions and decode.
4. **rollback** — any failed vote or a vote timeout makes the leader
   broadcast ``abort``: everyone drops the staged weights.  A rank that
   DIES mid-swap breaks the epoch instead; the new epoch's recovery doc
   carries the durable version record, so the re-formed fleet converges
   on exactly one version.

Chaos point ``swap_commit`` (``action=swap_abort``) fires between a
successful prefetch and the flip.

Honest limits: requests in flight ACROSS a committed flip continue
decoding under the new weights over a KV cache built by the old ones,
so their post-flip tokens are identical on every rank but not samples
of either model — drain first if that matters.  Requests admitted
entirely under one version are reproducible under that version.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, List, Optional, Tuple

from ..ckpt.replica import job_fingerprint
from ..ckpt.sharded import (
    ShardCorruptError,
    latest_step,
    save_sharded,
    restore_sharded,
)
from ..obs import flightrec as obs_flightrec
from ..obs import get_registry
from ..testing.faults import DEFAULT_EXIT_CODE, maybe_fail
from ..utils.logging import get_logger

LOG = get_logger("serve.hotswap")

__all__ = ["publish_weights", "SwapManager", "DEFAULT_POLL_STEPS",
           "ANNOUNCE_KEY", "VERSION_KEY"]

DEFAULT_POLL_STEPS = 16
# Leader steps a prefetch may stay short of full votes before the swap
# is rolled back.  Prefetch is synchronous between decode steps, so
# votes normally land by the next step; a rank that died instead breaks
# the epoch long before this trips.  Generous on purpose.
DEFAULT_VOTE_TIMEOUT_STEPS = 64

# Keys under the durable ``serve`` scope (frontend.SCOPE):
ANNOUNCE_KEY = "weights"         # publisher -> fleet: newest version
VERSION_KEY = "weight_version"   # leader's durable flip record


def publish_weights(directory: str, params: Any, version: int, *,
                    kv=None, extra: Optional[dict] = None) -> str:
    """Training-side publisher: commit ``params`` — the served model's
    ``state_dict`` — as weight version ``version`` (the
    sharded-checkpoint step number; must be newer than every version
    already published — versions are totally ordered).

    ``kv``: optionally a :class:`~..run.rendezvous.KVStoreClient` bound
    to the serving job's store — the committed version is then also
    announced over the signed KV path (stamped with the job
    fingerprint, so a recycled endpoint can never advertise a stale
    job's weights), which spares the serving leader a directory listing
    per poll and works when the publisher's clock beats the fleet's
    filesystem cache.  The manifest on disk remains the source of
    truth; an announce for a version the directory cannot serve is
    simply rolled back by the prefetch votes."""
    version = int(version)
    if version < 1:
        raise ValueError(
            f"weight version must be >= 1 (0 is the fleet's built-in "
            f"init-params version); got {version}"
        )
    path = save_sharded(
        directory, dict(params), version, rank=0, world_size=1,
        extra={"weight_version": version, **(extra or {})},
    )
    if kv is not None:
        from .frontend import SCOPE  # noqa: PLC0415 - avoid cycle

        kv.put(SCOPE, ANNOUNCE_KEY, pickle.dumps(
            {"version": version, "fp": job_fingerprint(kv)}
        ))
    LOG.info("published weight version %d -> %s", version, path)
    return path


class SwapManager:
    """Per-rank hot-swap state rider for the serving loop.

    One instance lives for the whole serve_worker lifetime (versions
    survive epoch re-formation; staged-but-unflipped state does not).
    The leader additionally runs the poll/vote half through
    :meth:`leader_step`; every rank applies broadcasts through
    :meth:`apply`."""

    def __init__(self, directory: str, initial_params: Any, *,
                 poll_steps: int = DEFAULT_POLL_STEPS,
                 vote_timeout_steps: int = DEFAULT_VOTE_TIMEOUT_STEPS):
        """``initial_params``: version 0, the seed-derived state dict
        every rank built identically (kept on the host)."""
        self.directory = directory
        self.initial_params = initial_params
        self.poll_steps = max(int(poll_steps), 1)
        self.vote_timeout_steps = max(int(vote_timeout_steps), 2)
        self.version = 0
        self._staged: Optional[Tuple[int, Any]] = None
        # Leader-only: version awaiting votes, and the step the
        # prefetch broadcast went out (for the vote timeout).
        self._pending: Optional[int] = None
        self._pending_step = 0
        # Versions that failed a swap this epoch: do not re-offer them
        # until the epoch changes or a NEWER version appears, or a bad
        # checkpoint would be retried every poll forever.
        self._rejected: set = set()
        # (version, epoch, step) of every flip this rank applied: the
        # drain summary reports them, so a caller can check every rank
        # flipped on the same step.
        self.flips: List[Tuple[int, int, int]] = []

    # --------------------------------------------------------- versions

    def load(self, version: int, target: Any) -> Any:
        """Version ``v``'s state dict: the seed-derived init weights for
        0, the checksummed manifest reassembly otherwise (``target``, the
        served model's state dict, supplies the structure, shapes and
        dtypes the manifest is validated against — a wrong-model
        checkpoint fails here, loudly)."""
        if version == 0:
            return self.initial_params
        return restore_sharded(self.directory, target=target,
                               step=version)

    def ensure_version(self, engine, version: int) -> None:
        """Epoch-start convergence: make this rank serve exactly
        ``version`` (the recovery doc's durable record).  A survivor
        already there pays nothing; a fresh respawn (or a survivor the
        flip never reached) loads it from the manifest."""
        version = int(version)
        if version == self.version:
            get_registry().gauge("serve.weight_version").set(version)
            return
        params = self.load(version, _target(engine))
        engine.set_params(params)
        LOG.info("converged on weight version %d (was %d)",
                 version, self.version)
        self.version = version
        get_registry().gauge("serve.weight_version").set(version)

    def reset_epoch(self) -> None:
        """A world break abandons any in-progress swap: staged trees
        and pending votes are epoch-local (the votes' KV keys are
        epoch-scoped, so they die with the scope)."""
        self._staged = None
        self._pending = None
        self._rejected = set()

    # ------------------------------------------------------ leader half

    def poll_candidate(self, kv) -> Optional[int]:
        """Newest publishable version strictly above the incumbent, or
        None — from the signed KV announce when present (and stamped
        with THIS job's fingerprint), else from the directory listing.
        Shared data only: every rank WOULD reach the same answer; only
        the leader asks, and broadcasts what it found."""
        candidate: Optional[int] = None
        raw = kv.get(_scope(), ANNOUNCE_KEY)
        if raw is not None:
            try:
                doc = pickle.loads(raw)
                if doc.get("fp") == job_fingerprint(kv):
                    v = int(doc["version"])
                    if v > self.version:
                        candidate = v
            except Exception:
                LOG.warning("malformed weights announce; ignoring")
        disk = latest_step(self.directory, newer_than=self.version)
        if disk is not None and (candidate is None or disk > candidate):
            candidate = disk
        if candidate is not None and candidate in self._rejected:
            return None
        return candidate

    def leader_step(self, kv, scope: str, world, step: int
                    ) -> Optional[dict]:
        """The leader's per-step swap contribution to the schedule
        broadcast (sdoc["swap"]), or None.  Exactly one of
        prefetch/flip/abort per step."""
        if self._pending is not None:
            v = self._pending
            votes = {}
            for r in world:
                raw = kv.get(scope, f"swapok_{v}_{r}")
                if raw is None:
                    break
                votes[r] = raw == b"ok"
            if len(votes) == len(world):
                self._pending = None
                if all(votes.values()):
                    # Durable record FIRST, broadcast second: a death
                    # between the two leaves a recorded version nobody
                    # flipped to — epoch recovery then loads it
                    # everywhere, which is still exactly one version.
                    kv.put(_scope(), VERSION_KEY, str(v).encode())
                    return {"phase": "flip", "version": v}
                self._rejected.add(v)
                return {"phase": "abort", "version": v}
            if step - self._pending_step > self.vote_timeout_steps:
                self._pending = None
                self._rejected.add(v)
                LOG.warning(
                    "weight version %d prefetch votes incomplete after "
                    "%d steps; rolling back", v, self.vote_timeout_steps,
                )
                return {"phase": "abort", "version": v}
            return None
        if step % self.poll_steps == 0:
            v = self.poll_candidate(kv)
            if v is not None:
                self._pending = v
                self._pending_step = step
                return {"phase": "prefetch", "version": v}
        return None

    # ------------------------------------------------------- every rank

    def prefetch(self, version: int, target: Any) -> bool:
        """Stage version ``v`` on the host; False (never raises) on any
        doubt — a torn shard, a checksum mismatch, a manifest from a
        different model — so the vote can roll the fleet back."""
        t0 = time.monotonic()
        try:
            params = self.load(version, target)
        except (ShardCorruptError, FileNotFoundError, ValueError,
                RuntimeError, OSError) as exc:
            LOG.warning("weight version %d prefetch failed: %s",
                        version, exc)
            get_registry().counter("serve.swap_prefetch_failures").inc()
            self._staged = None
            return False
        self._staged = (int(version), params)
        get_registry().histogram("serve.swap_prefetch_ms").observe(
            (time.monotonic() - t0) * 1e3
        )
        return True

    def apply(self, swap_doc: dict, engine, kv, scope: str, rank: int,
              epoch: int, step: int) -> None:
        """Obey one broadcast swap transition (every rank, leader
        included — the leader votes through the same keys)."""
        reg = get_registry()
        phase = swap_doc["phase"]
        version = int(swap_doc["version"])
        if phase == "prefetch":
            ok = self.prefetch(version, _target(engine))
            kv.put(scope, f"swapok_{version}_{rank}",
                   b"ok" if ok else b"fail")
        elif phase == "flip":
            # Chaos point: die between a successful prefetch and the
            # version flip — the single-version convergence window.
            # os._exit (no cleanup, no atexit): the injected death must
            # look like a hard mid-swap crash.
            if maybe_fail("swap_commit", step=step,
                          rank=rank) == "swap_abort":
                os._exit(DEFAULT_EXIT_CODE)
            if self._staged is not None and self._staged[0] == version:
                params = self._staged[1]
            else:
                # Defensive slow path (cannot happen under the vote
                # protocol: flip only follows this rank's ok vote):
                # correctness over latency.
                params = self.load(version, _target(engine))
            engine.set_params(params)
            self._staged = None
            self.version = version
            self.flips.append((version, int(epoch), int(step)))
            reg.gauge("serve.weight_version").set(version)
            reg.counter("serve.swaps", outcome="committed").inc()
            obs_flightrec.record(
                "init", name="weight_swap", cycle=epoch,
                detail=f"v{version} at step {step}",
            )
            LOG.info("flipped to weight version %d at epoch %d step %d",
                     version, epoch, step)
        elif phase == "abort":
            self._staged = None
            self._rejected.add(version)
            reg.counter("serve.swaps", outcome="rollback").inc()
            LOG.warning(
                "weight version %d rolled back at epoch %d step %d; "
                "serving stays on v%d", version, epoch, step,
                self.version,
            )


def _target(engine) -> dict:
    """The served model's state dict: the structure a version is checked
    against."""
    return engine.model.state_dict()


def _scope() -> str:
    from .frontend import SCOPE  # noqa: PLC0415 - avoid import cycle

    return SCOPE
