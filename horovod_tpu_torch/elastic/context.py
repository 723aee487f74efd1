"""Worker-side elastic world: epoch rendezvous + KV-backed collectives
(a port of ``horovod_tpu/elastic/context.py``).

Why not ``torch.distributed`` here: a process group pins its membership
for its whole life — a dead rank can never be replaced inside it, which
is exactly the elastic contract.  The elastic world instead rides the
launcher's HMAC-signed HTTP KV store (run/rendezvous.py), with every
collective keyed by the *rendezvous epoch* the launcher mints:

* epoch ``e`` keys are immutable once written, so a re-formed world at
  ``e+1`` can never read a dead world's partial step;
* a survivor blocked on a dead peer's contribution notices the epoch
  bump (the launcher's respawn path) and raises
  :class:`HorovodShutdownError`, which ``elastic.run`` turns into
  rollback + re-rendezvous;
* a respawned rank joins at the new epoch and adopts the newest
  committed state through :meth:`ElasticContext.sync_state`'s
  owner election (highest commit count, lowest rank tiebreak).

The data path is deliberately the rendezvous store, not a ring: elastic
steps are checkpoint-rate, not gradient-rate — a training step's own
gradients go through its ``DistributedOptimizer`` / ``OverlapPlan``, and
this is the control/recovery plane (the same split upstream Elastic
Horovod makes between its gloo ring and its rendezvous server).

Environment contract (set by the elastic launcher, runner.py)::

    HVDTPU_ELASTIC_KV       host:port of the launcher's KV store
    HVDTPU_SECRET           per-job HMAC secret (rendezvous.SECRET_ENV)
    HVDTPU_ELASTIC_RANK     this worker's stable rank
    HVDTPU_ELASTIC_EPOCH    epoch current at spawn time
    HVDTPU_ELASTIC_TIMEOUT  collective/rendezvous wait bound (secs, 120)
    HVDTPU_ELASTIC_HEARTBEAT_SECS   liveness beat period (secs, 1.0)
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..obs import flightrec as obs_flightrec
from ..obs import get_registry
from ..obs import progress as obs_progress
from ..obs import straggler as obs_straggler
from ..run.rendezvous import KVStoreClient
from ..testing.faults import corrupt_grad, maybe_fail
from ..utils.env import env_float
from ..utils.logging import get_logger
from .exceptions import HorovodShutdownError, RankDroppedError

LOG = get_logger("elastic")

_SCOPE = "elastic"
_POLL_SECS = 0.05
DEFAULT_TIMEOUT = 120.0
DEFAULT_HEARTBEAT_SECS = 1.0

__all__ = ["ElasticContext", "LocalContext", "context", "reset_context"]


def _epoch_scope(epoch: int) -> str:
    return f"elastic_e{epoch}"


def _to_host(value):
    """``(host value, back)``: a torch tensor becomes a numpy array (bf16
    and fp16 as fp32), and ``back`` maps a numpy result onto the
    tensor's device and dtype; anything else passes through."""
    import torch  # noqa: PLC0415

    if not isinstance(value, torch.Tensor):
        return value, lambda out: out
    t = value.detach()
    host = t.to("cpu", torch.float32 if t.dtype in (
        torch.bfloat16, torch.float16) else t.dtype).numpy()

    def back(out):
        return torch.from_numpy(np.require(out, requirements="C")).to(
            device=t.device, dtype=t.dtype)

    return host, back


class ElasticContext:
    """One worker's view of the elastic world (rank, epoch, membership)
    plus the epoch-scoped collectives the training loop runs on."""

    def __init__(
        self,
        rank: int,
        kv: KVStoreClient,
        epoch: int = 0,
        *,
        timeout: float = DEFAULT_TIMEOUT,
        heartbeat_secs: float = DEFAULT_HEARTBEAT_SECS,
    ):
        self.rank = int(rank)
        self.kv = kv
        self.epoch = int(epoch)
        self.world: List[int] = [self.rank]
        self.size = 1
        self.timeout = timeout
        self.heartbeat_secs = heartbeat_secs
        self._seq = 0
        self._min_epoch = 0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    @classmethod
    def from_env(cls) -> "ElasticContext":
        addr = os.environ["HVDTPU_ELASTIC_KV"]
        return cls(
            rank=int(os.environ.get("HVDTPU_ELASTIC_RANK", "0")),
            kv=KVStoreClient(addr),
            epoch=int(os.environ.get("HVDTPU_ELASTIC_EPOCH", "0")),
            timeout=env_float("HVDTPU_ELASTIC_TIMEOUT", DEFAULT_TIMEOUT),
            heartbeat_secs=env_float(
                "HVDTPU_ELASTIC_HEARTBEAT_SECS", DEFAULT_HEARTBEAT_SECS
            ),
        )

    # -- liveness ---------------------------------------------------------

    def start_heartbeat(self) -> None:
        """Beat ``hb_<rank>`` from a dedicated thread so the launcher
        can spot a *frozen process* — SIGSTOP, OOM-thrash, a wedged
        host (a crashed one is caught by its exit code first).

        The beat body piggybacks the collective-path progress counter
        and phase (obs/progress.py): the wall-clock field keeps proving
        the *process* lives (the beat thread survives a training-thread
        deadlock, so its mere arrival proves nothing more), while the
        launcher's workload-aware progress policy watches the counter to
        catch the deadlocked *training thread* directly — instead of
        leaving the hang to peers' collective timeouts and their retry
        budget."""
        if self._hb_thread is not None:
            return
        # The live telemetry publisher rides the heartbeat lifecycle:
        # same launcher KV endpoint, same signed PUT path, armed by the
        # same spawn env (HVDTPU_LIVE_STATS_SECS).
        from ..obs import stream as obs_stream  # noqa: PLC0415

        obs_stream.maybe_start_from_env()

        def _beat():
            while True:
                try:
                    # Epoch-stamped: the launcher must not attribute a
                    # dead incarnation's last beat to the respawned
                    # successor (hb_<rank> is not epoch-scoped).
                    self.kv.put(
                        _SCOPE, f"hb_{self.rank}",
                        obs_progress.beat_payload(epoch=self.epoch),
                    )
                except Exception:
                    pass  # launcher going down; the exit path handles it
                if self._hb_stop.wait(self.heartbeat_secs):
                    return

        self._hb_thread = threading.Thread(
            target=_beat, name="hvdtpu_elastic_hb", daemon=True
        )
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()

    # -- epoch / membership ----------------------------------------------

    def current_epoch(self) -> int:
        raw = self.kv.get(_SCOPE, "epoch")
        return int(raw) if raw is not None else self.epoch

    def world_changed(self) -> bool:
        """True when the launcher minted a newer epoch than the one this
        context last rendezvoused into."""
        return self.current_epoch() > self.epoch

    def notify_world_broken(self) -> None:
        """Record that a collective/sync failed in the current epoch.
        The next rendezvous then refuses to rejoin it: epoch ``e``'s
        keys still hold pre-failure values (collective contributions,
        the epoch-start sync blob), so replaying rolled-back steps
        against them silently diverges from peers.  Recovery only
        proceeds once the launcher mints a fresh epoch; a rank that
        never sees one times out, exits, and is respawned into one."""
        obs_flightrec.record("world_broken", cycle=self.epoch)
        self._min_epoch = self.epoch + 1

    def rendezvous(self, timeout: Optional[float] = None) -> int:
        """Join the current epoch's world: fetch membership, check in,
        wait for every member.  Restarts transparently if the epoch
        advances mid-wait; raises :class:`HorovodShutdownError` when the
        deadline passes with members still missing."""
        # The whole join is a launcher/peer wait: the progress beat
        # reports `waiting`, so the staleness policy never shoots a rank
        # that is merely parked for a respawned peer to come up.
        with obs_progress.waiting():
            return self._rendezvous(timeout)

    def _rendezvous(self, timeout: Optional[float] = None) -> int:
        deadline = time.monotonic() + (timeout or self.timeout)
        while True:
            e = self.current_epoch()
            if e < self._min_epoch:
                if time.monotonic() > deadline:
                    raise HorovodShutdownError(
                        f"rendezvous timed out waiting for a fresh epoch "
                        f"(> {self._min_epoch - 1}) after a world failure "
                        f"— the launcher never re-formed the world"
                    )
                time.sleep(_POLL_SECS)
                continue
            raw = self._fetch(_SCOPE, f"world_{e}", deadline,
                              what=f"world for epoch {e}", epoch=None)
            world = sorted(pickle.loads(raw))
            if self.rank not in world:
                # The launcher shrank the world past this rank (it was
                # presumed dead); there is nothing left to compute here.
                raise RankDroppedError(
                    f"rank {self.rank} is not a member of epoch {e}'s "
                    f"world {world}; the launcher dropped it"
                )
            self.kv.put(_SCOPE, f"ready_{e}_{self.rank}", b"1")
            restart = False
            for r in world:
                while self.kv.get(_SCOPE, f"ready_{e}_{r}") is None:
                    if self.current_epoch() > e:
                        restart = True
                        break
                    if time.monotonic() > deadline:
                        raise HorovodShutdownError(
                            f"rendezvous for epoch {e} timed out waiting "
                            f"for rank {r} (world {world})"
                        )
                    time.sleep(_POLL_SECS)
                if restart:
                    break
            if restart:
                continue
            self.epoch, self.world, self.size = e, world, len(world)
            # Collective numbering is per-epoch: survivors (mid-run
            # _seq) and a respawned rank (fresh process, _seq 0) must
            # agree on auto-minted names like "op3" after recovery.
            self._seq = 0
            # Straggler attribution starts clean per incarnation: the
            # old world's blame (often the very rank that just died or
            # was respawned) must not leak into the new epoch's verdict.
            obs_straggler.reset()
            get_registry().counter("elastic.rendezvous").inc()
            obs_flightrec.record(
                "rendezvous", name=f"epoch{e}", cycle=e,
                detail=f"world={world}",
            )
            LOG.info("rank %d joined epoch %d world %s",
                     self.rank, e, world)
            return e

    # -- collectives ------------------------------------------------------

    def allreduce(self, value, name: Optional[str] = None, *,
                  average: bool = True):
        """Epoch-scoped allreduce: every member publishes, everyone
        gathers.  A missing peer surfaces as HorovodShutdownError —
        either via the epoch bump (launcher noticed first) or the
        timeout (it didn't).

        ``value``: a numpy array, a Python scalar (the result is a numpy
        array) or a torch tensor, which goes to the host (bf16 as fp32:
        numpy has no bfloat16) and whose result comes back on its device
        in its dtype."""
        value, back = _to_host(value)
        self._seq += 1
        name = name or f"op{self._seq}"
        # Deterministic chaos: the worker_exit injection point sits at
        # the step boundary BEFORE this rank contributes, so when it
        # fires no peer can have completed the step (recovery resumes
        # from the last commit on every rank).
        maybe_fail("worker_exit", step=self._seq, rank=self.rank)
        # Flight recorder, KV-collective flavor: the per-epoch sequence
        # number is this path's "cycle" — identical on every member, so
        # the post-mortem aligns elastic rings the same way it aligns
        # engine rings.
        obs_flightrec.record(
            "enqueue", name=name, cycle=self._seq, detail="kv_allreduce",
        )
        arr = np.asarray(value)
        scope = _epoch_scope(self.epoch)
        self.kv.put(scope, f"ar_{name}_{self.rank}", pickle.dumps(arr))
        deadline = time.monotonic() + self.timeout
        parts = []
        waits = {}
        # Contribution is in: from here this rank is blocked on PEERS,
        # and the beat's waiting flag says so — a hung peer freezes this
        # counter too, and the policy must kill the peer, not us.
        with obs_progress.waiting():
            for r in self.world:
                t0 = time.monotonic()
                raw = self._fetch(scope, f"ar_{name}_{r}", deadline,
                                  what=f"allreduce {name!r} from rank {r}")
                waits[r] = time.monotonic() - t0
                parts.append(pickle.loads(raw))
        # Straggler attribution, KV-collective flavor: blame the peer
        # this rank actually sat polling for (a delayed rank waits on
        # nobody, so it never smears blame; see obs/straggler.py).
        obs_straggler.record_waits(
            waits, self.rank, tensor=name,
            alert_ms=env_float("HVDTPU_ALERT_SKEW_MS", 0.0),
        )
        total = parts[0].astype(np.float64) if average else parts[0]
        for p in parts[1:]:
            total = total + p
        if average:
            total = (total / len(parts)).astype(arr.dtype)
        # Chaos hook for the divergence sentinel: grad_ready fires
        # AFTER the reduction, on this rank's copy of the agreed total
        # — the SDC shape where exactly one rank walks away with a
        # different result (a pre-reduce flip would spread identically
        # to every rank and diverge nothing).
        action = maybe_fail("grad_ready", step=self._seq, rank=self.rank,
                            name=name)
        if action in ("flip_bits", "nan_inject"):
            total = corrupt_grad(total, action, rank=self.rank,
                                 step=self._seq, name=name)
        # Progress beat source for the elastic path: the collective
        # completed with every member's contribution in hand.
        obs_flightrec.record(
            "complete", name=name, cycle=self._seq, detail="kv_allreduce",
        )
        obs_progress.tick()
        get_registry().counter("elastic.kv_collectives").inc()
        return back(total)

    def sync_state(self, make_blob: Callable[[], bytes],
                   commit_count: int) -> Optional[bytes]:
        """Elect the state owner for this epoch — highest commit count,
        lowest rank on ties — and broadcast its serialized snapshot.
        A freshly respawned rank (commit count 0) therefore always
        adopts a survivor's state, and a full fresh start converges on
        rank 0's initial values.

        ``make_blob`` serializes this rank's snapshot; it is called only
        when this rank owns the state and a peer needs the bytes.
        Returns the owner's bytes, or ``None`` when this rank's own
        state won."""
        obs_flightrec.record(
            "sync_state", name=f"epoch{self.epoch}", cycle=self.epoch,
            detail=f"commits={int(commit_count)}",
        )
        if self.world == [self.rank]:
            # A world of one elects itself: it neither serializes its
            # snapshot (1.6 GB for gpt-small with AdamW) nor sends it
            # through the store.
            obs_progress.tick(to_steady=False)
            return None
        scope = _epoch_scope(self.epoch)
        self.kv.put(scope, f"have_{self.rank}",
                    pickle.dumps(int(commit_count)))
        deadline = time.monotonic() + self.timeout
        counts = {}
        with obs_progress.waiting():  # checked in; blocked on peers
            for r in self.world:
                raw = self._fetch(scope, f"have_{r}", deadline,
                                  what=f"commit count from rank {r}")
                counts[r] = pickle.loads(raw)
            owner = max(self.world, key=lambda r: (counts[r], -r))
            if owner == self.rank:
                self.kv.put(scope, "state", make_blob())
                out = None
            else:
                out = self._fetch(scope, "state", deadline,
                                  what=f"state from owner rank {owner}")
        # Epoch-start sync is a completed collective (liveness), but NOT
        # steady state: the user's first step — and its possibly very
        # long jit compile — has not started yet, and snapping to steady
        # here would hand the steady budget to that compile.
        obs_progress.tick(to_steady=False)
        return out

    # -- plumbing ---------------------------------------------------------

    def _fetch(self, scope: str, key: str, deadline: float, *,
               what: str, epoch: Optional[int] = -1) -> bytes:
        """Poll one key; fail with HorovodShutdownError on epoch bump
        (unless ``epoch=None`` disables the check — the rendezvous loop
        handles bumps itself) or deadline."""
        watch_epoch = self.epoch if epoch == -1 else epoch
        while True:
            raw = self.kv.get(scope, key)
            if raw is not None:
                return raw
            if watch_epoch is not None:
                current = self.current_epoch()
                if current > watch_epoch:
                    raise HorovodShutdownError(
                        f"world re-formed (epoch {watch_epoch} -> "
                        f"{current}) while waiting for {what}"
                    )
            if time.monotonic() > deadline:
                raise HorovodShutdownError(
                    f"timed out waiting for {what} — a peer likely died "
                    f"without the launcher re-forming the world yet"
                )
            time.sleep(_POLL_SECS)


class LocalContext:
    """Degenerate single-process world so ``elastic.run`` / ``State``
    work (and unit-test) without a launcher: collectives are identity,
    rendezvous is a no-op, the fault-injection points still fire."""

    def __init__(self):
        self.rank = 0
        self.size = 1
        self.epoch = 0
        self.world: Sequence[int] = (0,)
        self._seq = 0

    def start_heartbeat(self) -> None:
        pass

    def stop_heartbeat(self) -> None:
        pass

    def current_epoch(self) -> int:
        return self.epoch

    def world_changed(self) -> bool:
        return False

    def rendezvous(self, timeout: Optional[float] = None) -> int:
        return self.epoch

    def notify_world_broken(self) -> None:
        pass

    def allreduce(self, value, name: Optional[str] = None, *,
                  average: bool = True):
        value, back = _to_host(value)
        self._seq += 1
        maybe_fail("worker_exit", step=self._seq, rank=self.rank)
        obs_progress.tick()
        return back(np.asarray(value))

    def sync_state(self, make_blob: Callable[[], bytes],
                   commit_count: int) -> Optional[bytes]:
        return None


_current = None
_current_lock = threading.Lock()


def context():
    """The ambient elastic context: built from the launcher env when
    present, a LocalContext otherwise.  Cached per process."""
    global _current
    with _current_lock:
        if _current is None:
            if os.environ.get("HVDTPU_ELASTIC_KV"):
                _current = ElasticContext.from_env()
            else:
                _current = LocalContext()
        return _current


def reset_context() -> None:
    """Drop the cached ambient context (tests, or re-launch in-process)."""
    global _current
    with _current_lock:
        ctx, _current = _current, None
    if ctx is not None:
        ctx.stop_heartbeat()
