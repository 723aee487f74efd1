"""Request front door: sharded HTTP ingest on the launcher, streaming
results (a port of ``horovod_tpu/serve/frontend.py``; no model code, so
the port's copy differs only in its imports).

The serving plane reuses the launcher's HMAC-signed KV store
(run/rendezvous.py) as its wire — the same plumbing that already
carries rendezvous, heartbeats, live telemetry and checkpoint replicas.
The request plane is **sharded**: ``F`` frontend pumps
(:class:`FrontDoor`) each own a rid-hash partition of the request log,
so one frontend death strands nothing.  Key families under the
``serve`` scope:

* ``serve/req/<shard>/<rid>`` — client submissions (signed PUT).
  Clients route by the pure hash ``crc32(rid) % F`` — the same
  PYTHONHASHSEED-proof digest the sampling plane keys streams on — so
  producer-side routing needs no coordination.  The HTTP surface
  deliberately has no listing verb, so workers cannot drain this
  directly; the launcher-resident shard pumps (which own the store
  in-process, like the live aggregator) scan their partitions and...
* ``serve/log/<shard>/<n>`` — ...rewrite each submission into a
  per-shard, immutable ingest log with per-shard sequence numbers.
  The interleave ``gkey = n * F + shard`` is the total order every
  consumer derives identically; each serving group's leader drains the
  partition ``gkey % groups == group`` (service.py).  The log also IS
  the durable request record elastic recovery replays from.
* ``serve/out/<rid>`` — per-request streaming state, written by the
  serving leader after every step: tokens emitted so far, done flag,
  admission/finish bookkeeping.  Clients poll it (signed GET) to
  stream tokens as they are generated.
* ``serve/frontdoor`` — the shard-ownership doc (`{frontends, owners,
  fd_epoch}`): clients read ``frontends`` once to route, workers read
  it at epoch start to derive the interleave.
* ``serve/fd/hb/<fid>`` — per-frontend heartbeat counters.  The
  :class:`FrontDoor` supervisor declares a frontend dead when its beat
  goes stale (or its thread dies), hands its shards to the lowest
  surviving frontend, and surfaces a takeover event the elastic
  monitor turns into a re-minted epoch — in-flight requests replay from
  the log with zero drops.

``serve/stop`` is the drain sentinel: the leader folds it into the
step schedule, finishes everything in flight, and the world exits
cleanly.
"""

from __future__ import annotations

import pickle
import threading
import time
import uuid
import zlib
from typing import Dict, List, Optional, Sequence, Set

from ..obs import trace as obs_trace
from ..run.rendezvous import KVStoreClient
from ..utils.logging import get_logger
from .scheduler import SLO_CLASSES

LOG = get_logger("serve.frontend")

SCOPE = "serve"
REQ_PREFIX = SCOPE + "/req/"
LOG_PREFIX = SCOPE + "/log/"
WATERMARK_PREFIX = SCOPE + "/log_watermark/"
FRONTDOOR_KEY = "frontdoor"
HEARTBEAT_PREFIX = "fd/hb/"

__all__ = ["ServeClient", "IngestPump", "FrontDoor", "validate_request",
           "Rejection", "RequestRejected", "shard_of", "SCOPE"]


def shard_of(rid: str, frontends: int) -> int:
    """The rid's front-door shard: ``crc32(rid) % F``.  Pure and
    PYTHONHASHSEED-proof (never builtin ``hash()``), so the client, the
    pumps, and every serving rank derive the same route."""
    if frontends <= 1:
        return 0
    return zlib.crc32(rid.encode("utf-8")) % frontends


class Rejection(str):
    """A machine-readable reject verdict: a plain ``str`` (the human
    message — drop-in for every call site that formatted the old bare
    string) carrying a stable ``code`` for programmatic handling."""

    code: str

    def __new__(cls, code: str, message: str) -> "Rejection":
        obj = super().__new__(cls, message)
        obj.code = code
        return obj

    def __getnewargs__(self):
        return (self.code, str(self))

    @property
    def message(self) -> str:
        return str(self)


class RequestRejected(RuntimeError):
    """Raised by :meth:`ServeClient.result` when the server refused the
    request; ``code`` is the machine-readable reason
    (:func:`validate_request`), ``message`` the human one."""

    def __init__(self, rid: str, code: str, message: str):
        super().__init__(f"request {rid} rejected [{code}]: {message}")
        self.rid = rid
        self.code = code
        self.message = message


def validate_request(doc: dict, serve_len: int,
                     vocab_size: Optional[int] = None,
                     budget_tokens: Optional[int] = None
                     ) -> Optional[Rejection]:
    """Reject verdict for an ingest-log entry, or None when servable.
    Pure — every rank applies it to the same log entry and reaches the
    same verdict (a rank-divergent reject would desync the schedule).
    Returns a :class:`Rejection` (a str subclass), so existing
    formatting keeps working while clients get a stable ``code``.

    ``serve_len`` is the engine's serving context cap
    (``min(cache_len, cfg.max_len)``): bounding against the raw cache
    length alone would let an oversized cache admit a prompt whose
    prefill bucket trips the model's own max_len guard.  ``vocab_size``
    rejects out-of-vocab ids — the embedding gather would otherwise
    fail on them (an index error on the CPU, a device-side assert that
    kills the rank on the GPU), where this module's contract is a loud
    reject.
    ``budget_tokens`` is the TenantQoS per-window token budget when a
    QoS policy is armed: a request whose cost (prompt +
    max_new_tokens) exceeds the whole budget would be throttled in
    EVERY window forever — with per-tenant-FIFO heads that bricks the
    tenant behind it, and its never-done log slot stalls the shard's
    compaction watermark permanently.  Rejecting it loudly at
    validation time publishes a done doc, so the client learns
    immediately and compaction advances."""
    prompt = doc.get("prompt")
    if not isinstance(prompt, (list, tuple)) or not prompt:
        return Rejection("bad_prompt", "empty or malformed prompt")
    if not all(isinstance(t, int) and t >= 0 for t in prompt):
        return Rejection("bad_token",
                         "prompt tokens must be non-negative ints")
    if vocab_size is not None and any(t >= vocab_size for t in prompt):
        return Rejection(
            "oob_token", f"prompt token out of vocab (>= {vocab_size})"
        )
    mnt = doc.get("max_new_tokens", 0)
    if not isinstance(mnt, int) or mnt < 1:
        return Rejection("bad_budget", "max_new_tokens must be >= 1")
    if len(prompt) + mnt > serve_len:
        return Rejection(
            "ctx_exceeded",
            f"prompt ({len(prompt)}) + max_new_tokens ({mnt}) exceeds "
            f"the {serve_len}-token serving context",
        )
    if budget_tokens is not None and len(prompt) + mnt > budget_tokens:
        return Rejection(
            "budget_exceeded",
            f"prompt ({len(prompt)}) + max_new_tokens ({mnt}) exceeds "
            f"the {budget_tokens}-token per-window tenant budget; the "
            f"request could never be admitted",
        )
    temp = doc.get("temperature", 0.0)
    if not isinstance(temp, (int, float)) or temp < 0:
        return Rejection("bad_temperature",
                         "temperature must be a number >= 0")
    top_k = doc.get("top_k", 0)
    if not isinstance(top_k, int) or top_k < 0:
        return Rejection("bad_top_k", "top_k must be an int >= 0")
    tenant = doc.get("tenant", "default")
    if not isinstance(tenant, str) or not tenant or len(tenant) > 64 \
            or "/" in tenant:
        return Rejection(
            "bad_tenant",
            "tenant must be a non-empty str (<= 64 chars, no '/')",
        )
    slo = doc.get("slo", "standard")
    if slo not in SLO_CLASSES:
        return Rejection(
            "bad_slo", f"slo must be one of {'/'.join(SLO_CLASSES)}"
        )
    return None


class ServeClient:
    """Client half of the front door: submit prompts, stream tokens.

    Talks the signed KV protocol (the secret travels via
    ``HVDTPU_SECRET`` or the constructor), so any process holding the
    per-job secret can drive a serving job — the CI gates, bench.py's
    open-loop generator, and operator tooling all use this class.
    Routing is client-side and coordination-free: one read of the
    ``serve/frontdoor`` doc pins ``F``, then every submission routes by
    ``crc32(rid) % F``.
    """

    def __init__(self, addr: str, secret: Optional[str] = None):
        self._kv = KVStoreClient(addr, secret)
        self._frontends: Optional[int] = None

    def frontends(self) -> int:
        """Shard count ``F`` from the front-door doc (cached once
        READ — the count is fixed for the job's lifetime; only shard
        OWNERSHIP moves on takeover, which routing is blind to by
        design).  An absent or unreadable doc falls back to 1 WITHOUT
        caching: a client constructed before the FrontDoor publishes
        (or during a transient KV error) must not pin every later
        submission to shard 0 for its lifetime — the next call
        re-reads."""
        if self._frontends is None:
            raw = self._kv.get(SCOPE, FRONTDOOR_KEY)
            if raw is None:
                return 1
            try:
                self._frontends = max(
                    int(pickle.loads(raw).get("frontends", 1)), 1
                )
            except Exception:
                return 1
        return self._frontends

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               temperature: float = 0.0,
               top_k: int = 0,
               tenant: str = "default",
               slo: str = "standard",
               rid: Optional[str] = None) -> str:
        """Enqueue one generation request; returns its request id.

        ``temperature > 0`` samples instead of greedy argmax (``top_k``
        truncates the candidate set); the stream is still deterministic
        — tokens are keyed on (rid, emission index, serve seed), so a
        resubmission with the SAME rid reproduces the same text and
        elastic replay continues it bit-exactly (serve/sampling.py).

        ``tenant``/``slo`` feed the tenant-aware admission policy
        (serve/scheduler.py TenantQoS): the tenant names the token
        budget bucket, the slo class ("interactive" | "standard" |
        "batch") the admission weight.  Both are validated server-side
        (machine-readable reject on a bad value) and ignored when the
        fleet runs without a QoS policy."""
        rid = rid or uuid.uuid4().hex[:16]
        doc = {
            "rid": rid,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "eos_id": None if eos_id is None else int(eos_id),
            "temperature": float(temperature),
            "top_k": int(top_k),
            "tenant": str(tenant),
            "slo": str(slo),
            # Client-clock submit stamp: the trace waterfall's first
            # span (submit -> ingest) is measured against this; the
            # rid doubles as the request's trace id.
            "submit_t": time.time(),
        }
        shard = shard_of(rid, self.frontends())
        self._kv.put(SCOPE, f"req/{shard}/{rid}", pickle.dumps(doc))
        return rid

    def poll(self, rid: str) -> Optional[dict]:
        """Streaming state ``{"tokens", "done", ...}`` or None before
        the first token lands."""
        raw = self._kv.get(SCOPE, f"out/{rid}")
        return None if raw is None else pickle.loads(raw)

    def result(self, rid: str, timeout: float = 120.0, *,
               poll_floor: float = 0.02,
               poll_cap: float = 0.5) -> dict:
        """Block until the request finishes; raises
        :class:`RequestRejected` when the server refused it (the
        machine-readable code rides the exception) and TimeoutError on
        the deadline.

        Polling backs off exponentially from ``poll_floor`` to
        ``poll_cap`` — the same backoff ``KVStoreClient.wait`` uses,
        so thousands of blocked clients cannot saturate a frontend
        shard — and RESETS to the floor whenever the stream makes
        progress (first doc, more tokens): an actively streaming
        request is tracked closely, a queued one is polled gently."""
        deadline = time.monotonic() + timeout
        t_fetch0 = time.time()
        delay = poll_floor
        progress = -1
        while time.monotonic() < deadline:
            doc = self.poll(rid)
            if doc is not None and doc.get("done"):
                if doc.get("error"):
                    raise RequestRejected(
                        rid, doc.get("error_code") or "rejected",
                        doc["error"],
                    )
                # Result-fetch span on the caller's clock (the bench /
                # CI client runs in the launcher process, so this lands
                # in the launcher's span dump when tracing is armed).
                if obs_trace.enabled() and obs_trace.sampled(rid):
                    obs_trace.add_span(rid, "result_fetch", t_fetch0,
                                       time.time(),
                                       tokens=len(doc.get("tokens", [])))
                return doc
            seen = -1 if doc is None else len(doc.get("tokens", ()))
            if seen > progress:
                progress = seen
                delay = poll_floor
            time.sleep(delay)
            delay = min(delay * 2, poll_cap)
        raise TimeoutError(f"request {rid} not finished within {timeout}s")

    def stop(self) -> None:
        """Raise the drain sentinel: in-flight and queued requests
        complete, then the serving world exits."""
        self._kv.put(SCOPE, "stop", b"1")


class _FrontendKilled(Exception):
    """Internal: an injected frontend death (FrontDoor.kill or the
    ``frontend_beat:action=frontend_exit`` chaos point) — the pump
    thread dies abruptly, mid-traffic, without draining."""


class _ShardFence:
    """In-process fencing for front-door shard ownership.

    The stale-heartbeat supervisor can declare a pump dead that is
    merely SLOW — stalled mid-round on the GIL or a store scan, which
    is exactly what made its beat stale.  Without a fence that zombie
    finishes its in-flight round concurrently with the adopter: both
    scan the same ``serve/req/<shard>/`` keys and can append the same
    rid twice, or write the same ``log/<shard>/<n>`` key with
    different rids.  Two guarantees close that race:

    * **per-shard locks** — at most one pump is ever inside a shard's
      scan-and-append round, so the adopter can never interleave
      appends with the pump it replaced; the adopter recovers the
      shard's cursor and dedup set AFTER first acquiring the lock, so
      it sees every append the previous owner got in;
    * **an owner map** — a pump re-checks ownership under the lock at
      round start and again before every append, so a zombie that lost
      its shard to a takeover aborts instead of writing.

    All pumps are launcher-resident threads of ONE FrontDoor, which is
    what makes an in-process fence sufficient: there is no
    cross-process writer to fence against."""

    def __init__(self, owners: Dict[int, int]):
        self._meta = threading.Lock()
        self._owners: Dict[int, int] = {int(s): int(f)
                                        for s, f in owners.items()}
        self._locks: Dict[int, threading.Lock] = {}

    def lock_of(self, shard: int) -> threading.Lock:
        with self._meta:
            return self._locks.setdefault(int(shard), threading.Lock())

    def owner_of(self, shard: int) -> Optional[int]:
        with self._meta:
            return self._owners.get(int(shard))

    def transfer(self, shard: int, fid: int,
                 timeout: float = 1.0) -> None:
        """Move a shard to ``fid``.  Acquiring the shard lock first
        puts the flip BETWEEN rounds of the previous owner (the common
        case: the stall just ended); when the owner stays wedged past
        ``timeout`` the flip happens anyway and the per-append owner
        check fences its leftover writes instead."""
        lock = self.lock_of(shard)
        got = lock.acquire(timeout=timeout)
        try:
            with self._meta:
                self._owners[int(shard)] = int(fid)
        finally:
            if got:
                lock.release()


class IngestPump:
    """One launcher-resident frontend pump: scans its owned request
    shards (``serve/req/<s>/*`` — the listing the HTTP surface
    deliberately lacks) and appends each submission to the per-shard
    ingest log ``serve/log/<s>/<n>`` the serving leaders drain.

    Ordering within one scan round is by request id — arrival order
    inside a round is not observable from a dict snapshot, and a
    deterministic tiebreak beats a racy one.  Arrival wall time is
    stamped here (the launcher's clock), which is what ttft is measured
    against.

    Standalone construction (``IngestPump(server)``) is the F=1 front
    door minus supervision: one pump owning shard 0 and the GC duties.  Under a
    :class:`FrontDoor` each pump owns its own shard set (``gc=False``;
    the door's GC pump sweeps), heartbeats every round, and can ADOPT a
    dead sibling's shards mid-stream: adoption recovers the shard's
    next sequence number from the surviving log keys and dedupes
    against already-logged rids, so the crash window between a dead
    pump's log-append and req-discard can never double-ingest."""

    def __init__(self, server, interval: float = 0.02,
                 out_ttl_secs: Optional[float] = None, *,
                 fid: int = 0, frontends: int = 1,
                 shards: Optional[Sequence[int]] = None,
                 gc: bool = True,
                 fence: Optional[_ShardFence] = None):
        from ..utils import env as envmod  # noqa: PLC0415

        self._server = server
        # Shard-ownership fence (FrontDoor-managed pumps only): a
        # standalone pump has no sibling to race, so None skips the
        # locking entirely.
        self._fence = fence
        self._kv = KVStoreClient(f"127.0.0.1:{server.port}",
                                 server.secret)
        self.fid = int(fid)
        self.frontends = max(int(frontends), 1)
        self.interval = max(float(interval), 0.005)
        # Finished-output retention: a result doc whose log index fell
        # below its shard's compaction watermark is kept this long for
        # late client polls, then GC'd (see _gc_finished_outputs).
        self.out_ttl_secs = (
            float(out_ttl_secs) if out_ttl_secs is not None
            else envmod.env_float(envmod.SERVE_OUT_TTL,
                                  envmod.DEFAULT_SERVE_OUT_TTL)
        )
        self._lock = threading.Lock()
        self._shards: List[int] = (
            sorted(int(s) for s in shards) if shards is not None
            else [self.fid]
        )
        self._next: Dict[int, int] = {}        # shard -> next log index
        self._known: Dict[int, Set[str]] = {}  # shard -> logged rids
        self.ingested_by_shard: Dict[int, int] = {}
        self.beats = 0
        self._gc_enabled = bool(gc)
        self._done_seen: dict = {}  # out key -> monotonic first-seen-done
        # The finished-output GC unpickles every live out doc, so it
        # runs on its own ~1s cadence, not the 20ms ingest tick (TTL
        # granularity is hundreds of seconds; millisecond precision
        # would buy 50x the deserialization cost and nothing else).
        self._gc_every = min(1.0, max(self.out_ttl_secs / 4, 0.01))
        self._next_gc = 0.0
        self._stop = threading.Event()
        self._stopped = False   # deliberate stop() vs abrupt death
        self._killed = False
        self._thread: Optional[threading.Thread] = None

    @property
    def ingested(self) -> int:
        return sum(self.ingested_by_shard.values())

    @property
    def shards(self) -> List[int]:
        with self._lock:
            return list(self._shards)

    def adopt(self, shards: Sequence[int]) -> None:
        """Take ownership of a dead sibling's shards (thread-safe; the
        pump picks them up at its next round)."""
        with self._lock:
            for s in shards:
                if int(s) not in self._shards:
                    self._shards.append(int(s))
            self._shards.sort()

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------ ingest

    def _adopt_state(self, shard: int) -> None:
        """Recover a shard's append cursor + dedup set from the store:
        next index = max surviving log key + 1 (floored at the shard's
        watermark), known rids = the uncompacted entries'.  Run on
        first ownership AND on takeover — a fresh shard trivially
        yields (watermark, empty)."""
        nxt = 0
        raw = self._server.scan(WATERMARK_PREFIX + str(shard))
        try:
            nxt = int(raw[WATERMARK_PREFIX + str(shard)].decode())
        except (KeyError, ValueError):
            pass
        known: Set[str] = set()
        for key, blob in self._server.scan(
                f"{LOG_PREFIX}{shard}/").items():
            try:
                m = int(key.rsplit("/", 1)[1])
            except ValueError:
                continue
            nxt = max(nxt, m + 1)
            try:
                known.add(pickle.loads(blob)["rid"])
            except Exception:
                continue
        self._next[shard] = nxt
        self._known[shard] = known

    def round(self) -> int:
        """Move every pending submission on the owned shards into their
        logs; returns how many.  Also publishes this frontend's
        heartbeat and (when this pump owns the GC duty) collects
        dead-epoch serving scopes and compacted finished outputs."""
        from ..testing.faults import maybe_fail  # noqa: PLC0415

        # Deterministic chaos: the frontend analog of worker_exit —
        # an advisory action the supervisor must notice via the stale
        # heartbeat, not a cooperative shutdown.  step = THIS pump's
        # 1-based beat counter (the shared per-point counter would
        # interleave nondeterministically across F pumps).  The GC
        # pump (fid < 0) is exempt: it publishes no heartbeat, so an
        # unfiltered frontend_exit spec would kill it silently and GC
        # would stop for the rest of the job — chaos targets the
        # FRONTEND pumps, whose death the supervisor can detect.
        if self.fid >= 0 and maybe_fail(
                "frontend_beat", step=self.beats + 1,
                rank=self.fid) == "frontend_exit":
            raise _FrontendKilled(f"frontend {self.fid}")
        if self._gc_enabled:
            self._gc_stale_epochs()
            self._gc_finished_outputs()
        moved = 0
        for shard in self.shards:
            if self._fence is None:
                if shard not in self._next:
                    self._adopt_state(shard)
                moved += self._pump_shard(shard)
                continue
            # Fenced path (FrontDoor pumps): the shard lock serializes
            # this round against a live-but-slow previous owner, and
            # the ownership check under it aborts a pump that lost the
            # shard to a takeover — the zero-drop/zero-dup claim must
            # hold even when the stale heartbeat was a false positive.
            lock = self._fence.lock_of(shard)
            if not lock.acquire(blocking=False):
                # The previous owner is still mid-round (stalled): skip
                # this tick rather than wedge behind it; the shard is
                # retried next round.
                continue
            try:
                if self._fence.owner_of(shard) != self.fid:
                    continue  # lost the shard; never append
                if shard not in self._next:
                    self._adopt_state(shard)
                moved += self._pump_shard(shard)
            finally:
                lock.release()
        self.beats += 1
        if self.fid >= 0:
            self._kv.put(SCOPE, f"{HEARTBEAT_PREFIX}{self.fid}",
                         str(self.beats).encode())
        return moved

    def _pump_shard(self, shard: int) -> int:
        pending = self._server.scan(f"{REQ_PREFIX}{shard}/")
        moved = 0
        known = self._known.setdefault(shard, set())
        for key in sorted(pending):
            if self._fence is not None \
                    and self._fence.owner_of(shard) != self.fid:
                # Fenced off mid-round: the takeover declared this pump
                # dead while it was wedged past the transfer timeout.
                # Stop appending immediately — the adopter re-derives
                # the cursor and dedup set under the shard lock after
                # this round releases it, so everything appended so far
                # is seen and nothing is appended twice.
                break
            try:
                doc = pickle.loads(pending[key])
                rid = doc["rid"]
            except Exception:
                LOG.warning("dropping malformed submission %s", key)
                self._server.discard([key])
                continue
            if rid in known:
                # Already logged by the dead previous owner (it crashed
                # between log-append and req-discard): finish its
                # discard, never double-append.
                self._server.discard([key])
                continue
            n = self._next.setdefault(shard, 0)
            doc["arrival"] = time.time()
            doc["shard"] = shard
            doc["n"] = n
            # The total order every consumer derives: per-shard
            # sequence interleaved over the shard count.
            doc["gkey"] = n * self.frontends + shard
            self._kv.put(SCOPE, f"log/{shard}/{n}", pickle.dumps(doc))
            self._next[shard] = n + 1
            known.add(rid)
            if len(known) > 4096:
                # Bound the dedup set: re-derive it from the store (the
                # compacted prefix left the replay set, so its rids can
                # leave the dedup set too).
                self._adopt_state(shard)
            moved += 1
            self.ingested_by_shard[shard] = (
                self.ingested_by_shard.get(shard, 0) + 1
            )
            self._server.discard([key])
            # Launcher-side spans: submit -> ingest (client clock to
            # launcher clock — one host in practice) and the log
            # append itself.  The deterministic sampling verdict is the
            # SAME one every serving rank reaches for this rid.
            if obs_trace.enabled() and obs_trace.sampled(rid):
                submit_t = float(doc.get("submit_t") or doc["arrival"])
                obs_trace.add_span(rid, "ingest",
                                   min(submit_t, doc["arrival"]),
                                   doc["arrival"], n=doc["gkey"])
                obs_trace.add_span(rid, "log_append", doc["arrival"],
                                   time.time(), n=doc["gkey"])
            LOG.debug("ingested request %s as log/%d/%d", rid, shard, n)
        return moved

    # ---------------------------------------------------------------- gc

    def _gc_stale_epochs(self) -> None:
        """Drop schedule/recovery keys from epochs older than the
        current rendezvous epoch.  The leader's in-band GC only trims
        its OWN epoch's trailing window; every world break would
        otherwise permanently leak the dead epoch's remaining sched
        pickles and recovery doc — unbounded launcher memory on a
        long-lived fleet with periodic rank churn.  Old-epoch keys are
        immutable and unreadable by design (survivors and respawns
        alike rebuild from the NEW epoch's recovery doc), so deleting
        them can never race a reader."""
        raw = self._server.scan("elastic/epoch")
        try:
            current = int(raw["elastic/epoch"])
        except (KeyError, ValueError):
            return  # no elastic world yet (or a non-elastic store)
        doomed = []
        for key in self._server.scan("serve_e"):
            scope = key.split("/", 1)[0]
            try:
                epoch = int(scope[len("serve_e"):])
            except ValueError:
                continue
            if epoch < current:
                doomed.append(key)
        if doomed:
            self._server.discard(doomed)
            LOG.debug("GC'd %d stale-epoch serving keys", len(doomed))

    def _watermarks(self) -> Dict[int, int]:
        marks: Dict[int, int] = {}
        for key, blob in self._server.scan(WATERMARK_PREFIX).items():
            try:
                marks[int(key.rsplit("/", 1)[1])] = int(blob.decode())
            except ValueError:
                continue
        return marks

    def _gc_finished_outputs(self) -> None:
        """Drop result docs of requests the leader's compaction
        watermarks already retired (their log keys are gone — recovery
        replay will never need them) once they have been done for
        ``out_ttl_secs``.  This is the second half of request-log
        compaction: without it ``serve/out/*`` still grows with total
        requests ever served even though ``serve/log/*`` no longer
        does.  The TTL exists for late pollers; a client that sleeps
        past it sees a result timeout, which docs/inference.md states
        as the honest trade."""
        if time.monotonic() < self._next_gc:
            return
        self._next_gc = time.monotonic() + self._gc_every
        marks = self._watermarks()
        if not marks:
            return  # no compaction yet
        # Orphan sweep: the leader publishes each shard's watermark
        # BEFORE deleting the retired log keys, so a crash between the
        # two leaves below-watermark entries nobody will ever read (the
        # recovery scan starts at the watermark).  The pump is the one
        # component that can list them.
        orphans = []
        for key in self._server.scan(LOG_PREFIX):
            try:
                _, shard_s, n_s = key.rsplit("/", 2)
                if int(n_s) < marks.get(int(shard_s), 0):
                    orphans.append(key)
            except ValueError:
                continue
        if orphans:
            self._server.discard(orphans)
            LOG.debug("GC'd %d below-watermark log orphans",
                      len(orphans))
        now = time.monotonic()
        doomed = []
        live = self._server.scan(SCOPE + "/out/")
        for key, blob in live.items():
            try:
                doc = pickle.loads(blob)
            except Exception:
                continue
            n = doc.get("n")
            shard = int(doc.get("shard") or 0)
            if not doc.get("done") or n is None \
                    or int(n) >= marks.get(shard, 0):
                continue
            first = self._done_seen.setdefault(key, now)
            if now - first >= self.out_ttl_secs:
                doomed.append(key)
        if doomed:
            self._server.discard(doomed)
            for key in doomed:
                self._done_seen.pop(key, None)
            LOG.debug("GC'd %d compacted result docs", len(doomed))
        # Tracking entries for keys something else already removed.
        for key in list(self._done_seen):
            if key not in live:
                self._done_seen.pop(key, None)

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop,
            name=f"hvdtpu_serve_ingest_{self.fid}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.round()
            except _FrontendKilled as exc:
                LOG.warning("frontend pump died abruptly: %s", exc)
                return  # no drain — the supervisor must take over
            except Exception as exc:  # pragma: no cover - defensive
                LOG.warning("ingest round failed: %s", exc)

    def kill(self) -> None:
        """Abrupt, mid-stream death (chaos hook): the thread exits
        without the final drain and WITHOUT marking a deliberate stop,
        so the FrontDoor supervisor sees exactly what a crashed
        frontend looks like."""
        self._killed = True
        self._stop.set()

    def stop(self) -> None:
        self._stopped = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._killed:
            return
        try:
            self.round()  # drain what arrived before the stop
        except Exception:  # pragma: no cover - defensive
            pass


class FrontDoor:
    """The sharded, supervised front door: ``F`` frontend pumps (one
    per rid-hash shard), a GC pump, and a heartbeat supervisor that
    survives any one frontend's death.

    Lifecycle of a frontend death (:meth:`kill`, a crash, or the
    ``frontend_beat:action=frontend_exit`` chaos point):

    1. the supervisor notices the dead pump (thread down or heartbeat
       counter stale past ``heartbeat_timeout``; on the stale path it
       also joins the thread briefly — a stale beat may mean SLOW, not
       dead);
    2. its shards are ADOPTED by the lowest surviving frontend
       (deterministic) — ownership flips through the
       :class:`_ShardFence` first, so even a live-but-slow "corpse"
       cannot append concurrently with its adopter — which recovers
       each shard's append cursor from the surviving log keys and
       dedupes already-logged rids — no drop, no double-ingest; with
       no survivor (F=1) a replacement pump is spawned in place;
    3. the ownership doc (``serve/frontdoor``) is re-published under a
       bumped ``fd_epoch`` and a takeover event is queued;
    4. the elastic monitor polls :meth:`poll_takeover` and re-mints the
       serving world's rendezvous epoch — exactly the failure-recovery
       machinery — so every in-flight request replays from the durable
       log, bitwise on course.

    Clients never re-route: the rid hash names the SHARD, and shards
    are immortal — only their owning pump changes."""

    def __init__(self, server, frontends: int = 1,
                 interval: float = 0.02,
                 out_ttl_secs: Optional[float] = None,
                 heartbeat_timeout: float = 2.0):
        self._server = server
        self._kv = KVStoreClient(f"127.0.0.1:{server.port}",
                                 server.secret)
        self.frontends = max(int(frontends), 1)
        self.interval = max(float(interval), 0.005)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.owners: Dict[int, int] = {s: s
                                       for s in range(self.frontends)}
        # The ownership fence every pump writes through: a takeover
        # flips it BEFORE the adopter picks the shards up, so a
        # false-positive death (live-but-slow pump) can never append
        # concurrently with its adopter (_ShardFence).
        self._fence = _ShardFence(self.owners)
        self._pumps: Dict[int, IngestPump] = {
            fid: IngestPump(server, interval, out_ttl_secs, fid=fid,
                            frontends=self.frontends, gc=False,
                            fence=self._fence)
            for fid in range(self.frontends)
        }
        # GC rides its own pump (no shards, no heartbeat): the duty
        # must survive any frontend's death, so it cannot live on one.
        # It is exempt from the frontend_exit chaos point (round()) and
        # supervised by thread liveness instead (_check_pumps respawns
        # it) — "GC must survive any frontend's death" includes its own.
        self._gc_pump = IngestPump(server, max(interval * 5, 0.05),
                                   out_ttl_secs, fid=-1,
                                   frontends=self.frontends,
                                   shards=(), gc=True)
        self.fd_epoch = 0
        self.takeovers = 0
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._beat_seen: Dict[int, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._publish_doc()
        self._publish_gauges()

    # ------------------------------------------------------------- state

    def _publish_doc(self) -> None:
        # Snapshot under the lock, put outside it: the supervisor
        # mutates owners/fd_epoch under self._lock, and the KV put is
        # network I/O that must not ride inside the critical section.
        with self._lock:
            doc = {
                "frontends": self.frontends,
                "owners": dict(self.owners),
                "fd_epoch": self.fd_epoch,
            }
        self._kv.put(SCOPE, FRONTDOOR_KEY, pickle.dumps(doc))

    def _publish_gauges(self) -> None:
        from ..obs import get_registry  # noqa: PLC0415

        reg = get_registry()
        reg.gauge("serve.frontend.count").set(self.frontends)
        reg.gauge("serve.frontend.alive").set(
            sum(1 for p in self._pumps.values()
                if p.alive() or p._thread is None and not p._killed)
        )

    @property
    def ingested(self) -> int:
        return (sum(p.ingested for p in self._pumps.values())
                + self._gc_pump.ingested)

    def stats(self) -> dict:
        """Front-door provenance for bench records and tests:
        per-shard ingest counters, ownership, takeover history."""
        by_shard: Dict[int, int] = {}
        for p in self._pumps.values():
            for s, c in p.ingested_by_shard.items():
                by_shard[s] = by_shard.get(s, 0) + c
        # stats() runs on bench/test/metrics threads while the
        # supervisor mutates this state under self._lock mid-takeover:
        # iterating self.owners bare can observe a dict resize, and a
        # bare fd_epoch/takeovers pair can be torn across a takeover.
        with self._lock:
            owners = {int(k): int(v) for k, v in self.owners.items()}
            fd_epoch = self.fd_epoch
            takeovers = self.takeovers
        return {
            "frontends": self.frontends,
            "owners": owners,
            "fd_epoch": fd_epoch,
            "takeovers": takeovers,
            "ingested_by_shard": {int(s): by_shard[s]
                                  for s in sorted(by_shard)},
        }

    def prometheus(self) -> str:
        """Launcher-local ``serve.frontend.*`` series for the live
        plane's /metrics exposition (the same add_render lane the
        autoscale controller uses — these series exist only on the
        launcher, so worker snapshots never carry them)."""
        s = self.stats()
        lines = [
            f"hvdtpu_serve_frontend_count {s['frontends']}",
            f"hvdtpu_serve_frontend_takeovers {s['takeovers']}",
            f"hvdtpu_serve_frontend_fd_epoch {s['fd_epoch']}",
        ]
        for fid in sorted(self._pumps):
            up = 1 if self._pumps[fid].alive() else 0
            lines.append(
                f'hvdtpu_serve_frontend_up{{fid="{fid}"}} {up}')
        for shard, count in s["ingested_by_shard"].items():
            owner = s["owners"].get(shard, -1)
            lines.append(
                f'hvdtpu_serve_frontend_ingested'
                f'{{shard="{shard}",owner="{owner}"}} {count}')
        return "\n".join(lines) + "\n"

    def poll_takeover(self) -> List[dict]:
        """Drain queued takeover events (``{"fid", "owner", "shards"}``)
        — the elastic monitor consumes these and re-mints the serving
        epoch, one mint per event."""
        with self._lock:
            events, self._events = self._events, []
            return events

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        for pump in self._pumps.values():
            pump.start()
        self._gc_pump.start()
        self._thread = threading.Thread(
            target=self._supervise, name="hvdtpu_serve_frontdoor",
            daemon=True,
        )
        self._thread.start()

    def kill(self, fid: int) -> None:
        """Chaos hook: abruptly kill frontend ``fid`` mid-stream (no
        drain, no handoff) — the supervisor must detect it and the
        surviving frontends must strand nothing."""
        self._pumps[int(fid)].kill()

    def _supervise(self) -> None:
        tick = max(self.interval, 0.02)
        while not self._stop.wait(tick):
            try:
                self._check_pumps()
            except Exception as exc:  # pragma: no cover - defensive
                LOG.warning("frontdoor supervisor tick failed: %s", exc)

    def _check_pumps(self) -> None:
        now = time.monotonic()
        dead: List[int] = []
        for fid, pump in sorted(self._pumps.items()):
            if pump._stopped:
                continue
            if not pump.alive():
                dead.append(fid)
                continue
            seen = self._beat_seen.get(fid)
            if seen is None or seen[0] != pump.beats:
                self._beat_seen[fid] = (pump.beats, now)
            elif now - seen[1] > self.heartbeat_timeout:
                LOG.warning(
                    "frontend %d heartbeat stale > %.1fs; declaring "
                    "it dead", fid, self.heartbeat_timeout,
                )
                pump.kill()
                # Bounded join: kill() only raises the stop flag, so a
                # LIVE-but-slow pump may still be mid-round.  Most
                # stalls end quickly once noticed — joining here makes
                # the takeover race-free in the common case; a pump
                # still wedged past the bound is fenced off by
                # _ShardFence instead (ownership flips before the
                # adopter appends, and the zombie's leftover writes
                # abort on the owner check).
                if pump._thread is not None:
                    pump._thread.join(timeout=0.5)
                dead.append(fid)
        for fid in dead:
            self._takeover(fid)
        if dead:
            self._publish_gauges()
        # The GC pump has no heartbeat (fid=-1 publishes none), so it
        # is supervised by thread liveness: if it dies — it is exempt
        # from the chaos point, but defense-in-depth against a real
        # crash — respawn it, or stale-epoch and finished-output GC
        # silently stops for the rest of the job.
        gc = self._gc_pump
        if gc._thread is not None and not gc._stopped and not gc.alive():
            LOG.warning("GC pump died; respawning it")
            fresh = IngestPump(self._server, gc.interval,
                               gc.out_ttl_secs, fid=-1,
                               frontends=self.frontends, shards=(),
                               gc=True)
            # Carry the done-TTL tracking over so already-finished
            # outputs keep their original GC deadline.
            fresh._done_seen = dict(gc._done_seen)
            self._gc_pump = fresh
            fresh.start()

    def _takeover(self, fid: int) -> None:
        from ..obs import get_registry  # noqa: PLC0415

        pump = self._pumps[fid]
        shards = pump.shards
        self._beat_seen.pop(fid, None)
        survivors = [f for f, p in sorted(self._pumps.items())
                     if f != fid and p.alive() and not p._stopped]
        if survivors:
            owner = survivors[0]
            # Fence FIRST, adopt second: each shard's ownership flips
            # under its lock (waiting out an in-flight round, bounded)
            # before the survivor can append to it, so a
            # false-positive death — the pump was alive but slow —
            # cannot double-ingest against its adopter.
            for s in shards:
                self._fence.transfer(s, owner)
            self._pumps[owner].adopt(shards)
            # Retire the dead pump: its shards are re-owned, so the
            # supervisor must not re-fire this takeover every tick.
            pump._stopped = True
        else:
            # No survivor (F=1, or everyone died at once): spawn a
            # replacement pump in place — the supervisor is the actor
            # of last resort.  Ownership stays with this fid; the
            # per-shard fence locks still serialize the replacement
            # against the corpse's possible in-flight last round.
            owner = fid
            fresh = IngestPump(
                self._server, self.interval, pump.out_ttl_secs,
                fid=fid, frontends=self.frontends, shards=shards,
                gc=False, fence=self._fence,
            )
            # The replacement inherits the corpse's ingest accounting:
            # counters survive a respawn the way a rank's completed
            # work survives an epoch — stats()/bench records must not
            # read a death as traffic vanishing.
            fresh.ingested_by_shard = dict(pump.ingested_by_shard)
            self._pumps[fid] = fresh
            fresh.start()
        with self._lock:
            for s in shards:
                self.owners[s] = owner
            self.fd_epoch += 1
            self.takeovers += 1
            fd_epoch = self.fd_epoch
            self._events.append({"fid": fid, "owner": owner,
                                 "shards": list(shards)})
        self._publish_doc()
        reg = get_registry()
        reg.counter("serve.frontend.takeovers").inc()
        LOG.warning("frontend %d dead; shards %s taken over by "
                    "frontend %d (fd_epoch %d)", fid, shards, owner,
                    fd_epoch)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for pump in self._pumps.values():
            try:
                pump.stop()
            except Exception:  # pragma: no cover - defensive
                pass
        try:
            self._gc_pump.stop()
        except Exception:  # pragma: no cover - defensive
            pass
