"""Continuous-batching scheduler core: iteration-level admit/evict over
a fixed pool of batch slots.

A copy of ``horovod_tpu/serve/scheduler.py`` (pure Python), so the port
imports nothing of the JAX package; the decisions are the reference's,
held against it by ``tests/test_torch_serve.py``.  The lint registration
described below is the reference file's.

Orca-style scheduling (Yu et al., OSDI '22) reduced to its SPMD
essentials: between decode steps, queued requests are admitted into
free slots (FCFS, lowest-numbered slot first) and finished sequences
(EOS or token budget) are evicted immediately, their slots recycled —
so ONE compiled ``decode_step`` shape serves a churning request mix
without recompilation.

This module is deliberately a **pure state machine**: no framework, no
networking, no clocks, no rank awareness.  Every rank of the serving
world runs its own instance and feeds it the SAME inputs in the SAME
order (new requests from the rank-0 schedule broadcast, token
observations from the deterministic decode math) — so every rank
derives an identical admit/evict schedule.  That is the serving plane's
HVD001 invariant: a rank-divergent schedule here is exactly the
divergent-collective deadlock class hvdtpu-lint checks for on the
training side, which is why nothing in this file may consult
``hvd.rank()``, a wall clock, or an unordered dict iteration.  Unit
tests drive the decision table directly (tests/test_serve.py), and the
multi-rank determinism test replays one trace through N instances.

In the reference the contract is also *statically checked*: hvdtpu-lint's
HVD012 registers this module (and anything marked ``# hvdtpu:
deterministic``) as a determinism contract and rejects any clock /
``random`` / hash-order / rank read in its call tree at lint time —
the invariant holds on every diff, not just when the replay test runs.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["Request", "ActiveSlot", "Admission", "Eviction",
           "SlotScheduler", "TenantQoS", "SLO_CLASSES"]

# The SLO vocabulary and its default admission weights: an
# ``interactive`` head outranks a ``standard`` head outranks a
# ``batch`` head, 8:4:1.  Pure data — the frontend validates the class
# names (validate_request), the scheduler only weighs them.
SLO_CLASSES: Tuple[str, ...] = ("interactive", "standard", "batch")
_DEFAULT_WEIGHTS: Dict[str, int] = {
    "interactive": 8, "standard": 4, "batch": 1,
}


@dataclass(frozen=True)
class Request:
    """One generation request.  ``arrival`` is informational (latency
    accounting) — scheduling NEVER reads it; order of arrival is fixed
    by the ingest log's sequence numbers, not by clocks.

    ``temperature``/``top_k`` select per-request sampling
    (serve/sampling.py): pure DATA here — the scheduler never reads
    them either; the engine keys the PRNG stream on (rid, emission
    index, serve seed), so they stay rank-deterministic."""

    rid: str
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    arrival: float = 0.0
    temperature: float = 0.0
    top_k: int = 0
    # Multi-tenant QoS (pure data like temperature/top_k): ``tenant``
    # names the budget bucket, ``slo`` the admission weight class.
    # With qos=None the scheduler never reads either — the
    # single-tenant path stays byte-identical FCFS.
    tenant: str = "default"
    slo: str = "standard"

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.rid!r} has an empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid!r}: max_new_tokens must be >= 1"
            )
        if self.temperature < 0:
            raise ValueError(
                f"request {self.rid!r}: temperature must be >= 0"
            )
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError(
                f"request {self.rid!r}: tenant must be a non-empty str"
            )

    @property
    def cost(self) -> int:
        """Admission cost in tokens — the same worst case the paged
        pool commits (prompt + full budget), so one number drives both
        capacity and tenant budgets."""
        return len(self.prompt) + self.max_new_tokens


@dataclass
class ActiveSlot:
    """One slot's live request plus its emission progress."""

    req: Request
    slot: int
    emitted: List[int] = field(default_factory=list)
    # Serving-step index the admission happened at (scheduling never
    # reads it; the frontend publishes it so tests and operators can
    # SEE continuous admission — requests entering mid-stream).
    admitted_step: int = 0
    # How many of `emitted` were replayed from a dead world's streams
    # rather than generated here (scheduling never reads it; the trace
    # plane uses it to mark the replayed prefix on a request's
    # waterfall lane, and snapshot() exposes it for introspection).
    resumed: int = 0

    @property
    def done(self) -> bool:
        if len(self.emitted) >= self.req.max_new_tokens:
            return True
        return bool(
            self.emitted
            and self.req.eos_id is not None
            and self.emitted[-1] == self.req.eos_id
        )


@dataclass(frozen=True)
class Admission:
    slot: int
    req: Request
    resume: Tuple[int, ...]  # already-emitted tokens (elastic replay)


@dataclass(frozen=True)
class Eviction:
    slot: int
    rid: str
    reason: str  # "eos" | "budget"
    tokens: Tuple[int, ...]
    admitted_step: int = 0
    resumed: int = 0  # replayed-prefix length (see ActiveSlot.resumed)


class TenantQoS:
    """Deterministic weighted-fair admission policy.

    Pure configuration + arithmetic — every rank constructs an
    identical instance from the job spec and the scheduler derives the
    identical pick from it, so the HVD001/HVD012 determinism contract
    extends through multi-tenant admission unchanged.  Three rules,
    applied to the per-tenant FIFO heads of the queue:

    1. **Budgets** — with ``budget_tokens`` set, a tenant whose spend
       this window (admitted ``prompt + max_new_tokens``) would exceed
       the budget is *throttled*: skipped, counted, resumed at the
       next window.  Windows are serving-step-indexed
       (``step // window_steps``), never wall clock — every rank
       refills at the same broadcast step.
    2. **SLO preemption** — among un-throttled heads, the highest
       ``weights[slo]`` wins: an interactive head admits before a
       batch head that arrived earlier.
    3. **Weighted fairness** — within one weight class, the tenant
       with the lowest *virtual time* wins; each admission advances
       the winner's clock by ``cost / weight``, so long-run admitted
       tokens converge to the weight ratio.  Ties break on arrival
       (queue) order.

    Honest limit: a tenant arriving late starts at virtual time 0 and
    briefly wins its weight class until its clock catches up — the
    window is bounded by one backlog's worth of cost, and the trade
    (no global clock to maintain) keeps the policy a pure fold over
    the admission sequence.
    """

    def __init__(self, weights: Optional[Dict[str, int]] = None,
                 budget_tokens: Optional[int] = None,
                 window_steps: int = 64):
        self.weights = dict(_DEFAULT_WEIGHTS)
        if weights:
            self.weights.update({str(k): int(v)
                                 for k, v in sorted(weights.items())})
        if any(w < 1 for w in self.weights.values()):
            raise ValueError("slo weights must be >= 1")
        self.budget_tokens = (None if budget_tokens is None
                              else int(budget_tokens))
        if self.budget_tokens is not None and self.budget_tokens < 1:
            raise ValueError("budget_tokens must be >= 1")
        self.window_steps = max(int(window_steps), 1)

    @classmethod
    def from_spec(cls, cfg: Optional[dict]) -> Optional["TenantQoS"]:
        """Build from the job spec's ``tenants`` dict (None/{} = off).
        The spec travels to every rank identically (pickled func /
        forwarded env), which is what makes the policy rank-identical
        by construction."""
        if not cfg:
            return None
        return cls(weights=cfg.get("weights"),
                   budget_tokens=cfg.get("budget_tokens"),
                   window_steps=int(cfg.get("window_steps") or 64))

    def weight_of(self, slo: str) -> int:
        return self.weights.get(slo, 1)


class SlotScheduler:
    """The per-rank scheduling state machine.

    Lifecycle per decode step::

        sched.enqueue(req)            # rank-0-broadcast new arrivals
        admits = sched.admit()        # queued -> free slots, FCFS
        ... engine prefills each admission, decodes active slots ...
        sched.record(slot, token)     # one emitted token per live slot
        evicts = sched.evict_finished()

    Deterministic by construction: the queue is FCFS, free slots are
    handed out in ascending slot order, and eviction order is ascending
    slot order.
    """

    def __init__(self, num_slots: int,
                 qos: Optional[TenantQoS] = None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.queue: Deque[Tuple[Request, Tuple[int, ...]]] = deque()
        self.active: Dict[int, ActiveSlot] = {}
        # Tenant-aware admission (TenantQoS); None keeps the original
        # FCFS path byte-identical.  All the per-tenant state below is
        # a pure fold over (enqueue order, admit(step) calls) — no
        # clocks, no ranks, no unordered iteration (HVD012).
        self.qos = qos
        self.vtime: Dict[str, float] = {}     # weighted-fair clocks
        self.spent: Dict[str, int] = {}       # window token spend
        self.throttled: Dict[str, int] = {}   # cumulative throttles
        self.admitted_tokens: Dict[str, int] = {}  # cumulative cost
        self._window = -1

    # ------------------------------------------------------------ intake

    def enqueue(self, req: Request,
                resume: Sequence[int] = ()) -> None:
        """Append to the FCFS queue.  ``resume``: tokens the request
        already emitted before a world break — the admission carries
        them so the engine re-prefills ``prompt + resume`` instead of
        restarting the generation (zero dropped requests on respawn).
        A request whose resume already satisfies its stop condition
        must not be re-admitted; the caller detects that via
        :meth:`ActiveSlot.done` semantics replicated here."""
        self.queue.append((req, tuple(resume)))

    # --------------------------------------------------------- admission

    def free_slots(self) -> List[int]:
        return [s for s in range(self.num_slots) if s not in self.active]

    # hvdtpu: deterministic
    def admit(self, step: int = 0, can_admit=None) -> List[Admission]:
        """Admit queued requests into free slots: FCFS, lowest slot
        first.  Mutates the schedule and returns the admissions in
        order.  ``step`` is recorded on the slot for observability
        only — it never influences the decision.

        ``can_admit(req, resume) -> bool`` is the CAPACITY gate (paged
        KV: are there free pages for this request's worst case?).  FCFS
        is strict: when the HEAD of the queue does not fit, admission
        stops — skipping ahead would let a stream of small requests
        starve a big one, and (worse) make the admit order depend on
        capacity timing in a way that is harder to reason about across
        elastic replays.  The gate MUST be a deterministic function of
        the schedule so far (the engine's page accounting is), or ranks
        diverge — the HVD001 invariant extends through this callback.

        With a :class:`TenantQoS` policy the pick is the qos-chosen
        head (budget -> slo weight -> virtual time -> arrival) and
        admission is head-strict on THAT head: when the chosen head
        does not fit, admission stops — skipping past it would
        re-introduce exactly the capacity-timing dependence and
        big-request starvation strict FCFS exists to prevent.
        """
        out: List[Admission] = []
        if self.qos is None:
            for slot in self.free_slots():
                if not self.queue:
                    break
                req, resume = self.queue[0]
                if can_admit is not None and not can_admit(req, resume):
                    break
                self.queue.popleft()
                self.active[slot] = ActiveSlot(req=req, slot=slot,
                                               emitted=list(resume),
                                               admitted_step=step,
                                               resumed=len(resume))
                out.append(Admission(slot=slot, req=req, resume=resume))
            return out
        self._maybe_refill(step)
        throttled_this_call: Set[str] = set()
        for slot in self.free_slots():
            if not self.queue:
                break
            pick = self._pick(throttled_this_call)
            if pick is None:
                break  # every queued tenant is over budget this window
            req, resume = self.queue[pick]
            if can_admit is not None and not can_admit(req, resume):
                break
            del self.queue[pick]
            w = self.qos.weight_of(req.slo)
            self.vtime[req.tenant] = (
                self.vtime.get(req.tenant, 0.0) + req.cost / w
            )
            self.spent[req.tenant] = (
                self.spent.get(req.tenant, 0) + req.cost
            )
            self.admitted_tokens[req.tenant] = (
                self.admitted_tokens.get(req.tenant, 0) + req.cost
            )
            self.active[slot] = ActiveSlot(req=req, slot=slot,
                                           emitted=list(resume),
                                           admitted_step=step,
                                           resumed=len(resume))
            out.append(Admission(slot=slot, req=req, resume=resume))
        return out

    def _maybe_refill(self, step: int) -> None:
        """Step-indexed budget window: every rank calls admit() with
        the same broadcast step, so every rank refills at the same
        instant — the no-clocks budget refill."""
        if self.qos is None or self.qos.budget_tokens is None:
            return
        win = step // self.qos.window_steps
        if win != self._window:
            self._window = win
            self.spent = {}

    def _pick(self, throttled_this_call: Set[str]) -> Optional[int]:
        """Queue index of the next admission under the QoS rules, or
        None when every queued tenant is throttled.  One forward scan:
        each tenant's FIRST queued request is its head (per-tenant
        FIFO), heads compete on (budget, slo weight, virtual time,
        arrival order) — every input a pure function of the schedule
        so far."""
        assert self.qos is not None
        budget = self.qos.budget_tokens
        heads: Dict[str, int] = {}
        for idx, (req, _) in enumerate(self.queue):
            if req.tenant not in heads:
                heads[req.tenant] = idx
        best: Optional[Tuple[int, float, int]] = None
        best_idx: Optional[int] = None
        for tenant in sorted(heads):
            idx = heads[tenant]
            req = self.queue[idx][0]
            if budget is not None and \
                    self.spent.get(tenant, 0) + req.cost > budget:
                if tenant not in throttled_this_call:
                    throttled_this_call.add(tenant)
                    self.throttled[tenant] = (
                        self.throttled.get(tenant, 0) + 1
                    )
                continue
            key = (-self.qos.weight_of(req.slo),
                   self.vtime.get(tenant, 0.0), idx)
            if best is None or key < best:
                best, best_idx = key, idx
        return best_idx

    # ---------------------------------------------------------- progress

    def record(self, slot: int, token: int) -> None:
        """Record one emitted token for a live slot."""
        act = self.active.get(slot)
        if act is None:
            raise KeyError(f"slot {slot} has no active request")
        if act.done:
            raise ValueError(
                f"slot {slot} ({act.req.rid}) is finished; the engine "
                f"must not emit past the stop condition"
            )
        act.emitted.append(int(token))

    # hvdtpu: deterministic
    def evict_finished(self) -> List[Eviction]:
        """Evict every finished slot (ascending order), freeing it for
        the next step's admissions."""
        out: List[Eviction] = []
        for slot in sorted(self.active):
            act = self.active[slot]
            if not act.done:
                continue
            reason = (
                "eos"
                if act.req.eos_id is not None
                and act.emitted
                and act.emitted[-1] == act.req.eos_id
                else "budget"
            )
            out.append(Eviction(slot=slot, rid=act.req.rid,
                                reason=reason,
                                tokens=tuple(act.emitted),
                                admitted_step=act.admitted_step,
                                resumed=act.resumed))
            del self.active[slot]
        return out

    # ------------------------------------------------------------- views

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active_slots(self) -> int:
        return len(self.active)

    def idle(self) -> bool:
        return not self.queue and not self.active

    def tenant_depths(self) -> Dict[str, int]:
        """Queued requests per tenant (sorted tenant order) — the
        ``serve.tenant.queued`` gauges.  Observability only; admission
        never calls it."""
        depths: Dict[str, int] = {}
        for req, _ in self.queue:
            depths[req.tenant] = depths.get(req.tenant, 0) + 1
        return {t: depths[t] for t in sorted(depths)}

    def snapshot(self) -> List[dict]:
        """In-flight then queued requests as plain dicts (ascending
        slot order, then queue order) — introspection/debugging view.
        NOTE: elastic recovery does NOT flow through this method; the
        authoritative replay is service._build_recovery(), which joins
        the durable KV ingest log with the published token streams (a
        respawned leader has no in-memory scheduler to snapshot)."""
        return [
            {
                "rid": act.req.rid,
                "prompt": list(act.req.prompt),
                "max_new_tokens": act.req.max_new_tokens,
                "eos_id": act.req.eos_id,
                "arrival": act.req.arrival,
                "tenant": act.req.tenant,
                "slo": act.req.slo,
                "emitted": list(act.emitted),
                "resumed": act.resumed,
            }
            for _, act in sorted(self.active.items())
        ] + [
            {
                "rid": req.rid,
                "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "arrival": req.arrival,
                "tenant": req.tenant,
                "slo": req.slo,
                "emitted": list(resume),
            }
            for req, resume in self.queue
        ]
