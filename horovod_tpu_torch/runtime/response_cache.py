"""Response cache for the Python eager engine's steady-state fast path (a
copy of ``horovod_tpu/runtime/response_cache.py``, which imports no JAX).

Reference: horovod/common/response_cache.cc — an LRU cache of previously
negotiated Responses keyed by tensor name + parameters; once every rank's
queued messages hit the cache, negotiation collapses from exchanging full
serialized RequestLists to a fixed-size **bit-vector vote**
(CacheCoordinator::sync, response_cache.h:107-167).

Coherence model (the whole design hangs on this): cache mutations happen
only from data every rank observes identically — insertions in response-
construction order during slow-path negotiation, LRU touches in cached-
response execution order, evictions on conflicting re-submissions that
every rank sees in the gathered payloads.  All ranks therefore hold
bitwise-identical caches and a slot index means the same tensor
everywhere, which is what makes the armed-bit vote sufficient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .messages import Request, RequestType, Response, ResponseType

# lookup() outcomes
MISS = 0    # name unknown -> negotiate, then insert
HIT = 1     # signature matches -> vote the slot bit
CONFLICT = 2  # name cached with DIFFERENT params -> evict + renegotiate


def request_signature(req: Request) -> tuple:
    """Everything that must match for a cached response to be reusable
    (reference response_cache.cc keyed on name + the full request params)."""
    return (
        req.tensor_name,
        int(req.request_type),
        req.dtype,
        tuple(req.shape),
        req.reduce_op,
        req.root_rank,
        req.prescale_factor,
        req.postscale_factor,
        # req.device deliberately EXCLUDED: residency may legitimately
        # differ across ranks (a CPU tensor on one, a CUDA tensor on another),
        # and a rank-varying field in the signature would make mixed
        # submissions permanently thrash HIT/CONFLICT.  The executed plane
        # is the NEGOTIATED one stored on the slot (_Slot.device), identical
        # everywhere.
    )


def cacheable(rtype: RequestType) -> bool:
    """ALLGATHER is excluded: its response depends on per-submission ragged
    dim-0 sizes (Response::tensor_sizes), so a cached copy would be stale
    by construction.  BARRIER/JOIN are control events, not data ops."""
    return rtype in (
        RequestType.ALLREDUCE,
        RequestType.ADASUM,
        RequestType.BROADCAST,
        RequestType.ALLTOALL,
        RequestType.REDUCESCATTER,
    )


@dataclass
class _Slot:
    signature: tuple
    response_type: ResponseType
    tensor_name: str
    shape: Tuple[int, ...]
    dtype: str
    root_rank: int
    fuse_meta: Optional[tuple]
    nbytes: int
    device: bool = False
    lru_tick: int = 0


class ResponseCache:
    """Fixed-capacity slot table; slot index == bit position in the vote."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 0)
        self._slots: Dict[int, _Slot] = {}
        self._by_name: Dict[str, int] = {}
        self._tick = 0
        # Content-mutation counter: bumped on every insert/evict (NOT on
        # LRU touches, which don't change what a slot means).  All
        # mutations derive from data every rank observes identically, so
        # the counter is bitwise-identical everywhere — which is what
        # lets (mutations, slot list) serve as an exact fingerprint of
        # an executed schedule for the replay fast path.
        self._mutations = 0
        # Slots shielded from LRU eviction this cycle (slots some rank is
        # actively voting on — set by the engine from the gathered bit
        # matrix, which is identical on every rank, keeping eviction
        # decisions coherent).
        self.protected: frozenset = frozenset()

    def __len__(self) -> int:
        return len(self._slots)

    @property
    def num_bits(self) -> int:
        return (self.capacity + 7) // 8

    def lookup(self, req: Request) -> Tuple[int, int]:
        """-> (status, slot).  slot is -1 unless status is HIT/CONFLICT."""
        if self.capacity == 0 or not cacheable(req.request_type):
            return MISS, -1
        slot = self._by_name.get(req.tensor_name)
        if slot is None:
            return MISS, -1
        if self._slots[slot].signature == request_signature(req):
            return HIT, slot
        return CONFLICT, slot

    def touch(self, slot: int) -> None:
        """LRU touch — call in deterministic (execution) order only."""
        self._tick += 1
        self._slots[slot].lru_tick = self._tick

    def evict_name(self, name: str) -> None:
        slot = self._by_name.pop(name, None)
        if slot is not None:
            del self._slots[slot]
            self._mutations += 1

    def schedule_key(self, slots) -> tuple:
        """Exact fingerprint of the cached schedule ``slots`` (a sorted
        slot-index iterable): identical across cycles iff the executed
        schedule is bitwise-identical.  The mutation counter folds in
        slot *content*: a conflict-evict-reinsert that reuses the same
        index still changes the key.  Coherent across ranks because
        every mutation is (see the module docstring)."""
        return (self._mutations, tuple(slots))

    def insert(self, req: Request, resp: Response) -> None:
        """Insert a freshly negotiated (pre-fusion) response.  Called in
        response-construction order — identical on every rank."""
        if self.capacity == 0 or not cacheable(req.request_type):
            return
        self.evict_name(req.tensor_name)
        if len(self._slots) >= self.capacity:
            victims = [
                s for s in self._slots if s not in self.protected
            ]
            if not victims:
                # every slot is being voted on: skip the insertion rather
                # than strand a voter (deterministic — protected set and
                # occupancy are identical on every rank)
                return
            victim = min(victims, key=lambda s: self._slots[s].lru_tick)
            del self._by_name[self._slots[victim].tensor_name]
            del self._slots[victim]
            self._mutations += 1
        # lowest free slot: deterministic allocation
        slot = next(i for i in range(self.capacity) if i not in self._slots)
        self._tick += 1
        self._mutations += 1
        self._slots[slot] = _Slot(
            signature=request_signature(req),
            response_type=resp.response_type,
            tensor_name=req.tensor_name,
            shape=tuple(req.shape),
            dtype=req.dtype,
            root_rank=req.root_rank,
            fuse_meta=getattr(resp, "_fuse_meta", None),
            nbytes=getattr(resp, "_nbytes", 0),
            device=getattr(resp, "_device", False),
            lru_tick=self._tick,
        )
        self._by_name[req.tensor_name] = slot

    def response_for(self, slot: int) -> Response:
        """Reconstruct the negotiated response from the cache (reference
        executes the stored Response object; we store its template)."""
        s = self._slots[slot]
        resp = Response(s.response_type, [s.tensor_name])
        resp._shapes = [tuple(s.shape)]  # type: ignore[attr-defined]
        resp._dtype = s.dtype  # type: ignore[attr-defined]
        resp._root_rank = s.root_rank  # type: ignore[attr-defined]
        if s.fuse_meta is not None:
            resp._fuse_meta = s.fuse_meta  # type: ignore[attr-defined]
        resp._nbytes = s.nbytes  # type: ignore[attr-defined]
        resp._device = s.device  # type: ignore[attr-defined]
        return resp

    def name_for(self, slot: int) -> str:
        return self._slots[slot].tensor_name
