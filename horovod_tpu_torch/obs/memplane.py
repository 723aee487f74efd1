"""Device-memory plane: per-owner accounting, per-program breakdowns and
the OOM black box (counterpart of ``horovod_tpu/obs/memplane.py``).

* **Static accounting** — a program's breakdown (argument / output /
  temp / alias bytes) is registered with :func:`register_program`.  The
  reference reads it from the compiled XLA program
  (``compiled.memory_analysis()``); PyTorch runs no compiled program to
  read, so the port's callers pass ``stats=`` with what they measured
  (the training step passes its measured peak, ``torch.cuda.
  max_memory_allocated()``, as ``temp_bytes``), and
  :func:`parse_memory_analysis` reads an object or dict of that shape
  when one is given and answers ``source: unavailable`` otherwise.
* **Dynamic census** — :func:`census` buckets the tensors the
  :func:`register_owner` suppliers return (params / optimizer_state /
  grad_buckets / kv_cache), deduplicating views of one storage by
  ``untyped_storage().data_ptr()``.  There is no ``jax.live_arrays()``:
  ``other`` is ``torch.cuda.memory_allocated()`` less the owned bytes,
  and the backend stats are ``torch.cuda.memory_stats()``.  On the CPU
  the census reports the owners' bytes and no device totals.
* **OOM black box** — :func:`maybe_record_oom` (hooked into
  ``flightrec.record_exception``) detects an out-of-memory error
  (``torch.cuda.OutOfMemoryError`` or a RESOURCE_EXHAUSTED message) and
  drops a ``mem.oom`` event carrying the last census and the dominant
  owner into the flight-recorder ring, which the post-mortem's memory
  verdict reads.  :func:`alloc_guard` is the ``mem_alloc`` fault point's
  consumer.

:func:`kv_occupancy` is the pure math behind
``serve.kv.{allocated_bytes,live_bytes,waste_ratio}``, the reference's.

No torch import at module scope: the launcher imports obs eagerly.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "OWNERS",
    "parse_memory_analysis",
    "register_program",
    "program_report",
    "reset_programs",
    "register_owner",
    "reset_owners",
    "census",
    "last_census",
    "install_census",
    "device_memory_stats",
    "dominant_owner",
    "kv_occupancy",
    "memory_record",
    "is_resource_exhausted",
    "resource_exhausted_error",
    "alloc_guard",
    "maybe_record_oom",
    "record_oom",
]

# The owner taxonomy.  Free-form owners are accepted (a future subsystem
# can tag itself without touching this module) but the canonical five
# are what the docs, the digest and the post-mortem verdict talk about.
OWNERS = ("params", "optimizer_state", "grad_buckets", "kv_cache", "other")

# -- module state ------------------------------------------------------------
# REENTRANT locks: record_oom() runs from flightrec.record_exception,
# which excepthook/fatal-signal handlers call — a signal landing while
# the owning thread is mid-census must not self-deadlock the dying rank
# (a flush deadlock otherwise).
_lock = threading.RLock()
_owners: Dict[str, List[Callable]] = {}
_programs: Dict[str, dict] = {}
_last_census: Optional[dict] = None
_census_installed = False


# ---------------------------------------------------------------------------
# static accounting: compiled.memory_analysis()
# ---------------------------------------------------------------------------

# (breakdown key, memory_analysis attribute/dict key) pairs.
_MA_FIELDS = (
    ("argument_bytes", "argument_size_in_bytes"),
    ("output_bytes", "output_size_in_bytes"),
    ("temp_bytes", "temp_size_in_bytes"),
    ("alias_bytes", "alias_size_in_bytes"),
    ("generated_code_bytes", "generated_code_size_in_bytes"),
)


def parse_memory_analysis(compiled) -> dict:
    """Read a memory breakdown from ``compiled.memory_analysis()``.

    PyTorch has no compiled program to read: the port's callers use
    :func:`register_program` with ``stats=`` instead, and this reads any
    object whose ``memory_analysis()`` answers in the reference's shape.
    Returns ``{"source": "memory_analysis", "argument_bytes": …,
    "output_bytes": …, "temp_bytes": …, "alias_bytes": …,
    "generated_code_bytes": …, "total_bytes": …}`` where
    ``total_bytes`` is the per-device footprint of one
    execution: arguments + outputs + temporaries, minus the aliased
    (donated) bytes that are counted on both sides.

    Tolerates every per-version shape: the ``CompiledMemoryStats``
    attribute object, a plain dict, a single-element list
    of either, and an executable that exposes no analysis at all —
    those degrade to ``{"source": "unavailable"}``, never an exception
    (the ``flops_from_compiled`` contract, applied to bytes).
    """
    try:
        ma = compiled.memory_analysis()
    except Exception:
        return {"source": "unavailable"}
    if isinstance(ma, (list, tuple)):
        ma = ma[0] if ma else None
    if ma is None:
        return {"source": "unavailable"}
    out = {"source": "memory_analysis"}
    seen_any = False
    for key, field in _MA_FIELDS:
        if isinstance(ma, dict):
            v = ma.get(field)
        else:
            v = getattr(ma, field, None)
        try:
            v = int(v)
        except (TypeError, ValueError):
            v = None
        if v is not None:
            seen_any = True
            out[key] = v
        else:
            out[key] = 0
    if not seen_any:
        return {"source": "unavailable"}
    out["total_bytes"] = max(
        out["argument_bytes"] + out["output_bytes"] + out["temp_bytes"]
        - out["alias_bytes"], 0,
    )
    return out


def register_program(name: str, compiled=None, *, stats: Optional[dict] = None,
                     registry=None) -> dict:
    """Record one compiled program's memory breakdown and publish it as
    ``mem.compiled.*{program=name}`` gauges.  Call with the executable
    at the compile site (``stats=`` accepts a pre-parsed breakdown — the
    mem gate reuses it).  Re-registration overwrites: a recompile's
    numbers are the current truth.  Never raises — accounting is
    observability, not correctness."""
    try:
        if stats is None:
            stats = parse_memory_analysis(compiled)
        with _lock:
            _programs[name] = dict(stats)
        if stats.get("source") != "memory_analysis":
            return stats
        from .registry import get_registry  # noqa: PLC0415

        reg = registry if registry is not None else get_registry()
        for key, _ in _MA_FIELDS:
            reg.gauge(f"mem.compiled.{key}", program=name).set(
                stats.get(key, 0)
            )
        reg.gauge("mem.compiled.total_bytes", program=name).set(
            stats.get("total_bytes", 0)
        )
        return stats
    except Exception:
        return stats if isinstance(stats, dict) else {"source": "unavailable"}


def program_report() -> Dict[str, dict]:
    """``{program name -> breakdown}`` of everything registered so far
    (what BENCH records embed)."""
    with _lock:
        return {k: dict(v) for k, v in _programs.items()}


def reset_programs() -> None:
    """Drop registered program breakdowns (tests)."""
    with _lock:
        _programs.clear()


# ---------------------------------------------------------------------------
# dynamic census: owner tagging + the CUDA caching allocator's stats
# ---------------------------------------------------------------------------


def register_owner(owner: str, supplier: Callable) -> None:
    """Tag a logical owner of device memory.  ``supplier`` is called at
    census time and returns the owner's CURRENT pytree (or None when
    the owner is gone — dead suppliers are pruned, so register through
    a weakref when the owner's lifetime is shorter than the process:
    ``register_owner("kv_cache", lambda r=weakref.ref(e): (r() or
    _G).cache)``-style).  Suppliers must be cheap: they run on every
    registry snapshot once :func:`install_census` armed the plane."""
    with _lock:
        _owners.setdefault(owner, []).append(supplier)


def reset_owners() -> None:
    """Drop every owner supplier (tests, or a full plane re-arm)."""
    with _lock:
        _owners.clear()


def _leaves(tree) -> List:
    """The tensors of a supplier's answer: a tensor, a module (its
    parameters and buffers), an optimizer (its state), or dicts, lists
    and tuples of those."""
    import torch  # noqa: PLC0415

    out: List = []
    stack = [tree]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            out.append(item)
        elif isinstance(item, torch.nn.Module):
            out.extend(item.parameters())
            out.extend(item.buffers())
        elif isinstance(item, torch.optim.Optimizer):
            stack.extend(item.state.values())
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
    return out


def _device_nbytes(leaf) -> Optional[int]:
    """Bytes of the storage under one tensor (a view counts its whole
    storage, once: :func:`_buffer_key` deduplicates).  None for a
    non-tensor or a meta tensor."""
    try:
        if leaf.device.type == "meta":
            return None
        return int(leaf.untyped_storage().nbytes())
    except Exception:
        return None


def _buffer_key(t):
    """Identity of a tensor's storage: views of one buffer share it."""
    try:
        return ("ptr", t.device.type, t.untyped_storage().data_ptr())
    except Exception:
        return ("id", id(t))


def device_memory_stats() -> dict:
    """The caching allocator's stats for this process's current CUDA
    device: ``{"source": "memory_stats", "bytes_in_use", "peak_bytes",
    "limit_bytes", "headroom_bytes"}``, or ``{"source": "unavailable"}``
    where no CUDA device is initialized (the CPU has no device memory to
    report)."""
    try:
        import torch  # noqa: PLC0415

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {"source": "unavailable"}
        ms = torch.cuda.memory_stats()
        limit = int(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    except Exception:
        return {"source": "unavailable"}
    in_use = int(ms.get("allocated_bytes.all.current", 0) or 0)
    return {
        "source": "memory_stats",
        "bytes_in_use": in_use,
        "peak_bytes": int(ms.get("allocated_bytes.all.peak", 0) or 0),
        "limit_bytes": limit or None,
        "headroom_bytes": (limit - in_use) if limit else None,
    }


def census(*, publish: bool = True, registry=None) -> dict:
    """One owner-bucketed pass over the suppliers' tensors plus the
    backend stats.  Returns (and caches as :func:`last_census`)::

        {"source": "memory_allocated" | "owners",
         "total_bytes": <device bytes allocated by this process, or the
                         owners' bytes where there is no CUDA device>,
         "owners": {"params": …, "kv_cache": …, …, "other": …},
         "device": <device_memory_stats()>}

    ``publish=True`` additionally sets the ``mem.*`` gauges.  A storage
    two owners share counts once (for the first), and ``other`` is the
    allocator's bytes that no owner claimed."""
    global _last_census
    with _lock:
        suppliers = [(owner, list(fns)) for owner, fns in _owners.items()]
    owners: Dict[str, int] = {}
    claimed: Dict[Tuple, str] = {}
    dead: List[Tuple[str, Callable]] = []
    for owner, fns in suppliers:
        total = 0
        for fn in fns:
            try:
                tree = fn()
            except Exception:
                tree = None
            if tree is None:
                dead.append((owner, fn))
                continue
            try:
                leaves = _leaves(tree)
            except Exception:
                leaves = []
            for leaf in leaves:
                b = _device_nbytes(leaf)
                if b is None:
                    continue
                key = _buffer_key(leaf)
                if key in claimed:
                    continue
                claimed[key] = owner
                total += b
        owners[owner] = owners.get(owner, 0) + total
    if dead:
        with _lock:
            for owner, fn in dead:
                fns = _owners.get(owner)
                if fns and fn in fns:
                    fns.remove(fn)
    source = "owners"
    total_live = sum(owners.values())
    other = 0
    dev = device_memory_stats()
    if dev.get("source") == "memory_stats":
        source = "memory_allocated"
        total_live = max(dev["bytes_in_use"], total_live)
        other = total_live - sum(owners.values())
    # ADD to (not overwrite) any explicitly-registered "other" supplier:
    # free-form owners are legal, and their claimed bytes must not
    # vanish from every bucket just because they chose this name.
    owners["other"] = owners.get("other", 0) + other
    doc = {
        "source": source,
        "total_bytes": int(total_live),
        "owners": {k: int(v) for k, v in owners.items()},
        "device": dev,
    }
    with _lock:
        _last_census = doc
    if publish:
        _publish_census(doc, registry=registry)
    return doc


def _publish_census(doc: dict, registry=None) -> None:
    try:
        from .registry import get_registry  # noqa: PLC0415

        reg = registry if registry is not None else get_registry()
        reg.gauge("mem.live_bytes").set(doc.get("total_bytes", 0))
        for owner, b in (doc.get("owners") or {}).items():
            reg.gauge("mem.owner_bytes", owner=owner).set(b)
        dev = doc.get("device") or {}
        if dev.get("source") == "memory_stats":
            # the reference's gauge names (the summary and the live
            # digest read them): here they hold the card's HBM3
            reg.gauge("mem.hbm_bytes_in_use").set(dev.get("bytes_in_use", 0))
            reg.gauge("mem.hbm_peak_bytes").set(dev.get("peak_bytes", 0))
            if dev.get("limit_bytes"):
                reg.gauge("mem.hbm_limit_bytes").set(dev["limit_bytes"])
                reg.gauge("mem.headroom_bytes").set(
                    dev.get("headroom_bytes") or 0
                )
    except Exception:
        pass  # gauges are observability, not correctness


def last_census() -> Optional[dict]:
    """The most recent :func:`census` result (what the OOM event
    falls back to when a fresh census cannot run inside the handler)."""
    with _lock:
        return dict(_last_census) if _last_census else None


def install_census(registry=None) -> None:
    """Arm the census as a registry collector: every snapshot (the live
    stream's publish round, the exit dump, ``collect_engine_gauges``)
    refreshes the ``mem.*`` gauges.  Idempotent."""
    global _census_installed
    with _lock:
        if _census_installed:
            return
        _census_installed = True
    from .registry import get_registry  # noqa: PLC0415

    reg = registry if registry is not None else get_registry()

    def _collect(r) -> None:
        census(publish=True, registry=r)

    reg.register_collector(_collect)


def reset_census() -> None:
    """Forget the cached census + installed-collector latch (tests;
    the collector itself dies with its registry)."""
    global _last_census, _census_installed
    with _lock:
        _last_census = None
        _census_installed = False


def dominant_owner(doc: Optional[dict] = None) -> Tuple[Optional[str], float]:
    """``(owner, share)`` of the biggest tagged-or-other bucket in a
    census (share of the census total).  ``(None, 0.0)`` on an empty
    census."""
    doc = doc or last_census()
    owners = (doc or {}).get("owners") or {}
    total = sum(owners.values())
    if not total:
        return None, 0.0
    owner = max(sorted(owners), key=lambda k: owners[k])
    return owner, owners[owner] / total


def memory_record() -> dict:
    """The record-embeddable view: one fresh census + every registered
    per-program breakdown.  Safe anywhere (before any device is used the
    census holds only the owners' bytes and the programs dict is
    empty)."""
    try:
        c = census(publish=False)
    except Exception:
        c = last_census() or {"source": "unavailable"}
    return {"census": c, "programs": program_report()}


# ---------------------------------------------------------------------------
# KV occupancy: allocated vs live bytes of a contiguous slot pool
# ---------------------------------------------------------------------------


def kv_occupancy(positions: Sequence[int], active_slots: Sequence[int],
                 cache_len: int, bytes_per_position: float,
                 pool_bytes: Optional[int] = None) -> dict:
    """Occupancy of a fixed-row KV slot pool.

    * ``allocated_bytes`` — what the contiguous design reserves for the
      busy slots: slots-in-use x worst-case ``cache_len`` rows.
    * ``live_bytes`` — positions those slots actually wrote:
      ``sum(pos[slot])`` x bytes-per-position.
    * ``waste_ratio`` — ``1 - live/allocated`` (0.0 when idle): the
      tail a short request wastes in a long-cache pool, i.e. the bytes
      paged attention reclaims.
    * ``pool_bytes`` — the whole pool's resident footprint (free slots
      included), when the caller knows it.
    """
    slots = sorted(set(int(s) for s in active_slots))
    allocated = len(slots) * int(cache_len) * float(bytes_per_position)
    live = 0.0
    for s in slots:
        pos = int(positions[s]) if 0 <= s < len(positions) else 0
        live += min(max(pos, 0), int(cache_len)) * float(bytes_per_position)
    out = {
        "slots_in_use": len(slots),
        "allocated_bytes": int(allocated),
        "live_bytes": int(live),
        "waste_ratio": (1.0 - live / allocated) if allocated else 0.0,
    }
    if pool_bytes is not None:
        out["pool_bytes"] = int(pool_bytes)
    return out


# ---------------------------------------------------------------------------
# OOM black box
# ---------------------------------------------------------------------------


class ResourceExhaustedError(RuntimeError):
    """Stand-in for the allocator's out-of-memory error where
    ``torch.cuda.OutOfMemoryError`` is not available."""


def resource_exhausted_error(message: str) -> BaseException:
    """An out-of-memory error shaped like the allocator's:
    ``torch.cuda.OutOfMemoryError`` (so ``except OutOfMemoryError``
    handlers and the OOM detector treat an injected death exactly like a
    real one), its message led by RESOURCE_EXHAUSTED as the reference's
    is."""
    if not message.startswith("RESOURCE_EXHAUSTED"):
        message = "RESOURCE_EXHAUSTED: " + message
    try:
        import torch  # noqa: PLC0415

        return torch.cuda.OutOfMemoryError(message)
    except Exception:
        return ResourceExhaustedError(message)


def is_resource_exhausted(exc: BaseException) -> bool:
    """Whether an exception is the out-of-device-memory signature: a
    ``torch.cuda.OutOfMemoryError`` (whatever its message), the local
    stand-in, or a message carrying RESOURCE_EXHAUSTED."""
    if isinstance(exc, ResourceExhaustedError):
        return True
    try:
        import torch  # noqa: PLC0415

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    try:
        return "RESOURCE_EXHAUSTED" in str(exc)
    except Exception:
        return False


def record_oom(where: str = "", exc: Optional[BaseException] = None) -> dict:
    """Drop a ``mem.oom`` event (last census + dominant owner) into the
    flight-recorder ring — the memory half of the black box.  Returns
    the event's parsed fields (tests assert on them)."""
    try:
        doc = census(publish=False)
    except Exception:
        doc = last_census() or {}
    owner, share = dominant_owner(doc)
    owners = (doc or {}).get("owners") or {}
    dev = (doc or {}).get("device") or {}
    fields = {
        "where": where or "?",
        "owner": owner or "?",
        "share": round(share, 4),
        "owner_bytes": owners.get(owner, 0) if owner else 0,
        "total_bytes": (doc or {}).get("total_bytes", 0),
        "in_use": dev.get("bytes_in_use"),
        "limit": dev.get("limit_bytes"),
    }
    detail = " ".join(
        f"{k}={v}" for k, v in fields.items() if v is not None
    )
    try:
        from . import flightrec  # noqa: PLC0415

        flightrec.record("mem.oom", name=where or (owner or ""),
                         detail=detail)
    except Exception:
        pass
    return fields


def maybe_record_oom(exc: BaseException, where: str = "") -> bool:
    """Record the OOM black-box event iff ``exc`` is a
    RESOURCE_EXHAUSTED.  Hooked into ``flightrec.record_exception`` so
    every death path that records its exception gets the memory story
    for free; safe to call redundantly (each call appends one ring
    event — the post-mortem reads the newest)."""
    if not is_resource_exhausted(exc):
        return False
    if getattr(exc, "_hvdtpu_oom_recorded", False):
        # Already black-boxed at the allocation site (alloc_guard) with
        # the PRECISE program name — the generic death-path hook must
        # not append a newer, vaguer event (the post-mortem reads the
        # newest).
        return True
    record_oom(where=where, exc=exc)
    try:
        exc._hvdtpu_oom_recorded = True
    except Exception:
        pass
    return True


def alloc_guard(where: str, *, rank: Optional[int] = None) -> None:
    """The ``mem_alloc`` fault point's consumer: call on an
    allocation-heavy path (the serve decode/prefill steps) so
    ``HVDTPU_FAULT_SPEC=mem_alloc:action=oom`` deterministically raises
    an out-of-memory error there — the chaos input the
    whole OOM black-box path (event, post-mortem verdict) is tested
    against.  Near-free when no fault spec is loaded."""
    from ..testing import faults  # noqa: PLC0415

    if not faults.active():
        return
    action = faults.maybe_fail("mem_alloc", rank=rank, name=where)
    if action == "oom":
        err = resource_exhausted_error(
            f"RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            f"in {where} (injected by HVDTPU_FAULT_SPEC mem_alloc)"
        )
        # Black-box NOW, at the allocation site, with the precise
        # program name — the death-path hook sees the marker and keeps
        # this event as the newest memory story.
        record_oom(where=where, exc=err)
        try:
            err._hvdtpu_oom_recorded = True
        except Exception:
            pass
        raise err


# Optional env knob: arming the census at init time for any worker
# (serve_worker and bench arm it explicitly; a training job can opt in
# without code changes).
CENSUS_ENV = "HVDTPU_MEM_CENSUS"


def maybe_install_from_env() -> None:
    """Arm the census collector when ``HVDTPU_MEM_CENSUS=1`` (called
    from worker init paths that already import the obs plane)."""
    if os.environ.get(CENSUS_ENV, "") in ("1", "true", "on", "yes"):
        install_census()


def accounting_armed() -> bool:
    """Whether the memory plane is armed in this process (census
    collector installed, or ``HVDTPU_MEM_CENSUS=1``).  Compile sites
    whose registration costs a real extra compile (the engine's fused
    allreduce AOT probe) consult this so the cost lands only on jobs
    that asked for the plane — bench and the serving worker arm it;
    a bare unit-test engine spin-up stays exactly as cheap as before.
    Sites where the artifact is already in hand (slot engine, overlap,
    bench) register unconditionally: their registration is free."""
    if _census_installed:
        return True
    return os.environ.get(CENSUS_ENV, "") in ("1", "true", "on", "yes")
