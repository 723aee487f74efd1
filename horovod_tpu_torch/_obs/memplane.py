"""The memory plane's hooks on the serving path (counterpart of
``horovod_tpu/obs/memplane.py``).

The reference's census, per-program compiled bytes and OOM black box are
observability, ROADMAP A13; until that ports them :func:`install_census`
and :func:`memory_record` record nothing.  :func:`alloc_guard` keeps the
reference's ``mem_alloc`` fault point, so a chaos spec
``mem_alloc:action=oom`` raises a RESOURCE_EXHAUSTED error at the
serving loop's prefill and decode allocations, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["alloc_guard", "install_census", "memory_record"]


def alloc_guard(where: str, *, rank: Optional[int] = None) -> None:
    """The ``mem_alloc`` fault point's consumer (near-free when no fault
    spec is loaded): under ``HVDTPU_FAULT_SPEC=mem_alloc:action=oom`` it
    raises a ``RuntimeError`` shaped like an out-of-memory error at
    ``where``."""
    from ..testing import faults  # noqa: PLC0415

    if not faults.active():
        return
    if faults.maybe_fail("mem_alloc", rank=rank, name=where) == "oom":
        raise RuntimeError(
            f"RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            f"in {where} (injected by HVDTPU_FAULT_SPEC mem_alloc)")


def install_census(registry=None) -> None:
    """The reference arms its device-memory census here (A13): records
    nothing."""
    return None


def memory_record() -> dict:
    """The record-embeddable memory view (A13): the census is not ported,
    so it says so."""
    return {"census": {"source": "unavailable"}, "programs": {}}
