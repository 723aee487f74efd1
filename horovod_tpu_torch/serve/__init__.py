"""Serving plane of the port (counterpart of ``horovod_tpu/serve/``):
continuous-batching inference over the slot-based KV cache.

* :mod:`.scheduler`: the pure iteration-level admit / evict state machine
  over a fixed slot pool (a copy of the reference's).
* :mod:`.paged`: the pure page allocator and per-slot block tables (a
  copy of the reference's).
* :mod:`.engine`: :class:`SlotEngine`, the model half: one decode step
  over the pool, bucketed one-shot prefill for admissions, contiguous or
  paged KV.
* :mod:`.sampling`: replicated per-request sampling on jax's threefry
  keys (``ops/prng.py``).

Serving on the CPU::

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.serve import Request, SlotEngine, SlotScheduler
    eng, sched = SlotEngine(gpt("nano", device="cpu"), 2), SlotScheduler(2)
    sched.enqueue(Request(rid="a", prompt=(5, 17, 3), max_new_tokens=8))
    done = {}
    while not done:
        for a in sched.admit():
            sched.record(a.slot, eng.admit(a.slot, a.req.prompt, rid=a.req.rid))
        done.update({e.rid: e.tokens for e in sched.evict_finished()})
        for slot, tok in eng.step(sorted(sched.active)).items():
            sched.record(slot, tok)
        done.update({e.rid: e.tokens for e in sched.evict_finished()})

The reference's service, frontend, hot swap, autoscale and long-context
modules (``ServeJob``, ``validate_request``, ...) are ROADMAP A12b.
"""

from .engine import SlotEngine, prompt_bucket  # noqa: F401
from .paged import PagedKV, page_reject_reason, pages_for  # noqa: F401
from .scheduler import (  # noqa: F401
    ActiveSlot, Admission, Eviction, Request, SlotScheduler, TenantQoS,
)

__all__ = ["SlotEngine", "SlotScheduler", "Request", "PagedKV", "pages_for",
           "page_reject_reason", "prompt_bucket", "ActiveSlot", "Admission",
           "Eviction", "TenantQoS"]
