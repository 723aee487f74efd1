"""Serving plane of the port (counterpart of ``horovod_tpu/serve/``):
continuous-batching inference over the slot-based KV cache, served by an
elastic fleet behind the launcher's front door.

* :mod:`.scheduler`: the pure iteration-level admit / evict state machine
  over a fixed slot pool (a copy of the reference's).
* :mod:`.paged`: the pure page allocator and per-slot block tables (a
  copy of the reference's).
* :mod:`.engine`: :class:`SlotEngine`, the model half: one decode step
  over the pool, bucketed one-shot prefill for admissions, contiguous or
  paged KV.
* :mod:`.sampling`: replicated per-request sampling on jax's threefry
  keys (``ops/prng.py``).
* :mod:`.frontend`: the sharded front door — F launcher-resident ingest
  pumps order client submissions into per-shard durable request logs
  over the launcher's HMAC-signed KV store; :class:`ServeClient` submits
  and streams.
* :mod:`.service`: the serving loop on the elastic launcher (a dead rank
  respawns and replays in-flight requests from the durable log; zero
  dropped requests) and the :class:`ServeJob` driver.
* :mod:`.hotswap`: live weight hot-swap from a publisher
  (:func:`publish_weights`), one weight version at every step.

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

A fleet (``python -m horovod_tpu_torch.run --elastic --serve -np 2 --
python -m horovod_tpu_torch.serve --size small``, or from Python)::

    from horovod_tpu_torch.serve import ServeJob
    job = ServeJob({"size": "nano", "num_slots": 4}, np=2).start()
    rid = job.client.submit([5, 17, 3], max_new_tokens=8)
    print(job.client.result(rid)["tokens"])
    job.stop()

* :mod:`.longctx`: long-context serving over a sequence-sharded slot
  cache (Ulysses prefill, merged partial-softmax decode).

* :mod:`.autoscale`: the launcher's load-driven grow/shrink of a fleet
  (``ServeJob(max_workers=, autoscale=)``, ``hvdrun --serve-autoscale``),
  reading the live telemetry plane's queue and TTFT gauges.
"""

from .engine import SlotEngine, prompt_bucket  # noqa: F401
from .frontend import (  # noqa: F401
    FrontDoor, IngestPump, Rejection, RequestRejected, ServeClient,
    validate_request,
)
from .hotswap import SwapManager, publish_weights  # noqa: F401
from .paged import PagedKV, page_reject_reason, pages_for  # noqa: F401
from .scheduler import (  # noqa: F401
    ActiveSlot, Admission, Eviction, Request, SlotScheduler, TenantQoS,
)
from .service import DEFAULT_SPEC, ServeJob, serve_worker  # noqa: F401

__all__ = ["SlotEngine", "SlotScheduler", "Request", "PagedKV", "pages_for",
           "page_reject_reason", "prompt_bucket", "ActiveSlot", "Admission",
           "Eviction", "TenantQoS", "ServeJob", "ServeClient", "FrontDoor",
           "IngestPump", "validate_request", "Rejection", "RequestRejected",
           "publish_weights", "SwapManager", "serve_worker", "DEFAULT_SPEC"]
