"""The elastic retry loop: ``elastic.run(fn)`` (a copy of
``horovod_tpu/elastic/run.py``).

Wraps a training function taking a :class:`~.state.State` first argument
in the recover-and-resume loop (upstream ``hvd.elastic.run``):

1. rendezvous into the current epoch's world,
2. ``state.sync()`` — agree on the newest committed snapshot,
3. run ``fn``; on a recoverable failure (:class:`HorovodShutdownError`:
   peer death / engine shutdown / stalled wait;
   :class:`WorkersAvailableException`: the launcher re-minted the
   epoch), roll back to the last commit and loop.

All three steps are inside the recoverable region: a peer dying while
THIS rank is mid-rendezvous or mid-sync (a cascading second failure —
exactly the event elasticity exists for) retries like a failure inside
``fn``.  Non-recoverable exceptions (user bugs, injected ``ckpt_write``
faults, :class:`RankDroppedError` when the launcher shrank past this
rank, ...) propagate unchanged — the elastic loop only absorbs world
breakage this rank can rejoin, never correctness errors.

The retry budget (``HVDTPU_ELASTIC_MAX_RETRIES``, default 10) bounds
*recoveries in this process*; the launcher separately bounds respawns
with its own ``max_retries`` knob.
"""

from __future__ import annotations

import functools
import time

from ..utils.env import env_int
from ..utils.logging import get_logger
from .context import context as _ambient_context
from .exceptions import (
    HorovodShutdownError,
    RankDroppedError,
    WorkersAvailableException,
)

LOG = get_logger("elastic")

MAX_RETRIES_ENV = "HVDTPU_ELASTIC_MAX_RETRIES"
DEFAULT_MAX_RETRIES = 10

__all__ = ["run"]


def run(fn):
    """Decorate ``fn(state, *args, **kwargs)`` with rollback-and-resume
    fault tolerance.  Returns ``fn``'s result once it completes inside a
    stable world."""

    @functools.wraps(fn)
    def wrapper(state, *args, **kwargs):
        ctx = _ambient_context()
        state._ctx = ctx
        max_retries = env_int(MAX_RETRIES_ENV, DEFAULT_MAX_RETRIES)
        recoveries = 0
        while True:
            try:
                ctx.rendezvous()
                before = state.last_restore
                state.sync(ctx)
                prov = state.last_restore
                if prov is not None and prov is not before \
                        and prov["source"] != "none":
                    # The one-line operator answer to "where did this
                    # incarnation's state come from, and how long did
                    # recovery take" (the full story is in the flight
                    # recorder / post-mortem).
                    LOG.info(
                        "rank %s recovered state at commit %d from %s "
                        "in %.0f ms", getattr(ctx, "rank", 0),
                        prov["commits"],
                        "peer replica" if prov.get("replica_adopted")
                        else prov["source"], prov["ms"],
                    )
                return fn(state, *args, **kwargs)
            except RankDroppedError:
                # The launcher shrank the world past this rank; no
                # amount of retrying lets it rejoin.
                raise
            except WorkersAvailableException as exc:
                reason = f"world update: {exc}"
            except HorovodShutdownError as exc:
                reason = f"world failure: {exc}"
            recoveries += 1
            from ..obs import get_registry  # noqa: PLC0415

            get_registry().counter("elastic.recoveries").inc()
            if recoveries > max_retries:
                raise HorovodShutdownError(
                    f"elastic retry budget exhausted after {max_retries} "
                    f"recoveries (last: {reason})"
                )
            LOG.warning(
                "rank %s recovery %d/%d — rolling back to commit %d (%s)",
                getattr(ctx, "rank", 0), recoveries, max_retries,
                state.commits, reason,
            )
            state.restore()
            # The failed epoch's KV scope still holds pre-failure values
            # — the next rendezvous must land in a FRESH epoch or the
            # replayed steps would read stale contributions.
            notify = getattr(ctx, "notify_world_broken", None)
            if notify is not None:
                notify()
            # Give the launcher's monitor a beat to mint the new epoch
            # when we raced it (timeout-path failures); the rendezvous at
            # the top of the loop then blocks until the world re-forms.
            time.sleep(0.05)

    return wrapper
