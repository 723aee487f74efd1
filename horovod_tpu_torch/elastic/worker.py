"""Elastic worker entry of :func:`~.launch.launch`: one per rank slot,
(re)spawned by the elastic launcher (a port of
``horovod_tpu/elastic/worker.py``).

Fetch-execute-publish: the ambient :class:`~.context.ElasticContext` is
built from the spawn env before the user function runs, the heartbeat
starts at once (so the launcher can tell "slow to import" from "hung"),
and failure *results* are posted under an epoch-qualified key so the
launcher can tell a user exception (abort the job, surface the
traceback) from a crash (respawn the rank).  The function is read with
``pickle`` (what ``cloudpickle.loads`` is; a function shipped by value
imports cloudpickle as it unpickles) and the result is written by
``run/api.py``'s ``_dumps`` (cloudpickle where it is installed).
"""

from __future__ import annotations

import pickle
import sys
import traceback

from ..testing.faults import maybe_fail
from .context import ElasticContext, context as _set_ambient
from .exceptions import HorovodShutdownError

_SCOPE = "elastic"


def main() -> int:
    import os  # noqa: PLC0415

    # Death-path hooks first (main thread: signal handlers need it):
    # everything after this point leaves a black box if it dies.
    from ..obs import flightrec, goodput  # noqa: PLC0415
    from ..run.api import _dumps  # noqa: PLC0415

    flightrec.install_death_hooks()
    # The wall-clock goodput ledger rides the flight recorder's event
    # tap from the first phase event: every second of this incarnation is
    # classified and published as goodput.* gauges in its metrics dump.
    goodput.install(epoch=int(os.environ.get("HVDTPU_ELASTIC_EPOCH",
                                             "0") or 0))
    ctx = _set_ambient()
    if not isinstance(ctx, ElasticContext):  # pragma: no cover - misuse
        raise RuntimeError(
            "horovod_tpu_torch.elastic.worker must be spawned by the "
            "elastic launcher (HVDTPU_ELASTIC_KV unset)"
        )
    ctx.start_heartbeat()
    maybe_fail("task_fn", rank=ctx.rank)
    blob = ctx.kv.wait(_SCOPE, "func", timeout=60)
    func, args, kwargs = pickle.loads(blob)
    try:
        result = func(*args, **kwargs)
        ctx.kv.put(_SCOPE, f"result_{ctx.rank}", _dumps((True, result)))
        return 0
    except HorovodShutdownError:
        # World breakage that outlived the elastic retry budget (or a
        # rank the launcher dropped) is an infrastructure failure, not a
        # user error: exit like a crash, WITHOUT posting a traceback, so
        # the launcher's monitor respawns/shrinks instead of aborting
        # the whole job on a "user error".
        return 1
    except BaseException:
        # Epoch-qualified so the launcher attributes the failure to THIS
        # incarnation of the rank, not a successor already respawned
        # into a later epoch.  A plain string: the launcher reads it with
        # pickle.
        ctx.kv.put(
            _SCOPE,
            f"error_{ctx.rank}_{ctx.epoch}",
            pickle.dumps(traceback.format_exc()),
        )
        return 1
    finally:
        ctx.stop_heartbeat()


if __name__ == "__main__":
    sys.exit(main())
