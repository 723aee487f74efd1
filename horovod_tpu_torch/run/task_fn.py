"""Worker-side stub of the run() API (a port of
``horovod_tpu/run/task_fn.py``; reference: horovod/run/task_fn.py): fetch
the pickled function from the driver's KV store, execute, publish the
result under this rank."""

from __future__ import annotations

import os
import pickle
import sys
import traceback

from ..testing.faults import maybe_fail
from .api import _dumps
from .rendezvous import KVStoreClient

_SCOPE = "runfunc"


def main() -> int:
    addr = os.environ["HVDTPU_RUN_FUNC_ADDR"]
    rank = int(os.environ.get("HVDTPU_RANK", "0"))
    # Chaos point "task_fn": kill (or fail) a worker before the user
    # function runs — the launcher-side failure-propagation surface
    # (HVDTPU_FAULT_SPEC="task_fn:rank=1").
    maybe_fail("task_fn", rank=rank)
    client = KVStoreClient(addr)
    blob = client.wait(_SCOPE, "func", timeout=60)
    try:
        func, args, kwargs = pickle.loads(blob)
        result = func(*args, **kwargs)
        client.put(_SCOPE, f"result_{rank}", _dumps((True, result)))
        return 0
    except BaseException:
        client.put(
            _SCOPE,
            f"result_{rank}",
            pickle.dumps((False, traceback.format_exc())),
        )
        return 1


if __name__ == "__main__":
    sys.exit(main())
