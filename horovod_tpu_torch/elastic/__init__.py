"""Elastic fault-tolerant training (the port of ``horovod_tpu.elastic``:
Elastic Horovod's commit-and-rollback + re-rendezvous design).

Three layers:

* **User API** — :class:`State` (commit/restore/sync of tensors,
  modules and optimizers) and :func:`run` (catch recoverable world
  failures, roll back, re-rendezvous, resume).
* **Launcher** — ``run/runner.py:launch_elastic_job`` (``python -m
  horovod_tpu_torch.run --elastic``) and :func:`launch`: per-rank failure
  detection (exit code + heartbeat + progress beat), host blacklisting
  with exponential backoff (``run/blacklist.py``), bounded respawn into
  re-minted rendezvous epochs.
* **Fault injection** — ``horovod_tpu_torch/testing/faults.py``
  (``HVDTPU_FAULT_SPEC``), so the recovery paths run deterministically
  on the CPU in the tests.

Minimal elastic training loop::

    import horovod_tpu_torch.elastic as elastic

    def train():
        ctx = elastic.context()
        state = elastic.State(model=model, opt=opt, step=0)

        @elastic.run
        def loop(state):
            while state.step < 100:
                loss = train_step(state.model, state.opt, state.step)
                ctx.allreduce(loss.item(), name=f"loss{state.step}")
                state.step += 1
                state.commit()

        return loop(state)

Importing this package needs no cloudpickle: ``run/api.py`` imports it
only to ship a function by value (:func:`launch`), and only where it is
installed.
"""

from .context import (  # noqa: F401
    ElasticContext,
    LocalContext,
    context,
    reset_context,
)
from .exceptions import (  # noqa: F401
    HorovodShutdownError,
    RankDroppedError,
    WorkersAvailableException,
)
from .launch import launch  # noqa: F401
from .run import run  # noqa: F401
from .state import State  # noqa: F401

__all__ = [
    "State",
    "run",
    "launch",
    "context",
    "reset_context",
    "ElasticContext",
    "LocalContext",
    "HorovodShutdownError",
    "RankDroppedError",
    "WorkersAvailableException",
]
