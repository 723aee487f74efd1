"""Process-wide handle to the eager engine (counterpart of
``horovod_tpu/_engine_registry.py``).

Kept in its own module so :func:`horovod_tpu_torch.shutdown` can stop the
engine without importing it eagerly."""

from __future__ import annotations

import os
import threading

from .utils import env as envmod

_lock = threading.Lock()
_engine = None


def get_engine():
    """Start the eager engine on first use (reference: InitializeHorovodOnce
    spawning the background thread, horovod/common/operations.cc:604-650).

    ``HVDTPU_EAGER_ENGINE``:

    * ``python`` — the Python engine (``runtime/engine.py``): negotiation
      on a gloo group, CUDA payloads reduced on the card over NCCL
      (``runtime/device_plane.py``).
    * ``native`` — the C++ engine (``runtime/native.py`` on the port's copy
      of its sources, ``csrc/engine/``), built at first use.  Its TCP wire
      carries host bytes, so a CUDA payload crosses to the host and back.
      A failed build or load raises; it never falls back.
    * ``auto`` (the default) — the Python engine, at every world size.
      The reference's ``auto`` takes the native engine for worlds of more
      than one process whenever its library is built
      (``horovod_tpu/_engine_registry.py:39-63``); the port does not: that
      would add a device-to-host and host-to-device copy of every CUDA
      gradient, and make the engine depend on what happens to be built.
    """
    global _engine
    with _lock:
        if _engine is None:
            choice = os.environ.get(envmod.EAGER_ENGINE, "auto").lower()
            _engine = _make_engine(choice)
        return _engine


def _make_engine(choice: str):
    if choice == "native":
        import atexit  # noqa: PLC0415

        from .runtime.native import NativeEngine  # noqa: PLC0415

        eng = NativeEngine()
        # as the Python engine's start() does: a script that exits without
        # shutdown() still runs the coordinated shutdown cycle instead of
        # vanishing mid-negotiation under its peers
        atexit.register(eng.shutdown)
        return eng
    if choice not in ("auto", "python"):
        raise ValueError(f"HVDTPU_EAGER_ENGINE={choice!r}; choices: auto, "
                         "python, native")
    from .runtime.engine import EagerEngine  # noqa: PLC0415

    return EagerEngine.start()


def shutdown_engine() -> None:
    """Stop the engine, if one runs.  The handle is swapped out under the
    lock and the (blocking) shutdown runs outside it, so a concurrent
    ``get_engine`` never waits on the thread's join."""
    global _engine
    with _lock:
        engine, _engine = _engine, None
    if engine is not None:
        engine.shutdown()
