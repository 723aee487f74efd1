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

    ``HVDTPU_EAGER_ENGINE``: ``auto`` (the default) and ``python`` give the
    Python engine (``runtime/engine.py``); ``native``, the reference's C++
    engine, is not ported yet and raises ``NotPortedError``.
    """
    global _engine
    with _lock:
        if _engine is None:
            choice = os.environ.get(envmod.EAGER_ENGINE, "auto").lower()
            _engine = _make_engine(choice)
        return _engine


def _make_engine(choice: str):
    if choice == "native":
        from . import NotPortedError  # noqa: PLC0415

        raise NotPortedError(
            "HVDTPU_EAGER_ENGINE=native: the C++ eager engine "
            "(runtime/native.py on cpp/hvdtpu) is not ported yet (ROADMAP "
            "A15); use auto or python")
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
