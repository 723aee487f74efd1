"""Logging (a copy of ``horovod_tpu/utils/logging.py``; reference:
horovod/common/logging.cc — LOG(level, rank) macros to stderr, controlled
by HOROVOD_LOG_LEVEL / HOROVOD_LOG_HIDE_TIME).

Maps onto python logging with the same env contract, HVDTPU_-prefixed,
under the ``horovod_tpu_torch`` logger.  One difference: the reference
always installs its handler, and its logger stops propagating; the port's
runtime modules log through plain ``logging.getLogger(__name__)`` loggers
under the same name, which an application (or pytest) configures from
the root.  So the handler, the level and the cut-off from the root are
installed only when ``HVDTPU_LOG_LEVEL`` asks for them; otherwise the
records propagate to whatever the application configured (by default,
warnings and errors to stderr)."""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_ROOT = "horovod_tpu_torch"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    if not os.environ.get("HVDTPU_LOG_LEVEL"):
        return
    level_name = os.environ["HVDTPU_LOG_LEVEL"].lower()
    level = _LEVELS.get(level_name, logging.WARNING)
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("HVDTPU_LOG_HIDE_TIME", "0") in ("1", "true"):
        fmt = "[%(levelname)s] %(name)s: %(message)s"
    else:
        fmt = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
    handler.setFormatter(logging.Formatter(fmt))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False


def get_logger(name: str = _ROOT) -> logging.Logger:
    _configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def log(level: str, msg: str, *args) -> None:
    get_logger().log(_LEVELS.get(level, logging.INFO), msg, *args)
