"""Exception taxonomy (counterpart of ``horovod_tpu/exceptions.py``).

The same names and hierarchy, so code written against Elastic Horovod's
split catches the same things here; the elastic driver that raises the
last three is ``elastic/`` (``context.py``, ``run.py``).  All but
:class:`NotPortedError`, which names a part of the reference the port
does not carry yet, subclass ``RuntimeError``.
"""

from __future__ import annotations

__all__ = [
    "NotPortedError",
    "NotInitializedError",
    "HorovodShutdownError",
    "RankDroppedError",
    "WorkersAvailableException",
]


class NotPortedError(NotImplementedError, AttributeError):
    """A part of the reference the port does not carry yet: a top-level
    name, or a launcher flag whose plane is not ported.  Its message
    names the ROADMAP item.  An ``AttributeError`` too, so ``hasattr``
    answers False for a name."""


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__(
            "horovod_tpu_torch has not been initialized; call "
            "horovod_tpu_torch.init() first."
        )


class HorovodShutdownError(RuntimeError):
    """A collective or rendezvous failed because the world broke: peer
    death, coordinated shutdown, or a stalled wait."""


class RankDroppedError(HorovodShutdownError):
    """This rank is no longer a member of the current world."""


class WorkersAvailableException(RuntimeError):
    """The rendezvous epoch advanced; the current world is stale."""
