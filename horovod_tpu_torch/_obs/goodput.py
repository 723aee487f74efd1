"""Goodput accounting of the serving plane (counterpart of
``horovod_tpu/obs/goodput.py``).

* :class:`TokenGoodput` — a copy of the reference's serving-side
  accountant: tokens actually generated over slot-step capacity,
  published beside the KV-occupancy gauges by the serving loop.
* :func:`install`, :func:`get_ledger`, :func:`publish` — the wall-clock
  goodput ledger's live wiring, which the reference feeds from its flight
  recorder's event tap.  The port has no flight recorder yet (ROADMAP
  A13, the observability planes), so these record nothing:
  :func:`get_ledger` answers None, and the serving loop's drain summary
  carries no ``wall`` section.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["TokenGoodput", "install", "get_ledger", "publish"]


class TokenGoodput:
    """Decode-capacity utilization: tokens actually generated over the
    slot-step capacity that elapsed — ``tokens ÷ (steps × slots)``, and
    per wall-clock, ``tokens ÷ (slot-seconds)`` against the pool.  A
    4-slot pool decoding 3 tokens per step has token goodput 0.75; an
    idle pool decays toward 0.  Pure function of the caller's clock,
    like the ledger."""

    def __init__(self, slots: int, start: float):
        self.slots = max(int(slots), 1)
        self._start = float(start)
        self._tokens = 0
        self._steps = 0

    def observe_step(self, tokens: int) -> None:
        """One decode step completed, emitting ``tokens`` (0 on an idle
        step — idle capacity is exactly what the fraction must see)."""
        self._steps += 1
        self._tokens += max(int(tokens), 0)

    @property
    def tokens(self) -> int:
        return self._tokens

    def fraction(self) -> float:
        """Share of slot-step capacity converted into tokens."""
        if self._steps <= 0:
            return 0.0
        return self._tokens / float(self._steps * self.slots)

    def per_slot_second(self, now: float) -> float:
        """Tokens per slot-second of pool existence."""
        elapsed = max(float(now) - self._start, 1e-9)
        return self._tokens / (elapsed * self.slots)

    def publish(self, reg, now: float) -> None:
        reg.gauge("serve.goodput.token_fraction").set(
            round(self.fraction(), 6))
        reg.gauge("serve.goodput.tokens_per_slot_sec").set(
            round(self.per_slot_second(now), 4))


def install(now: Optional[float] = None, epoch: int = 0) -> None:
    """The reference arms its wall-clock ledger here; A13 ports it.
    Records nothing."""
    return None


def get_ledger():
    """The live wall-clock ledger: None until A13 ports it."""
    return None


def publish(reg, now: Optional[float] = None) -> None:
    """Publish the wall-clock ledger (A13): records nothing."""
    return None
