"""Deterministic, env-driven fault injection (the part of
``horovod_tpu/testing/faults.py`` that the port's one injection point
needs; copied, not imported).

A test sets ``HVDTPU_FAULT_SPEC`` and the injection point fires exactly
where the spec says, every run, with no timing dependence.

Grammar::

    HVDTPU_FAULT_SPEC := fault ("," fault)*
    fault             := point (":" key "=" value)*
    key               := rank | step | count | action | code | name

    HVDTPU_FAULT_SPEC="enqueue:rank=1:step=60:action=delay:1000"

* ``point`` — the injection site.  The port wires one: ``enqueue`` (the
  eager engine's enqueue path).  A spec naming another point is refused
  at parse time: it would never fire.
* ``rank`` — only fire on this rank (the ``rank=`` call argument, else
  ``HVDTPU_RANK``).  Absent means any rank.
* ``step`` — fire on the Nth visit to the point (a 1-based counter per
  point).  Absent means the first visit.
* ``count`` — times to fire (default 1).
* ``action`` — ``raise`` (default) raises :class:`InjectedFault`;
  ``exit`` calls ``os._exit(code)``; ``delay:<ms>`` sleeps the calling
  thread that many milliseconds (default 1000) and continues: a
  deterministic straggler.
* ``code`` — exit code for ``action=exit`` (default 43).
* ``name`` — only fire when the call site passes a matching ``name=``
  (a tensor name on the enqueue path).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "maybe_fail", "parse_spec", "reset"]

SPEC_ENV = "HVDTPU_FAULT_SPEC"
DEFAULT_EXIT_CODE = 43
POINTS = ("enqueue",)
ACTIONS = ("raise", "exit", "delay")


class InjectedFault(RuntimeError):
    """Raised by a fired ``action=raise`` fault; carries the site name."""

    def __init__(self, point: str, detail: str):
        super().__init__(
            f"injected fault at {point!r} ({detail}) — HVDTPU_FAULT_SPEC"
        )
        self.point = point


@dataclass
class FaultSpec:
    point: str
    rank: Optional[int] = None
    step: Optional[int] = None
    count: int = 1
    action: str = "raise"
    code: int = DEFAULT_EXIT_CODE
    delay_ms: int = 1000
    name: Optional[str] = None
    fired: int = field(default=0, compare=False)

    def describe(self) -> str:
        parts = [self.point]
        for k in ("rank", "step", "count", "name"):
            v = getattr(self, k)
            if v is not None:
                parts.append(f"{k}={v}")
        return ":".join(parts)


def parse_spec(raw: str) -> List[FaultSpec]:
    """Parse a spec string; raises ``ValueError`` on malformed entries so
    a typo'd spec fails the run loudly instead of silently never firing."""
    specs: List[FaultSpec] = []
    for chunk in raw.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields = chunk.split(":")
        point = fields[0].strip()
        if point not in POINTS:
            raise ValueError(f"fault point {point!r} in {chunk!r} is not "
                             f"wired in this package (points: {POINTS})")
        spec = FaultSpec(point=point)
        for kv in fields[1:]:
            if "=" not in kv:
                # ``action=delay:<ms>``: the parameter rides as a bare
                # field right after the action
                if spec.action == "delay" and kv.strip().isdigit():
                    spec.delay_ms = int(kv.strip())
                    continue
                raise ValueError(
                    f"fault spec field {kv!r} in {chunk!r} is not key=value"
                )
            key, value = (s.strip() for s in kv.split("=", 1))
            if key in ("rank", "step", "count", "code", "delay_ms"):
                setattr(spec, key, int(value))
            elif key == "action":
                if value not in ACTIONS:
                    raise ValueError(f"unknown fault action {value!r}")
                spec.action = value
            elif key == "name":
                spec.name = value
            else:
                raise ValueError(
                    f"unknown fault spec key {key!r} in {chunk!r}"
                )
        specs.append(spec)
    return specs


# Parsed cache, keyed by the raw env string so a test that monkeypatches
# the env (or calls reset()) gets a fresh registry.
_cache_raw: Optional[str] = None
_specs: Dict[str, List[FaultSpec]] = {}
_counters: Dict[str, int] = {}


def reset() -> None:
    """Drop the parsed registry and per-point counters (tests)."""
    global _cache_raw
    _cache_raw = None
    _specs.clear()
    _counters.clear()


def _load() -> Dict[str, List[FaultSpec]]:
    global _cache_raw
    raw = os.environ.get(SPEC_ENV, "")
    if raw != _cache_raw:
        _specs.clear()
        _counters.clear()
        for spec in parse_spec(raw):
            _specs.setdefault(spec.point, []).append(spec)
        _cache_raw = raw
    return _specs


def maybe_fail(point: str, *, rank: Optional[int] = None,
               name: Optional[str] = None) -> None:
    """Fire any matching fault for ``point``; a no-op when none match.
    The point's counter advances on every call whether or not a fault
    fires, so ``step=N`` means "the Nth visit to this point"."""
    specs = _load().get(point)
    if not specs:
        return
    step = _counters[point] = _counters.get(point, 0) + 1
    if rank is None:
        from ..utils.env import resolve_rank  # noqa: PLC0415

        rank = resolve_rank(None)
    for spec in specs:
        if spec.fired >= spec.count:
            continue
        if spec.rank is not None and spec.rank != rank:
            continue
        if spec.step is not None and spec.step != step:
            continue
        if spec.name is not None and spec.name != name:
            continue
        spec.fired += 1
        if spec.action == "delay":
            time.sleep(spec.delay_ms / 1000.0)
            return
        if spec.action == "exit":
            # os._exit, not sys.exit: the injected death must look like a
            # hard crash (no atexit, no finally blocks posting results)
            os._exit(spec.code)
        raise InjectedFault(point, spec.describe())
