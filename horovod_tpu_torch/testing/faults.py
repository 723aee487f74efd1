"""Deterministic, env-driven fault injection (a copy of
``horovod_tpu/testing/faults.py`` for the points this package wires).

A test or a launcher sets ``HVDTPU_FAULT_SPEC`` and the injection points
threaded through the code fire exactly where the spec says, every run,
with no timing dependence.

Grammar::

    HVDTPU_FAULT_SPEC := fault ("," fault)*
    fault             := point (":" key "=" value)*
    key               := rank | step | epoch | count | action | code | name

    HVDTPU_FAULT_SPEC="ckpt_write:step=3:rank=0,worker_exit:step=5:rank=2"

* ``point`` — the injection site.  The port wires: ``enqueue`` (the
  eager engine's enqueue path), ``worker_exit`` (the elastic context,
  once per collective), ``task_fn`` (the elastic worker, before the user
  function runs), ``grad_ready`` (the elastic context's allreduce, after
  the total is computed: a corruption lands on one rank's copy of the
  agreed result), ``shard_write`` (``ckpt/sharded.py``, each rank's shard
  write), ``replica_push`` (``ckpt/replica.py``, the push after each
  commit), ``ckpt_write`` (``checkpoint.py``, rank 0's write),
  ``frontend_beat`` (``serve/frontend.py``, the top of each ingest pump
  round: the pump's frontend id is the rank, its beat counter the step),
  ``mem_alloc`` (``obs/memplane.alloc_guard`` on the serving prefill and
  decode paths), ``swap_commit`` (``serve/hotswap.py``, between a
  successful prefetch and the version flip), ``trace_flush``
  (``obs/trace.py``, the span dump), ``scale_admit`` (the launcher's
  autoscale grow path, once per standby rank it is about to admit, with
  that rank) and ``campaign_point`` (``bench/campaign.py``, between one
  point's journal commit and the next point's launch, with the 1-based
  point index as the step).  A spec naming another point
  is refused at parse time: it would never fire.
* ``rank`` — only fire on this rank (the ``rank=`` call argument, else
  ``HVDTPU_RANK``, else ``HVDTPU_ELASTIC_RANK``).  Absent means any rank.
* ``step`` — fire when the observed step equals N.  Sites with a natural
  step (checkpoint saves, the elastic collective's sequence number) pass
  it; the others use the per-point 1-based visit counter.  Absent means
  the first eligible call.
* ``epoch`` — the rendezvous epoch to fire in, default 0 (``any`` to
  disable the filter): a respawned worker re-runs the same steps at
  epoch >= 1 and must not re-trigger the fault that killed its
  predecessor.
* ``count`` — times to fire (default 1).
* ``action`` — ``raise`` (default) raises :class:`InjectedFault`;
  ``raise:<ExcName>`` raises that builtin exception; ``exit`` calls
  ``os._exit(code)``; ``abort`` raises SIGABRT in this process; ``hang``
  blocks the calling thread forever (the heartbeat thread keeps beating:
  a deadlocked training thread, which the progress beat catches);
  ``delay:<ms>`` sleeps that many milliseconds and continues.  Advisory
  actions are returned to the call site, which applies them:
  ``corrupt_write`` (``shard_write``: the bytes written are damaged with
  :func:`corrupt_bytes`), ``drop_replica`` (``replica_push``: the push is
  skipped), ``flip_bits`` and ``nan_inject`` (``grad_ready``: one element
  of the result is damaged with :func:`corrupt_grad`), ``frontend_exit``
  (``frontend_beat``: the pump dies without draining), ``trace_drop``
  (``trace_flush``: the next span dump is suppressed), ``oom``
  (``mem_alloc``: a RESOURCE_EXHAUSTED ``RuntimeError`` is raised) and
  ``swap_abort`` (``swap_commit``: the rank exits with ``os._exit`` mid-swap),
  ``scale_fail`` (``scale_admit``: the standby refuses admission, and the
  autoscale policy backs off) and ``degrade`` (``campaign_point``: the
  point is journaled degraded without running).
  ``worker_exit`` / ``task_fn`` default to ``exit``.
* ``code`` — exit code for ``action=exit`` (default 43).
* ``name`` — only fire when the call site passes a matching ``name=``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "maybe_fail", "corrupt_bytes", "corrupt_grad",
           "parse_spec", "reset", "active", "point_count"]

SPEC_ENV = "HVDTPU_FAULT_SPEC"
DEFAULT_EXIT_CODE = 43
# the injection sites this package wires (see the module docstring)
POINTS = ("enqueue", "worker_exit", "task_fn", "grad_ready", "shard_write",
          "replica_push", "ckpt_write", "frontend_beat", "mem_alloc",
          "swap_commit", "trace_flush", "scale_admit", "campaign_point")
_EXIT_POINTS = ("worker_exit", "task_fn")
# Advisory actions only take effect at call sites that consume
# maybe_fail's return value; parse-time validation keeps a spec like
# "ckpt_write:action=corrupt_write" from "firing" as a silent no-op —
# a chaos test built on it would pass vacuously.
_ADVISORY_POINTS = {
    "corrupt_write": ("shard_write",),
    "drop_replica": ("replica_push",),
    "trace_drop": ("trace_flush",),
    "swap_abort": ("swap_commit",),
    "oom": ("mem_alloc",),
    "frontend_exit": ("frontend_beat",),
    "flip_bits": ("grad_ready",),
    "nan_inject": ("grad_ready",),
    "scale_fail": ("scale_admit",),
    "degrade": ("campaign_point",),
}


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
    epoch: Optional[int] = 0
    count: int = 1
    action: str = "raise"
    code: int = DEFAULT_EXIT_CODE
    delay_ms: int = 1000
    exc_name: Optional[str] = None
    name: Optional[str] = None
    fired: int = field(default=0, compare=False)

    def describe(self) -> str:
        parts = [self.point]
        for k in ("rank", "step", "epoch", "count", "name"):
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
        if not point:
            raise ValueError(f"fault spec entry has no point name: {chunk!r}")
        if point not in POINTS:
            raise ValueError(f"fault point {point!r} in {chunk!r} is not "
                             f"wired in this package (points: {POINTS})")
        spec = FaultSpec(point=point)
        if point in _EXIT_POINTS:
            spec.action = "exit"
        for kv in fields[1:]:
            if "=" not in kv:
                # ``action=delay:<ms>`` / ``action=raise:<ExcName>``:
                # the parameter rides as a bare field right after the
                # action (the grammar's separator is ":", so it can't
                # live in the value).
                if spec.action == "delay" and kv.strip().isdigit():
                    spec.delay_ms = int(kv.strip())
                    continue
                if spec.action == "raise" and kv.strip().isidentifier():
                    exc_name = kv.strip()
                    cls = getattr(__import__("builtins"), exc_name, None)
                    if not (isinstance(cls, type)
                            and issubclass(cls, BaseException)):
                        raise ValueError(
                            f"action=raise:{exc_name}: {exc_name!r} is "
                            f"not a builtin exception"
                        )
                    spec.exc_name = exc_name
                    continue
                raise ValueError(
                    f"fault spec field {kv!r} in {chunk!r} is not key=value"
                )
            key, value = (s.strip() for s in kv.split("=", 1))
            if key in ("rank", "step", "count", "code", "delay_ms"):
                setattr(spec, key, int(value))
            elif key == "epoch":
                spec.epoch = None if value in ("any", "*") else int(value)
            elif key == "action":
                if value not in ("raise", "exit", "abort", "hang",
                                 "delay", *_ADVISORY_POINTS):
                    raise ValueError(f"unknown fault action {value!r}")
                spec.action = value
            elif key == "name":
                spec.name = value
            else:
                raise ValueError(
                    f"unknown fault spec key {key!r} in {chunk!r}"
                )
        allowed = _ADVISORY_POINTS.get(spec.action)
        if allowed is not None and spec.point not in allowed:
            raise ValueError(
                f"action={spec.action} is only implemented at "
                f"{'/'.join(allowed)}, not at point {spec.point!r} — "
                f"it would fire as a silent no-op there"
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


def active() -> bool:
    """True when any fault spec is loaded (cheap hot-path gate)."""
    return bool(_load())


def point_count(point: str) -> int:
    """Current value of a point's 1-based invocation counter (0 before
    the first visit) — lets an advisory site key deterministic payload
    corruption (:func:`corrupt_grad`) on the same step number
    :func:`maybe_fail` just matched."""
    return _counters.get(point, 0)


def _resolve_rank(rank: Optional[int]) -> Optional[int]:
    if rank is not None:
        return rank
    from ..utils.env import resolve_rank  # noqa: PLC0415

    return resolve_rank(None)


def _resolve_epoch() -> int:
    value = os.environ.get("HVDTPU_ELASTIC_EPOCH")
    return int(value) if value not in (None, "") else 0


def corrupt_bytes(data: bytes) -> bytes:
    """Deterministically damage ``data`` (first/middle/last byte flipped)
    — the payload an ``action=corrupt_write`` call site writes instead of
    the real one, so checksum validation has something real to catch."""
    if not data:
        return data
    buf = bytearray(data)
    for i in (0, len(buf) // 2, len(buf) - 1):
        buf[i] ^= 0xFF
    return bytes(buf)


def corrupt_grad(arr, action: str, *, rank: int = 0, step: int = 0,
                 name: Optional[str] = None):
    """Apply a fired ``grad_ready`` advisory action to a reduced
    gradient: damage exactly ONE element, chosen deterministically by
    ``crc32(rank:step:name)`` so a chaos assertion can name the exact
    bucket/tensor it expects to see diverge.

    ``flip_bits`` XORs 0x40 into the element's most-significant byte —
    for floats that is a single exponent-bit flip (the canonical SDC:
    a large, *finite* magnitude change that value-level sanity checks
    miss but a bitwise digest cannot); ``nan_inject`` overwrites the
    element with NaN (integer dtypes fall back to the bit flip).
    Returns a same-dtype copy; the input is never mutated.
    """
    import zlib  # noqa: PLC0415

    import numpy as np  # noqa: PLC0415

    a = np.array(arr, copy=True)
    if a.size == 0:
        return a
    key = f"{rank}:{step}:{name or ''}".encode()
    # CRC32 is linear over GF(2): a one-character key change (e.g. the
    # rank digit) XORs a fixed delta whose low bits can be all-zero, so
    # ``crc % power_of_two_size`` would hit the same slot for every
    # rank.  Avalanche the high bits down before reducing.
    h = zlib.crc32(key)
    h ^= h >> 16
    h = (h * 0x45D9F3B) & 0xFFFFFFFF
    h ^= h >> 16
    pos = h % a.size
    if action == "nan_inject" and np.issubdtype(a.dtype, np.floating):
        a.reshape(-1)[pos] = np.nan
        return a
    if action not in ("flip_bits", "nan_inject"):
        raise ValueError(f"corrupt_grad does not implement {action!r}")
    raw = a.view(np.uint8).reshape(a.size, a.dtype.itemsize)
    # Little-endian: the last byte of each element is the most
    # significant — sign + high exponent bits for IEEE floats.
    raw[pos, -1] ^= 0x40
    return a


def maybe_fail(
    point: str,
    *,
    step: Optional[int] = None,
    rank: Optional[int] = None,
    name: Optional[str] = None,
) -> Optional[str]:
    """Fire any matching fault for ``point``; no-op when none match.

    ``step=None`` uses the per-point invocation counter (1-based) — the
    counter advances on every call whether or not a fault fires, so
    ``step=N`` deterministically means "the Nth visit to this point".

    Returns the fired action name for the *advisory* actions the call
    site must apply itself (the keys of ``_ADVISORY_POINTS``) and
    ``None`` otherwise.
    """
    specs = _load().get(point)
    counter = None
    if specs is not None or point in _counters:
        counter = _counters[point] = _counters.get(point, 0) + 1
    if not specs:
        return None
    observed_step = step if step is not None else counter
    observed_rank = _resolve_rank(rank)
    observed_epoch = _resolve_epoch()
    for spec in specs:
        if spec.fired >= spec.count:
            continue
        if spec.rank is not None and spec.rank != observed_rank:
            continue
        if spec.step is not None and spec.step != observed_step:
            continue
        if spec.epoch is not None and spec.epoch != observed_epoch:
            continue
        if spec.name is not None and spec.name != name:
            continue
        spec.fired += 1
        # Black-box the injection itself: a chaos run's post-mortem must
        # show the fault firing as an event, not leave the analyzer to
        # infer it from the wreckage.
        from ..obs import flightrec  # noqa: PLC0415

        flightrec.record(
            "fault", name=point,
            detail=f"{spec.action}:{spec.describe()}",
        )
        if spec.action in _ADVISORY_POINTS:
            # Advisory actions: the call site owns the I/O, so the
            # registry can only instruct it — corrupt the payload it is
            # about to write, or skip the push entirely.
            return spec.action
        if spec.action == "delay":
            # A deterministic straggler: stall the calling thread, then
            # proceed normally — the collective completes late, which is
            # exactly the skew signature straggler attribution must name.
            import time  # noqa: PLC0415

            time.sleep(spec.delay_ms / 1000.0)
            return None
        if spec.action == "exit":
            # os._exit, not sys.exit: the injected death must look like a
            # hard crash (no atexit, no finally blocks posting results).
            os._exit(spec.code)
        if spec.action == "abort":
            # raise_signal (not os.abort): os.abort bypasses Python
            # signal handlers, which would defeat the very dump path
            # this action exists to chaos-test.  With the flight
            # recorder's handler installed the rank dumps its ring,
            # then dies by real SIGABRT (no atexit, no finally blocks);
            # without it, it is a plain abort.
            import signal  # noqa: PLC0415

            signal.raise_signal(signal.SIGABRT)
        if spec.action == "hang":
            # Deadlock the CALLING thread only: daemon threads (the KV
            # heartbeat) keep beating, so the process looks alive while
            # its training thread is wedged — reproducing the failure
            # mode the collective-path progress beat detects.  The
            # process dies by external SIGTERM/SIGKILL.
            import threading  # noqa: PLC0415

            while True:
                threading.Event().wait(3600)
        if spec.exc_name is not None:
            cls = getattr(__import__("builtins"), spec.exc_name)
            raise cls(
                f"injected fault at {point!r} ({spec.describe()}) — "
                f"HVDTPU_FAULT_SPEC"
            )
        raise InjectedFault(point, spec.describe())
