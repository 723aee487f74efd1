"""Collective-schedule checker: the runtime-artifact gate.

The source-level rules (HVD001/HVD010/...) reject schedules that *look*
divergent; this module checks the property the runtime actually needs:
**every rank must issue the same collective sequence** — same kinds,
same order, same groups, same payload.  The JAX package checks that on
the compiled HLO (``horovod_tpu.analysis.hlo``).  There is no HLO in the
port: a PyTorch step issues its collectives eagerly, so this module
reads what the ranks' process groups actually issued, as torch's own
flight recorder kept it (``torch._C._distributed_c10d._dump_fr_trace_json``
or ``_dump_nccl_trace_json``; the producer is
``horovod_tpu_torch.obs.collective_schedule.dump_collective_schedule``):

* :func:`extract_schedule` — parse one rank's flight-recorder JSON into
  its ordered collective sequence: kind (``profiling_name`` without the
  ``nccl:`` / ``gloo:`` prefix), dtype / element / byte accounting from
  the input and output sizes, the process group (id and description),
  and the position (``collective_seq_id``).  Point-to-point entries
  (``is_p2p``) are kept apart: a send on one rank is a receive on its
  peer, so they are counted, not compared;
* :func:`diff_schedules` — structural diff of N schedules (one per
  rank, or per step expected to be identical), reporting the first
  divergence in readable form;
* a CLI — ``python -m horovod_tpu_torch.analysis.schedule rank0=a.json
  rank1=b.json`` — exit 0 when all schedules agree, 1 on divergence, 2
  on usage errors, so the CI gate is one subprocess call.

Stdlib-only, like the rest of the package: the producer of the dump
needs torch; the checker runs anywhere.  It imports nothing of the
package either, so ``python horovod_tpu_torch/analysis/schedule.py ...``
runs the same CLI without importing torch (``-m`` imports the package,
and with it torch).
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SCHEDULE_SCHEMA = "hvdtpu-torch-fr-schedule-v1"

# The flight recorder's dtype names (c10's ScalarType names) -> bytes.
_BYTES: Dict[str, int] = {
    "Bool": 1, "Byte": 1, "Char": 1, "UInt8": 1, "Int8": 1,
    "Short": 2, "Half": 2, "BFloat16": 2, "UInt16": 2,
    "Int": 4, "Float": 4, "UInt32": 4, "ComplexHalf": 4,
    "Long": 8, "Double": 8, "UInt64": 8, "ComplexFloat": 8,
    "ComplexDouble": 16,
    "Float8_e5m2": 1, "Float8_e4m3fn": 1, "Float8_e5m2fnuz": 1,
    "Float8_e4m3fnuz": 1, "Float8_e8m0fnu": 1,
}


class ScheduleError(ValueError):
    """The input is not a flight-recorder dump."""


def _payload(sizes: Sequence[Sequence[int]],
             dtypes: Sequence[str]) -> Tuple[int, int]:
    """(elements, bytes) over every tensor of one side of a collective
    (a coalesced or list collective moves every tensor)."""
    elements = 0
    nbytes = 0
    for dims, dtype in zip(sizes, dtypes):
        n = 1
        for d in dims:
            n *= int(d)
        elements += n
        nbytes += n * _BYTES.get(dtype, 0)
    return elements, nbytes


def _shape_text(sizes: Sequence[Sequence[int]],
                dtypes: Sequence[str]) -> str:
    return ",".join(f"{t}[{'x'.join(str(int(d)) for d in dims)}]"
                    for dims, t in zip(sizes, dtypes))


@dataclass(frozen=True)
class CollectiveInstr:
    """One collective a rank issued.  ``signature()`` holds the facts
    that must match across ranks; ``position`` and ``record`` say where
    it sits in this rank's history."""

    kind: str            # "all_reduce", "broadcast", ...
    dtype: str           # the input dtypes, "," joined
    shape: str           # "in -> out" tensor shapes with their dtypes
    elements: int        # of the outputs (the inputs where none)
    nbytes: int
    group: str           # "<pg_id>:<desc>"
    position: int        # collective_seq_id (p2p_seq_id for p2p)
    record: int          # the dump's record_id: issue order
    p2p: bool = False

    def signature(self) -> Tuple:
        return (self.kind, self.shape, self.group)

    def key(self) -> Tuple:
        """Which entry of this rank's history it is."""
        return (self.group, self.p2p, self.position)

    def display(self) -> str:
        return (f"{self.kind} {self.shape} ({self.nbytes}B) "
                f"group={self.group} seq={self.position}")

    def as_dict(self) -> dict:
        return {
            "kind": self.kind, "dtype": self.dtype, "shape": self.shape,
            "elements": self.elements, "bytes": self.nbytes,
            "group": self.group, "position": self.position,
            "record": self.record, "p2p": self.p2p,
        }


@dataclass
class CollectiveSchedule:
    """The ordered collective sequence one rank issued."""

    label: str
    instrs: List[CollectiveInstr] = field(default_factory=list)
    p2p: List[CollectiveInstr] = field(default_factory=list)
    # the recorder's ring dropped older entries: positions do not start
    # at the first collective of the run
    truncated: bool = False

    @property
    def total_bytes(self) -> int:
        return sum(i.nbytes for i in self.instrs)

    def signatures(self) -> List[Tuple]:
        return [i.signature() for i in self.instrs]

    def since(self, earlier: "CollectiveSchedule",
              label: str = "") -> "CollectiveSchedule":
        """The entries this dump holds that ``earlier`` (an earlier dump of
        the same rank) does not: one step's slice.  An entry is known by
        its group and its position there."""
        seen = {i.key() for i in earlier.instrs + earlier.p2p}
        return CollectiveSchedule(
            label=label or self.label,
            instrs=[i for i in self.instrs if i.key() not in seen],
            p2p=[i for i in self.p2p if i.key() not in seen],
            truncated=self.truncated)

    def as_dict(self) -> dict:
        return {
            "schema": SCHEDULE_SCHEMA,
            "label": self.label,
            "collectives": [i.as_dict() for i in self.instrs],
            "p2p": [i.as_dict() for i in self.p2p],
            "total_bytes": self.total_bytes,
            "truncated": self.truncated,
        }


def _kind(profiling_name: str) -> str:
    """``nccl:all_reduce`` -> ``all_reduce``."""
    return profiling_name.split(":", 1)[-1] if profiling_name else "?"


def _group(entry: dict) -> str:
    pg = entry.get("process_group") or []
    pg_id = pg[0] if pg else entry.get("pg_id", "?")
    desc = pg[1] if len(pg) > 1 else ""
    return f"{pg_id}:{desc}"


def extract_schedule(doc, label: str = "") -> CollectiveSchedule:
    """One rank's flight-recorder dump (its JSON text, or the parsed
    object) -> its collective sequence, in issue order.  Raises
    :class:`ScheduleError` when ``doc`` is not such a dump."""
    if isinstance(doc, (str, bytes)):
        try:
            doc = json.loads(doc)
        except ValueError as e:
            raise ScheduleError(f"not JSON: {e}") from None
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"),
                                                   list):
        raise ScheduleError("no 'entries' list: not a flight-recorder "
                            "dump")
    sched = CollectiveSchedule(label=label)
    entries = sorted(doc["entries"], key=lambda e: e.get("record_id", 0))
    first: Dict[str, int] = {}
    for e in entries:
        if not isinstance(e, dict) or "profiling_name" not in e:
            raise ScheduleError(f"entry without a profiling_name: {e!r}")
        p2p = bool(e.get("is_p2p"))
        ins, outs = e.get("input_sizes") or [], e.get("output_sizes") or []
        in_t = e.get("input_dtypes") or []
        out_t = e.get("output_dtypes") or []
        elements, nbytes = _payload(outs, out_t) if outs else \
            _payload(ins, in_t)
        position = int(e.get("p2p_seq_id" if p2p else "collective_seq_id",
                             0))
        instr = CollectiveInstr(
            kind=_kind(e["profiling_name"]),
            dtype=",".join(in_t),
            shape=f"{_shape_text(ins, in_t)} -> {_shape_text(outs, out_t)}",
            elements=elements, nbytes=nbytes, group=_group(e),
            position=position, record=int(e.get("record_id", 0)), p2p=p2p)
        (sched.p2p if p2p else sched.instrs).append(instr)
        if not p2p:
            first.setdefault(instr.group, position)
    sched.truncated = any(seq > 1 for seq in first.values())
    return sched


def diff_schedules(
    schedules: Sequence[CollectiveSchedule],
) -> List[str]:
    """Structural diff against the first schedule (the reference rank).
    Empty list = every rank issued the identical collective sequence;
    otherwise each entry is one readable divergence."""
    if len(schedules) < 2:
        return []
    ref = schedules[0]
    ref_sigs = ref.signatures()
    problems: List[str] = []
    for other in schedules[1:]:
        sigs = other.signatures()
        if sigs == ref_sigs:
            continue
        n = min(len(sigs), len(ref_sigs))
        if len(sigs) != len(ref_sigs):
            longer = other if len(sigs) > len(ref_sigs) else ref
            extra = longer.instrs[n].display()
            problems.append(
                f"{other.label}: {len(sigs)} collective(s) vs "
                f"{len(ref_sigs)} on {ref.label} — ranks disagree about "
                f"HOW MANY collectives the program issues; the extras "
                f"block forever (first unmatched: #{n} on {longer.label}, "
                f"{extra})"
            )
        for i in range(n):
            if sigs[i] == ref_sigs[i]:
                continue
            problems.append(
                f"{other.label}: collective #{i} diverges — "
                f"{other.instrs[i].display()} vs "
                f"{ref.instrs[i].display()} on {ref.label}"
            )
            break  # first divergence per pair: the rest is noise
    return problems


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_arg(arg: str) -> Tuple[str, str]:
    """``label=path`` or bare ``path`` (label = path)."""
    if "=" in arg:
        label, path = arg.split("=", 1)
        return label or path, path
    return arg, arg


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse  # noqa: PLC0415

    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.schedule",
        description="diff the collective schedules torch's flight "
                    "recorder kept on each rank: all ranks must issue "
                    "the same sequence",
    )
    parser.add_argument(
        "dumps", nargs="+", metavar="LABEL=PATH",
        help="flight-recorder JSON dumps to compare (the first one is "
             "the reference); bare paths use the path as the label",
    )
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument(
        "--expect-collectives", type=int, default=0, metavar="N",
        help="fail unless the reference schedule has at least N "
             "collectives (guards against a gate silently comparing "
             "empty schedules)",
    )
    args = parser.parse_args(argv)

    schedules: List[CollectiveSchedule] = []
    for arg in args.dumps:
        label, path = _parse_arg(arg)
        try:
            with open(path, "r", encoding="utf-8") as f:
                schedules.append(extract_schedule(f.read(), label=label))
        except (OSError, UnicodeDecodeError) as e:
            print(f"hvdtpu-schedule: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        except ScheduleError as e:
            print(f"hvdtpu-schedule: {path}: {e}", file=sys.stderr)
            return 2

    problems = diff_schedules(schedules)
    ref = schedules[0]
    if len(ref.instrs) < args.expect_collectives:
        problems.insert(0, (
            f"{ref.label}: expected >= {args.expect_collectives} "
            f"collectives, found {len(ref.instrs)} — wrong dump, or "
            f"the program under test lost its collectives"
        ))

    if args.format == "json":
        print(json.dumps({
            "schema": SCHEDULE_SCHEMA,
            "schedules": [s.as_dict() for s in schedules],
            "divergences": problems,
        }, indent=2))
    else:
        for s in schedules:
            note = " (recorder ring wrapped: older entries dropped)" \
                if s.truncated else ""
            print(f"{s.label}: {len(s.instrs)} collective(s), "
                  f"{len(s.p2p)} p2p, {s.total_bytes} payload "
                  f"bytes{note}")
        for p in problems:
            print(f"DIVERGENCE: {p}")
        if not problems:
            print(f"hvdtpu-schedule: {len(schedules)} schedule(s) "
                  f"identical")
    return 1 if problems else 0


if __name__ == "__main__":  # pragma: no cover - exercised via CI gate
    sys.exit(main())
