"""Dump the collectives this rank issued, as torch's flight recorder kept
them, for the schedule gate (:mod:`horovod_tpu_torch.analysis.schedule`).

torch records, per process group, the ordered list of collectives a rank
issued when its flight recorder is on.  Turn it on BEFORE the process
group is created (before ``hvd.init()``), with a ring large enough for
the run::

    TORCH_FR_BUFFER_SIZE=20000            # torch >= 2.7
    TORCH_NCCL_TRACE_BUFFER_SIZE=20000    # older torch, NCCL groups

(:data:`RECORDER_ENV` holds both) and call :func:`dump_collective_schedule`
after the steps to check; then ``python -m
horovod_tpu_torch.analysis.schedule rank0=a.json rank1=b.json`` compares
the ranks' dumps.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Tuple

# the environment that turns the recorder on, with the ring's size
RECORDER_ENV = ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")
# the dump functions of torch._C._distributed_c10d: the recorder of the
# CPU backends (gloo), and the NCCL groups' (the only one of older
# releases).  Every one the installed torch has is read.
DUMPERS = ("_dump_fr_trace_json", "_dump_nccl_trace_json")


def recorder_env(entries: int = 20000) -> dict:
    """The environment that turns the recorder on for ``entries``
    collectives; set it before the process group is created."""
    return {name: str(entries) for name in RECORDER_ENV}


def _dumpers() -> List[Tuple[str, Callable]]:
    import torch.distributed  # noqa: F401, PLC0415
    from torch._C import _distributed_c10d as c10d  # noqa: PLC0415

    return [(name, getattr(c10d, name)) for name in DUMPERS
            if hasattr(c10d, name)]


def _entry_key(e: dict) -> tuple:
    pg = e.get("process_group") or [e.get("pg_id")]
    return (str(pg[0]), bool(e.get("is_p2p")), e.get("collective_seq_id"),
            e.get("p2p_seq_id"), e.get("op_id"), e.get("profiling_name"))


def read_recorder(allow_empty: bool = False) -> dict:
    """The flight recorders' JSON of this process: the first dump's
    document with every recorder's entries, each recorder's in its own
    issue order and the recorders one after the other (their record ids
    renumbered so), an entry two recorders both hold kept once;
    ``dumpers`` counts the entries each function gave.  Raises
    ``RuntimeError`` when the recorder is off, the dump API is absent, or
    (unless ``allow_empty``: the state before a first collective) no
    collective was recorded."""
    if not any(int(os.environ.get(n) or 0) > 0 for n in RECORDER_ENV):
        raise RuntimeError(
            "the flight recorder is off: set one of "
            f"{', '.join(RECORDER_ENV)} to a ring size before the process "
            "group is created")
    dumpers = _dumpers()
    if not dumpers:
        raise RuntimeError(
            "this torch has no flight-recorder dump API (none of "
            f"{', '.join(DUMPERS)} in torch._C._distributed_c10d)")
    merged, seen, counts = None, set(), {}
    for name, fn in dumpers:
        # every entry, completed ones too (onlyActive=False)
        doc = json.loads(fn(True, False))
        entries = sorted(doc.get("entries") or [],
                         key=lambda e: e.get("record_id", 0))
        counts[name] = len(entries)
        if merged is None:
            merged = dict(doc, entries=[])
        for e in entries:
            key = _entry_key(e)
            if key in seen:
                continue
            seen.add(key)
            merged["entries"].append(dict(
                e, record_id=len(merged["entries"]), recorder=name))
    if merged is not None and (merged["entries"] or allow_empty):
        merged["dumpers"] = counts
        return merged
    raise RuntimeError(
        "the flight recorder holds no collective (was it turned on before "
        f"the process group was created?); tried {[n for n, _ in dumpers]}")


def dump_collective_schedule(path: str) -> int:
    """Write this rank's flight-recorder JSON to ``path`` (the input of
    ``analysis.schedule``); returns the number of entries written.  Never
    writes an empty schedule: raises as :func:`read_recorder` does."""
    doc = read_recorder()
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(doc["entries"])
