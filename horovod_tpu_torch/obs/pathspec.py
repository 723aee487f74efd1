"""Per-rank artifact paths and atomic writes (the parts of
``horovod_tpu/obs/pathspec.py`` the port's callers need, copied):
``resolve`` and ``epoch_tag`` for every per-rank artifact (metrics,
flight recorder, spans, the timeline, the autotune log), ``glob_pattern``,
``rank_of_path`` and ``epoch_of_path`` for the launcher's aggregators, and
``write_bytes_atomic`` / ``write_json_atomic`` for every artifact and the
checkpoint tiers.
"""

from __future__ import annotations

import itertools
import json
import os
import re
from typing import Optional

__all__ = ["resolve", "glob_pattern", "rank_of_path", "epoch_of_path",
           "epoch_tag", "write_json_atomic", "write_bytes_atomic"]

_RANK_RE = re.compile(r"(?:^|[^0-9a-zA-Z])rank[._]?(\d+)")
_EPOCH_RE = re.compile(r"\.e(\d+)\.")

# Per-call uniquifier for tmp names: pid alone is not enough when two
# writers in one process (threads, or a signal handler interrupting a
# write) target the same path.  itertools.count().__next__ is atomic
# under the GIL.
_tmp_seq = itertools.count()


def write_bytes_atomic(path: str, data) -> str:
    """Write ``data`` (bytes or a buffer) to ``path`` through a per-call
    tmp file and ``os.replace``, so a reader, a crash mid-write or a
    second writer never sees a torn or half-visible file.  A failed write
    removes its own tmp.  Returns ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_seq)}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


def write_json_atomic(path: str, doc, *, indent: int = 1) -> str:
    """:func:`write_bytes_atomic` of ``doc`` as JSON.  Returns ``path``."""
    return write_bytes_atomic(path, json.dumps(doc, indent=indent).encode())


def resolve(raw: str, stem: str, rank, epoch: Optional[str] = None) -> str:
    """This rank's file for the env value ``raw``: a ``{rank}`` template,
    a directory (``<stem>.rank.<k>.json`` inside), or a plain path with
    ``.rank.<k>`` before the extension; epoch-tagged under the elastic
    launcher (``HVDTPU_ELASTIC_EPOCH``)."""
    rank = str(rank)
    if epoch is None:
        epoch = os.environ.get("HVDTPU_ELASTIC_EPOCH")
    tag = (f"e{epoch}.rank.{rank}" if epoch not in (None, "")
           else f"rank.{rank}")
    if "{rank}" in raw:
        path = raw.replace("{rank}", rank)
        if epoch not in (None, ""):
            base, ext = os.path.splitext(path)
            path = f"{base}.e{epoch}{ext}"
        return path
    if raw.endswith(os.sep) or os.path.isdir(raw):
        return os.path.join(raw, f"{stem}.{tag}.json")
    base, ext = os.path.splitext(raw)
    return f"{base}.{tag}{ext or '.json'}"


def epoch_tag(path: str, epoch: Optional[str] = None) -> str:
    """``path`` with ``.e<E>`` before the extension when an elastic epoch
    is active; ``path`` otherwise."""
    if epoch is None:
        epoch = os.environ.get("HVDTPU_ELASTIC_EPOCH")
    if epoch in (None, ""):
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.e{epoch}{ext}"


def glob_pattern(raw: str, stem: str) -> str:
    """The glob matching every per-rank file :func:`resolve` can derive
    from ``raw`` (all ranks, all epochs) — what the launcher aggregates.
    Never matches the merged/summary output path itself."""
    if "{rank}" in raw:
        return raw.replace("{rank}", "*")
    if raw.endswith(os.sep) or os.path.isdir(raw):
        return os.path.join(raw, f"{stem}.*rank*.json")
    base, ext = os.path.splitext(raw)
    return f"{base}.*rank*{ext or '.json'}"


def rank_of_path(path: str) -> Optional[int]:
    """Best-effort rank extraction from a per-rank filename
    (``trace.rank.3.json``, ``trace.e1.rank.3.json``, ``rank_3`` ...)."""
    m = None
    for m in _RANK_RE.finditer(os.path.basename(path)):
        pass  # keep the last match: epoch tags come before the rank tag
    return int(m.group(1)) if m else None


def epoch_of_path(path: str) -> Optional[int]:
    m = _EPOCH_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None
