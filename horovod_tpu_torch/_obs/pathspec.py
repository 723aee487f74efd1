"""Per-rank artifact paths and atomic writes (the parts of
``horovod_tpu/obs/pathspec.py`` the port's callers need, copied):
``resolve`` and ``epoch_tag`` for the timeline and the autotune log,
``write_bytes_atomic`` and ``write_json_atomic`` for the checkpoint
tiers (``checkpoint.py``, ``ckpt/sharded.py``).
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Optional

__all__ = ["resolve", "epoch_tag", "write_bytes_atomic", "write_json_atomic"]

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
