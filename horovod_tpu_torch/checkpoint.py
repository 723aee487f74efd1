"""Checkpoint / resume and the Store abstraction (a port of
``horovod_tpu/checkpoint.py``).

The reference has no checkpoint engine of its own; its pattern (SURVEY.md
§5.4) is "rank 0 checkpoints through the framework, everyone else restores
by broadcast": ``broadcast_parameters`` / ``broadcast_optimizer_state``
(horovod/torch/__init__.py:452-605) and the Spark estimators persisting
through a ``Store`` (horovod/spark/common/store.py:30-330).

* :class:`Store` / :class:`LocalStore` — where checkpoints and run metadata
  live (mirroring LocalStore/HDFSStore).
* :func:`save_checkpoint` — rank 0 writes, the other ranks wait at a
  barrier (the reference's rank-0 checkpoint discipline).  The JAX package
  writes through orbax; the port writes its own files: the state tree
  (dicts, lists and tuples of tensors, numpy arrays and scalars;
  ``ckpt/tree.py``) as its JSON structure and leaf dtypes
  (``structure.json``) beside its leaves as numpy arrays (``leaves.npz``,
  read back without pickle), in a step directory that appears whole or
  not at all (written aside, then renamed).
* :func:`restore_checkpoint` — rank 0 reads, then the state is broadcast to
  every rank, so a resumed job starts bit-identical everywhere even if the
  filesystem is not shared.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional

import numpy as np

from .obs import flightrec as _flightrec
from .obs import get_registry
from .basics import rank, size
from .ckpt import tree as _tree

__all__ = [
    "Store",
    "LocalStore",
    "save_checkpoint",
    "save_checkpoint_async",
    "AsyncSave",
    "restore_checkpoint",
    "latest_checkpoint_step",
]

_STRUCTURE_FILE = "structure.json"
_LEAVES_FILE = "leaves.npz"


class Store:
    """Filesystem-layout contract for run artifacts (reference:
    horovod/spark/common/store.py Store — checkpoint/metadata paths keyed
    off a prefix; subclasses own the actual filesystem).
    """

    def __init__(self, prefix_path: str):
        self.prefix_path = str(prefix_path)

    # -- paths (reference store.py get_checkpoint_path/get_*_data_path) --
    def checkpoint_dir(self, run_id: str = "default") -> str:
        return os.path.join(self.prefix_path, run_id, "checkpoints")

    def metadata_path(self, run_id: str = "default") -> str:
        return os.path.join(self.prefix_path, run_id, "metadata.json")

    def logs_dir(self, run_id: str = "default") -> str:
        return os.path.join(self.prefix_path, run_id, "logs")

    # -- filesystem ops subclasses implement --
    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    # -- metadata helpers used by the estimator layer --
    def write_metadata(self, meta: dict, run_id: str = "default") -> None:
        path = self.metadata_path(run_id)
        self.makedirs(os.path.dirname(path))
        self.write_bytes(path, json.dumps(meta, indent=2).encode())

    def read_metadata(self, run_id: str = "default") -> Optional[dict]:
        path = self.metadata_path(run_id)
        if not self.exists(path):
            return None
        return json.loads(self.read_bytes(path).decode())


class LocalStore(Store):
    """Local (or NFS-mounted) filesystem store (reference LocalStore,
    horovod/spark/common/store.py)."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        # per-call-unique tmp name + os.replace: a crash mid-save never
        # leaves a torn file for a later reader to select
        from .obs.pathspec import write_bytes_atomic  # noqa: PLC0415

        write_bytes_atomic(path, data)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)


def _barrier() -> None:
    """All-rank sync point; no-op in a single-process world.  The default
    process group's barrier: the eager engine issues its collectives on
    groups of its own, so this cannot interleave with them."""
    if size() <= 1:
        return
    import torch.distributed as dist  # noqa: PLC0415

    dist.barrier()


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _write_step(path: str, structure: dict, dtypes: List[str],
                leaves: List[np.ndarray]) -> None:
    """The step directory appears whole or not at all: its files are
    written into a directory aside, which is then renamed into place (a
    re-save of the step replaces the old directory, the reference's
    overwrite)."""
    from .obs.pathspec import write_json_atomic  # noqa: PLC0415

    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp, old = f"{path}.tmp.{tag}", f"{path}.old.{tag}"
    try:
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _LEAVES_FILE),
                 **{str(i): a for i, a in enumerate(leaves)})
        write_json_atomic(os.path.join(tmp, _STRUCTURE_FILE),
                          {"structure": structure, "dtypes": dtypes})
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(old, ignore_errors=True)


def _read_step(path: str) -> Any:
    """The tree :func:`_write_step` wrote; tensors come back on the
    CPU."""
    with open(os.path.join(path, _STRUCTURE_FILE)) as f:
        doc = json.load(f)
    structure, dtypes = doc["structure"], doc["dtypes"]
    with np.load(os.path.join(path, _LEAVES_FILE),
                 allow_pickle=False) as arrays:
        leaves = [arrays[str(i)] for i in range(len(dtypes))]
    return _tree.unflatten(structure, [
        _tree.from_host(a, kind, dtype) for a, kind, dtype
        in zip(leaves, _tree.leaves_of(structure), dtypes)])


def save_checkpoint(
    directory: str,
    state: Any,
    step: int,
    *,
    keep: Optional[int] = None,
) -> str:
    """Save a state-tree checkpoint; rank 0 writes, all ranks
    synchronize.

    ``state`` is a tree of tensors (params, optimizer state, ...):
    dicts, lists and tuples of tensors, numpy arrays and scalars, e.g.
    ``{"model": model.state_dict(), "opt": opt.state_dict()}``.
    ``directory`` is a local (or NFS-mounted) path — pair with
    ``LocalStore.checkpoint_dir(run_id)`` for estimator-style layouts.
    ``keep``: retain at most this many newest step directories (>= 1).
    Returns the step directory path.
    """
    return save_checkpoint_async(directory, state, step,
                                 keep=keep).wait()


class AsyncSave:
    """Handle for an in-flight :func:`save_checkpoint_async`.

    ``wait()`` finalizes the save — rank 0 joins its background write and
    applies retention; every rank then passes the job barrier, and rank
    0's outcome is broadcast so that a failed write raises on every rank.
    Call it before the next save to the same directory (or at shutdown);
    until then training steps overlap the checkpoint I/O.
    """

    def __init__(self, path, thread=None, directory=None, keep=None,
                 error=None):
        self.path = path
        self._thread = thread
        self._directory = directory
        self._keep = keep
        self._error = error  # a failure deferred to wait()
        self._finalized = False

    def wait(self) -> str:
        if self._finalized:
            # repeat wait() must not silently bless a failed save
            if self._error is not None:
                raise self._error
            return self.path
        t_wait = time.monotonic()
        try:
            if self._thread is not None:  # rank 0
                self._thread.join()
                if self._error is None and self._keep is not None:
                    steps = sorted(_list_step_dirs(self._directory))
                    for old in steps[: max(len(steps) - self._keep, 0)]:
                        shutil.rmtree(_step_dir(self._directory, old),
                                      ignore_errors=True)
        finally:
            # a failed background write must still release the peers
            _barrier()
            self._finalized = True
        # Commit status, as the reference's wait() propagates it: after
        # the release barrier rank 0 broadcasts its outcome and the other
        # ranks turn a failure into their own raise, so the commit is
        # all-or-nothing on every rank.  (ADVICE.md's entry on
        # horovod_tpu/checkpoint.py:229 — a failed rank-0 write raising
        # on rank 0 only — describes the reference before this
        # propagation; ROADMAP C logs it.)
        if size() > 1:
            from .optim import broadcast_object  # noqa: PLC0415

            summary = (
                f"{type(self._error).__name__}: {self._error}"
                if self._error is not None and rank() == 0 else None
            )
            summary = broadcast_object(summary, root_rank=0)
            if summary is not None and self._error is None:
                self._error = RuntimeError(
                    f"checkpoint save of {self.path!r} failed on rank 0 "
                    f"({summary}); no rank may treat this step as "
                    f"committed"
                )
        metrics = get_registry()
        metrics.histogram("checkpoint.commit_wait_ms").observe(
            (time.monotonic() - t_wait) * 1e3
        )
        if self._error is not None:
            metrics.counter("checkpoint.save_errors").inc()
            _flightrec.record(
                "ckpt.error", name=os.path.basename(self.path),
                detail=str(self._error)[:200],
            )
            raise self._error
        metrics.counter("checkpoint.saves_committed").inc()
        _flightrec.record("ckpt.commit", name=os.path.basename(self.path))
        return self.path


def save_checkpoint_async(
    directory: str,
    state: Any,
    step: int,
    *,
    keep: Optional[int] = None,
) -> AsyncSave:
    """:func:`save_checkpoint` without stalling the training loop.

    Rank 0 snapshots the tree to host memory before returning (the loop
    may update the live tensors at once), then a background thread writes
    it; the returned handle's ``wait()`` is the commit point — retention
    and the job-wide barrier happen there, so the reference's
    rank-0-writes/all-ranks-sync contract still holds, just deferred.
    """
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    path = _step_dir(directory, step)
    get_registry().counter("checkpoint.saves_started").inc()
    _flightrec.record("ckpt.begin", name=f"step{step}", cycle=step)
    if rank() != 0:
        return AsyncSave(path)
    try:
        from .testing.faults import maybe_fail  # noqa: PLC0415

        # Chaos point "ckpt_write": a deterministic stand-in for the disk
        # full / permission lost failure the deferred-error path exists
        # for (HVDTPU_FAULT_SPEC="ckpt_write:step=N:rank=0").
        maybe_fail("ckpt_write", step=step)
        # host copies of the leaves, so the loop may update the live
        # tensors while the write runs
        leaves, structure = _tree.flatten(state)
        dtypes = [_tree.dtype_name(x) for x in leaves]
        host = [_tree.to_host(x) for x in leaves]
    except Exception as exc:
        # rank 0 failing before a handle exists must not strand ranks
        # != 0 in wait()'s barrier — defer the raise to wait(), after
        # the barrier releases everyone
        return AsyncSave(path, error=exc)
    handle = AsyncSave(path, None, directory, keep)

    def _write():
        try:
            os.makedirs(directory, exist_ok=True)
            _write_step(path, structure, dtypes, host)
        except BaseException as exc:  # surfaces at wait()
            handle._error = exc

    handle._thread = threading.Thread(target=_write, daemon=True,
                                      name="hvdtpu_checkpoint_write")
    handle._thread.start()
    return handle


def _list_step_dirs(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name[len("step_"):]))
            except ValueError:
                continue  # a directory being written aside
    return steps


def latest_checkpoint_step(directory: str) -> Optional[int]:
    steps = _list_step_dirs(directory)
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str,
    target: Any,
    step: Optional[int] = None,
    *,
    broadcast: bool = True,
) -> Any:
    """Restore a checkpoint and (by default) broadcast it from rank 0.

    ``target`` is a tree of the expected structure, shapes and dtypes;
    each leaf comes back as the kind of its target leaf (a tensor on the
    target tensor's device).  ``step=None`` restores the latest.  With
    ``broadcast=True`` only rank 0 needs the files — every other rank
    receives the state over the wire (reference broadcast_parameters-on-
    start, horovod/torch/__init__.py:452-530), which also guarantees
    bit-identical resume across ranks on non-shared filesystems.
    """
    t_restore = time.monotonic()
    needs_files = rank() == 0 or not broadcast or size() <= 1
    if step is None:
        # Resolve "latest" only where the files are required to exist; on a
        # non-shared filesystem the other ranks have no checkpoint dir and
        # receive the resolved step (or the failure) from rank 0.
        if needs_files:
            step = latest_checkpoint_step(directory)
        if broadcast and size() > 1:
            from .optim import broadcast_object  # noqa: PLC0415

            step = broadcast_object(step, root_rank=0)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    state = None
    if needs_files:
        state = _read_step(_step_dir(directory, step))
    if broadcast and size() > 1:
        from .optim import broadcast_object  # noqa: PLC0415

        state = broadcast_object(state, root_rank=0)
    state = _tree.conform(state, target)
    metrics = get_registry()
    metrics.counter("checkpoint.restores").inc()
    metrics.histogram("checkpoint.restore_ms").observe(
        (time.monotonic() - t_restore) * 1e3
    )
    return state
