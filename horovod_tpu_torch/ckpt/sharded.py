"""Sharded checkpoint format: every rank writes only its own shard (a port
of ``horovod_tpu/ckpt/sharded.py``, the same on-disk format).

The rank-0 ``save_checkpoint`` discipline (checkpoint.py) funnels the
whole pytree through one writer — fine for a workstation, minutes of
serialized I/O at production world sizes.  This format splits the work:

* **Leaf-partitioned shards** — the state tree is flattened and its
  leaves are assigned round-robin to ranks (leaf ``i`` -> shard
  ``i % world_size``).  Each rank pickles only its own leaves (numpy
  arrays, read back with ``ckpt/tree.py``'s restricted loader) into
  ``shard_<rank>_of_<world>.bin`` plus a tiny ``*.meta.json`` sidecar
  carrying the payload's SHA-256, both written through the shared
  atomic tmp+rename helper (obs/pathspec.py) — a crash mid-save can
  never leave a torn shard that a later restore then selects.
* **Manifest committed LAST by rank 0** — ``manifest.json`` records the
  schema, step, writer world size, the full leaf table (index, shard,
  shape, dtype), every shard's checksum, and the tree's structure.  A
  step directory without a valid manifest is *not a checkpoint*:
  :func:`latest_step` never selects it, so the commit point is exactly
  the manifest rename.
* **Reshard on restore (N -> M)** — restore reads the manifest's shard
  table, not the current world: any number of readers can reassemble a
  checkpoint written by any number of writers, so an elastic
  shrink/grow restores the same logical state bit-for-bit.  The *next*
  save re-partitions over the new world.
* **Overlapped save** — :func:`save_sharded_async` snapshots leaves to
  host and hands the write to a background thread (the AsyncSave
  pattern); ``wait()`` is the commit point.  Cross-rank commit status
  rides the filesystem, not a collective: rank 0 polls for every
  sidecar before renaming the manifest, and every other rank polls for
  the manifest — so a failed save surfaces on EVERY rank (the
  all-or-nothing contract AsyncSave's commit-status broadcast
  established), and the path works identically under the engine, the
  elastic KV world, and a single process.

The port's trees (``ckpt/tree.py``): dicts, lists and tuples of torch
tensors, numpy arrays and scalars, flattened in ``jax.tree_util``'s order
for dicts and sequences.  Shards hold numpy arrays, as the reference's do,
so each package restores the other's checkpoints of such trees when given
a target.  The manifest's ``structure`` field is the port's JSON
description of the tree (the reference's pickled jax ``treedef`` is left
``null``): :func:`restore_sharded` without a target rebuilds the tree from
it.  A bfloat16 tensor's shard holds its raw 16-bit words, with the dtype
``"bfloat16"`` in its leaf spec.

Honest limits: the sidecar/manifest handshake assumes the step
directory is visible to all writers (shared filesystem or single
host).  On non-shared filesystems run one save per host and lean on
the peer-replica tier (ckpt/replica.py) for recovery; disk remains the
durability floor — replicas die with the job.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import flightrec as _flightrec
from ..obs import get_registry
from ..obs.pathspec import write_bytes_atomic, write_json_atomic
from ..testing.faults import corrupt_bytes, maybe_fail
from ..utils import env as envmod
from ..utils.logging import get_logger
from . import tree as _tree

LOG = get_logger("ckpt")

SCHEMA = "hvdtpu-sharded-ckpt-v1"
MANIFEST = "manifest.json"

__all__ = [
    "SCHEMA",
    "MANIFEST",
    "ShardCorruptError",
    "ShardedSave",
    "shard_assignment",
    "step_dir",
    "write_shard",
    "write_manifest",
    "load_manifest",
    "latest_step",
    "list_steps",
    "save_sharded_async",
    "save_sharded",
    "restore_sharded",
    "read_shard_payload",
]


class ShardCorruptError(RuntimeError):
    """A shard's bytes do not match the manifest's checksum (torn or
    corrupted write); the restore path treats the whole step as invalid
    and falls back to an older one."""


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"shards_{step:010d}")


def _shard_name(rank: int, world: int) -> str:
    return f"shard_{rank:05d}_of_{world:05d}.bin"


def _sidecar_name(rank: int, world: int) -> str:
    return f"shard_{rank:05d}_of_{world:05d}.meta.json"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def shard_assignment(num_leaves: int, world_size: int) -> List[List[int]]:
    """Leaf indices owned by each shard: round-robin ``i % world_size``.
    Every rank computes the identical table (it is a pure function of
    two integers), so there is nothing to negotiate."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    table: List[List[int]] = [[] for _ in range(world_size)]
    for i in range(num_leaves):
        table[i % world_size].append(i)
    return table


def _flatten(state: Any) -> Tuple[List[np.ndarray], List[str], dict]:
    """Flatten + SNAPSHOT: ``(host leaves, dtype names, structure)``.
    Every leaf is copied to a host array of its own (the background
    writer must not race an in-place ``w -= lr*g`` into a
    checksum-valid-but-torn shard); a bfloat16 tensor as its raw words."""
    leaves, spec = _tree.flatten(state)
    return ([_tree.to_host(x) for x in leaves],
            [_tree.dtype_name(x) for x in leaves], spec)


def write_shard(
    directory: str,
    step: int,
    rank: int,
    world_size: int,
    leaves: Dict[int, np.ndarray],
) -> dict:
    """Write this rank's shard (its assigned leaves, pickled) plus the
    checksum sidecar, both atomically.  Returns the sidecar dict."""
    payload = pickle.dumps(
        {int(i): np.asarray(a) for i, a in leaves.items()},
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    checksum = _sha256(payload)
    # Chaos point "shard_write": an action=corrupt_write spec makes the
    # bytes on disk disagree with the checksum just computed — exactly
    # the torn/bit-flipped write restore-time validation must reject.
    # The rank filter resolves from the PROCESS env (not the shard
    # position passed in as ``rank``): after an elastic shrink the two
    # diverge, and "rank=2" in a spec must keep meaning rank 2.
    if maybe_fail("shard_write", step=step) == "corrupt_write":
        payload = corrupt_bytes(payload)
    d = step_dir(directory, step)
    write_bytes_atomic(os.path.join(d, _shard_name(rank, world_size)),
                       payload)
    meta = {
        "rank": int(rank),
        "world_size": int(world_size),
        "step": int(step),
        "file": _shard_name(rank, world_size),
        "bytes": len(payload),
        "checksum": checksum,
        "leaves": sorted(int(i) for i in leaves),
    }
    write_json_atomic(os.path.join(d, _sidecar_name(rank, world_size)),
                      meta)
    metrics = get_registry()
    metrics.histogram("ckpt.shard_bytes").observe(float(len(payload)))
    metrics.counter("ckpt.shards_written").inc()
    _flightrec.record("ckpt.shard", name=f"step{step}", cycle=step,
                      detail=f"rank={rank} bytes={len(payload)}")
    return meta


def _leaf_specs(leaves: List[np.ndarray], dtypes: List[str],
                world_size: int) -> List[dict]:
    table = shard_assignment(len(leaves), world_size)
    shard_of = {}
    for shard, owned in enumerate(table):
        for i in owned:
            shard_of[i] = shard
    return [
        {
            "index": i,
            "shard": shard_of[i],
            "shape": list(np.shape(a)),
            "dtype": dtype,
        }
        for i, (a, dtype) in enumerate(zip(leaves, dtypes))
    ]


def write_manifest(
    directory: str,
    step: int,
    world_size: int,
    leaf_specs: List[dict],
    structure: dict,
    *,
    extra: Optional[dict] = None,
    sidecar_timeout: float = 30.0,
) -> str:
    """Rank 0's commit: wait for every writer's sidecar, then rename the
    manifest into place LAST.  Raises if any sidecar never appears —
    the step stays invisible to :func:`latest_step` in that case."""
    d = step_dir(directory, step)
    deadline = time.monotonic() + sidecar_timeout
    shards = []
    for rank in range(world_size):
        path = os.path.join(d, _sidecar_name(rank, world_size))
        while True:
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        shards.append(json.load(f))
                    break
                except ValueError:
                    pass  # racing the atomic rename; retry
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"sharded save step {step}: shard sidecar for rank "
                    f"{rank}/{world_size} never appeared under {d!r} — "
                    f"a writer died before its shard landed; the step "
                    f"is NOT committed"
                )
            time.sleep(0.02)
    doc = {
        "schema": SCHEMA,
        "step": int(step),
        "world_size": int(world_size),
        "created": time.time(),
        "num_leaves": len(leaf_specs),
        "leaves": leaf_specs,
        "shards": sorted(shards, key=lambda s: s["rank"]),
        # the reference's pickled jax treedef; the port writes its own
        # JSON structure instead
        "treedef": None,
        "treedef_repr": f"port structure of {len(leaf_specs)} leaves",
        "structure": structure,
        "extra": dict(extra or {}),
    }
    return write_json_atomic(os.path.join(d, MANIFEST), doc)


def load_manifest(directory: str, step: int) -> Optional[dict]:
    path = os.path.join(step_dir(directory, step), MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("schema") != SCHEMA:
        return None
    return doc


def list_steps(directory: str) -> List[int]:
    """Steps with a schema-valid manifest — an uncommitted step
    directory (writer died before the manifest rename) is invisible."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("shards_"):
            continue
        try:
            step = int(name[len("shards_"):])
        except ValueError:
            continue
        if load_manifest(directory, step) is not None:
            steps.append(step)
    return sorted(steps)


def latest_step(directory: str,
                newer_than: Optional[int] = None) -> Optional[int]:
    """Newest committed step, or None.  ``newer_than`` makes this a
    cheap incremental poll (the weight hot-swap watcher calls it every
    few decode steps, forever): step directories are scanned by NAME
    descending and the manifest — the expensive validation — is only
    loaded for candidates above the floor, so a long-lived serving
    fleet pays O(1) manifest reads per poll instead of O(published
    versions)."""
    if newer_than is None:
        steps = list_steps(directory)
        return steps[-1] if steps else None
    if not os.path.isdir(directory):
        return None
    candidates = []
    for name in os.listdir(directory):
        if not name.startswith("shards_"):
            continue
        try:
            step = int(name[len("shards_"):])
        except ValueError:
            continue
        if step > newer_than:
            candidates.append(step)
    for step in sorted(candidates, reverse=True):
        if load_manifest(directory, step) is not None:
            return step
    return None


def read_shard_payload(directory: str, step: int, shard: dict) -> Dict[int, np.ndarray]:
    """Read + checksum-validate one shard named by the manifest."""
    path = os.path.join(step_dir(directory, step), shard["file"])
    try:
        with open(path, "rb") as f:
            payload = f.read()
    except OSError as exc:
        raise ShardCorruptError(
            f"shard {shard['file']} of step {step} unreadable: {exc}"
        ) from exc
    if _sha256(payload) != shard["checksum"]:
        raise ShardCorruptError(
            f"shard {shard['file']} of step {step} failed checksum "
            f"validation (torn or corrupted write)"
        )
    return _tree.safe_loads(payload)


class ShardedSave:
    """Handle for an in-flight :func:`save_sharded_async`.

    The writer thread does all I/O: this rank's shard, then (rank 0)
    the sidecar wait + manifest rename, then (every rank) the
    manifest-commit poll.  ``wait()`` joins the thread and raises the
    deferred error, so a failed save surfaces on every rank and repeat
    ``wait()`` never silently blesses it."""

    def __init__(self, directory: str, step: int, rank: int):
        self.directory = directory
        self.step = step
        self.rank = rank
        self.path = step_dir(directory, step)
        self.manifest: Optional[dict] = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> str:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            metrics = get_registry()
            if self._error is not None:
                metrics.counter("ckpt.save_errors").inc()
                _flightrec.record(
                    "ckpt.error", name=f"step{self.step}",
                    cycle=self.step, detail=str(self._error)[:200],
                )
            else:
                metrics.counter("ckpt.saves_committed").inc()
                _flightrec.record("ckpt.commit", name=f"step{self.step}",
                                  cycle=self.step, detail="sharded")
        if self._error is not None:
            raise self._error
        return self.path


def save_sharded_async(
    directory: str,
    state: Any,
    step: int,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    extra: Optional[dict] = None,
    commit_timeout: Optional[float] = None,
) -> ShardedSave:
    """Start this rank's shard write in the background; ``wait()`` is
    the commit point.  Leaves are snapshotted to host arrays BEFORE
    returning, so the training loop may mutate ``state`` immediately.

    ``rank``/``world_size`` default to the engine world
    (``hvd.rank()``/``size()``) and may be passed explicitly to ride a
    different world (the elastic context supplies world *positions*)
    or to simulate many writers in one process (tests).
    """
    if rank is None or world_size is None:
        from ..basics import rank as _rank, size as _size  # noqa: PLC0415

        rank = _rank() if rank is None else rank
        world_size = _size() if world_size is None else world_size
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    if commit_timeout is None:
        commit_timeout = envmod.env_float(
            envmod.CKPT_COMMIT_TIMEOUT, envmod.DEFAULT_CKPT_COMMIT_TIMEOUT
        )
    leaves, dtypes, structure = _flatten(state)
    specs = _leaf_specs(leaves, dtypes, world_size)
    owned = {i: leaves[i]
             for i in shard_assignment(len(leaves), world_size)[rank]}
    handle = ShardedSave(directory, step, rank)
    get_registry().counter("ckpt.saves_started").inc()
    _flightrec.record("ckpt.begin", name=f"step{step}", cycle=step,
                      detail=f"sharded rank={rank}/{world_size}")

    def _write():
        try:
            my_meta = write_shard(directory, step, rank, world_size,
                                  owned)
            if rank == 0:
                # A pre-existing manifest (an earlier attempt at this
                # step) is NOT removed: it stays restorable until the
                # atomic rename replaces it — a crash mid-re-save must
                # never destroy a checkpoint that was already durable.
                # Peers can't be confused by it because their commit
                # poll below accepts only a manifest carrying THEIR
                # attempt's checksum.
                write_manifest(
                    directory, step, world_size, specs, structure,
                    extra=extra, sidecar_timeout=commit_timeout,
                )
                manifest = load_manifest(directory, step)
            else:
                # Commit = a manifest that names THIS attempt's shard
                # checksum for this rank.  A stale manifest from an
                # earlier attempt keeps the poll waiting (not failing:
                # rank 0 may simply not have re-committed yet); only
                # the deadline turns a mismatch into an error.
                deadline = time.monotonic() + commit_timeout
                manifest = None
                while True:
                    doc = load_manifest(directory, step)
                    if doc is not None:
                        mine = next(
                            (s for s in doc.get("shards", [])
                             if s.get("rank") == rank), None)
                        if mine is not None and \
                                mine.get("checksum") == \
                                my_meta["checksum"]:
                            manifest = doc
                            break
                    if time.monotonic() > deadline:
                        if doc is not None:
                            raise RuntimeError(
                                f"sharded save step {step}: the "
                                f"committed manifest never carried "
                                f"this rank's shard checksum (a stale "
                                f"attempt's sidecar was committed "
                                f"instead) — this save is NOT valid "
                                f"on rank {rank}"
                            )
                        raise TimeoutError(
                            f"sharded save step {step}: manifest never "
                            f"committed by rank 0 within "
                            f"{commit_timeout}s — no rank may treat "
                            f"this step as committed"
                        )
                    time.sleep(0.02)
            handle.manifest = manifest
        except BaseException as exc:  # surfaces at wait()
            handle._error = exc

    handle._thread = threading.Thread(
        target=_write, name=f"hvdtpu_ckpt_shard_w{rank}", daemon=True
    )
    handle._thread.start()
    return handle


def save_sharded(directory: str, state: Any, step: int, **kwargs) -> str:
    """Synchronous :func:`save_sharded_async` (write + commit)."""
    return save_sharded_async(directory, state, step, **kwargs).wait()


def restore_sharded(
    directory: str,
    target: Any = None,
    step: Optional[int] = None,
    *,
    with_manifest: bool = False,
):
    """Reassemble a sharded checkpoint into one pytree (any reader
    world size — the manifest, not the current world, names the
    shards; this is what makes N->M elastic reshard work).

    ``target`` supplies the tree structure (validated against the
    manifest's leaf count, shapes and dtypes), and each leaf comes back
    as the kind of its target leaf (a CPU tensor for a tensor, a numpy
    array, a numpy or Python scalar); ``target=None`` rebuilds the tree
    from the manifest's ``structure`` (a checkpoint the port wrote).  ``step=None`` restores the newest
    valid step, **falling back to older steps** when a shard fails
    checksum validation — a corrupt newest checkpoint degrades to the
    previous commit instead of killing recovery.  An explicitly
    requested step never falls back.  ``with_manifest=True`` returns
    ``(state, manifest)``.
    """
    t0 = time.monotonic()
    metrics = get_registry()
    explicit = step is not None
    candidates = [step] if explicit else list(reversed(list_steps(directory)))
    if not candidates:
        raise FileNotFoundError(
            f"no committed sharded checkpoint under {directory!r}"
        )
    last_exc: Optional[Exception] = None
    for s in candidates:
        manifest = load_manifest(directory, s)
        if manifest is None:
            last_exc = FileNotFoundError(
                f"step {s} has no valid manifest under {directory!r}"
            )
            if explicit:
                raise last_exc
            continue
        try:
            state = _reassemble(directory, manifest, target)
        except ShardCorruptError as exc:
            metrics.counter("ckpt.restore_corrupt_shards").inc()
            LOG.warning("sharded restore: step %d rejected (%s)%s",
                        s, exc,
                        "" if explicit else "; falling back to an "
                        "older committed step")
            last_exc = exc
            if explicit:
                raise
            continue
        # Disk-reassembly time specifically; the end-to-end recovery
        # time (ckpt.restore_ms) is observed by State.sync, which may
        # not touch disk at all.
        metrics.histogram("ckpt.restore_disk_ms").observe(
            (time.monotonic() - t0) * 1e3
        )
        metrics.counter("ckpt.restores_disk").inc()
        _flightrec.record(
            "ckpt.restore_disk", name=f"step{manifest['step']}",
            cycle=manifest["step"],
            detail=f"world={manifest['world_size']}",
        )
        return (state, manifest) if with_manifest else state
    raise last_exc if last_exc is not None else FileNotFoundError(
        f"no restorable sharded checkpoint under {directory!r}"
    )


def _reassemble(directory: str, manifest: dict, target: Any):
    step = manifest["step"]
    flat: Dict[int, np.ndarray] = {}
    for shard in manifest["shards"]:
        flat.update(read_shard_payload(directory, step, shard))
    n = manifest["num_leaves"]
    missing = [i for i in range(n) if i not in flat]
    if missing:
        raise ShardCorruptError(
            f"step {step}: leaves {missing[:5]} missing from every shard"
        )
    specs = manifest.get("leaves") or []
    dtypes = [s.get("dtype") for s in specs] or [None] * n
    if target is not None:
        t_leaves, structure = _tree.flatten(target)
        if len(t_leaves) != n:
            raise ValueError(
                f"target has {len(t_leaves)} leaves but the "
                f"manifest records {n} — structure mismatch "
                f"(manifest: {manifest.get('treedef_repr')})"
            )
        # Leaf count alone would let a same-arity checkpoint from a
        # DIFFERENT model restore silently into the wrong fields; the
        # manifest's per-leaf shape/dtype table rejects that here, at
        # the restore site, instead of as wrong weights later.
        for spec, tl in zip(specs, t_leaves):
            shape, dtype = _tree.leaf_sig(tl)
            if spec.get("shape") is not None and spec["shape"] != shape:
                raise ValueError(
                    f"leaf {spec['index']}: target shape {shape} != "
                    f"manifest shape {spec['shape']} — this checkpoint "
                    f"belongs to a different state structure"
                )
            if spec.get("dtype") is not None and spec["dtype"] != dtype:
                raise ValueError(
                    f"leaf {spec['index']}: target dtype {dtype} != "
                    f"manifest dtype {spec['dtype']} — this checkpoint "
                    f"belongs to a different state structure"
                )
    else:
        structure = manifest.get("structure")
        if structure is None:
            raise ValueError(
                "manifest carries no port structure (another package "
                "wrote it); pass a target tree"
            )
    kinds = _tree.leaves_of(structure)
    leaves = [_tree.from_host(flat[i], kind, dtype)
              for i, (kind, dtype) in enumerate(zip(kinds, dtypes))]
    return _tree.unflatten(structure, leaves)
